// The Swin attention half-block's training forward and backward for Hopper
// (sm_90a), on the raster token stream of one stage, (B, S*S, C):
//
//   K9a (forward):   y = W-MSA(LN(x)) @ Wo + bo        (no residual)
//                    saving qkv (post-bias, unscaled), ctx and the
//                    normalised probabilities p
//   K9b (core bwd):  dqkv, dbias from qkv, p and da = dL/dctx
//   K9c (all bwd):   da = g Wo^T, dWo, dbo, the core, the LN recompute,
//                    dWqkv, dbqkv, dh = dqkv Wqkv^T, the LN VJP -> dx, dls, dlb
//
// Replaces geovpr/ops/pallas_swin_block.py::_swin_train_fwd_pallas
// (_train_kernel), _swin_attn_bwd_pallas (_train_bwd_kernel) and
// _swin_attn_bwd_all_pallas (_train_bwd_all_kernel), and covers the rolled
// entries (_train_kernel_rolled, roll_relayout): the stream stays in raster
// order and every kernel that touches windows finds token (ry, rx) of
// window (wy, wx) of image b at raster row
//   b*S*S + ((wy*w + ry + shift) mod S) * S + (wx*w + rx + shift) mod S,
// as K4 does (swin_attn.cu), so the partition, the cyclic shift and its
// inverse for dx are addressing, not copies.
//
// Numerics follow the JAX bodies. K9a: LN in f32; qkv in f32 stored as bf16
// unscaled, q scaled by dh^-0.5 log2(e) from the f32 value and rounded to
// bf16 on a separate copy (bf16_gemm.cuh's ln_qkv_gemm_kernel); bias and mask in the
// exp2 domain; p = exp2(min(s, 100)) with no max-shift, normalised by the
// reciprocal of its f32 row sum, stored as bf16 and used in bf16 (never
// fp16: p reaches 2^100 before the normalisation) for P.V. K9b/K9c: dp =
// da v^T, ds = p (dp - sum(dp p)) in f32, dbias += ds, ds * dh^-0.5 rounded
// to bf16 before dq = ds k and dk = ds^T q, dv = p^T da, all stored bf16;
// the mask gets no gradient. K9c also rounds da, the recomputed LN output
// and dh to bf16 where JAX does, and accumulates every weight gradient in
// f32 over all rows.
//
// Cross-CTA sums (dbias, the weight and bias gradients, dls, dlb) are
// deterministic: each CTA writes a partial sum of its own and one
// reduce_partials launch adds the partials in a fixed order; no atomics.
//
// What bounds it on the H100: at Swin-B-384 stage 0, B=16 (M = 147,456
// rows, C 128, H 4) K9a moves ~396 MB (x, qkv, ctx, p, y; p alone is
// 170 MB) against ~30 GFLOP, K9c ~435 MB (reads x, qkv, ctx, g, p, the
// weights, ln_scale and ln_bias; writes dx, the f32 weight and bias
// gradients and dbias; all but x..dx and p are under 1 MB) against
// ~60 GFLOP: both bound by bytes (0.118 and
// 0.130 ms at 3.35 TB/s; the measured times, from chip_smoke.py, are in
// PERF.md beside the card and its power limit). K9a and the cores keep
// the first version's WMMA / mma.sync without a copy pipeline, a scaled-q
// copy and the scratch tensors between launches (da, dqkv, the LN output,
// partial sums).
//
// K9c's launches (`geovpr_swin_train_bwd_all_parts` runs a range of them,
// for timing one by one): 0 da, 1 dWo, 2 dbo, 3 the core, 4 the LN
// recompute, 5 dWqkv, 6 dbqkv, 7 dh, 8 the LN VJP. Its four products run
// on hopper_gemm.cuh's persistent TMA + wgmma GEMM: da = g Wo^T and dh =
// dqkv Wqkv^T read the (in, out) weights as the K-major B operand and round
// once to bf16; dWo = ctx^T g and dWqkv = h^T dqkv read both operands as
// boxes of rows (A MN-major), split the rows into the first version's
// chunks (train_gemm.cuh's split_rows over its 64 x 64 tiles) whose f32
// partials one reduce_partials launch adds in order. Each output element
// takes its k16 steps in the first version's order, one tensor-core
// product each, so where the card's wgmma and mma.sync k16 products round
// alike the four products keep the first version's bits (and a training
// run its trajectory). The column sums (dbo, dbqkv), the core, the LN
// recompute and VJP are the first version's. The kernels allocate nothing;
// the caller passes the scratch.

#include "hopper_gemm.cuh"
#include "train_gemm.cuh"
#include "window_attn.cuh"

namespace {

constexpr float kLog2eT = 1.4426950408889634f;
constexpr float kMaskL2T = -100.f * kLog2eT;
constexpr int TR_NT = 9;              // key / query tiles of 16: N = 144
constexpr int TR_N = TR_NT * 16;
constexpr int TR_PLD = TR_N + 8;      // bf16 row stride of p and ds in smem
constexpr int kMaxSmemT = 232448;

__host__ __device__ inline size_t al128(size_t v) { return (v + 127) & ~(size_t)127; }

// raster row of token r of window `win_idx` (b, wy, wx) and, for the
// forward, its bias position and mask label (as swin_attn.cu)
__device__ __forceinline__ int raster_row(int win_idx, int r, int S, int win,
                                          int shift, int* pos, int* lab) {
  const int nwx = S / win;
  const int b = win_idx / (nwx * nwx);
  const int wy = (win_idx / nwx) % nwx;
  const int wx = win_idx % nwx;
  const int ry = r / win;
  const int rx = r % win;
  const int Y = wy * win + ry;
  const int X = wx * win + rx;
  int y = Y + shift;
  int x = X + shift;
  if (y >= S) y -= S;
  if (x >= S) x -= S;
  if (pos) *pos = ry * (2 * win - 1) + rx;
  if (lab)
    *lab = shift ? 3 * (Y < S - win ? 0 : (Y < S - shift ? 1 : 2)) +
                       (X < S - win ? 0 : (X < S - shift ? 1 : 2))
                 : 0;
  return (b * S + y) * S + x;
}

// ------------------------------------------------------------ K9a core ----
// Shared memory: rows, positions, labels (3N ints), the head's bias table
// ((2w-1)^2 floats), scaled q and k rows (N x 80 bytes each), v^T (32 rows
// of N + 8 bf16).
__host__ __device__ inline size_t fwd_smem_bytes(int win) {
  const int n = win * win;
  const int t = 2 * win - 1;
  return al128((size_t)(3 * n + t * t) * 4) + (size_t)2 * n * QK_LD_BF16 +
         (size_t)SW_DH * (n + 8) * sizeof(bf16);
}

// Grid (BW, H), N/16 warps. qs (M, C) bf16 scaled q; qkv (M, 3C) bf16
// (k, v read from it); ctx (M, C) bf16 out; p (BW, H, N, N) bf16 out;
// table ((2w-1)^2, H) f32 natural-log domain.
__global__ void __launch_bounds__(512)
swin_train_attn_fwd_kernel(const bf16* __restrict__ qs,
                           const bf16* __restrict__ qkv,
                           bf16* __restrict__ ctx, bf16* __restrict__ p_out,
                           const float* __restrict__ table, int C, int H,
                           int S, int win, int shift) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = win * win;
  const int T = 2 * win - 1;
  const int w_idx = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  int* rows_s = reinterpret_cast<int*>(smem);
  int* pos_s = rows_s + N;
  int* lab_s = pos_s + N;
  float* tab_s = reinterpret_cast<float*>(lab_s + N);
  unsigned char* q_s = smem + al128((size_t)(3 * N + T * T) * 4);
  unsigned char* k_s = q_s + (size_t)N * QK_LD_BF16;
  bf16* vt_s = reinterpret_cast<bf16*>(k_s + (size_t)N * QK_LD_BF16);
  const int vt_ld = N + 8;

  for (int r = tid; r < N; r += nthreads)
    rows_s[r] = raster_row(w_idx, r, S, win, shift, pos_s + r, lab_s + r);
  for (int i = tid; i < T * T; i += nthreads) tab_s[i] = table[i * H + h] * kLog2eT;
  __syncthreads();

  const size_t ld3 = 3 * (size_t)C;
  for (int i = tid; i < N * 4; i += nthreads) {
    const int r = i >> 2;
    const int c = i & 3;
    const size_t row = (size_t)rows_s[r];
    *reinterpret_cast<uint4*>(q_s + r * QK_LD_BF16 + c * 16) =
        *reinterpret_cast<const uint4*>(qs + row * C + h * SW_DH + c * 8);
    const bf16* src = qkv + row * ld3 + h * SW_DH + c * 8;
    *reinterpret_cast<uint4*>(k_s + r * QK_LD_BF16 + c * 16) =
        *reinterpret_cast<const uint4*>(src + C);
    const uint4 vv = *reinterpret_cast<const uint4*>(src + 2 * C);
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt_s[(c * 8 + e) * vt_ld + r] = ve[e];
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qa[2][4];
  load_q_frags_bf16(q_s, r0, t, qa);
  const int base = (win - 1) * (T + 1);
  const int pos0 = pos_s[r0] + base;
  const int pos1 = pos_s[r1] + base;
  const int lab0 = lab_s[r0];
  const int lab1 = lab_s[r1];

  // + bias [+ mask], p = exp2(min(s, 100)), as K4
  auto prob = [&](int key, bool hi, float sv) {
    float v = __fadd_rn(sv, tab_s[(hi ? pos1 : pos0) - pos_s[key]]);
    if (shift && (hi ? lab1 : lab0) != lab_s[key]) v = __fadd_rn(v, kMaskL2T);
    return exp2f(fminf(v, 100.f));
  };

  // pass 1: row sums of p
  float l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < N; k0 += 16) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s[4];
      scores_bf16(qa, k_s, k0 + j * 8 + g, t, s);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = prob(k0 + j * 8 + 2 * t + (e & 1), e >= 2, s[e]);
        if (e >= 2) l1 += pv; else l0 += pv;
      }
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;

  // pass 2: normalised p (stored bf16) and P.V from it
  bf16* pw = p_out + ((size_t)w_idx * H + h) * N * N;
  float o[4][4];
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jn][e] = 0.f;
  for (int k0 = 0; k0 < N; k0 += 16) {
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      scores_bf16(qa, k_s, k0 + j * 8 + g, t, s[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        s[j][e] = prob(k0 + j * 8 + 2 * t + (e & 1), hi, s[j][e]) *
                  (hi ? inv1 : inv0);
      }
    }
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = k0 + j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(pw + (size_t)r0 * N + key) = pa[2 * j];
      *reinterpret_cast<uint32_t*>(pw + (size_t)r1 * N + key) = pa[2 * j + 1];
    }
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const bf16* vp = vt_s + (jn * 8 + g) * vt_ld + k0 + 2 * t;
      mma_bf16(o[jn], pa, *reinterpret_cast<const uint32_t*>(vp),
               *reinterpret_cast<const uint32_t*>(vp + 8));
    }
  }
  const size_t out0 = (size_t)rows_s[r0] * C + h * SW_DH + 2 * t;
  const size_t out1 = (size_t)rows_s[r1] * C + h * SW_DH + 2 * t;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    *reinterpret_cast<__nv_bfloat162*>(ctx + out0 + jn * 8) =
        __floats2bfloat162_rn(o[jn][0], o[jn][1]);
    *reinterpret_cast<__nv_bfloat162*>(ctx + out1 + jn * 8) =
        __floats2bfloat162_rn(o[jn][2], o[jn][3]);
  }
}

// ------------------------------------------------------- K9b/K9c core ----
// One CTA per (window group, head): it walks windows blockIdx.x,
// blockIdx.x + gridDim.x, ... of head blockIdx.y, keeping its warps' rows
// of dbias in registers across them, and writes them as its partial
// dbias_part[blockIdx.x][h] (N x N f32) at the end. Per window:
//   gather q, v, da rows, k^T and the stored p plane into shared memory;
//   each warp (16 query rows) sums dp p over the keys (pass 1), then forms
//   ds tile by tile (pass 2): dbias += ds, ds_b = bf16(ds * scale) stored
//   to shared memory and packed as the A operand of dq = ds_b k;
//   after a barrier each warp takes 16 key rows: dk = ds_b^T q and
//   dv = p^T da by WMMA (col-major A reads the transposes in place).
struct CoreSmem {
  static constexpr size_t rows = 0;
  static constexpr size_t q = 1024;                          // N ints
  static constexpr size_t v = q + (size_t)TR_N * QK_LD_BF16;
  static constexpr size_t da = v + (size_t)TR_N * QK_LD_BF16;
  static constexpr size_t kt = da + (size_t)TR_N * QK_LD_BF16;
  static constexpr size_t p = kt + (size_t)SW_DH * TR_PLD * 2;
  static constexpr size_t ds = p + (size_t)TR_N * TR_PLD * 2;
  static constexpr size_t stage = ds + (size_t)TR_N * TR_PLD * 2;
  static constexpr size_t bytes = stage + (size_t)TR_NT * 256 * 4;
};

__global__ void __launch_bounds__(TR_NT * 32)
swin_train_attn_bwd_kernel(const bf16* __restrict__ qkv,
                           const bf16* __restrict__ p,
                           const bf16* __restrict__ da,
                           bf16* __restrict__ dqkv,
                           float* __restrict__ dbias_part, int BW, int C,
                           int H, int S, int win, int shift, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = TR_N;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;

  int* rows_s = reinterpret_cast<int*>(smem + CoreSmem::rows);
  unsigned char* q_s = smem + CoreSmem::q;
  unsigned char* v_s = smem + CoreSmem::v;
  unsigned char* da_s = smem + CoreSmem::da;
  bf16* kt_s = reinterpret_cast<bf16*>(smem + CoreSmem::kt);
  bf16* p_s = reinterpret_cast<bf16*>(smem + CoreSmem::p);
  bf16* ds_s = reinterpret_cast<bf16*>(smem + CoreSmem::ds);
  float* stage_s = reinterpret_cast<float*>(smem + CoreSmem::stage) + warp * 256;
  const size_t ld3 = 3 * (size_t)C;

  float dbias[TR_NT][2][4];
#pragma unroll
  for (int kt = 0; kt < TR_NT; ++kt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dbias[kt][j][e] = 0.f;

  for (int w_idx = blockIdx.x; w_idx < BW; w_idx += gridDim.x) {
    for (int r = tid; r < N; r += nthreads)
      rows_s[r] = raster_row(w_idx, r, S, win, shift, nullptr, nullptr);
    __syncthreads();
    for (int i = tid; i < N * 4; i += nthreads) {
      const int r = i >> 2;
      const int c = i & 3;
      const size_t row = (size_t)rows_s[r];
      const bf16* src = qkv + row * ld3 + h * SW_DH + c * 8;
      *reinterpret_cast<uint4*>(q_s + r * QK_LD_BF16 + c * 16) =
          *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(v_s + r * QK_LD_BF16 + c * 16) =
          *reinterpret_cast<const uint4*>(src + 2 * C);
      *reinterpret_cast<uint4*>(da_s + r * QK_LD_BF16 + c * 16) =
          *reinterpret_cast<const uint4*>(da + row * C + h * SW_DH + c * 8);
      const uint4 kv = *reinterpret_cast<const uint4*>(src + C);
      const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
      for (int e = 0; e < 8; ++e) kt_s[(c * 8 + e) * TR_PLD + r] = ke[e];
    }
    const bf16* pw = p + ((size_t)w_idx * H + h) * N * N;
    for (int i = tid; i < N * (N / 8); i += nthreads) {
      const int r = i / (N / 8);
      const int c8 = i % (N / 8);
      *reinterpret_cast<uint4*>(p_s + r * TR_PLD + c8 * 8) =
          *reinterpret_cast<const uint4*>(pw + (size_t)r * N + c8 * 8);
    }
    __syncthreads();

    uint32_t dfr[2][4];
    load_q_frags_bf16(da_s, r0, t, dfr);

    // pass 1: sum_j dp * p of rows r0, r1
    float sub0 = 0.f, sub1 = 0.f;
#pragma unroll
    for (int kt = 0; kt < TR_NT; ++kt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float dp[4];
        scores_bf16(dfr, v_s, kt * 16 + j * 8 + g, t, dp);
        const int key = kt * 16 + j * 8 + 2 * t;
        const __nv_bfloat162 pa = *reinterpret_cast<const __nv_bfloat162*>(
            p_s + r0 * TR_PLD + key);
        const __nv_bfloat162 pb = *reinterpret_cast<const __nv_bfloat162*>(
            p_s + r1 * TR_PLD + key);
        sub0 += dp[0] * __low2float(pa) + dp[1] * __high2float(pa);
        sub1 += dp[2] * __low2float(pb) + dp[3] * __high2float(pb);
      }
    }
    sub0 += __shfl_xor_sync(0xffffffffu, sub0, 1);
    sub0 += __shfl_xor_sync(0xffffffffu, sub0, 2);
    sub1 += __shfl_xor_sync(0xffffffffu, sub1, 1);
    sub1 += __shfl_xor_sync(0xffffffffu, sub1, 2);

    // pass 2: ds, dbias, ds_b to shared memory, dq = ds_b k
    float dq[4][4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[jn][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < TR_NT; ++kt) {
      uint32_t dsa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float dp[4];
        scores_bf16(dfr, v_s, kt * 16 + j * 8 + g, t, dp);
        const int key = kt * 16 + j * 8 + 2 * t;
        const __nv_bfloat162 pa = *reinterpret_cast<const __nv_bfloat162*>(
            p_s + r0 * TR_PLD + key);
        const __nv_bfloat162 pb = *reinterpret_cast<const __nv_bfloat162*>(
            p_s + r1 * TR_PLD + key);
        const float pv[4] = {__low2float(pa), __high2float(pa),
                             __low2float(pb), __high2float(pb)};
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[e] = pv[e] * (dp[e] - (e >= 2 ? sub1 : sub0));
          dbias[kt][j][e] += ds[e];
        }
        dsa[2 * j] = pack_bf16(ds[0] * scale, ds[1] * scale);
        dsa[2 * j + 1] = pack_bf16(ds[2] * scale, ds[3] * scale);
        *reinterpret_cast<uint32_t*>(ds_s + r0 * TR_PLD + key) = dsa[2 * j];
        *reinterpret_cast<uint32_t*>(ds_s + r1 * TR_PLD + key) = dsa[2 * j + 1];
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const bf16* kp = kt_s + (jn * 8 + g) * TR_PLD + kt * 16 + 2 * t;
        mma_bf16(dq[jn], dsa, *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    {
      const size_t o0 = (size_t)rows_s[r0] * ld3 + h * SW_DH + 2 * t;
      const size_t o1 = (size_t)rows_s[r1] * ld3 + h * SW_DH + 2 * t;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        *reinterpret_cast<__nv_bfloat162*>(dqkv + o0 + jn * 8) =
            __floats2bfloat162_rn(dq[jn][0], dq[jn][1]);
        *reinterpret_cast<__nv_bfloat162*>(dqkv + o1 + jn * 8) =
            __floats2bfloat162_rn(dq[jn][2], dq[jn][3]);
      }
    }
    __syncthreads();

    // dk = ds_b^T q and dv = p^T da for key rows j0 .. j0 + 15
    const int j0 = warp * 16;
    const bf16* qrow = reinterpret_cast<const bf16*>(q_s);
    const bf16* darow = reinterpret_cast<const bf16*>(da_s);
    constexpr int RLD = QK_LD_BF16 / 2;  // bf16 elements per q / da row
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const bf16* amat = which == 0 ? ds_s : p_s;
      const bf16* bmat = which == 0 ? qrow : darow;
#pragma unroll
      for (int d0 = 0; d0 < SW_DH; d0 += 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int i0 = 0; i0 < TR_N; i0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, amat + i0 * TR_PLD + j0, TR_PLD);
          wmma::load_matrix_sync(fb, bmat + i0 * RLD + d0, RLD);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(stage_s, acc, 16, wmma::mem_row_major);
        __syncwarp();
        const size_t col = (size_t)(which + 1) * C + h * SW_DH + d0;
        for (int i = lane; i < 16 * 8; i += 32) {
          const int r = i >> 3;
          const int c2 = (i & 7) * 2;
          *reinterpret_cast<__nv_bfloat162*>(
              dqkv + (size_t)rows_s[j0 + r] * ld3 + col + c2) =
              __floats2bfloat162_rn(stage_s[r * 16 + c2], stage_s[r * 16 + c2 + 1]);
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }

  float* part = dbias_part + ((size_t)blockIdx.x * H + h) * N * N;
#pragma unroll
  for (int kt = 0; kt < TR_NT; ++kt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = kt * 16 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(part + (size_t)r0 * N + key) =
          make_float2(dbias[kt][j][0], dbias[kt][j][1]);
      *reinterpret_cast<float2*>(part + (size_t)r1 * N + key) =
          make_float2(dbias[kt][j][2], dbias[kt][j][3]);
    }
}

// ---------------------------------------------------------------- host ----

bool train_shapes_ok(int B, int S, int C, int H, int win, int shift) {
  return B > 0 && H > 0 && C == H * SW_DH && C % 64 == 0 && C <= 1024 &&
         win * win == TR_N && S > 0 && S % win == 0 && shift >= 0 &&
         shift < win && (long long)B * (S / win) * (S / win) <= 0x7fffffff &&
         (long long)B * S * S / GEMM_BM + 1 <= 65535;
}

// the window groups of the core backward: about 2 CTAs per SM over all heads
int core_groups(int BW, int H) { return std::max(1, std::min(BW, cdiv(264, H))); }

// f32 scratch K9c needs (the largest partial-sum buffer of its launches)
long long bwd_scratch_floats(int B, int S, int C, int H, int win) {
  const int M = B * S * S;
  const int BW = M / (win * win);
  int s1, c1;
  split_rows(M, cdiv(C, TG_BM) * cdiv(C, TG_BN), &s1, &c1);
  int s3, c3;
  split_rows(M, cdiv(C, TG_BM) * cdiv(3 * C, TG_BN), &s3, &c3);
  int s2, c2;
  split_rows(M, cdiv(3 * C, 128), &s2, &c2);
  long long need = (long long)s1 * C * C;
  need = std::max(need, (long long)s3 * C * 3 * C);
  need = std::max(need, (long long)s2 * 3 * C);
  need = std::max(need, (long long)core_groups(BW, H) * H * TR_N * TR_N);
  need = std::max(need, 2LL * LN_VJP_BLOCKS * LN_VJP_WARPS * C);
  need = std::max(need, 528LL * 3 * C);  // colsum partials
  return need;
}

cudaError_t core_bwd(cudaStream_t st, const bf16* qkv, const bf16* p,
                     const bf16* da, bf16* dqkv, float* part, float* dbias,
                     int B, int S, int C, int H, int win, int shift, float scale) {
  const int BW = B * (S / win) * (S / win);
  const int G = core_groups(BW, H);
  swin_train_attn_bwd_kernel<<<dim3(G, H), TR_NT * 32, CoreSmem::bytes, st>>>(
      qkv, p, da, dqkv, part, BW, C, H, S, win, shift, scale);
  cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : reduce(st, part, G, (size_t)H * TR_N * TR_N, dbias);
}

}  // namespace

// Raises the kernels' dynamic shared-memory limits on the current device.
extern "C" int geovpr_swin_train_init(void) {
  cudaError_t e;
  if (tmap_encode_fn() == nullptr) return (int)cudaErrorSymbolNotFound;
  if ((e = allow_gemm_smem<HG_EPI_NONE, true>()) != cudaSuccess ||
      (e = allow_gemm_smem<HG_EPI_F32, false, true>()) != cudaSuccess ||
      (e = allow_smem(ln_qkv_gemm_kernel, kMaxSmemT)) != cudaSuccess ||
      (e = allow_smem(swin_train_attn_fwd_kernel, fwd_smem_bytes(12))) != cudaSuccess)
    return (int)e;
  return (int)allow_smem(swin_train_attn_bwd_kernel, CoreSmem::bytes);
}

extern "C" long long geovpr_swin_train_scratch_floats(int B, int S, int C, int H,
                                                      int win) {
  return bwd_scratch_floats(B, S, C, H, win);
}

// K9a. Returns a cudaError_t as int. x (M, C) bf16 raster rows; wqkv (C, 3C)
// and wo (C, C) bf16 (in, out); ln_scale, ln_bias, bqkv, bo f32; table
// ((2w-1)^2, H) f32. Outputs: qkv (M, 3C) bf16 unscaled, ctx (M, C) bf16,
// p (BW, H, N, N) bf16, y (M, C) bf16; scratch qs (M, C) bf16.
// qscale = dh^-0.5 log2(e).
extern "C" int geovpr_swin_train_fwd(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* table,
    void* qkv, void* qs, void* ctx, void* p, void* y, int B, int S, int C,
    int H, int win, int shift, float eps, float qscale, void* stream) {
  if (!train_shapes_ok(B, S, C, H, win, shift) ||
      gemm_smem_bytes(C) > (size_t)kMaxSmemT)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  const int BW = M / (win * win);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;

  ln_qkv_gemm_kernel<<<dim3(cdiv(3 * C, GEMM_BN), cdiv(M, GEMM_BM)),
                       GEMM_THREADS, gemm_smem_bytes(C), st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), eps, static_cast<bf16*>(qkv), M, C,
      3 * C, qscale, C, static_cast<bf16*>(qs));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  swin_train_attn_fwd_kernel<<<dim3(BW, H), 2 * TR_N, fwd_smem_bytes(win), st>>>(
      static_cast<const bf16*>(qs), static_cast<const bf16*>(qkv),
      static_cast<bf16*>(ctx), static_cast<bf16*>(p),
      static_cast<const float*>(table), C, H, S, win, shift);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  return (int)tgemm(st, static_cast<const bf16*>(ctx), C,
                    static_cast<const bf16*>(wo), C, M, C, C,
                    static_cast<const float*>(bo), static_cast<bf16*>(y));
}

// K9b. qkv (M, 3C), p (BW, H, N, N), da (M, C) bf16 -> dqkv (M, 3C) bf16,
// dbias (H, N, N) f32; scratch part (at least
// geovpr_swin_train_scratch_floats) f32. scale = dh^-0.5.
extern "C" int geovpr_swin_train_bwd_core(
    const void* qkv, const void* p, const void* da, void* dqkv, void* part,
    void* dbias, int B, int S, int C, int H, int win, int shift, float scale,
    void* stream) {
  if (!train_shapes_ok(B, S, C, H, win, shift)) return (int)cudaErrorInvalidValue;
  return (int)core_bwd(static_cast<cudaStream_t>(stream),
                       static_cast<const bf16*>(qkv), static_cast<const bf16*>(p),
                       static_cast<const bf16*>(da), static_cast<bf16*>(dqkv),
                       static_cast<float*>(part), static_cast<float*>(dbias), B,
                       S, C, H, win, shift, scale);
}

// K9c's launches first..last: 0 da = bf16(g Wo^T); 1 dWo = ctx^T g (and
// its reduce); 2 dbo = sum g; 3 the attention core (and its dbias reduce);
// 4 the LN recompute; 5 dWqkv = h^T dqkv (and its reduce); 6 dbqkv = sum
// dqkv; 7 dh = bf16(dqkv Wqkv^T) into the da buffer; 8 the LN VJP and its
// two reduces. Returns a cudaError_t as int. Inputs: x (M, C), qkv (M, 3C),
// p (BW, H, N, N), ctx (M, C), g (M, C) bf16; wqkv (C, 3C), wo (C, C)
// bf16; ln_scale, ln_bias f32. Outputs: dx (M, C) bf16; dwqkv (C, 3C),
// dbqkv (3C), dwo (C, C), dbo (C), dbias (H, N, N), dls, dlb (C) f32.
// Scratch: da, h (M, C) and dqkv (M, 3C) bf16, stats (M) float2, part f32
// (geovpr_swin_train_scratch_floats). A launch alone reads what the
// earlier launches of an earlier call left in the scratch.
extern "C" int geovpr_swin_train_bwd_all_parts(
    const void* x, const void* qkv, const void* p, const void* ctx,
    const void* g, const void* wqkv, const void* wo, const void* ln_scale,
    const void* ln_bias, void* da, void* dqkv, void* h, void* stats,
    void* part, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
    void* dbias, void* dls, void* dlb, int B, int S, int C, int H, int win,
    int shift, float eps, float scale, int first, int last, void* stream) {
  if (!train_shapes_ok(B, S, C, H, win, shift) || C > 512 || first < 0 ||
      last > 8 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* qkvb = static_cast<const bf16*>(qkv);
  bf16* dab = static_cast<bf16*>(da);
  bf16* dqkvb = static_cast<bf16*>(dqkv);
  bf16* hb = static_cast<bf16*>(h);
  float* pt = static_cast<float*>(part);
  const int parts = LN_VJP_BLOCKS * LN_VJP_WARPS;
  const HgEpilogue ep{nullptr, nullptr, nullptr, 1.f, 0, pt};
  CUtensorMap ta;
  cudaError_t e = cudaSuccess;
  int splits, chunk;
  for (int k = first; k <= last && e == cudaSuccess; ++k) {
    switch (k) {
      case 0:  // da = bf16(g Wo^T), Wo (C, C) read K-major
        if (!map_rows(&ta, gb, M, C)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_NONE, true>(ta, static_cast<const bf16*>(wo),
                                           C, C, ep, dab, M, st);
        break;
      case 1:  // dWo = ctx^T g: partials over chunks of rows, then reduced
        split_rows(M, cdiv(C, TG_BM) * cdiv(C, TG_BN), &splits, &chunk);
        if (!map_tiles64(&ta, static_cast<const bf16*>(ctx), M, C))
          return (int)cudaErrorInvalidValue;
        if ((e = launch_gemm<HG_EPI_F32, false, true>(
                 ta, gb, M, C, ep, nullptr, C, st, chunk)) == cudaSuccess)
          e = reduce(st, pt, splits, (size_t)C * C, static_cast<float*>(dwo));
        break;
      case 2:  // dbo = sum g
        e = colsum(st, gb, M, C, pt, static_cast<float*>(dbo));
        break;
      case 3:  // the attention core: dqkv, dbias
        e = core_bwd(st, qkvb, static_cast<const bf16*>(p), dab, dqkvb, pt,
                     static_cast<float*>(dbias), B, S, C, H, win, shift,
                     scale);
        break;
      case 4:  // the LN recompute
        ln_stats_kernel<<<cdiv(M, 8), 256, 0, st>>>(
            xb, static_cast<const float*>(ln_scale),
            static_cast<const float*>(ln_bias), eps, M, C, hb,
            static_cast<float2*>(stats));
        e = cudaGetLastError();
        break;
      case 5:  // dWqkv = h^T dqkv, as dWo
        split_rows(M, cdiv(C, TG_BM) * cdiv(3 * C, TG_BN), &splits, &chunk);
        if (!map_tiles64(&ta, hb, M, C)) return (int)cudaErrorInvalidValue;
        if ((e = launch_gemm<HG_EPI_F32, false, true>(
                 ta, dqkvb, M, 3 * C, ep, nullptr, C, st, chunk)) ==
            cudaSuccess)
          e = reduce(st, pt, splits, (size_t)C * 3 * C,
                     static_cast<float*>(dwqkv));
        break;
      case 6:  // dbqkv = sum dqkv
        e = colsum(st, dqkvb, M, 3 * C, pt, static_cast<float*>(dbqkv));
        break;
      case 7:  // dh = bf16(dqkv Wqkv^T) into the da buffer, Wqkv (C, 3C)
               // read K-major
        if (!map_rows(&ta, dqkvb, M, 3 * C)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_NONE, true>(ta, static_cast<const bf16*>(wqkv),
                                           3 * C, C, ep, dab, M, st);
        break;
      default:  // the LN VJP -> dx and the partials of dls, dlb
        if ((e = ln_vjp(st, xb, dab, static_cast<const float2*>(stats),
                        static_cast<const float*>(ln_scale), nullptr, M, C,
                        static_cast<bf16*>(dx), pt, pt + (size_t)parts * C)) ==
                cudaSuccess &&
            (e = reduce(st, pt, parts, C, static_cast<float*>(dls))) ==
                cudaSuccess)
          e = reduce(st, pt + (size_t)parts * C, parts, C,
                     static_cast<float*>(dlb));
    }
  }
  return (int)e;
}

// K9c, all its launches (the whole backward).
extern "C" int geovpr_swin_train_bwd_all(
    const void* x, const void* qkv, const void* p, const void* ctx,
    const void* g, const void* wqkv, const void* wo, const void* ln_scale,
    const void* ln_bias, void* da, void* dqkv, void* h, void* stats,
    void* part, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
    void* dbias, void* dls, void* dlb, int B, int S, int C, int H, int win,
    int shift, float eps, float scale, void* stream) {
  return geovpr_swin_train_bwd_all_parts(
      x, qkv, p, ctx, g, wqkv, wo, ln_scale, ln_bias, da, dqkv, h, stats,
      part, dx, dwqkv, dbqkv, dwo, dbo, dbias, dls, dlb, B, S, C, H, win,
      shift, eps, scale, 0, 8, stream);
}
