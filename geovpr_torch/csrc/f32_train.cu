// The f32 forms of the ViT attention half-block's training backward for
// Hopper (sm_90a), for a DINOv2 built with compute_dtype="float32", on the
// (B, N, D) token stream, head dim 64, from the residuals of the training
// forward K8a (in f32: K1's f32 launches in f32_serving.cu, whose qkv and
// ctx the training forward keeps):
//
//   K8b.f32 (core bwd): dqkv from the saved qkv and da = dL/dctx, with p
//                       recomputed
//   K8c.f32 (all bwd):  dy = g gamma, dbo, da = dy Wo^T, dWo, dgamma (the
//                       y = ctx Wo + bo recompute), the core, the LN
//                       recompute, dWqkv, dbqkv, dh = dqkv Wqkv^T, the LN
//                       VJP -> dx = g + dx_ln, dls, dlb
//
// Replaces, in f32, geovpr/ops/pallas_mhsa.py::_attn_bwd_pallas (:1166,
// pallas_call :1192; f32 takes the masked body _attn_bwd_kernel) and
// _mhsa_bwd_all_pallas (:1385, pallas_call :1409), whose Pallas bodies
// write x.dtype. The bf16 forms (mhsa_train.cu) are separate kernels;
// nothing here is shared with them.
//
// Numerics, as the masked bodies compute them in f32, with no rounding to
// a narrower type anywhere (JAX's rounding points, dy, da, the LN output
// and dh to x.dtype, are no-ops in f32):
// - s = (q . k) dh^-0.5 over the keys < N; p = exp(s - max) / sum, a
//   two-pass softmax over each query row's stored scores (the row max,
//   then one exponential a score, 2^((s - max) log2 e) on the SFU, and the
//   row sum), p = e times the reciprocal of the sum (one division a row);
// - dp = da v^T; ds = p (dp - sum_j dp p); dq = (ds dh^-0.5) k, dk =
//   (ds dh^-0.5)^T q, dv = p^T da;
// - products on the CUDA cores (FFMA), each output a sequential sum; no
//   TF32 (PERF.md: a single-pass TF32 product misses the f32 bound).
//
// The core (K8b.f32, and K8c.f32's launch 5) is two launches. Each streams
// its operands' 16-byte row pieces into shared memory by cp.async from
// every thread, each fill's arrival counted on an mbarrier
// (cp.async.mbarrier.arrive.noinc): the dk / dv CTA through a three-stage
// ring, two stages ahead of its products; the dq CTA through one tile,
// whose fill the products of the SM's other dq CTA overlap (a two-stage
// ring of half the keys measured slower):
//   f32_core_dq_kernel, a 32-row query tile a CTA of 4 warps (two CTAs an
//     SM, so that one's loads and row passes overlap the other's
//     products): the tile's score rows stay on chip (S and DP, 2 x 32 x N
//     floats: 67 KB at N = 257, in shared memory up to N = 280; past that
//     the CTA's own rows of the P and dS planes hold them), so that the
//     key rows stream three times for three products: S = q k^T, DP = da
//     v^T, then dq = ds k, and sum_j dp p is a row pass over S and DP
//     instead of a product. It writes p and ds dh^-0.5 to two f32 planes P
//     and dS (B H, N, N rounded up to 4).
//   f32_core_dkdv_kernel, a 64-key tile a CTA of 8 warps: the query rows'
//     P and dS columns with q and da: dv = P^T da, dk = dS^T q.
// Five N x N x dh products a head, the five the bound counts (the first
// port ran eight). The planes cost 2 x 4 B H N^2 bytes written and read
// (137 MB each way at large-14, B = 16: 41 us each way at 3.35 TB/s),
// against the two products a recompute of s and dp in the dk / dv half
// would add (65 us at the FFMA peak). The ragged tail costs its tokens: a
// warp's 8 query rows or 16 keys that lie past N are skipped, and the keys
// past the last whole 32 of a key tile (one at N = 257) are computed as
// (row, key) dot products over the CTA's threads; a dk / dv stage reads
// the tile's keys rounded up to 4. Register tiles: a lane 8 rows x 4 keys
// of S and DP, 4 x 4 of dq, 8 keys x 4 columns of dk or dv; shared rows at
// a stride of 68 floats, so that 16-byte reads of 8 rows hit distinct
// banks. A warp's 8 score rows pass at once (8 independent chains of loads
// and warp sums).
//
// K8c.f32's launches (`geovpr_vit_f32_bwd_all_parts` runs a range of them,
// for timing one by one): 0 dy, 1 dbo, 2 da, 3 dWo, 4 dgamma, 5 the core,
// 6 the LN recompute, 7 dWqkv, 8 dbqkv, 9 dh, 10 the LN VJP. Its products
// run on f32_gemm.cuh's FFMA GEMM: da = dy Wo^T and dh = dqkv Wqkv^T read
// the (in, out) weights transposed (kTW); dWo = ctx^T dy and dWqkv = h^T
// dqkv read the row-major activations as A^T (kTA), in train_gemm.cuh's
// split_rows chunks of rows (counted over the GEMM's 128 x 64 tiles)
// whose f32 partials one reduce_partials launch adds in order; dgamma
// recomputes y = ctx Wo + bo with the GY epilogue's 128-row partials. dy,
// the column sums, the LN recompute and VJP are row passes in f32. No
// atomics: a training step repeats bit for bit.
//
// The f32 Swin training backward, for a Swin built with
// compute_dtype="float32" (window 12, head dim 32, on the raster stream,
// from the residuals of K9a.f32 in f32_serving.cu: qkv and ctx in raster
// order, the normalised p (BW, H, N, N) in window order):
//
//   K9b.f32 (core bwd): dqkv and dbias from the stored p, no recompute:
//                       dp = da v^T, ds = p (dp - sum_j dp p), dbias = sum
//                       of ds over the windows, dq = (ds dh^-0.5) k, dk =
//                       (ds dh^-0.5)^T q, dv = p^T da
//   K9c.f32 (all bwd):  da = g Wo^T, dWo, dbo, the core, the LN recompute,
//                       dWqkv, dbqkv, dh = dqkv Wqkv^T, the LN VJP -> dx,
//                       dls, dlb (K8c.f32's launches without dy and dgamma:
//                       Swin has no LayerScale, and the residual stays
//                       outside)
//
// Replaces, in f32, pallas_swin_block.py::_swin_attn_bwd_pallas (:1351,
// pallas_call :1369, body _train_bwd_kernel :704) and
// _swin_attn_bwd_all_pallas (:910, pallas_call :934, body
// _train_bwd_all_kernel :783), whose bodies write x.dtype. The core is one
// launch over (window, head) CTAs (f32_swin_core_kernel: the head's q, k,
// v, da rows and its p plane in shared memory, 156 KB; the window's tokens
// addressed in the raster stream through the cyclic shift), writing ds to
// an f32 plane that a column-sum launch and its reduce add over the
// windows in a fixed order (no atomics). K9c.f32's products, column sums
// and LN passes are K8c.f32's.
//
// What bounds it on the H100: operations. At DINOv2-B/14 training shapes
// (B = 16, N = 257, D = 768, 12 heads) K8c.f32 is ~51.8 GFLOP (18 M D^2 of
// products and five N x N x dh products a head), ~0.77 ms at the CUDA
// cores' ~67 TFLOP/s; K9c.f32 at Swin-B-384's stage 0 (B = 16, C = 128, 4
// heads) is 38.7 GFLOP of products and 21.7 of the core, ~0.90 ms, and
// K9b.f32 at stage 3 2.7 GFLOP, 0.041 ms. The measured times, from
// chip_smoke.py, are in PERF.md beside the card and its power limit. The
// kernels allocate nothing; the caller passes outputs and scratch.

#include "f32_gemm.cuh"
#include "train_gemm.cuh"

namespace {

// ------------------------------------------------------------ K8b.f32 ----

constexpr int FC_DH = 64;          // head dim
constexpr int FC_LD = FC_DH + 4;   // row stride of a staged q, da, k or v
                                   // row: 8 lanes' 16-byte reads of 8
                                   // rows hit distinct banks
constexpr int FC_BQ = 32;          // query rows of a dq CTA, 8 a warp
constexpr int FC_KT = 128;         // key rows of a dq CTA's k or v tile
constexpr int FC_BK = 64;          // keys of a dk / dv CTA
constexpr int FC_QT = 32;          // query rows of a dk / dv ring stage
constexpr int FC_THREADS = 256;    // a dk / dv CTA's 8 warps
constexpr int FC_DQ_THREADS = 128;  // a dq CTA's 4 warps
constexpr int FC_KV_STAGES = 3;    // a dk / dv CTA's ring
constexpr int FC_BAR_BYTES = 64;   // the mbarriers, before the tiles
constexpr int FC_DQ_SMEM_MAX = 115712;  // two dq CTAs an SM (228 KB, 1 KB
                                        // reserved a CTA)
// the dq CTA's fixed shared memory: the barrier, q (then da) rows, a k or
// v tile; the score rows follow when they fit (f32_rows_in_smem)
constexpr int FC_DQ_FIXED =
    FC_BAR_BYTES + 4 * (FC_BQ * FC_LD + FC_KT * FC_LD);
constexpr int FC_KV_STAGE = 4 * FC_QT * FC_LD;  // P, dS, q, da rows
constexpr int FC_KV_SMEM = FC_BAR_BYTES + 4 * FC_KV_STAGES * FC_KV_STAGE;

struct CoreArgs {
  const float* qkv;  // (B*N, 3D)
  const float* da;   // (B*N, D)
  float* dqkv;       // (B*N, 3D)
  float* P;          // (B*H, N, ld): p
  float* dS;         // (B*H, N, ld): ds * dh^-0.5
  int N, D, H;
  long long ld;      // the planes' row length: N rounded up to 4
  float scale;       // dh^-0.5
};

constexpr float kFcLog2e = 1.4426950408889634f;

// v (the keys key0 .. key0 + 3 of a score row, key0 < N) with the
// components of keys past N replaced by `fill`
__device__ __forceinline__ float4 fc_mask(float4 v, int key0, int N,
                                          float fill) {
  if (key0 + 3 < N) return v;
  if (key0 + 1 >= N) v.y = fill;
  if (key0 + 2 >= N) v.z = fill;
  v.w = fill;
  return v;
}

// the max and the sum of each of R rows' lane values over the warp, the R
// butterflies in lockstep
template <int R>
__device__ __forceinline__ void fc_rows_max(float (&v)[R]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < R; ++i)
      v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
}

template <int R>
__device__ __forceinline__ void fc_rows_sum(float (&v)[R]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
}

// rows r < rows of the 64 columns at src (row stride ldm) into dst [r][e]
// at a stride of FC_LD; rows past `rows` zero
__device__ __forceinline__ void fc_stage_rows(float* dst, const float* src,
                                              long long ldm, int rows,
                                              int tid) {
  for (int idx = tid; idx < FC_BQ * FC_DH / 4; idx += FC_DQ_THREADS) {
    const int r = idx >> 4, e4 = (idx & 15) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = f32_ld4(src + r * ldm + e4);
    *reinterpret_cast<float4*>(dst + r * FC_LD + e4) = v;
  }
}

// acc[i][j] = sum_e A[i][e] B[lane + 32 j][e] in e order, i < 8, j < J: a
// warp's 8 rows of A (broadcast) against a key row a lane of B
template <int J>
__device__ __forceinline__ void fc_nt8(float (&acc)[8][4], const float* A,
                                       const float* B, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int e = 0; e < FC_DH; e += 4) {
    float4 bq[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      bq[j] = f32_ld4(B + (lane + 32 * j) * FC_LD + e);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 aq = f32_ld4(A + i * FC_LD + e);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        acc[i][j] = fmaf(aq.x, bq[j].x, acc[i][j]);
        acc[i][j] = fmaf(aq.y, bq[j].y, acc[i][j]);
        acc[i][j] = fmaf(aq.z, bq[j].z, acc[i][j]);
        acc[i][j] = fmaf(aq.w, bq[j].w, acc[i][j]);
      }
    }
  }
}

template <int J>
__device__ __forceinline__ void fc_rows8(const float* A, const float* B,
                                         float* out, long long lds, int r0,
                                         int nrows, float mul, int lane) {
  float acc[8][4];
  fc_nt8<J>(acc, A + r0 * FC_LD, B, lane);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (r0 + i >= nrows) break;
#pragma unroll
    for (int j = 0; j < J; ++j)
      out[(r0 + i) * lds + lane + 32 * j] = __fmul_rn(acc[i][j], mul);
  }
}

// out[r][c] = mul * sum_e A[r][e] B[c][e] for r < nrows, c < nk (one dq
// key tile's keys; out at the tile's first key, rows of lds): each warp
// its 8 rows by the whole 32-key columns (a lane one key of each), then the
// last nk % 32 keys (the ragged tail) by (row, key) pairs over the CTA's
// threads, so that a tail costs its tokens. Each score a sequential sum
// over e; mul = 1 is exact.
__device__ __forceinline__ void fc_scores(const float* A, const float* B,
                                          float* out, long long lds, int nk,
                                          int nrows, float mul, int tid) {
  const int lane = tid & 31, r0 = 8 * (tid >> 5);
  const int whole = nk >> 5;
  if (r0 < nrows) switch (whole) {
      case 4: fc_rows8<4>(A, B, out, lds, r0, nrows, mul, lane); break;
      case 3: fc_rows8<3>(A, B, out, lds, r0, nrows, mul, lane); break;
      case 2: fc_rows8<2>(A, B, out, lds, r0, nrows, mul, lane); break;
      case 1: fc_rows8<1>(A, B, out, lds, r0, nrows, mul, lane); break;
      default: break;
    }
  const int c0 = 32 * whole, tail = nk - c0;
  for (int p = tid; p < nrows * tail; p += FC_DQ_THREADS) {
    const int r = p / tail, c = c0 + p - r * tail;
    const float* ar = A + r * FC_LD;
    const float* br = B + c * FC_LD;
    float v = 0.f;
#pragma unroll 4
    for (int e = 0; e < FC_DH; e += 4) {
      const float4 aq = f32_ld4(ar + e), bq = f32_ld4(br + e);
      v = fmaf(aq.x, bq.x, v);
      v = fmaf(aq.y, bq.y, v);
      v = fmaf(aq.z, bq.z, v);
      v = fmaf(aq.w, bq.w, v);
    }
    out[r * lds + c] = __fmul_rn(v, mul);
  }
}

// dq of one 32-row query tile (grid (ceil(N / 32), H, B)), and its rows of
// the P and dS planes. The head's k rows, its v rows, then its k rows
// again stream through one shared tile of FC_KT key rows, which every
// thread fills by 16-byte cp.async, each fill's arrival counted on an
// mbarrier (a fill waits for the products of the last; the SM's other CTA
// computes meanwhile); the 4 warps, 8 query rows each:
//   pass 1  S = (q k^T) dh^-0.5 (q resident), the whole score rows;
//   stats   each row's max, e = exp(S - max) in place and 1 / sum e;
//   pass 2  DP = da v^T (da resident);
//   rows    D = sum_j DP e / sum e, then p = e / sum e and ds dh^-0.5 =
//           p (DP - D) dh^-0.5 to the P and dS planes and in place;
//   pass 3  dq = (ds dh^-0.5) k.
// kSmemRows: the S and DP rows in shared memory (N <= 280); else the
// CTA's own rows of the P and dS planes hold them (any N).
template <bool kSmemRows>
__global__ void __launch_bounds__(FC_DQ_THREADS, 2)
f32_core_dq_kernel(CoreArgs a) {
  extern __shared__ __align__(16) unsigned char fc_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(fc_raw);
  float* qa = reinterpret_cast<float*>(fc_raw + FC_BAR_BYTES);
  float* kt = qa + FC_BQ * FC_LD;  // the k or v tile
  const int q0 = blockIdx.x * FC_BQ, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int nrows = min(FC_BQ, N - q0);
  const long long ld3 = 3LL * a.D;
  const int col = h * FC_DH;
  const long long row0 = ((long long)b * a.H + h) * N + q0;
  float* Pp = a.P + row0 * a.ld;
  float* dSp = a.dS + row0 * a.ld;
  const long long lds = a.ld;
  float* S = kSmemRows ? kt + FC_KT * FC_LD : Pp;
  float* Dp = kSmemRows ? S + FC_BQ * lds : dSp;
  const int tiles = (N + FC_KT - 1) / FC_KT;
  const int tid = threadIdx.x;
  if (tid == 0) mbar_init(full, FC_DQ_THREADS);
  mbar_fence_init();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, r0 = 8 * warp;
  int fill = 0;
  // a pass over the head's key tiles of the k (off 1) or v (off 2) rows:
  // body(tile, first key, keys), each tile loaded once every thread is
  // past the last one's products
  auto pass = [&](int off, auto body) {
    for (int t = 0; t < tiles; ++t, ++fill) {
      const int k0 = t * FC_KT, nk = min(FC_KT, N - k0);
      const float* src =
          a.qkv + ((long long)b * N + k0) * ld3 + off * a.D + col;
      __syncthreads();
      for (int c = tid; c < nk * (FC_DH / 4); c += FC_DQ_THREADS) {
        const int r = c >> 4, e4 = (c & 15) * 4;
        cp_async16(kt + r * FC_LD + e4, src + r * ld3 + e4, 16);
      }
      cp_async_arrive(full);
      mbar_wait(full, fill & 1);
      body(k0, nk);
    }
  };

  fc_stage_rows(qa, a.qkv + ((long long)b * N + q0) * ld3 + col, ld3, nrows,
                tid);
  __syncthreads();
  pass(1, [&](int k0, int nk) {
    fc_scores(qa, kt, S + k0, lds, nk, nrows, a.scale, tid);
  });
  __syncthreads();  // every score written; q read for the last time

  // the warp's 8 rows at once (8 independent chains; a row past nrows
  // reads row nrows - 1 and writes nothing), a lane its float4s lane + 32 t
  // of each: the max, e = exp(s - max) in place (the SFU's 2^x of (s - max)
  // log2 e; 0 past N), and 1 / sum e
  const int nv = (N + 3) >> 2;
  int roff[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) roff[i] = min(r0 + i, nrows - 1) * (int)lds;
  float rl[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (r0 < nrows) {
    float m[8], l[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = -INFINITY, l[i] = 0.f;
    for (int c = lane; c < nv; c += 32)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = fc_mask(f32_ld4(S + roff[i] + 4 * c), 4 * c, N,
                                 -INFINITY);
        m[i] = fmaxf(fmaxf(m[i], fmaxf(v.x, v.y)), fmaxf(v.z, v.w));
      }
    fc_rows_max(m);
    for (int c = lane; c < nv; c += 32)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = fc_mask(f32_ld4(S + roff[i] + 4 * c), 4 * c, N,
                                 -INFINITY);
        const float4 e = make_float4(exp2_ftz((v.x - m[i]) * kFcLog2e),
                                     exp2_ftz((v.y - m[i]) * kFcLog2e),
                                     exp2_ftz((v.z - m[i]) * kFcLog2e),
                                     exp2_ftz((v.w - m[i]) * kFcLog2e));
        if (r0 + i < nrows)
          *reinterpret_cast<float4*>(S + roff[i] + 4 * c) = e;
        l[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(l[i], e.x), e.y), e.z),
                         e.w);
      }
    fc_rows_sum(l);
#pragma unroll
    for (int i = 0; i < 8; ++i) rl[i] = 1.f / l[i];
  }
  fc_stage_rows(qa, a.da + ((long long)b * N + q0) * a.D + col, a.D, nrows,
                tid);
  __syncthreads();
  pass(2, [&](int k0, int nk) {
    fc_scores(qa, kt, Dp + k0, lds, nk, nrows, 1.f, tid);
  });
  __syncthreads();  // every dp written

  // the warp's 8 rows at once: D = sum_j dp p, then p and ds dh^-0.5 to
  // the planes (0 past N), ds dh^-0.5 over dp
  if (r0 < nrows) {
    float sub[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sub[i] = 0.f;
    for (int c = lane; c < nv; c += 32)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 e = f32_ld4(S + roff[i] + 4 * c);
        const float4 d = fc_mask(f32_ld4(Dp + roff[i] + 4 * c), 4 * c, N, 0.f);
        sub[i] = fmaf(d.x, __fmul_rn(e.x, rl[i]), sub[i]);
        sub[i] = fmaf(d.y, __fmul_rn(e.y, rl[i]), sub[i]);
        sub[i] = fmaf(d.z, __fmul_rn(e.z, rl[i]), sub[i]);
        sub[i] = fmaf(d.w, __fmul_rn(e.w, rl[i]), sub[i]);
      }
    fc_rows_sum(sub);
    for (int c = lane; c < nv; c += 32)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (r0 + i >= nrows) continue;
        const float4 e = f32_ld4(S + roff[i] + 4 * c);
        const float4 d = fc_mask(f32_ld4(Dp + roff[i] + 4 * c), 4 * c, N, 0.f);
        const float rr = rl[i];
        const float4 pv = make_float4(__fmul_rn(e.x, rr), __fmul_rn(e.y, rr),
                                      __fmul_rn(e.z, rr), __fmul_rn(e.w, rr));
        const float4 dsv = make_float4(
            __fmul_rn(__fmul_rn(pv.x, d.x - sub[i]), a.scale),
            __fmul_rn(__fmul_rn(pv.y, d.y - sub[i]), a.scale),
            __fmul_rn(__fmul_rn(pv.z, d.z - sub[i]), a.scale),
            __fmul_rn(__fmul_rn(pv.w, d.w - sub[i]), a.scale));
        const long long g = (long long)(r0 + i) * a.ld + 4 * c;
        *reinterpret_cast<float4*>(Pp + g) = pv;
        *reinterpret_cast<float4*>(dSp + g) = dsv;
        *reinterpret_cast<float4*>(Dp + roff[i] + 4 * c) = dsv;
      }
  }
  __syncwarp();  // the dq product reads only this warp's rows

  // dq = (ds dh^-0.5) k: a lane rows r0 + 4 rg + i, columns 4 cg + j
  const int rg = lane >> 4, cg = lane & 15;
  const float* ar[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    ar[i] = Dp + min(r0 + 4 * rg + i, nrows - 1) * lds;
  float dq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[i][j] = 0.f;
  const bool rows_in = r0 < nrows;
  pass(1, [&](int k0, int nk) {
    if (!rows_in) return;
    int c = 0;
    for (; c + 4 <= nk; c += 4) {
      float4 av[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = f32_ld4(ar[i] + k0 + c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        kv[kk] = f32_ld4(kt + (c + kk) * FC_LD + 4 * cg);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = f4_at(av[i], kk);
          dq[i][0] = fmaf(x, kv[kk].x, dq[i][0]);
          dq[i][1] = fmaf(x, kv[kk].y, dq[i][1]);
          dq[i][2] = fmaf(x, kv[kk].z, dq[i][2]);
          dq[i][3] = fmaf(x, kv[kk].w, dq[i][3]);
        }
    }
    for (; c < nk; ++c) {
      const float4 k4 = f32_ld4(kt + c * FC_LD + 4 * cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = ar[i][k0 + c];
        dq[i][0] = fmaf(x, k4.x, dq[i][0]);
        dq[i][1] = fmaf(x, k4.y, dq[i][1]);
        dq[i][2] = fmaf(x, k4.z, dq[i][2]);
        dq[i][3] = fmaf(x, k4.w, dq[i][3]);
      }
    }
  });
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * rg + i;
    if (r < nrows)
      *reinterpret_cast<float4*>(a.dqkv + ((long long)b * N + q0 + r) * ld3 +
                                 col + 4 * cg) =
          make_float4(dq[i][0], dq[i][1], dq[i][2], dq[i][3]);
  }
}

// dv = P^T da and dk = dS^T q of one 64-key tile (grid (ceil(N / 64), H,
// B)), summed over the queries in order. 32 query rows a stage of the P
// and dS planes (the tile's keys, rounded up to 4), q and da stream
// through a three-stage ring, which every thread fills by 16-byte
// cp.async two stages ahead (an mbarrier a stage); warps 0-3 sum dv, 4-7
// dk, a lane 8 keys x 4 columns; a warp whose 16 keys lie past N skips.
__global__ void __launch_bounds__(FC_THREADS, 2)
f32_core_dkdv_kernel(CoreArgs a) {
  extern __shared__ __align__(16) unsigned char fc_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(fc_raw);
  float* ring = reinterpret_cast<float*>(fc_raw + FC_BAR_BYTES);
  const int k0 = blockIdx.x * FC_BK, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N;
  const int nk = min(FC_BK, N - k0), pc = (nk + 3) >> 2;
  const long long ld3 = 3LL * a.D;
  const int col = h * FC_DH;
  const long long plane0 = ((long long)b * a.H + h) * N;
  const int stages = (N + FC_QT - 1) / FC_QT;
  const int tid = threadIdx.x;
  if (tid < FC_KV_STAGES) mbar_init(&full[tid], FC_THREADS);
  mbar_fence_init();
  __syncthreads();

  // stage t: query rows < N, the planes' pc float4s of the tile's keys
  auto load = [&](int t) {
    const int q0 = t * FC_QT, nq = min(FC_QT, N - q0);
    float* st = ring + (t % FC_KV_STAGES) * FC_KV_STAGE;
    for (int c = tid; c < nq * pc; c += FC_THREADS) {
      const int r = c / pc, e4 = (c - r * pc) * 4;
      const long long pr = (plane0 + q0 + r) * a.ld + k0 + e4;
      cp_async16(st + r * FC_LD + e4, a.P + pr, 16);
      cp_async16(st + (FC_QT + r) * FC_LD + e4, a.dS + pr, 16);
    }
    for (int c = tid; c < nq * (FC_DH / 4); c += FC_THREADS) {
      const int r = c >> 4, e4 = (c & 15) * 4;
      const long long tok = (long long)b * N + q0 + r;
      cp_async16(st + (2 * FC_QT + r) * FC_LD + e4,
                 a.qkv + tok * ld3 + col + e4, 16);
      cp_async16(st + (3 * FC_QT + r) * FC_LD + e4,
                 a.da + tok * a.D + col + e4, 16);
    }
    cp_async_arrive(&full[t % FC_KV_STAGES]);
  };
  for (int t = 0; t < FC_KV_STAGES - 1 && t < stages; ++t) load(t);

  const int warp = tid >> 5, lane = tid & 31;
  const int grp = warp >> 2, wk = 16 * (warp & 3);  // 0 dv, 1 dk; keys
  const int kg = 4 * (lane >> 4), cg = 4 * (lane & 15);
  const bool keys_in = wk < nk;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < stages; ++t) {
    const int s = t % FC_KV_STAGES;
    const int nq = min(FC_QT, N - t * FC_QT);
    mbar_wait(&full[s], (t / FC_KV_STAGES) & 1);
    __syncthreads();  // every thread is past stage t - 1: refill it
    if (t + FC_KV_STAGES - 1 < stages) load(t + FC_KV_STAGES - 1);
    if (keys_in) {
      const float* st = ring + s * FC_KV_STAGE;
      const float* A = st + grp * FC_QT * FC_LD + wk + kg;  // P or dS
      const float* Bm = st + (3 - grp) * FC_QT * FC_LD + cg;  // da or q
      for (int q = 0; q < nq; ++q) {
        const float4 a0 = f32_ld4(A + q * FC_LD);
        const float4 a1 = f32_ld4(A + q * FC_LD + 8);
        const float4 bq = f32_ld4(Bm + q * FC_LD);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(av[i], bq.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], bq.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], bq.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], bq.w, acc[i][3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + wk + kg + (i < 4 ? i : 4 + i);
    if (key >= N) continue;
    *reinterpret_cast<float4*>(a.dqkv + ((long long)b * N + key) * ld3 +
                               (2 - grp) * a.D + col + cg) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ------------------------------------------------------ K8c.f32 rows ----

// out = x * mul[col] over an (M, C) f32 matrix
__global__ void f32_scale_cols_kernel(const float* __restrict__ x,
                                      const float* __restrict__ mul,
                                      size_t n, int C,
                                      float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __fmul_rn(x[i], mul[i % C]);
}

// part[z][c] = sum over rows [z * rchunk, (z + 1) * rchunk) of x[row][c],
// each term times mul[c] where mul is given
__global__ void f32_colsum_partials_kernel(const float* __restrict__ x,
                                           int M, int C, int rchunk,
                                           float* __restrict__ part,
                                           const float* __restrict__ mul) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int r1 = min(M, (blockIdx.y + 1) * rchunk);
  const float mc = mul ? mul[c] : 1.f;
  float s = 0.f;
  for (int r = blockIdx.y * rchunk; r < r1; ++r) {
    const float v = x[(size_t)r * C + c];
    s = __fadd_rn(s, mul ? __fmul_rn(v, mc) : v);
  }
  part[(size_t)blockIdx.y * C + c] = s;
}

// column sums of an f32 (M, C) matrix into out (C) through part
// (colsum_parts(M, C) * C), each term times mul[c] where mul is given
cudaError_t f32_colsum(cudaStream_t st, const float* x, int M, int C,
                       float* part, float* out, const float* mul = nullptr) {
  int S, chunk;
  split_rows(M, cdiv(C, 128), &S, &chunk);
  f32_colsum_partials_kernel<<<dim3(cdiv(C, 128), S), 128, 0, st>>>(
      x, M, C, chunk, part, mul);
  cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : reduce(st, part, S, C, out);
}

// the LN recompute, one warp a row: two-pass f32 statistics, h = xhat ls +
// lb and each row's (mean, 1/std)
__global__ void f32_ln_stats_kernel(const float* __restrict__ x,
                                    const float* __restrict__ ls,
                                    const float* __restrict__ lb, float eps,
                                    int M, int C, float* __restrict__ h,
                                    float2* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const float* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += xr[c];
  const float mu = f32_warp_sum(s) / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = xr[c] - mu;
    q = fmaf(d, d, q);
  }
  const float rstd = 1.f / sqrtf(f32_warp_sum(q) / C + eps);
  for (int c = lane; c < C; c += 32)
    h[(size_t)row * C + c] =
        __fadd_rn(__fmul_rn(__fmul_rn(xr[c] - mu, rstd), ls[c]), lb[c]);
  if (lane == 0) stats[row] = make_float2(mu, rstd);
}

// The LN VJP, one warp a row, CPL = C / 32 columns a lane: dx = rstd (dh
// ls - mean(dh ls) - xhat mean(dh ls xhat)), + g with kG (K8c; Swin's K9c
// has no residual inside), and the warp's partial sums of dh xhat (dls)
// and dh (dlb) over its rows at row blockIdx.x * warps + warp of part_ls /
// part_lb.
template <int CPL, bool kG>
__global__ void __launch_bounds__(256)
f32_ln_vjp_kernel(const float* __restrict__ x, const float* __restrict__ dh,
                  const float2* __restrict__ stats,
                  const float* __restrict__ ls, const float* __restrict__ g,
                  int M, float* __restrict__ dx, float* __restrict__ part_ls,
                  float* __restrict__ part_lb) {
  constexpr int C = CPL * 32;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int wid = blockIdx.x * warps + (threadIdx.x >> 5);
  float acc_ls[CPL], acc_lb[CPL], lsv[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    acc_ls[i] = 0.f;
    acc_lb[i] = 0.f;
    lsv[i] = ls[lane + 32 * i];
  }
  for (int row = wid; row < M; row += gridDim.x * warps) {
    const float2 st = stats[row];
    float xh[CPL], dxh[CPL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const size_t o = (size_t)row * C + lane + 32 * i;
      xh[i] = __fmul_rn(x[o] - st.x, st.y);
      const float d = dh[o];
      acc_ls[i] = fmaf(d, xh[i], acc_ls[i]);
      acc_lb[i] += d;
      dxh[i] = __fmul_rn(d, lsv[i]);
      s1 += dxh[i];
      s2 = fmaf(dxh[i], xh[i], s2);
    }
    const float m1 = f32_warp_sum(s1) / C;
    const float m2 = f32_warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const size_t o = (size_t)row * C + lane + 32 * i;
      const float v = __fmul_rn(st.y, dxh[i] - m1 - __fmul_rn(xh[i], m2));
      dx[o] = kG ? __fadd_rn(v, g[o]) : v;
    }
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    part_ls[(size_t)wid * C + lane + 32 * i] = acc_ls[i];
    part_lb[(size_t)wid * C + lane + 32 * i] = acc_lb[i];
  }
}

// the LN VJP of every row; g null: no residual (K9c)
cudaError_t f32_ln_vjp(cudaStream_t st, const float* x, const float* dh,
                       const float2* stats, const float* ls, const float* g,
                       int M, int C, float* dx, float* part_ls,
                       float* part_lb) {
  switch (C / 32) {
#define GEOVPR_F32_LN_VJP(cpl)                                              \
  case cpl:                                                                 \
    if (g)                                                                  \
      f32_ln_vjp_kernel<cpl, true>                                          \
          <<<LN_VJP_BLOCKS, LN_VJP_WARPS * 32, 0, st>>>(                    \
              x, dh, stats, ls, g, M, dx, part_ls, part_lb);                \
    else                                                                    \
      f32_ln_vjp_kernel<cpl, false>                                         \
          <<<LN_VJP_BLOCKS, LN_VJP_WARPS * 32, 0, st>>>(                    \
              x, dh, stats, ls, g, M, dx, part_ls, part_lb);                \
    break;
    GEOVPR_F32_LN_VJP(2) GEOVPR_F32_LN_VJP(4) GEOVPR_F32_LN_VJP(6)
    GEOVPR_F32_LN_VJP(8) GEOVPR_F32_LN_VJP(10) GEOVPR_F32_LN_VJP(12)
    GEOVPR_F32_LN_VJP(14) GEOVPR_F32_LN_VJP(16) GEOVPR_F32_LN_VJP(18)
    GEOVPR_F32_LN_VJP(20) GEOVPR_F32_LN_VJP(22) GEOVPR_F32_LN_VJP(24)
    GEOVPR_F32_LN_VJP(26)
#undef GEOVPR_F32_LN_VJP
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}


// ------------------------------------------------------------ K9b.f32 ----

constexpr int SC_N = 144;          // a window's tokens (window 12)
constexpr int SC_DH = 32;          // head dim
constexpr int SC_THREADS = 576;  // 18 warps: 8 query rows a warp
constexpr int SC_VLD = SC_DH + 4;  // v's row stride: float4 rows whose
                                   // quarter-warp reads are conflict-free
constexpr int SC_SMEM =
    4 * (SC_N * SC_N + 3 * SC_N * SC_DH + SC_N * SC_VLD + SC_N);

struct SwinCoreArgs {
  const float* qkv;  // (B*S*S, 3C), raster rows
  const float* p;    // (BW, H, N, N), window order
  const float* da;   // (B*S*S, C), raster rows
  float* dqkv;       // (B*S*S, 3C), raster rows
  float* ds;         // (BW, H, N, N): ds (not scaled), for dbias
  int S, W, shift, C, H;
  float scale;       // dh^-0.5
};

// the raster row of token i of window gw, in the frame rolled by -shift:
// token (ty, tx) of window (wy, wx) is ((Y + shift) mod S, (X + shift) mod
// S), as the forward's raster windows address it
__device__ __forceinline__ int sc_row(const SwinCoreArgs& a, int gw, int i) {
  const int nw = a.S / a.W;
  const int b = gw / (nw * nw), wi = gw - b * nw * nw;
  const int wy = wi / nw, wx = wi - wy * nw;
  const int ty = i / a.W, tx = i - ty * a.W;
  int ry = wy * a.W + ty + a.shift, rx = wx * a.W + tx + a.shift;
  if (ry >= a.S) ry -= a.S;
  if (rx >= a.S) rx -= a.S;
  return (b * a.S + ry) * a.S + rx;
}

__device__ __forceinline__ void sc_outer(float (&acc)[4][4], float4 a4,
                                         float4 b4) {
  const float a[4] = {a4.x, a4.y, a4.z, a4.w};
  const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

__device__ __forceinline__ void sc_store(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// The core backward of one (window, head), grid (BW, H): the head's q, k,
// v and da rows of the window and its p plane in shared memory; dv = p^T
// da; then, a warp a query row, dp = da v^T, ds = p (dp - sum_j dp p)
// (stored to the ds plane, and ds dh^-0.5 over p in shared memory); then
// dq = (ds dh^-0.5) k and dk = (ds dh^-0.5)^T q. Each output a sequential
// sum over its k index, 4 x 4 outputs a thread.
__global__ void __launch_bounds__(SC_THREADS)
f32_swin_core_kernel(SwinCoreArgs a) {
  extern __shared__ __align__(16) float sc_smem[];
  float* P = sc_smem;                  // [N][N]: p, then ds dh^-0.5
  float* qs = P + SC_N * SC_N;         // [N][DH]
  float* ks = qs + SC_N * SC_DH;       // [N][DH]
  float* das = ks + SC_N * SC_DH;      // [N][DH]
  float* vs = das + SC_N * SC_DH;      // [N][VLD]
  int* rows = reinterpret_cast<int*>(vs + SC_N * SC_VLD);
  const int gw = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int C = a.C;
  const long long ld3 = 3LL * C;
  const int col = h * SC_DH;
  const long long plane = ((long long)gw * a.H + h) * SC_N * SC_N;
  for (int i = tid; i < SC_N; i += SC_THREADS) rows[i] = sc_row(a, gw, i);
  __syncthreads();
  for (int idx = tid; idx < SC_N * SC_DH / 4; idx += SC_THREADS) {
    const int i = idx / (SC_DH / 4), c4 = (idx % (SC_DH / 4)) * 4;
    const float* src = a.qkv + (long long)rows[i] * ld3 + col + c4;
    *reinterpret_cast<float4*>(qs + i * SC_DH + c4) = f32_ld4(src);
    *reinterpret_cast<float4*>(ks + i * SC_DH + c4) = f32_ld4(src + C);
    *reinterpret_cast<float4*>(vs + i * SC_VLD + c4) = f32_ld4(src + 2 * C);
    *reinterpret_cast<float4*>(das + i * SC_DH + c4) =
        f32_ld4(a.da + (long long)rows[i] * C + col + c4);
  }
  for (int idx = tid; idx < SC_N * SC_N / 4; idx += SC_THREADS)
    *reinterpret_cast<float4*>(P + 4 * idx) = f32_ld4(a.p + plane + 4 * idx);
  __syncthreads();

  // dv = p^T da: a thread 4 keys x 4 columns, summed over the query rows
  constexpr int kItems = (SC_N / 4) * (SC_DH / 4);
  for (int it = tid; it < kItems; it += SC_THREADS) {
    const int j0 = (it / (SC_DH / 4)) * 4, d0 = (it % (SC_DH / 4)) * 4;
    float acc[4][4] = {};
    for (int i = 0; i < SC_N; ++i)
      sc_outer(acc, f32_ld4(P + i * SC_N + j0), f32_ld4(das + i * SC_DH + d0));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      sc_store(a.dqkv + (long long)rows[j0 + jj] * ld3 + 2 * C + col + d0,
               acc[jj]);
  }
  __syncthreads();

  // a warp a query row: dp, the row's sum of dp p, ds; a lane the keys
  // lane + 32 t
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kT = (SC_N + 31) / 32;
  for (int i = warp; i < SC_N; i += SC_THREADS / 32) {
    float4 dr[SC_DH / 4];
#pragma unroll
    for (int e = 0; e < SC_DH / 4; ++e) dr[e] = f32_ld4(das + i * SC_DH + 4 * e);
    float dp[kT], pr[kT];
    float sub = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int j = lane + 32 * t;
      dp[t] = pr[t] = 0.f;
      if (j >= SC_N) continue;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < SC_DH / 4; ++e) {
        const float4 v4 = f32_ld4(vs + j * SC_VLD + 4 * e);
        d = fmaf(dr[e].x, v4.x, d);
        d = fmaf(dr[e].y, v4.y, d);
        d = fmaf(dr[e].z, v4.z, d);
        d = fmaf(dr[e].w, v4.w, d);
      }
      dp[t] = d;
      pr[t] = P[i * SC_N + j];
      sub = fmaf(d, pr[t], sub);
    }
    sub = f32_warp_sum(sub);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int j = lane + 32 * t;
      if (j >= SC_N) continue;
      const float dsv = __fmul_rn(pr[t], dp[t] - sub);
      a.ds[plane + i * SC_N + j] = dsv;
      P[i * SC_N + j] = __fmul_rn(dsv, a.scale);
    }
  }
  __syncthreads();

  // dq = dsb k (4 query rows x 4 columns) and dk = dsb^T q (4 keys x 4
  // columns), dsb = ds dh^-0.5
  for (int it = tid; it < 2 * kItems; it += SC_THREADS) {
    const bool is_dk = it >= kItems;
    const int w = is_dk ? it - kItems : it;
    const int r0 = (w / (SC_DH / 4)) * 4, d0 = (w % (SC_DH / 4)) * 4;
    float acc[4][4] = {};
    if (is_dk) {
      for (int i = 0; i < SC_N; ++i)
        sc_outer(acc, f32_ld4(P + i * SC_N + r0), f32_ld4(qs + i * SC_DH + d0));
    } else {
      for (int j = 0; j < SC_N; j += 4) {
        float4 ar[4], bk[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ar[r] = f32_ld4(P + (r0 + r) * SC_N + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          bk[jj] = f32_ld4(ks + (j + jj) * SC_DH + d0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float av[4] = {ar[r].x, ar[r].y, ar[r].z, ar[r].w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            acc[r][0] = fmaf(av[jj], bk[jj].x, acc[r][0]);
            acc[r][1] = fmaf(av[jj], bk[jj].y, acc[r][1]);
            acc[r][2] = fmaf(av[jj], bk[jj].z, acc[r][2]);
            acc[r][3] = fmaf(av[jj], bk[jj].w, acc[r][3]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      sc_store(a.dqkv + (long long)rows[r0 + r] * ld3 + (is_dk ? C : 0) + col +
                   d0,
               acc[r]);
  }
}


// ---------------------------------------------------------------- host ----

bool f32_vit_shapes_ok(int B, int N, int D, int H) {
  return B > 0 && N > 0 && H > 0 && B <= 65535 && H <= 65535 &&
         D == H * FC_DH && (long long)B * N <= 0x7fffffff;
}

// the P and dS planes' row length: N rounded up to 4 (16-byte rows of
// whole float4s, which the dk / dv ring's cp.async copies read)
long long f32_plane_ld(int N) { return (N + 3) / 4 * 4; }

long long f32_core_scratch_floats(int B, int N, int H) {
  return 2LL * B * H * N * f32_plane_ld(N);
}

// the dq CTA's shared memory with its S and DP rows in it
long long f32_dq_smem_rows(int N) {
  return FC_DQ_FIXED + 2LL * 4 * FC_BQ * f32_plane_ld(N);
}

// whether the dq CTA's score rows fit its shared memory (N <= 280)
bool f32_rows_in_smem(int N) { return f32_dq_smem_rows(N) <= FC_DQ_SMEM_MAX; }

cudaError_t f32_core_bwd(cudaStream_t st, const float* qkv, const float* da,
                         float* dqkv, float* pds, int B, int N, int D, int H,
                         float scale) {
  CoreArgs a{};
  a.qkv = qkv;
  a.da = da;
  a.dqkv = dqkv;
  a.ld = f32_plane_ld(N);
  a.P = pds;
  a.dS = pds + (size_t)B * H * N * a.ld;
  a.N = N;
  a.D = D;
  a.H = H;
  a.scale = scale;
  const dim3 dq_grid(cdiv(N, FC_BQ), H, B), kv_grid(cdiv(N, FC_BK), H, B);
  if (f32_rows_in_smem(N))
    f32_core_dq_kernel<true>
        <<<dq_grid, FC_DQ_THREADS, f32_dq_smem_rows(N), st>>>(a);
  else
    f32_core_dq_kernel<false>
        <<<dq_grid, FC_DQ_THREADS, FC_DQ_FIXED, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  f32_core_dkdv_kernel<<<kv_grid, FC_THREADS, FC_KV_SMEM, st>>>(a);
  return cudaGetLastError();
}

// the split of a weight gradient's M rows into chunks (split_rows over the
// f32 GEMM's 128 x 64 tiles of its (rows, cols) output)
void f32_wgrad_split(int M, int rows, int cols, int* S, int* chunk) {
  split_rows(M, cdiv(rows, GB_M) * cdiv(cols, GB_N), S, chunk);
}

// f32 scratch K8c.f32 needs (the largest partial-sum buffer of its launches)
long long f32_bwd_scratch_floats(int M, int D) {
  int s1, c1, s3, c3;
  f32_wgrad_split(M, D, D, &s1, &c1);
  f32_wgrad_split(M, D, 3 * D, &s3, &c3);
  long long need = (long long)s1 * D * D;
  need = std::max(need, (long long)s3 * D * 3 * D);
  need = std::max(need, (long long)cdiv(M, GB_M) * D);
  need = std::max(need, (long long)colsum_parts(M, 3 * D) * 3 * D);
  need = std::max(need, (long long)colsum_parts(M, D) * D);
  need = std::max(need, 2LL * LN_VJP_BLOCKS * LN_VJP_WARPS * D);
  return need;
}


// K9 on f32: the window geometry the core takes (window 12, head dim 32)
bool swin_f32_shapes_ok(int B, int S, int C, int H, int win, int shift) {
  return B > 0 && H > 0 && H <= 65535 && C == H * SC_DH && win * win == SC_N &&
         S > 0 && S % win == 0 && shift >= 0 && shift < win &&
         (long long)B * S * S <= 0x7fffffff;
}

// the core's scratch: the ds plane, then the partial sums of its column
// sums over the windows
long long swin_f32_core_floats(int B, int S, int H, int win) {
  const int bw = B * (S / win) * (S / win);
  const int hnn = H * SC_N * SC_N;
  return (long long)bw * hnn + (long long)colsum_parts(bw, hnn) * hnn;
}

// K9b.f32: dqkv and dbias (the ds plane summed over the windows in a fixed
// order: partials, then one reduce)
cudaError_t swin_f32_core_bwd(cudaStream_t st, const float* qkv,
                              const float* p, const float* da, float* dqkv,
                              float* part, float* dbias, int B, int S, int C,
                              int H, int win, int shift, float scale) {
  SwinCoreArgs a{};
  a.qkv = qkv;
  a.p = p;
  a.da = da;
  a.dqkv = dqkv;
  a.ds = part;
  a.S = S;
  a.W = win;
  a.shift = shift;
  a.C = C;
  a.H = H;
  a.scale = scale;
  const int bw = B * (S / win) * (S / win);
  f32_swin_core_kernel<<<dim3(bw, H), SC_THREADS, SC_SMEM, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int hnn = H * SC_N * SC_N;
  return f32_colsum(st, part, bw, hnn, part + (size_t)bw * hnn, dbias);
}

// f32 scratch K9b.f32 and K9c.f32 take as `part`: the core's, or the
// largest partial-sum buffer of K9c's other launches
long long swin_f32_scratch_floats(int B, int S, int C, int H, int win) {
  const int M = B * S * S;
  int s1, c1, s3, c3;
  f32_wgrad_split(M, C, C, &s1, &c1);
  f32_wgrad_split(M, C, 3 * C, &s3, &c3);
  long long need = swin_f32_core_floats(B, S, H, win);
  need = std::max(need, (long long)s1 * C * C);
  need = std::max(need, (long long)s3 * C * 3 * C);
  need = std::max(need, (long long)colsum_parts(M, 3 * C) * 3 * C);
  need = std::max(need, (long long)colsum_parts(M, C) * C);
  need = std::max(need, 2LL * LN_VJP_BLOCKS * LN_VJP_WARPS * C);
  return need;
}

}  // namespace

// Raises the core's dynamic shared-memory limits on the current device;
// returns a cudaError_t as int.
extern "C" int geovpr_f32_train_init(void) {
  cudaError_t e = allow_smem(f32_core_dq_kernel<true>, FC_DQ_SMEM_MAX);
  if (e == cudaSuccess) e = allow_smem(f32_core_dq_kernel<false>, FC_DQ_FIXED);
  if (e == cudaSuccess) e = allow_smem(f32_core_dkdv_kernel, FC_KV_SMEM);
  return (int)e;
}

// Floats of f32 scratch geovpr_vit_f32_bwd_all takes as `part`.
extern "C" long long geovpr_vit_f32_scratch_floats(int B, int N, int D) {
  return f32_bwd_scratch_floats(B * N, D);
}

// Floats of the core's scratch (geovpr_vit_f32_bwd_core's pds): the P and
// dS planes.
extern "C" long long geovpr_vit_f32_core_scratch_floats(int B, int N, int H) {
  return f32_core_scratch_floats(B, N, H);
}

// K8b.f32. qkv (B*N, 3D), da (B*N, D) f32 -> dqkv (B*N, 3D) f32; scratch
// pds (geovpr_vit_f32_core_scratch_floats f32), all 16-byte aligned.
// scale = dh^-0.5. geovpr_f32_train_init must have run on the current
// device.
extern "C" int geovpr_vit_f32_bwd_core(const void* qkv, const void* da,
                                       void* dqkv, void* pds, int B, int N,
                                       int D, int H, float scale,
                                       void* stream) {
  if (!f32_vit_shapes_ok(B, N, D, H)) return (int)cudaErrorInvalidValue;
  return (int)f32_core_bwd(static_cast<cudaStream_t>(stream),
                           static_cast<const float*>(qkv),
                           static_cast<const float*>(da),
                           static_cast<float*>(dqkv), static_cast<float*>(pds),
                           B, N, D, H, scale);
}

// K8c.f32's launches first..last: 0 dy = g gamma; 1 dbo = sum g gamma; 2
// da = dy Wo^T; 3 dWo = ctx^T dy (and its reduce); 4 dgamma = sum g (ctx
// Wo + bo) (and its reduce); 5 the attention core; 6 the LN recompute; 7
// dWqkv = h^T dqkv (and its reduce); 8 dbqkv = sum dqkv; 9 dh = dqkv
// Wqkv^T into the da buffer; 10 the LN VJP with + g and its two reduces.
// Returns a cudaError_t as int. The arguments are geovpr_vit_train_bwd_
// all_parts' (mhsa_train.cu), every tensor f32: inputs x, ctx, g (B*N, D),
// qkv (B*N, 3D), wqkv (D, 3D), wo (D, D), bo, gamma, ln_scale, ln_bias;
// outputs dx (B*N, D), dwqkv, dbqkv, dwo, dbo, dgamma, dls, dlb; scratch
// dy, da, h (B*N, D), dqkv (B*N, 3D), stats (B*N) float2, pds
// (geovpr_vit_f32_core_scratch_floats), part
// (geovpr_vit_f32_scratch_floats); all 16-byte aligned. A launch alone
// reads what the earlier launches of an earlier call left in the scratch.
// D <= 832 (the LN VJP's columns per lane). geovpr_f32_train_init must have
// run on the current device.
extern "C" int geovpr_vit_f32_bwd_all_parts(
    const void* x, const void* qkv, const void* ctx, const void* g,
    const void* wqkv, const void* wo, const void* bo, const void* gamma,
    const void* ln_scale, const void* ln_bias, void* dy, void* da, void* dqkv,
    void* h, void* stats, void* pds, void* part, void* dx, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* dgamma, void* dls, void* dlb,
    int B, int N, int D, int H, float eps, float scale, int first, int last,
    void* stream) {
  if (!f32_vit_shapes_ok(B, N, D, H) || D > 832 || first < 0 || last > 10 ||
      first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  const float* ctxf = static_cast<const float*>(ctx);
  const float* wof = static_cast<const float*>(wo);
  float* dyf = static_cast<float*>(dy);
  float* daf = static_cast<float*>(da);
  float* dqkvf = static_cast<float*>(dqkv);
  float* hf = static_cast<float*>(h);
  float* pt = static_cast<float*>(part);
  const int parts = LN_VJP_BLOCKS * LN_VJP_WARPS;
  const size_t n = (size_t)M * D;
  cudaError_t e = cudaSuccess;
  int S1, c1;
  for (int k = first; k <= last && e == cudaSuccess; ++k) {
    switch (k) {
      case 0:  // dy = g gamma
        f32_scale_cols_kernel<<<std::min(cdiv(n, 256), 4096), 256, 0, st>>>(
            gf, static_cast<const float*>(gamma), n, D, dyf);
        e = cudaGetLastError();
        break;
      case 1:  // dbo = sum g gamma
        e = f32_colsum(st, gf, M, D, pt, static_cast<float*>(dbo),
                       static_cast<const float*>(gamma));
        break;
      case 2:  // da = dy Wo^T, Wo (D, D) read transposed
        e = launch_gemm_f32<EPI_NONE, false, true>(dyf, wof, nullptr, nullptr,
                                                   nullptr, daf, M, D, D, st);
        break;
      case 3:  // dWo = ctx^T dy: partials over chunks of rows, then reduced
        f32_wgrad_split(M, D, D, &S1, &c1);
        if ((e = launch_gemm_f32<EPI_NONE, true>(ctxf, dyf, nullptr, nullptr,
                                                 nullptr, pt, D, D, M, st,
                                                 c1)) == cudaSuccess)
          e = reduce(st, pt, S1, (size_t)D * D, static_cast<float*>(dwo));
        break;
      case 4:  // dgamma = sum g (ctx Wo + bo), 128-row partials, reduced
        if ((e = launch_gemm_f32<EPI_GY>(
                 ctxf, wof, static_cast<const float*>(bo), nullptr, gf, pt, M,
                 D, D, st)) == cudaSuccess)
          e = reduce(st, pt, cdiv(M, GB_M), D, static_cast<float*>(dgamma));
        break;
      case 5:  // the attention core: dqkv
        e = f32_core_bwd(st, static_cast<const float*>(qkv), daf, dqkvf,
                         static_cast<float*>(pds), B, N, D, H, scale);
        break;
      case 6:  // the LN recompute
        f32_ln_stats_kernel<<<cdiv(M, 8), 256, 0, st>>>(
            xf, static_cast<const float*>(ln_scale),
            static_cast<const float*>(ln_bias), eps, M, D, hf,
            static_cast<float2*>(stats));
        e = cudaGetLastError();
        break;
      case 7:  // dWqkv = h^T dqkv, as dWo
        f32_wgrad_split(M, D, 3 * D, &S1, &c1);
        if ((e = launch_gemm_f32<EPI_NONE, true>(hf, dqkvf, nullptr, nullptr,
                                                 nullptr, pt, D, 3 * D, M, st,
                                                 c1)) == cudaSuccess)
          e = reduce(st, pt, S1, (size_t)D * 3 * D,
                     static_cast<float*>(dwqkv));
        break;
      case 8:  // dbqkv = sum dqkv
        e = f32_colsum(st, dqkvf, M, 3 * D, pt, static_cast<float*>(dbqkv));
        break;
      case 9:  // dh = dqkv Wqkv^T into the da buffer, Wqkv (D, 3D) read
               // transposed
        e = launch_gemm_f32<EPI_NONE, false, true>(
            dqkvf, static_cast<const float*>(wqkv), nullptr, nullptr, nullptr,
            daf, M, D, 3 * D, st);
        break;
      default:  // the LN VJP with + g, and the partials of dls, dlb
        if ((e = f32_ln_vjp(st, xf, daf, static_cast<const float2*>(stats),
                            static_cast<const float*>(ln_scale), gf, M, D,
                            static_cast<float*>(dx), pt,
                            pt + (size_t)parts * D)) == cudaSuccess &&
            (e = reduce(st, pt, parts, D, static_cast<float*>(dls))) ==
                cudaSuccess)
          e = reduce(st, pt + (size_t)parts * D, parts, D,
                     static_cast<float*>(dlb));
    }
  }
  return (int)e;
}

// K8c.f32, all its launches (the whole backward).
extern "C" int geovpr_vit_f32_bwd_all(
    const void* x, const void* qkv, const void* ctx, const void* g,
    const void* wqkv, const void* wo, const void* bo, const void* gamma,
    const void* ln_scale, const void* ln_bias, void* dy, void* da, void* dqkv,
    void* h, void* stats, void* pds, void* part, void* dx, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* dgamma, void* dls, void* dlb,
    int B, int N, int D, int H, float eps, float scale, void* stream) {
  return geovpr_vit_f32_bwd_all_parts(
      x, qkv, ctx, g, wqkv, wo, bo, gamma, ln_scale, ln_bias, dy, da, dqkv, h,
      stats, pds, part, dx, dwqkv, dbqkv, dwo, dbo, dgamma, dls, dlb, B, N,
      D, H, eps, scale, 0, 10, stream);
}

extern "C" int geovpr_f32_serving_init(void);

// K9's f32 forms: raises the dynamic shared-memory limits of K9a.f32's
// window attention (geovpr_f32_serving_init, f32_serving.cu) and of the
// K9b.f32 core on the current device; returns a cudaError_t as int.
extern "C" int geovpr_f32_swin_train_init(void) {
  const int e = geovpr_f32_serving_init();
  if (e != 0) return e;
  return (int)allow_smem(f32_swin_core_kernel, SC_SMEM);
}

// Floats of f32 scratch geovpr_swin_f32_bwd_core and geovpr_swin_f32_bwd_all
// take as `part`.
extern "C" long long geovpr_swin_f32_scratch_floats(int B, int S, int C,
                                                    int H, int win) {
  return swin_f32_scratch_floats(B, S, C, H, win);
}

// K9b.f32. qkv (M, 3C) and da (M, C) raster rows, p (BW, H, N, N) window
// order, all f32 -> dqkv (M, 3C) raster rows and dbias (H, N, N); scratch
// part (geovpr_swin_f32_scratch_floats). M = B S^2, window 12, C = 32 H;
// all 16-byte aligned. scale = dh^-0.5. geovpr_f32_swin_train_init must
// have run on the current device.
extern "C" int geovpr_swin_f32_bwd_core(
    const void* qkv, const void* p, const void* da, void* dqkv, void* part,
    void* dbias, int B, int S, int C, int H, int win, int shift, float scale,
    void* stream) {
  if (!swin_f32_shapes_ok(B, S, C, H, win, shift))
    return (int)cudaErrorInvalidValue;
  return (int)swin_f32_core_bwd(
      static_cast<cudaStream_t>(stream), static_cast<const float*>(qkv),
      static_cast<const float*>(p), static_cast<const float*>(da),
      static_cast<float*>(dqkv), static_cast<float*>(part),
      static_cast<float*>(dbias), B, S, C, H, win, shift, scale);
}

// K9c.f32's launches first..last: 0 da = g Wo^T; 1 dWo = ctx^T g (and its
// reduce); 2 dbo = sum g; 3 the core (K9b.f32: dqkv, dbias); 4 the LN
// recompute (h, stats); 5 dWqkv = h^T dqkv (and its reduce); 6 dbqkv = sum
// dqkv; 7 dh = dqkv Wqkv^T into the da buffer; 8 the LN VJP -> dx and the
// reduces of dls, dlb. The arguments are geovpr_swin_train_bwd_all_parts'
// (swin_train.cu), every tensor f32: x, ctx, g (M, C) and qkv (M, 3C)
// raster rows, p (BW, H, N, N), wqkv (C, 3C), wo (C, C), ln_scale,
// ln_bias; outputs dx (M, C), dwqkv, dbqkv, dwo, dbo, dbias, dls, dlb;
// scratch da, h (M, C), dqkv (M, 3C), stats (M) float2, part
// (geovpr_swin_f32_scratch_floats); all 16-byte aligned. C <= 512. A
// launch alone reads what the earlier launches of an earlier call left in
// the scratch. geovpr_f32_swin_train_init must have run on the current
// device.
extern "C" int geovpr_swin_f32_bwd_all_parts(
    const void* x, const void* qkv, const void* p, const void* ctx,
    const void* g, const void* wqkv, const void* wo, const void* ln_scale,
    const void* ln_bias, void* da, void* dqkv, void* h, void* stats,
    void* part, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
    void* dbias, void* dls, void* dlb, int B, int S, int C, int H, int win,
    int shift, float eps, float scale, int first, int last, void* stream) {
  if (!swin_f32_shapes_ok(B, S, C, H, win, shift) || C > 512 || first < 0 ||
      last > 8 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  float* daf = static_cast<float*>(da);
  float* dqkvf = static_cast<float*>(dqkv);
  float* hf = static_cast<float*>(h);
  float* pt = static_cast<float*>(part);
  const int parts = LN_VJP_BLOCKS * LN_VJP_WARPS;
  cudaError_t e = cudaSuccess;
  int S1, c1;
  for (int k = first; k <= last && e == cudaSuccess; ++k) {
    switch (k) {
      case 0:  // da = g Wo^T, Wo (C, C) read transposed
        e = launch_gemm_f32<EPI_NONE, false, true>(
            gf, static_cast<const float*>(wo), nullptr, nullptr, nullptr, daf,
            M, C, C, st);
        break;
      case 1:  // dWo = ctx^T g: partials over chunks of rows, then reduced
        f32_wgrad_split(M, C, C, &S1, &c1);
        if ((e = launch_gemm_f32<EPI_NONE, true>(
                 static_cast<const float*>(ctx), gf, nullptr, nullptr, nullptr,
                 pt, C, C, M, st, c1)) == cudaSuccess)
          e = reduce(st, pt, S1, (size_t)C * C, static_cast<float*>(dwo));
        break;
      case 2:  // dbo = sum g
        e = f32_colsum(st, gf, M, C, pt, static_cast<float*>(dbo));
        break;
      case 3:  // the attention core: dqkv, dbias
        e = swin_f32_core_bwd(st, static_cast<const float*>(qkv),
                              static_cast<const float*>(p), daf, dqkvf, pt,
                              static_cast<float*>(dbias), B, S, C, H, win,
                              shift, scale);
        break;
      case 4:  // the LN recompute
        f32_ln_stats_kernel<<<cdiv(M, 8), 256, 0, st>>>(
            static_cast<const float*>(x), static_cast<const float*>(ln_scale),
            static_cast<const float*>(ln_bias), eps, M, C, hf,
            static_cast<float2*>(stats));
        e = cudaGetLastError();
        break;
      case 5:  // dWqkv = h^T dqkv, as dWo
        f32_wgrad_split(M, C, 3 * C, &S1, &c1);
        if ((e = launch_gemm_f32<EPI_NONE, true>(hf, dqkvf, nullptr, nullptr,
                                                 nullptr, pt, C, 3 * C, M, st,
                                                 c1)) == cudaSuccess)
          e = reduce(st, pt, S1, (size_t)C * 3 * C,
                     static_cast<float*>(dwqkv));
        break;
      case 6:  // dbqkv = sum dqkv
        e = f32_colsum(st, dqkvf, M, 3 * C, pt, static_cast<float*>(dbqkv));
        break;
      case 7:  // dh = dqkv Wqkv^T into the da buffer
        e = launch_gemm_f32<EPI_NONE, false, true>(
            dqkvf, static_cast<const float*>(wqkv), nullptr, nullptr, nullptr,
            daf, M, C, 3 * C, st);
        break;
      default:  // the LN VJP, and the partials of dls, dlb
        if ((e = f32_ln_vjp(st, static_cast<const float*>(x), daf,
                            static_cast<const float2*>(stats),
                            static_cast<const float*>(ln_scale), nullptr, M,
                            C, static_cast<float*>(dx), pt,
                            pt + (size_t)parts * C)) == cudaSuccess &&
            (e = reduce(st, pt, parts, C, static_cast<float*>(dls))) ==
                cudaSuccess)
          e = reduce(st, pt + (size_t)parts * C, parts, C,
                     static_cast<float*>(dlb));
    }
  }
  return (int)e;
}

// K9c.f32, all its launches (the whole backward).
extern "C" int geovpr_swin_f32_bwd_all(
    const void* x, const void* qkv, const void* p, const void* ctx,
    const void* g, const void* wqkv, const void* wo, const void* ln_scale,
    const void* ln_bias, void* da, void* dqkv, void* h, void* stats,
    void* part, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
    void* dbias, void* dls, void* dlb, int B, int S, int C, int H, int win,
    int shift, float eps, float scale, void* stream) {
  return geovpr_swin_f32_bwd_all_parts(
      x, qkv, p, ctx, g, wqkv, wo, ln_scale, ln_bias, da, dqkv, h, stats,
      part, dx, dwqkv, dbqkv, dwo, dbo, dbias, dls, dlb, B, S, C, H, win,
      shift, eps, scale, 0, 8, stream);
}
