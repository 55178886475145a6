// The f32 forms of the serving kernels K1, K4, K6 and K7 for Hopper
// (sm_90a), for a model built with compute_dtype="float32":
//
//   K1  out = x + gamma * (MHSA(LN(x)) @ Wo + bo)            (DINOv2)
//   K4  out = x + proj(W-MSA(LN(x)) + rel-pos bias [+ shift mask])  (Swin)
//   K6  out = LN(concat[x00, x10, x01, x11]) @ W          (Swin boundary)
//   K7  out = softmax(q k^T dh^-0.5 + bias [+ mask]) v    (window core)
//
// and, on the same launches, the f32 Swin training forward K9a.f32: y =
// proj(W-MSA(LN(x))) with no residual, keeping qkv (unscaled), the
// normalised probabilities p (BW, H, N, N) and ctx for the backward
// (f32_train.cu). It replaces, in f32, pallas_swin_block.py::
// _swin_train_fwd_pallas (:1263, pallas_call :1318, body _train_kernel
// :560): K4.f32's LayerNorm and QKV GEMM, the window attention in its
// FA_TRAIN mode, and the out projection with the bias epilogue.
//
// Replaces, in f32, geovpr/ops/pallas_mhsa.py::fused_mhsa_block (:904,
// pallas_call :1064; f32 takes the masked body _mhsa_kernel :351),
// pallas_swin_block.py::fused_swin_attn_block (:1125, _forward :1070),
// pallas_patch_merge.py::fused_patch_merge_rolled (:112, pallas_call
// :143) and pallas_window_attention.py::window_attention_pallas (:182,
// pallas_call :149), whose Pallas bodies take any dtype. The bf16 forms
// (mhsa.cu, swin_attn.cu, patch_merge.cu, window_attn.cu) are separate
// kernels; nothing here is shared with them.
//
// Numerics: f32 operands and f32 sums throughout, as the f32 plain
// versions (geovpr_torch/ops/*::*_reference) compute:
// - LayerNorm with two-pass statistics, (x - mu) * (1 / sqrt(var + eps)) *
//   scale + bias (K6 over the merged 4C row, in the merge order
//   x00 | x10 | x01 | x11);
// - products on the CUDA cores (FFMA), each output a sequential sum over
//   k; no TF32;
// - K1's softmax: s = (q . k) dh^-0.5, keys past N masked, the exact row
//   max subtracted; up to N = FV_MAX_N (564) e = 2^((s - max) log2 e) on
//   the SFU and ctx = (E V) times the reciprocal of sum e, past it p =
//   exp(s - max) / sum (expf, a correctly rounded division), then P V;
// - K4's and K7's serving softmax: q scaled by dh^-0.5 log2(e) in f32,
//   s = q . k + table * log2(e) [+ (-100) * log2(e) across regions], p =
//   2^min(s, 100) with no max-shift, context = (P V) / sum p;
// - K9a's training softmax on the same scores: p = 2^min(s, 100) times
//   the correctly rounded reciprocal of its row sum (the p the backward
//   reads), context = P V of that p.
//
// What bounds it on the H100: operations. f32 has no tensor-core path (a
// single-pass TF32 product keeps a 10-bit mantissa; chip_smoke.py prints
// the plain version's error with TF32 on beside the check), so the peak
// is the CUDA cores' 2 x 128 FFMA lanes x 132 SMs x the SM clock,
// ~67 TFLOP/s at 1.98 GHz. K1 at DINOv2-B/14 (64 x 257 x 768, 12 heads)
// is 77.6 GFLOP of projections and 13.0 of attention, ~1.35 ms, against
// 0.03 ms of bytes; K4 at Swin-B-384's stage 0 is 77.3 + 43.5 GFLOP.
// Every design choice below is for that rate: register-blocked products,
// operands from shared memory, nothing recomputed but the scores of K1's
// streamed route past FV_MAX_N.
//
// Launches (K1 and K4 four, K6 two, K7 one), each on the caller's stream:
// - f32_ln_kernel<kMerge>: one warp a row, float4 loads, three passes
//   over the row (mean, squared deviations, normalised store) that the
//   warp's L1 serves after the first; kMerge reads the 4C row of a merged
//   token from its four source rows.
// - f32_gemm_kernel<kEpi> (f32_gemm.cuh, shared with f32_train.cu): C =
//   A W (A (M, K) row-major, W (K, N) (in, out)), 128 x 64 tiles of 128
//   threads, 8 x 8 outputs a thread, k tiles of 16 through a three-stage
//   cp.async ring on mbarriers; where those tiles would take more than
//   three waves (K1's projections at B = 64, most of K4's, K6's),
//   f32_gemm_wide_kernel's 128 x 128 tiles of 256 threads, k tiles of 8
//   double-buffered; epilogues: + bias (QKV), + bias + x (K4's out
//   projection), (+ bias) * gamma + x (K1's), none (K6).
// - f32_vit_attn_kernel: K1's attention up to N = FV_MAX_N (564), a CTA one
//   (32-row query tile, head, image) whose score rows stay in shared
//   memory: S = q k^T once, the rows' exact max and sums, then E V (see
//   its note). Past FV_MAX_N K1 takes f32_attn_kernel's FA_VIT mode
//   (ops/mhsa.py::k1_f32_attention_route names the rule).
// - f32_attn_kernel<DH, kMode>: a CTA one (query block, head, image) of
//   K1 past FV_MAX_N, or one (window, head, query block) of K4 / K7, each
//   warp FA_R query rows; key tiles of FA_KT rows through shared memory
//   (K at a stride of DH + 1, so that a lane's key row is conflict-free),
//   a lane one key of each 32-key chunk: the scores of the warp's rows,
//   then P written to the warp's shared slice and P V with a lane one
//   output column (two at DH = 64). K1 makes two passes over the keys
//   (per-lane running max and sum, combined across the warp, then p), the
//   serving windows one;
//   FA_TRAIN (K9a.f32) two on the raster windows: the row sums of p, then
//   p times their reciprocal, stored to the p plane and summed into P V.
// The attention's shared memory (Q block, a K and a V tile, the warps' P
// slices, the head's table column) stays under FA_SMEM_LIMIT; the wrappers
// allocate every buffer: qkv and ctx (which holds LN(x) until the
// attention writes the context), K6's LN(merged).

#include "f32_gemm.cuh"

namespace {

constexpr float F32_LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------ LayerNorm --

constexpr int LN_WARPS = 8;

// y (rows, D) = LN(row) * scale + bias. kMerge: row m is K6's merged token
// (b, y, x) of the next stage, D = 4C, read from the four tokens (2y + i,
// 2x + j) of x (B, S*S, C) in the order x00 | x10 | x01 | x11.
template <bool kMerge>
__global__ void __launch_bounds__(32 * LN_WARPS)
f32_ln_kernel(const float* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, float* __restrict__ y,
              int rows, int D, int S, int C, float eps) {
  const int row = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float* p00 = x + (long long)row * D;
  const float *p10 = p00, *p01 = p00, *p11 = p00;
  if (kMerge) {
    const int S2 = S / 2;
    const int b = row / (S2 * S2), rem = row - b * S2 * S2;
    const int yo = rem / S2, xo = rem - yo * S2;
    const long long t = ((long long)b * S + 2 * yo) * S + 2 * xo;
    p00 = x + t * C;
    p10 = x + (t + S) * C;
    p01 = x + (t + 1) * C;
    p11 = x + (t + S + 1) * C;
  }
  // the 4 floats at column c of the (merged) row; C % 4 == 0, so a chunk
  // never straddles two source tokens
  auto chunk = [&](int c) -> float4 {
    if (!kMerge) return f32_ld4(p00 + c);
    const int quad = c / C;
    const float* src = quad == 0 ? p00 : quad == 1 ? p10 : quad == 2 ? p01
                                                                     : p11;
    return f32_ld4(src + (c - quad * C));
  };
  float sum = 0.f;
  for (int c = 4 * lane; c < D; c += 128) {
    const float4 v = chunk(c);
    sum += v.x;
    sum += v.y;
    sum += v.z;
    sum += v.w;
  }
  const float mu = f32_warp_sum(sum) / (float)D;
  float sq = 0.f;
  for (int c = 4 * lane; c < D; c += 128) {
    const float4 v = chunk(c);
    const float d0 = v.x - mu, d1 = v.y - mu, d2 = v.z - mu, d3 = v.w - mu;
    sq += d0 * d0;
    sq += d1 * d1;
    sq += d2 * d2;
    sq += d3 * d3;
  }
  const float rstd = 1.f / sqrtf(f32_warp_sum(sq) / (float)D + eps);
  float* out = y + (long long)row * D;
  for (int c = 4 * lane; c < D; c += 128) {
    const float4 v = chunk(c), sc = f32_ld4(scale + c), bi = f32_ld4(bias + c);
    float4 o;
    o.x = __fadd_rn(__fmul_rn(__fmul_rn(v.x - mu, rstd), sc.x), bi.x);
    o.y = __fadd_rn(__fmul_rn(__fmul_rn(v.y - mu, rstd), sc.y), bi.y);
    o.z = __fadd_rn(__fmul_rn(__fmul_rn(v.z - mu, rstd), sc.z), bi.z);
    o.w = __fadd_rn(__fmul_rn(__fmul_rn(v.w - mu, rstd), sc.w), bi.w);
    *reinterpret_cast<float4*>(out + c) = o;
  }
}

cudaError_t launch_ln(const float* x, const float* scale, const float* bias,
                      float* y, int rows, int D, int S, int C, float eps,
                      bool merge, cudaStream_t s) {
  const dim3 grid((rows + LN_WARPS - 1) / LN_WARPS);
  if (merge)
    f32_ln_kernel<true><<<grid, 32 * LN_WARPS, 0, s>>>(x, scale, bias, y,
                                                        rows, D, S, C, eps);
  else
    f32_ln_kernel<false><<<grid, 32 * LN_WARPS, 0, s>>>(x, scale, bias, y,
                                                         rows, D, S, C, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------------ attention --

constexpr int FA_R = 8;         // query rows of a warp
constexpr int FA_KT = 64;       // keys of a shared-memory tile
constexpr int FA_MAX_N = 256;   // a window's tokens at most
constexpr int FA_WIN_ROWS = 144;  // a window CTA's query rows at most
constexpr int FA_SMEM_LIMIT = 96 * 1024;
enum { FA_VIT = 0, FA_RASTER = 1, FA_SPLIT = 2, FA_TRAIN = 3 };

// the modes that address the raster stream's windows (K4, K7's raster
// mode, and K9a's training attention)
__host__ __device__ constexpr bool fa_raster(int mode) {
  return mode == FA_RASTER || mode == FA_TRAIN;
}

struct FaArgs {
  // VIT and RASTER: q, k and v point into one qkv buffer at the q, k and v
  // column blocks, rows of `ld` floats; SPLIT: three (BW, H, N, DH) tensors
  const float* q;
  const float* k;
  const float* v;
  const float* bias;  // RASTER: the ((2W-1)^2, H) table; SPLIT: (H, N, N)
  const float* mask;  // SPLIT: (nW, N, N) or null
  float* out;
  int N;      // tokens (keys) of a sequence or a window
  int H;
  int ld;     // row stride of q, k and v
  int ldo;    // row stride of out
  int S, W, shift;  // RASTER geometry
  int nW;           // SPLIT: windows of the mask
  int qrows;        // query rows of a CTA (blockIdx.z its query block)
  float scale;      // VIT: dh^-0.5 on q . k; windows: dh^-0.5 log2(e) on q
  float* p;         // TRAIN: the normalised p (BW, H, N, N), window order
};

// The CTA's problem: its head, query rows, and how token i becomes a row
// of q, k, v and out. K1: blockIdx (query block, head, image); the
// windows: (window, head, query block).
template <int kMode>
struct FaGeo {
  int b, h, q0, wy, wx;
  __device__ FaGeo(const FaArgs& a) : wy(0), wx(0) {
    h = blockIdx.y;
    if (kMode == FA_VIT) {
      b = blockIdx.z;
      q0 = blockIdx.x * a.qrows;
    } else {
      b = blockIdx.x;
      q0 = blockIdx.z * a.qrows;
    }
    if (fa_raster(kMode)) {
      const int nw = a.S / a.W;
      const int gw = blockIdx.x;
      b = gw / (nw * nw);
      const int wi = gw - b * nw * nw;
      wy = wi / nw;
      wx = wi - wy * nw;
    }
  }
  // raster: token (ty, tx) of window (wy, wx) in the frame rolled by
  // -shift is the raster token ((Y + shift) mod S, (X + shift) mod S)
  __device__ long long row(const FaArgs& a, int i) const {
    if (kMode == FA_VIT) return (long long)b * a.N + i;
    if (kMode == FA_SPLIT) return ((long long)b * a.H + h) * a.N + i;
    const int ty = i / a.W, tx = i - ty * a.W;
    int ry = wy * a.W + ty + a.shift;
    int rx = wx * a.W + tx + a.shift;
    if (ry >= a.S) ry -= a.S;
    if (rx >= a.S) rx -= a.S;
    return ((long long)b * a.S + ry) * a.S + rx;
  }
  // the shift mask's region of rolled-frame coordinate t: [0, S - W),
  // [S - W, S - shift), [S - shift, S)
  __device__ int region(const FaArgs& a, int t) const {
    return t < a.S - a.W ? 0 : t < a.S - a.shift ? 1 : 2;
  }
};

// threads of a CTA at most: K1's query blocks of <= 64 rows, the windows'
// of <= FA_WIN_ROWS
constexpr int fa_threads_bound(int mode) {
  return mode == FA_VIT ? 256 : 32 * FA_WIN_ROWS / FA_R;
}

template <int DH, int kMode>
__global__ void __launch_bounds__(kMode == FA_VIT ? 256
                                                  : 32 * FA_WIN_ROWS / FA_R)
f32_attn_kernel(FaArgs a) {
  static_assert(DH % 32 == 0, "a lane owns DH / 32 output columns");
  constexpr int KLD = DH + 1;
  constexpr int E = DH / 32;
  extern __shared__ __align__(16) float fa_smem[];
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* sq = fa_smem;                    // [nwarps * FA_R][DH]
  float* sk = sq + nwarps * FA_R * DH;    // [FA_KT][KLD]
  float* sv = sk + FA_KT * KLD;           // [FA_KT][DH]
  float* sp = sv + FA_KT * DH;            // [nwarps][32][FA_R]
  float* stab = sp + nwarps * 32 * FA_R;  // RASTER: [(2W-1)^2]

  const FaGeo<kMode> g(a);
  const int nq = min(a.qrows, a.N - g.q0);
  const int col = kMode == FA_SPLIT ? 0 : g.h * DH;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int idx = threadIdx.x; idx < nwarps * FA_R * DH / 4;
       idx += blockDim.x) {
    const int r = idx / (DH / 4), c = 4 * (idx - r * (DH / 4));
    float4 v = zero;
    if (r < nq) {
      v = f32_ld4(a.q + g.row(a, g.q0 + r) * a.ld + col + c);
      if (kMode != FA_VIT) {
        v.x = __fmul_rn(v.x, a.scale);
        v.y = __fmul_rn(v.y, a.scale);
        v.z = __fmul_rn(v.z, a.scale);
        v.w = __fmul_rn(v.w, a.scale);
      }
    }
    *reinterpret_cast<float4*>(sq + r * DH + c) = v;
  }
  const int tw = 2 * a.W - 1;
  if (fa_raster(kMode))
    for (int t = threadIdx.x; t < tw * tw; t += blockDim.x)
      stab[t] = __fmul_rn(a.bias[(long long)t * a.H + g.h], F32_LOG2E);

  // this warp's rows: the token, and for RASTER its table position and
  // shift region
  const int r0 = warp * FA_R;
  int qtok[FA_R], qpos[FA_R], qlab[FA_R];
#pragma unroll
  for (int r = 0; r < FA_R; ++r) {
    qtok[r] = g.q0 + min(r0 + r, max(nq - 1, 0));
    qpos[r] = qlab[r] = 0;
    if (fa_raster(kMode)) {
      const int ty = qtok[r] / a.W, tx = qtok[r] - ty * a.W;
      qpos[r] = ty * tw + tx;
      qlab[r] = 3 * g.region(a, g.wy * a.W + ty) + g.region(a, g.wx * a.W + tx);
    }
  }
  const float kMaskL2 = __fmul_rn(-100.f, F32_LOG2E);
  const int pos_base = (a.W - 1) * 2 * a.W;  // (W-1)(2W-1) + W - 1

  float m[FA_R], l[FA_R], acc[FA_R][E];
#pragma unroll
  for (int r = 0; r < FA_R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }
  float* wp = sp + warp * 32 * FA_R;
  constexpr int kPasses = kMode == FA_VIT || kMode == FA_TRAIN ? 2 : 1;
  for (int pass = 0; pass < kPasses; ++pass) {
    const bool last = pass == kPasses - 1;
    for (int t0 = 0; t0 < a.N; t0 += FA_KT) {
      const int nk = min(FA_KT, a.N - t0);
      __syncthreads();  // the previous tile is read (and Q is staged)
      for (int idx = threadIdx.x; idx < FA_KT * DH / 4; idx += blockDim.x) {
        const int j = idx / (DH / 4), c = 4 * (idx - j * (DH / 4));
        float4 kv = zero, vv = zero;
        if (j < nk) {
          const long long off = g.row(a, t0 + j) * a.ld + col + c;
          kv = f32_ld4(a.k + off);
          if (last) vv = f32_ld4(a.v + off);
        }
        sk[j * KLD + c] = kv.x;
        sk[j * KLD + c + 1] = kv.y;
        sk[j * KLD + c + 2] = kv.z;
        sk[j * KLD + c + 3] = kv.w;
        if (last) *reinterpret_cast<float4*>(sv + j * DH + c) = vv;
      }
      __syncthreads();
#pragma unroll 1
      for (int c32 = 0; c32 < FA_KT / 32; ++c32) {
        const int jt = c32 * 32 + lane;  // this lane's key in the tile
        const int key = t0 + jt;
        const bool kin = jt < nk;
        float s[FA_R];
#pragma unroll
        for (int r = 0; r < FA_R; ++r) s[r] = 0.f;
        const float* krow = sk + jt * KLD;
#pragma unroll 4
        for (int d = 0; d < DH; d += 4) {
          const float k0 = krow[d], k1 = krow[d + 1], k2 = krow[d + 2],
                      k3 = krow[d + 3];
#pragma unroll
          for (int r = 0; r < FA_R; ++r) {
            const float4 q4 = f32_ld4(sq + (r0 + r) * DH + d);
            s[r] = fmaf(q4.x, k0, s[r]);
            s[r] = fmaf(q4.y, k1, s[r]);
            s[r] = fmaf(q4.z, k2, s[r]);
            s[r] = fmaf(q4.w, k3, s[r]);
          }
        }
        if (kMode == FA_VIT) {
#pragma unroll
          for (int r = 0; r < FA_R; ++r)
            s[r] = key < a.N ? __fmul_rn(s[r], a.scale) : -INFINITY;
        } else {
          int kpos = 0, klab = 0;
          if (fa_raster(kMode) && kin) {
            const int ty = key / a.W, tx = key - ty * a.W;
            kpos = ty * tw + tx;
            klab = 3 * g.region(a, g.wy * a.W + ty) +
                   g.region(a, g.wx * a.W + tx);
          }
#pragma unroll
          for (int r = 0; r < FA_R; ++r) {
            float x = s[r];
            if (kin) {
              if (fa_raster(kMode)) {
                x = __fadd_rn(x, stab[qpos[r] - kpos + pos_base]);
                if (a.shift && qlab[r] != klab) x = __fadd_rn(x, kMaskL2);
              } else {
                const long long at = ((long long)g.h * a.N + qtok[r]) * a.N + key;
                x = __fadd_rn(x, __fmul_rn(a.bias[at], F32_LOG2E));
                if (a.mask) {
                  const long long mw = g.b % a.nW;
                  x = __fadd_rn(x, __fmul_rn(
                      a.mask[(mw * a.N + qtok[r]) * a.N + key], F32_LOG2E));
                }
              }
            }
            s[r] = kin ? x : -INFINITY;
          }
        }
        if (!last && kMode == FA_TRAIN) {  // K9a's first pass: the sums
#pragma unroll
          for (int r = 0; r < FA_R; ++r)
            if (kin) l[r] = __fadd_rn(l[r], exp2f(fminf(s[r], 100.f)));
          continue;
        }
        if (!last) {  // K1's first pass: this lane's running max and sum
#pragma unroll
          for (int r = 0; r < FA_R; ++r) {
            if (s[r] > m[r]) {
              l[r] = __fmul_rn(l[r], expf(m[r] - s[r]));
              m[r] = s[r];
            }
            if (s[r] > -INFINITY) l[r] = __fadd_rn(l[r], expf(s[r] - m[r]));
          }
          continue;
        }
        float p[FA_R];
#pragma unroll
        for (int r = 0; r < FA_R; ++r) {
          if (kMode == FA_VIT) {
            p[r] = __fdiv_rn(expf(s[r] - m[r]), l[r]);
          } else if (kMode == FA_TRAIN) {
            // l holds the reciprocal of the row sum after the first pass
            p[r] = kin ? __fmul_rn(exp2f(fminf(s[r], 100.f)), l[r]) : 0.f;
            if (kin && r0 + r < nq)
              a.p[(((long long)blockIdx.x * a.H + g.h) * a.N + g.q0 + r0 +
                   r) * a.N + key] = p[r];
          } else {
            p[r] = exp2f(fminf(s[r], 100.f));
            l[r] = __fadd_rn(l[r], p[r]);
          }
        }
        __syncwarp();
        *reinterpret_cast<float4*>(wp + lane * FA_R) =
            make_float4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<float4*>(wp + lane * FA_R + 4) =
            make_float4(p[4], p[5], p[6], p[7]);
        __syncwarp();
        const float* vt = sv + (c32 * 32) * DH + lane;
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          const float4 pa = f32_ld4(wp + j * FA_R);
          const float4 pb = f32_ld4(wp + j * FA_R + 4);
          const float pj[FA_R] = {pa.x, pa.y, pa.z, pa.w,
                                  pb.x, pb.y, pb.z, pb.w};
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float vv = vt[j * DH + 32 * e];
#pragma unroll
            for (int r = 0; r < FA_R; ++r)
              acc[r][e] = fmaf(pj[r], vv, acc[r][e]);
          }
        }
      }
    }
    if (!last && kMode == FA_TRAIN) {  // each row's 1 / sum over the warp
#pragma unroll
      for (int r = 0; r < FA_R; ++r) l[r] = __fdiv_rn(1.f, f32_warp_sum(l[r]));
    } else if (!last) {  // each row's max and sum over the whole warp
#pragma unroll
      for (int r = 0; r < FA_R; ++r) {
        const float mr = f32_warp_max(m[r]);
        const float part =
            m[r] == -INFINITY ? 0.f : __fmul_rn(l[r], expf(m[r] - mr));
        m[r] = mr;
        l[r] = f32_warp_sum(part);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < FA_R; ++r) {
    const bool plain = kMode == FA_VIT || kMode == FA_TRAIN;
    const float sum = plain ? 1.f : f32_warp_sum(l[r]);
    if (r0 + r >= nq) continue;
    float* o = a.out + g.row(a, g.q0 + r0 + r) * a.ldo + col + lane;
#pragma unroll
    for (int e = 0; e < E; ++e)
      o[32 * e] = plain ? acc[r][e] : __fdiv_rn(acc[r][e], sum);
  }
}

int fa_smem_bytes(int dh, int nwarps, int table) {
  return 4 * (nwarps * FA_R * dh + FA_KT * (dh + 1) + FA_KT * dh +
              nwarps * 32 * FA_R + table);
}

template <int DH, int kMode>
cudaError_t launch_attn(const FaArgs& a, dim3 grid, cudaStream_t s) {
  const int nwarps = (a.qrows + FA_R - 1) / FA_R;
  if (nwarps <= 0 || 32 * nwarps > fa_threads_bound(kMode))
    return cudaErrorInvalidValue;
  const int tw = 2 * a.W - 1;
  const int smem =
      fa_smem_bytes(DH, nwarps, fa_raster(kMode) ? tw * tw : 0);
  if (smem > FA_SMEM_LIMIT) return cudaErrorInvalidValue;
  f32_attn_kernel<DH, kMode><<<grid, 32 * nwarps, smem, s>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------- K1's attention, rows on chip --

// K1.f32's attention (launch 2) for N <= FV_MAX_N: a CTA one (32-row query
// tile, head, image) of 4 warps; three CTAs an SM up to N = 260 (75 KB
// each: DINOv2's N = 257), two up to FV_MAX_N. The tile's q rows and the
// head's k rows, then its v rows, stream through a two-stage ring of
// FV_KT key rows (64 columns at h 64 of the qkv rows, stride 3D), which
// every thread fills by 16-byte cp.async, each fill's arrival counted on
// its stage's mbarrier; the next stage loads while the current one is
// used. The tile's whole score rows stay in shared memory:
//   pass 1  S = (q k^T) dh^-0.5 once over all keys: a stage of FV_KT keys
//           as a 4 x 4 tile a thread (rows ty + 8 i, keys tx + 16 j), q
//           and k read as float4s along the head dim; a stage of fewer
//           than 16 keys (the ragged tail: one key at N = 257) as (row,
//           key) dot products, each split over 4 lanes, so that it costs
//           its keys; keys past N to -inf;
//   rows    a warp's 8 rows: the exact max over the N keys, e = exp(s -
//           max) in place (the SFU's 2^x of (s - max) log2 e), 1 / sum e;
//   pass 3  ctx = (E V) / sum e: a lane 4 of its warp's rows x 4 columns,
//           e and v read as float4s over 4 keys, one multiply an output at
//           the end.
// Rows of the ring past N (the next image's, or past the tensor) are never
// loaded; the products read them only for outputs they do not store. The
// score columns past N hold -inf. q row r is stored with its 16-byte chunk
// c at chunk c ^ (r & 1), so that a warp's two q rows (ty, ty + 1) sit in
// different banks; k and v rows are padded to FV_LD floats.
constexpr int FV_DH = 64;          // head dim
constexpr int FV_LD = FV_DH + 4;   // row stride of a staged k or v row
constexpr int FV_BQ = 32;          // query rows of a CTA, 8 a warp
constexpr int FV_THREADS = 128;
constexpr int FV_KT = 64;          // key rows of a ring stage
constexpr int FV_STAGES = 2;
constexpr int FV_CTAS = 3;         // CTAs an SM at N = 257
constexpr int FV_BAR_BYTES = 16;   // the mbarriers, before the rows
constexpr int FV_SMEM_MAX = 115712;  // two CTAs an SM (228 KB, 1 KB
                                     // reserved a CTA)
constexpr int FV_FIXED =
    FV_BAR_BYTES + 4 * (FV_BQ * FV_DH + FV_STAGES * FV_KT * FV_LD);
// the score rows' stride: N rounded up to 4 floats
__host__ __device__ constexpr int fv_lds(int n) { return (n + 3) & ~3; }
constexpr int fv_smem(int n) { return FV_FIXED + 4 * FV_BQ * fv_lds(n); }
// the longest sequence whose score rows fit two CTAs an SM (564); past it
// K1.f32 runs f32_attn_kernel<64, FA_VIT>
constexpr int FV_MAX_N = (FV_SMEM_MAX - FV_FIXED) / (4 * FV_BQ) & ~3;
static_assert(fv_smem(FV_MAX_N) <= FV_SMEM_MAX, "two CTAs an SM");
static_assert(FV_CTAS * (fv_smem(257) + 1024) <= 233472,
              "three CTAs an SM at DINOv2's N = 257");

__global__ void __launch_bounds__(FV_THREADS, FV_CTAS)
f32_vit_attn_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                    int N, int D, float scale) {
  extern __shared__ __align__(16) unsigned char fv_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(fv_raw);
  float* sq = reinterpret_cast<float*>(fv_raw + FV_BAR_BYTES);
  float* ring = sq + FV_BQ * FV_DH;               // [stage][key][FV_LD]
  float* S = ring + FV_STAGES * FV_KT * FV_LD;    // [row][lds]
  const int q0 = blockIdx.x * FV_BQ, h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(FV_BQ, N - q0);
  const int lds = fv_lds(N);
  const long long ld3 = 3LL * D;
  const float* head = qkv + (long long)b * N * ld3 + h * FV_DH;
  const int tiles = (N + FV_KT - 1) / FV_KT;  // key tiles a pass
  const int tid = threadIdx.x, lane = tid & 31, r0 = 8 * (tid >> 5);
  if (tid < FV_STAGES) mbar_init(&full[tid], FV_THREADS);
  mbar_fence_init();
  __syncthreads();

  // ring tile t into its stage: the k rows of key tile t, or for t >=
  // tiles the v rows of key tile t - tiles; with t = 0 also the q rows
  // (rows past N zero-filled)
  auto load = [&](int t) {
    const int k0 = (t < tiles ? t : t - tiles) * FV_KT;
    const int nk = min(FV_KT, N - k0);
    const float* src = head + k0 * ld3 + (t < tiles ? D : 2 * D);
    float* st = ring + (t % FV_STAGES) * FV_KT * FV_LD;
    for (int c = tid; c < nk * (FV_DH / 4); c += FV_THREADS) {
      const int r = c >> 4, e4 = (c & 15) * 4;
      cp_async16(st + r * FV_LD + e4, src + r * ld3 + e4, 16);
    }
    if (t == 0)
      for (int c = tid; c < FV_BQ * (FV_DH / 4); c += FV_THREADS) {
        const int r = c >> 4, e4 = (c & 15) * 4;
        const bool in = r < nrows;
        cp_async16(sq + r * FV_DH + (e4 ^ ((r & 1) << 2)),
                   in ? head + (q0 + r) * ld3 + e4 : head, in ? 16 : 0);
      }
    cp_async_arrive(&full[t % FV_STAGES]);
  };

  // pass 1 of a stage's nk keys at key k0
  const int ty = tid >> 4, tx = tid & 15, qsw = (ty & 1) << 2;
  auto scores = [&](const float* st, int k0, int nk) {
    if (nk >= 16) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      const float* qr = sq + ty * FV_DH;
      const float* kr = st + tx * FV_LD;
#pragma unroll 4
      for (int e = 0; e < FV_DH; e += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = f32_ld4(qr + 8 * i * FV_DH + (e ^ qsw));
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = f32_ld4(kr + 16 * j * FV_LD + e);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(qv[i].x, kv[j].x, acc[i][j]);
            acc[i][j] = fmaf(qv[i].y, kv[j].y, acc[i][j]);
            acc[i][j] = fmaf(qv[i].z, kv[j].z, acc[i][j]);
            acc[i][j] = fmaf(qv[i].w, kv[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (ty + 8 * i < nrows && tx + 16 * j < nk)
            S[(ty + 8 * i) * lds + k0 + tx + 16 * j] =
                __fmul_rn(acc[i][j], scale);
    } else {
      // row tid / 4, dims 16 (tid % 4) .. + 15, summed over the 4 lanes
      const int r = tid >> 2, part = tid & 3;
      const float* qr = sq + r * FV_DH;
      const int rsw = (r & 1) << 2;
      for (int c = 0; c < nk; ++c) {
        const float* kr = st + c * FV_LD + 16 * part;
        float v = 0.f;
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          const float4 a = f32_ld4(qr + ((16 * part + e) ^ rsw));
          const float4 k = f32_ld4(kr + e);
          v = fmaf(a.x, k.x, v);
          v = fmaf(a.y, k.y, v);
          v = fmaf(a.z, k.z, v);
          v = fmaf(a.w, k.w, v);
        }
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (part == 0 && r < nrows) S[r * lds + k0 + c] = __fmul_rn(v, scale);
      }
    }
  };

  // the warp's 8 rows (a row past nrows reads row nrows - 1 and writes
  // nothing): 1 / sum e, and the pass-3 sums of a lane's rows r0 + 4 rg +
  // i, columns 4 cg .. 4 cg + 3
  const int rg = lane >> 4, cg = lane & 15;
  float rl[8];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* er[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    er[i] = S + min(r0 + 4 * rg + i, nrows - 1) * lds;
  const bool rows_in = r0 < nrows;

  load(0);
  if (2 * tiles > 1) load(1);
  for (int t = 0; t < 2 * tiles; ++t) {
    mbar_wait(&full[t % FV_STAGES], (t / FV_STAGES) & 1);
    const float* st = ring + (t % FV_STAGES) * FV_KT * FV_LD;
    const int k0 = (t < tiles ? t : t - tiles) * FV_KT;
    const int nk = min(FV_KT, N - k0);
    if (t < tiles) {
      scores(st, k0, nk);
      if (t == tiles - 1) {
        for (int p = tid; p < nrows * (lds - N); p += FV_THREADS) {
          const int r = p / (lds - N);
          S[r * lds + N + p - r * (lds - N)] = -INFINITY;
        }
        __syncthreads();  // every score row whole
        // the warp's 8 rows at once (8 independent chains), a lane its
        // float4s lane + 32 c of each: the max, e in place, 1 / sum e
        const int nv = lds >> 2;
        int roff[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) roff[i] = min(r0 + i, nrows - 1) * lds;
        float m[8], l[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) m[i] = -INFINITY, l[i] = 0.f;
        if (rows_in) {
          for (int c = lane; c < nv; c += 32)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 v = f32_ld4(S + roff[i] + 4 * c);
              m[i] = fmaxf(fmaxf(m[i], fmaxf(v.x, v.y)), fmaxf(v.z, v.w));
            }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int i = 0; i < 8; ++i)
              m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
          for (int c = lane; c < nv; c += 32)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 v = f32_ld4(S + roff[i] + 4 * c);
              const float4 e =
                  make_float4(exp2_ftz((v.x - m[i]) * F32_LOG2E),
                              exp2_ftz((v.y - m[i]) * F32_LOG2E),
                              exp2_ftz((v.z - m[i]) * F32_LOG2E),
                              exp2_ftz((v.w - m[i]) * F32_LOG2E));
              if (r0 + i < nrows)
                *reinterpret_cast<float4*>(S + roff[i] + 4 * c) = e;
              l[i] = __fadd_rn(
                  __fadd_rn(__fadd_rn(__fadd_rn(l[i], e.x), e.y), e.z), e.w);
            }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int i = 0; i < 8; ++i)
              l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) rl[i] = 1.f / l[i];
        __syncwarp();  // pass 3 reads only this warp's rows
      }
    } else if (rows_in) {
      int c = 0;
      for (; c + 4 <= nk; c += 4) {
        float4 ev[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ev[i] = f32_ld4(er[i] + k0 + c);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          vv[kk] = f32_ld4(st + (c + kk) * FV_LD + 4 * cg);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = f4_at(ev[i], kk);
            acc[i][0] = fmaf(x, vv[kk].x, acc[i][0]);
            acc[i][1] = fmaf(x, vv[kk].y, acc[i][1]);
            acc[i][2] = fmaf(x, vv[kk].z, acc[i][2]);
            acc[i][3] = fmaf(x, vv[kk].w, acc[i][3]);
          }
      }
      for (; c < nk; ++c) {  // the ragged tail's keys
        const float4 v4 = f32_ld4(st + c * FV_LD + 4 * cg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = er[i][k0 + c];
          acc[i][0] = fmaf(x, v4.x, acc[i][0]);
          acc[i][1] = fmaf(x, v4.y, acc[i][1]);
          acc[i][2] = fmaf(x, v4.z, acc[i][2]);
          acc[i][3] = fmaf(x, v4.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // every thread is past stage t, which tile t + 2 refills
    if (t + FV_STAGES < 2 * tiles) load(t + FV_STAGES);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * rg + i;
    const float inv = rg ? rl[4 + i] : rl[i];
    if (r < nrows)
      *reinterpret_cast<float4*>(out + ((long long)b * N + q0 + r) * D +
                                 h * FV_DH + 4 * cg) =
          make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
                      acc[i][3] * inv);
  }
}

// K1.f32's attention on qkv (B*N, 3D) into ctx (B*N, D): the rows-on-chip
// kernel for N <= FV_MAX_N, else the streamed f32_attn_kernel<64, FA_VIT>
// (query blocks of at most 64 rows, as even as N allows)
cudaError_t launch_vit_attn(const float* qkv, float* ctx, int B, int N,
                            int D, int H, cudaStream_t s) {
  const float scale = 1.f / sqrtf(64.f);
  if (N <= FV_MAX_N) {
    f32_vit_attn_kernel<<<dim3((N + FV_BQ - 1) / FV_BQ, H, B), FV_THREADS,
                          fv_smem(N), s>>>(qkv, ctx, N, D, scale);
    return cudaGetLastError();
  }
  const int nblk = (N + 63) / 64;
  FaArgs a{};
  a.q = qkv;
  a.k = qkv + D;
  a.v = qkv + 2 * D;
  a.out = ctx;
  a.N = N;
  a.H = H;
  a.ld = 3 * D;
  a.ldo = D;
  a.W = 1;
  a.nW = 1;
  a.qrows = (N + nblk - 1) / nblk;
  a.scale = scale;
  return launch_attn<64, FA_VIT>(a, dim3(nblk, H, B), s);
}

// K7's raster attention on the qkv (B*S*S, 3C) of K4 or of the window-7
// half, the context into out (B*S*S, C).
// the windows' query blocks: as few as hold FA_WIN_ROWS rows each, as even
// as N allows
int window_blocks(int n) { return (n + FA_WIN_ROWS - 1) / FA_WIN_ROWS; }

cudaError_t launch_raster(const float* qkv, const float* table, float* out,
                          int B, int S, int C, int H, int W, int shift,
                          float qscale, cudaStream_t s) {
  FaArgs a{};
  a.q = qkv;
  a.k = qkv + C;
  a.v = qkv + 2 * C;
  a.bias = table;
  a.out = out;
  a.N = W * W;
  a.H = H;
  a.ld = 3 * C;
  a.ldo = C;
  a.S = S;
  a.W = W;
  a.shift = shift;
  a.nW = 1;
  const int nblk = window_blocks(W * W);
  a.qrows = (W * W + nblk - 1) / nblk;
  a.scale = qscale;
  const int nw = S / W;
  return launch_attn<32, FA_RASTER>(a, dim3(B * nw * nw, H, nblk), s);
}

// K9a.f32's attention on the raster qkv (B*S*S, 3C): ctx (B*S*S, C) and
// the normalised p (BW, H, N, N) of each window, in the raster mode's
// query blocks (one of N = 144 rows at window 12), each row's sums over
// all the window's keys.
cudaError_t launch_train_attn(const float* qkv, const float* table,
                              float* out, float* p, int B, int S, int C,
                              int H, int W, int shift, float qscale,
                              cudaStream_t s) {
  FaArgs a{};
  a.q = qkv;
  a.k = qkv + C;
  a.v = qkv + 2 * C;
  a.bias = table;
  a.out = out;
  a.p = p;
  a.N = W * W;
  a.H = H;
  a.ld = 3 * C;
  a.ldo = C;
  a.S = S;
  a.W = W;
  a.shift = shift;
  a.nW = 1;
  const int nblk = window_blocks(W * W);
  a.qrows = (W * W + nblk - 1) / nblk;
  a.scale = qscale;
  const int nw = S / W;
  return launch_attn<32, FA_TRAIN>(a, dim3(B * nw * nw, H, nblk), s);
}

}  // namespace

// Raises the attention kernels' dynamic shared-memory limits on the
// current device; returns a cudaError_t as int.
extern "C" int geovpr_f32_serving_init(void) {
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(f32_vit_attn_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                FV_SMEM_MAX)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(f32_attn_kernel<64, FA_VIT>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                FA_SMEM_LIMIT)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(f32_attn_kernel<32, FA_RASTER>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                FA_SMEM_LIMIT)) != cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(f32_attn_kernel<32, FA_TRAIN>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                FA_SMEM_LIMIT)) != cudaSuccess)
    return (int)e;
  return (int)cudaFuncSetAttribute(
      f32_attn_kernel<32, FA_SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, FA_SMEM_LIMIT);
}

// The longest N whose attention keeps its score rows on chip
// (f32_vit_attn_kernel); ops/mhsa.py::k1_f32_attention_route holds the
// same limit.
extern "C" int geovpr_mhsa_f32_rows_max_n(void) { return FV_MAX_N; }

// K1 in f32, launches first..last (0 LayerNorm, 1 QKV GEMM, 2 attention, 3
// out projection); returns a cudaError_t as int. x, the matrices, qkv
// (B*N, 3D), ctx (B*N, D; LN(x) until the attention writes the context)
// and out are f32, as the vectors; all 16-byte aligned; D = 64 H. A launch
// alone reads what the earlier launches of an earlier call left in qkv and
// ctx.
extern "C" int geovpr_mhsa_f32_parts(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* gamma,
    void* qkv, void* ctx, void* out, int B, int N, int D, int H, float eps,
    int first, int last, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D != 64 * H || B > 65535 || H > 65535 ||
      first < 0 || last > 3 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* qkvf = static_cast<float*>(qkv);
  float* ctxf = static_cast<float*>(ctx);
  cudaError_t e = cudaSuccess;
  for (int part = first; part <= last; ++part) {
    switch (part) {
      case 0:
        e = launch_ln(xf, static_cast<const float*>(ln_scale),
                      static_cast<const float*>(ln_bias), ctxf, M, D, 0, 0,
                      eps, false, s);
        break;
      case 1:
        e = launch_gemm_f32<EPI_BIAS>(ctxf, static_cast<const float*>(wqkv),
                                      static_cast<const float*>(bqkv),
                                      nullptr, nullptr, qkvf, M, 3 * D, D, s);
        break;
      case 2:
        e = launch_vit_attn(qkvf, ctxf, B, N, D, H, s);
        break;
      default:
        e = launch_gemm_f32<EPI_GAMMA_RESID>(
            ctxf, static_cast<const float*>(wo), static_cast<const float*>(bo),
            static_cast<const float*>(gamma), xf, static_cast<float*>(out), M,
            D, D, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" int geovpr_mhsa_block_f32(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* gamma,
    void* qkv, void* ctx, void* out, int B, int N, int D, int H, float eps,
    void* stream) {
  return geovpr_mhsa_f32_parts(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                               gamma, qkv, ctx, out, B, N, D, H, eps, 0, 3,
                               stream);
}

// K4 in f32 on the raster stream x (B, S*S, C), launches first..last (0
// LayerNorm, 1 QKV GEMM, 2 window attention, 3 out projection + x);
// returns a cudaError_t as int. qkv (B*S*S, 3C) holds q unscaled (the
// attention scales it by qscale = dh^-0.5 log2(e)); ctx (B*S*S, C) holds
// LN(x) until the attention writes the context. C = 32 H, S a multiple of
// win, win*win <= 256, 0 <= shift < win; all f32, 16-byte aligned.
extern "C" int geovpr_swin_attn_f32_parts(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* table,
    void* qkv, void* ctx, void* out, int B, int S, int C, int H, int win,
    int shift, float eps, float qscale, int first, int last, void* stream) {
  if (B <= 0 || H <= 0 || C != 32 * H || win <= 0 || win * win > FA_MAX_N ||
      S <= 0 || S % win || shift < 0 || shift >= win || H > 65535 ||
      (long long)B * (S / win) * (S / win) > 0x7fffffff || first < 0 ||
      last > 3 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* qkvf = static_cast<float*>(qkv);
  float* ctxf = static_cast<float*>(ctx);
  cudaError_t e = cudaSuccess;
  for (int part = first; part <= last; ++part) {
    switch (part) {
      case 0:
        e = launch_ln(xf, static_cast<const float*>(ln_scale),
                      static_cast<const float*>(ln_bias), ctxf, M, C, 0, 0,
                      eps, false, s);
        break;
      case 1:
        e = launch_gemm_f32<EPI_BIAS>(ctxf, static_cast<const float*>(wqkv),
                                      static_cast<const float*>(bqkv),
                                      nullptr, nullptr, qkvf, M, 3 * C, C, s);
        break;
      case 2:
        e = launch_raster(qkvf, static_cast<const float*>(table), ctxf, B, S,
                          C, H, win, shift, qscale, s);
        break;
      default:
        e = launch_gemm_f32<EPI_BIAS_RESID>(
            ctxf, static_cast<const float*>(wo), static_cast<const float*>(bo),
            nullptr, xf, static_cast<float*>(out), M, C, C, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" int geovpr_swin_attn_f32(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* table,
    void* qkv, void* ctx, void* out, int B, int S, int C, int H, int win,
    int shift, float eps, float qscale, void* stream) {
  return geovpr_swin_attn_f32_parts(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                    table, qkv, ctx, out, B, S, C, H, win,
                                    shift, eps, qscale, 0, 3, stream);
}

// K9a.f32 on the raster stream x (B, S*S, C), launches first..last (0
// LayerNorm, 1 QKV GEMM with the bias, 2 the window attention, 3 out
// projection with the bias, no residual); returns a cudaError_t as int.
// Outputs: qkv (B*S*S, 3C) unscaled (the attention scales q by qscale =
// dh^-0.5 log2(e) as it stages it, the product the bf16 form writes as
// its scaled q copy), ctx (B*S*S, C; LN(x) until the attention writes the
// context), p (BW, H, N, N) the normalised probabilities in window order,
// y (B*S*S, C). K4.f32's geometry rule; all f32, 16-byte aligned. A launch
// alone reads what the earlier launches of an earlier call left in the
// buffers. geovpr_f32_serving_init must have run on the current device.
extern "C" int geovpr_swin_f32_train_fwd_parts(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* table,
    void* qkv, void* ctx, void* p, void* y, int B, int S, int C, int H,
    int win, int shift, float eps, float qscale, int first, int last,
    void* stream) {
  if (B <= 0 || H <= 0 || C != 32 * H || win <= 0 || win * win > FA_MAX_N ||
      S <= 0 || S % win || shift < 0 || shift >= win || H > 65535 ||
      (long long)B * (S / win) * (S / win) > 0x7fffffff || first < 0 ||
      last > 3 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* qkvf = static_cast<float*>(qkv);
  float* ctxf = static_cast<float*>(ctx);
  cudaError_t e = cudaSuccess;
  for (int part = first; part <= last; ++part) {
    switch (part) {
      case 0:
        e = launch_ln(static_cast<const float*>(x),
                      static_cast<const float*>(ln_scale),
                      static_cast<const float*>(ln_bias), ctxf, M, C, 0, 0,
                      eps, false, s);
        break;
      case 1:
        e = launch_gemm_f32<EPI_BIAS>(ctxf, static_cast<const float*>(wqkv),
                                      static_cast<const float*>(bqkv),
                                      nullptr, nullptr, qkvf, M, 3 * C, C, s);
        break;
      case 2:
        e = launch_train_attn(qkvf, static_cast<const float*>(table), ctxf,
                              static_cast<float*>(p), B, S, C, H, win, shift,
                              qscale, s);
        break;
      default:
        e = launch_gemm_f32<EPI_BIAS>(ctxf, static_cast<const float*>(wo),
                                      static_cast<const float*>(bo), nullptr,
                                      nullptr, static_cast<float*>(y), M, C,
                                      C, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" int geovpr_swin_f32_train_fwd(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* table,
    void* qkv, void* ctx, void* p, void* y, int B, int S, int C, int H,
    int win, int shift, float eps, float qscale, void* stream) {
  return geovpr_swin_f32_train_fwd_parts(x, ln_scale, ln_bias, wqkv, bqkv, wo,
                                         bo, table, qkv, ctx, p, y, B, S, C, H,
                                         win, shift, eps, qscale, 0, 3,
                                         stream);
}

// K6 in f32, launches first..last (0 merge-LN into lnbuf (B*S*S/4, 4C), 1
// the product with w (4C, 2C) into out (B*S*S/4, 2C)); returns a
// cudaError_t as int. C % 4 == 0, S even; all f32, 16-byte aligned.
extern "C" int geovpr_patch_merge_f32_parts(
    const void* x, const void* ln_scale, const void* ln_bias, const void* w,
    void* lnbuf, void* out, int B, int S, int C, float eps, int first,
    int last, void* stream) {
  if (B <= 0 || S <= 0 || S % 2 || C <= 0 || C % 4 || first < 0 ||
      last > 1 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M2 = B * (S / 2) * (S / 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lnf = static_cast<float*>(lnbuf);
  cudaError_t e = cudaSuccess;
  for (int part = first; part <= last; ++part) {
    if (part == 0)
      e = launch_ln(static_cast<const float*>(x),
                    static_cast<const float*>(ln_scale),
                    static_cast<const float*>(ln_bias), lnf, M2, 4 * C, S, C,
                    eps, true, s);
    else
      e = launch_gemm_f32<EPI_NONE>(lnf, static_cast<const float*>(w),
                                    nullptr, nullptr, nullptr,
                                    static_cast<float*>(out), M2, 2 * C,
                                    4 * C, s);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

extern "C" int geovpr_patch_merge_f32(const void* x, const void* ln_scale,
                                      const void* ln_bias, const void* w,
                                      void* lnbuf, void* out, int B, int S,
                                      int C, float eps, void* stream) {
  return geovpr_patch_merge_f32_parts(x, ln_scale, ln_bias, w, lnbuf, out, B,
                                      S, C, eps, 0, 1, stream);
}

// K7 in f32 on JAX's operands: q, k, v and out (BW, H, N, 32), bias (H, N,
// N), mask (nW, N, N) or null (BW a multiple of nW), all f32 and
// contiguous; 1 <= N <= 256. Returns a cudaError_t as int.
extern "C" int geovpr_window_attention_f32(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           const void* mask, void* out,
                                           int BW, int H, int N, int nW,
                                           float qscale, void* stream) {
  if (BW <= 0 || H <= 0 || H > 65535 || N <= 0 || N > FA_MAX_N ||
      (mask && (nW <= 0 || BW % nW)))
    return (int)cudaErrorInvalidValue;
  FaArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<float*>(out);
  a.N = N;
  a.H = H;
  a.ld = 32;
  a.ldo = 32;
  a.W = 1;
  a.nW = mask ? nW : 1;
  const int nblk = window_blocks(N);
  a.qrows = (N + nblk - 1) / nblk;
  a.scale = qscale;
  return (int)launch_attn<32, FA_SPLIT>(a, dim3(BW, H, nblk),
                                        static_cast<cudaStream_t>(stream));
}

// K7 in f32 on the raster qkv (B, S*S, 3C) of the window-attention half:
// the context (B, S*S, C) into out; table ((2W-1)^2, H); C = 32 H, W*W <=
// 256, S a multiple of W, 0 <= shift < W. Returns a cudaError_t as int.
extern "C" int geovpr_window_attention_raster_f32(
    const void* qkv, const void* table, void* out, int B, int S, int C, int H,
    int W, int shift, float qscale, void* stream) {
  if (B <= 0 || H <= 0 || H > 65535 || C != 32 * H || W <= 0 ||
      W * W > FA_MAX_N || S <= 0 || S % W || shift < 0 || shift >= W ||
      (long long)B * (S / W) * (S / W) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return (int)launch_raster(static_cast<const float*>(qkv),
                            static_cast<const float*>(table),
                            static_cast<float*>(out), B, S, C, H, W, shift,
                            qscale, static_cast<cudaStream_t>(stream));
}
