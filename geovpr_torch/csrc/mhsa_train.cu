// The ViT attention half-block's training backward for Hopper (sm_90a), on
// the (B, N, D) token stream of a DINOv2 block, head dim 64, from the
// residuals of the training forward K8a:
//
//   K8a (forward):  K1 (mhsa.cu), whose launches write qkv (post-bias,
//                   unscaled) and ctx to device memory; the training
//                   forward keeps them. The p that the kernels here
//                   recompute (vit_attn.cuh) is the one its attention
//                   rounds to bf16.
//   K8b (core bwd): dqkv from the saved qkv and da = dL/dctx, with p
//                   recomputed
//   K8c (all bwd):  dy = g gamma, da = dy Wo^T, dgamma (the y = ctx Wo + bo
//                   recompute), dWo, dbo, the core, the LN recompute, dWqkv,
//                   dbqkv, dh = dqkv Wqkv^T, the LN VJP -> dx = g + dx_ln,
//                   dls, dlb
//
// Replaces geovpr/ops/pallas_mhsa.py::_attn_bwd_pallas (_attn_bwd_kernel,
// _attn_bwd_kernel_v3) and _mhsa_bwd_all_pallas (_mhsa_bwd_all_kernel).
//
// Numerics follow JAX's masked bodies (_attn_bwd_kernel,
// _mhsa_bwd_all_kernel): p = exp(s - max) / sum recomputed in f32 from
// s = f32(q k^T) * dh^-0.5 with the keys >= N masked; dp = da v^T, ds =
// p (dp - sum_j dp p) in f32, ds * dh^-0.5 rounded to bf16 before dq = ds k
// and dk = ds^T q, dv = bf16(p)^T da. K8c rounds dy = g gamma, da, the LN
// output and dh to bf16 where JAX rounds them, sums dx = g + dx_ln in f32
// and every weight gradient in f32 over all rows.
//
// Cross-CTA sums (the weight and bias gradients, dgamma, dls, dlb) are
// partials per CTA that one reduce_partials launch adds in a fixed order
// (train_gemm.cuh); dk and dv sum over all queries inside the CTA of their
// key tile. No atomics, so a training step repeats bit for bit.
//
// What bounds it on the H100, at DINOv2-B/14 training shapes (B = 16,
// N = 257, D = 768, 12 heads; M = 4,112 rows): K8c ~52 GFLOP (GEMMs of
// 18 M D^2 and five N x N x dh products per head) against ~58 MB: 0.052 ms
// at 989 TFLOP/s, bound by operations; K8b ~8.1 GFLOP against ~44 MB (qkv,
// da, dqkv): 0.013 ms at 3.35 TB/s, bytes. The measured times, from
// chip_smoke.py, are in PERF.md beside the card and its power limit. This
// first version keeps JAX's structure with simple parts: the GEMMs are
// train_gemm.cuh's WMMA kernels without a copy pipeline, the attention
// loops are vit_attn.cuh's mma.sync tiles, p is recomputed in
// three passes (the row statistics, sum_j dp p, then ds and dq) in the dq
// half of the core backward, whose dk/dv half reads the statistics back;
// da, dqkv and the partial sums cross device memory between launches.
// wgmma/TMA and keeping dqkv on chip are the first things a faster version
// changes. The kernels allocate nothing; the caller passes outputs and
// scratch.

#include "train_gemm.cuh"
#include "vit_attn.cuh"

namespace {

// ------------------------------------------------------------ K8b core ----
// Two launches over grid (tiles of 64, H, B). The dq half: per query tile,
// the row statistics (pass 1), sum_j dp p (pass 2), then ds, ds_b =
// bf16(ds * scale) and dq = ds_b k (pass 3); it stores dq and each row's
// (max, sum, sum_j dp p) as stats[(b*N + row) * H + h]. The dk/dv half: per
// key tile, over all query tiles, p from those statistics, dv += bf16(p)^T da
// and dk += ds_b^T q, summed in registers in query order.
__global__ void __launch_bounds__(VT_THREADS)
vit_attn_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ da,
                       bf16* __restrict__ dqkv, float4* __restrict__ stats,
                       int N, int D, int H, float scale) {
  __shared__ __align__(16) bf16 q_s[VT_TILE];
  __shared__ __align__(16) bf16 da_s[VT_TILE];
  __shared__ __align__(16) bf16 k_s[VT_TILE];
  __shared__ __align__(16) bf16 v_s[VT_TILE];
  __shared__ __align__(16) bf16 kt_s[VT_DH * VT_TLD];
  const int q0 = blockIdx.x * VT_CH;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t ld = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * N * ld + h * VT_DH;
  const bf16* dab = da + (size_t)b * N * D + h * VT_DH;

  load_rows(q_s, base, q0, N, ld);
  load_rows(da_s, dab, q0, N, D);
  __syncthreads();
  uint32_t qa[4][4], dfr[4][4];
  a_frags(q_s, warp * 16 + g, t, qa);
  a_frags(da_s, warp * 16 + g, t, dfr);
  RowStat st0, st1;
  row_stats(qa, k_s, base + D, N, ld, scale, st0, st1);

  // pass 2: sum_j dp p of rows g, g + 8
  float sub0 = 0.f, sub1 = 0.f;
  for (int k0 = 0; k0 < N; k0 += VT_CH) {
    __syncthreads();
    load_rows(k_s, base + D, k0, N, ld);
    load_rows(v_s, base + 2 * D, k0, N, ld);
    __syncthreads();
#pragma unroll
    for (int kg = 0; kg < VT_CH / 8; ++kg) {
      float s[4], dp[4];
      tile_dot(qa, k_s, kg * 8 + g, t, s);
      tile_dot(dfr, v_s, kg * 8 + g, t, dp);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + kg * 8 + 2 * t + (e & 1) >= N) continue;
        if (e >= 2) sub1 += dp[e] * prob(s[e], scale, st1);
        else sub0 += dp[e] * prob(s[e], scale, st0);
      }
    }
  }
  sub0 = quad_sum(sub0);
  sub1 = quad_sum(sub1);

  // pass 3: ds, ds_b and dq = ds_b k
  float dq[8][4];
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[jn][e] = 0.f;
  for (int k0 = 0; k0 < N; k0 += VT_CH) {
    __syncthreads();
    load_rows(k_s, base + D, k0, N, ld);
    load_rows(v_s, base + 2 * D, k0, N, ld);
    load_cols(kt_s, base + D, k0, N, ld);
    __syncthreads();
#pragma unroll
    for (int kt = 0; kt < VT_CH / 16; ++kt) {
      float ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s[4], dp[4];
        tile_dot(qa, k_s, kt * 16 + j * 8 + g, t, s);
        tile_dot(dfr, v_s, kt * 16 + j * 8 + g, t, dp);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          const float p = k0 + kt * 16 + j * 8 + 2 * t + (e & 1) < N
                              ? prob(s[e], scale, hi ? st1 : st0)
                              : 0.f;
          ds[j][e] = p * (dp[e] - (hi ? sub1 : sub0)) * scale;
        }
      }
      uint32_t dsa[4];
      pack_a(ds, dsa);
      acc_tile(dq, dsa, kt_s, kt * 16, g, t);
    }
  }
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= N) continue;
    bf16* dst = dqkv + ((size_t)b * N + row) * ld + h * VT_DH + 2 * t;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
      *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) =
          __floats2bfloat162_rn(dq[jn][2 * half], dq[jn][2 * half + 1]);
    if (t == 0) {
      const RowStat& st = half ? st1 : st0;
      stats[((size_t)b * N + row) * H + h] =
          make_float4(st.m, st.l, half ? sub1 : sub0, 0.f);
    }
  }
}

__global__ void __launch_bounds__(VT_THREADS)
vit_attn_bwd_dkdv_kernel(const bf16* __restrict__ qkv,
                         const bf16* __restrict__ da,
                         const float4* __restrict__ stats,
                         bf16* __restrict__ dqkv, int N, int D, int H,
                         float scale) {
  // the key tile's k and v rows first, then each query tile's q and da
  // rows in the same buffers
  __shared__ __align__(16) bf16 q_s[VT_TILE];
  __shared__ __align__(16) bf16 da_s[VT_TILE];
  __shared__ __align__(16) bf16 qt_s[VT_DH * VT_TLD];
  __shared__ __align__(16) bf16 dat_s[VT_DH * VT_TLD];
  __shared__ float4 st_s[VT_CH];
  const int k0 = blockIdx.x * VT_CH;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t ld = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * N * ld + h * VT_DH;
  const bf16* dab = da + (size_t)b * N * D + h * VT_DH;

  load_rows(q_s, base + D, k0, N, ld);
  load_rows(da_s, base + 2 * D, k0, N, ld);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  a_frags(q_s, warp * 16 + g, t, ka);
  a_frags(da_s, warp * 16 + g, t, va);

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[jn][e] = 0.f;
      dv[jn][e] = 0.f;
    }
  for (int q0 = 0; q0 < N; q0 += VT_CH) {
    __syncthreads();
    load_rows(q_s, base, q0, N, ld);
    load_rows(da_s, dab, q0, N, D);
    load_cols(qt_s, base, q0, N, ld);
    load_cols(dat_s, dab, q0, N, D);
    for (int i = threadIdx.x; i < VT_CH; i += VT_THREADS)
      st_s[i] = q0 + i < N ? stats[((size_t)b * N + q0 + i) * H + h]
                           : make_float4(0.f, 1.f, 0.f, 0.f);
    __syncthreads();
#pragma unroll
    for (int qt = 0; qt < VT_CH / 16; ++qt) {
      // p^T and ds_b^T tiles: rows the warp's keys g, g + 8, columns queries
      float p[2][4], ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s[4], dp[4];
        tile_dot(ka, q_s, qt * 16 + j * 8 + g, t, s);
        tile_dot(va, da_s, qt * 16 + j * 8 + g, t, dp);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qt * 16 + j * 8 + 2 * t + (e & 1);
          const float4 sq = st_s[qi];
          const float pv =
              q0 + qi < N ? prob(s[e], scale, RowStat{sq.x, sq.y}) : 0.f;
          p[j][e] = pv;
          ds[j][e] = pv * (dp[e] - sq.z) * scale;
        }
      }
      uint32_t pa[4], dsa[4];
      pack_a(p, pa);
      pack_a(ds, dsa);
      acc_tile(dv, pa, dat_s, qt * 16, g, t);
      acc_tile(dk, dsa, qt_s, qt * 16, g, t);
    }
  }
  const int r0 = k0 + warp * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= N) continue;
    bf16* dst = dqkv + ((size_t)b * N + row) * ld + h * VT_DH + 2 * t;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      *reinterpret_cast<__nv_bfloat162*>(dst + D + jn * 8) =
          __floats2bfloat162_rn(dk[jn][2 * half], dk[jn][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2 * D + jn * 8) =
          __floats2bfloat162_rn(dv[jn][2 * half], dv[jn][2 * half + 1]);
    }
  }
}

// out = bf16(x * mul[col]) in f32 over an (M, C) bf16 matrix
__global__ void scale_cols_kernel(const bf16* __restrict__ x,
                                  const float* __restrict__ mul, size_t n,
                                  int C, bf16* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16(__bfloat162float(x[i]) * mul[i % C]);
}

// ---------------------------------------------------------------- host ----

bool vit_shapes_ok(int B, int N, int D, int H) {
  return B > 0 && N > 0 && H > 0 && B <= 65535 && H <= 65535 &&
         D == H * VT_DH && (long long)B * N <= 0x7fffffff &&
         ((long long)B * N + GEMM_BM - 1) / GEMM_BM <= 65535;
}

cudaError_t vit_core_bwd(cudaStream_t st, const bf16* qkv, const bf16* da,
                         bf16* dqkv, float4* stats, int B, int N, int D,
                         int H, float scale) {
  const dim3 grid(cdiv(N, VT_CH), H, B);
  vit_attn_bwd_dq_kernel<<<grid, VT_THREADS, 0, st>>>(qkv, da, dqkv, stats, N,
                                                      D, H, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  vit_attn_bwd_dkdv_kernel<<<grid, VT_THREADS, 0, st>>>(qkv, da, stats, dqkv,
                                                        N, D, H, scale);
  return cudaGetLastError();
}

// f32 scratch K8c needs (the largest partial-sum buffer of its launches)
long long vit_bwd_scratch_floats(int M, int D) {
  int s1, c1, s3, c3;
  split_rows(M, cdiv(D, TG_BM) * cdiv(D, TG_BN), &s1, &c1);
  split_rows(M, cdiv(D, TG_BM) * cdiv(3 * D, TG_BN), &s3, &c3);
  long long need = (long long)s1 * D * D;
  need = std::max(need, (long long)s3 * D * 3 * D);
  need = std::max(need, (long long)cdiv(M, TG_BM) * D);
  need = std::max(need, (long long)colsum_parts(M, 3 * D) * 3 * D);
  need = std::max(need, (long long)colsum_parts(M, D) * D);
  need = std::max(need, 2LL * LN_VJP_BLOCKS * LN_VJP_WARPS * D);
  return need;
}

}  // namespace

// Floats of f32 scratch geovpr_vit_train_bwd_all takes as `part`.
extern "C" long long geovpr_vit_train_scratch_floats(int B, int N, int D) {
  return vit_bwd_scratch_floats(B * N, D);
}

// K8b. qkv (B*N, 3D), da (B*N, D) bf16 -> dqkv (B*N, 3D) bf16; scratch
// stats (B*N*H float4). scale = dh^-0.5.
extern "C" int geovpr_vit_train_bwd_core(const void* qkv, const void* da,
                                         void* dqkv, void* stats, int B,
                                         int N, int D, int H, float scale,
                                         void* stream) {
  if (!vit_shapes_ok(B, N, D, H)) return (int)cudaErrorInvalidValue;
  return (int)vit_core_bwd(static_cast<cudaStream_t>(stream),
                           static_cast<const bf16*>(qkv),
                           static_cast<const bf16*>(da), static_cast<bf16*>(dqkv),
                           static_cast<float4*>(stats), B, N, D, H, scale);
}

// K8c. Inputs: x, ctx, g (B*N, D) and qkv (B*N, 3D) bf16; wqkv (D, 3D), wo
// (D, D) bf16; bo, gamma, ln_scale, ln_bias f32. Outputs: dx (B*N, D) bf16;
// dwqkv (D, 3D), dbqkv (3D), dwo (D, D), dbo, dgamma, dls, dlb (D) f32.
// Scratch: dy, da, h (B*N, D) and dqkv (B*N, 3D) bf16, stats (B*N) float2,
// astats (B*N*H) float4, part f32 (geovpr_vit_train_scratch_floats).
// D <= 832 (the LN VJP's columns per lane).
extern "C" int geovpr_vit_train_bwd_all(
    const void* x, const void* qkv, const void* ctx, const void* g,
    const void* wqkv, const void* wo, const void* bo, const void* gamma,
    const void* ln_scale, const void* ln_bias, void* dy, void* da, void* dqkv,
    void* h, void* stats, void* astats, void* part, void* dx, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* dgamma, void* dls, void* dlb,
    int B, int N, int D, int H, float eps, float scale, void* stream) {
  if (!vit_shapes_ok(B, N, D, H) || D > 832) return (int)cudaErrorInvalidValue;
  const int M = B * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* ctxb = static_cast<const bf16*>(ctx);
  const bf16* wob = static_cast<const bf16*>(wo);
  bf16* dyb = static_cast<bf16*>(dy);
  bf16* dab = static_cast<bf16*>(da);
  bf16* dqkvb = static_cast<bf16*>(dqkv);
  bf16* hb = static_cast<bf16*>(h);
  float* pt = static_cast<float*>(part);
  cudaError_t e;
  int S1, c1;

  // dy = bf16(g gamma); dbo = sum g gamma in f32
  const size_t n = (size_t)M * D;
  scale_cols_kernel<<<std::min(cdiv(n, 256), 4096), 256, 0, st>>>(
      gb, static_cast<const float*>(gamma), n, D, dyb);
  if ((e = cudaGetLastError()) != cudaSuccess ||
      (e = colsum(st, gb, M, D, pt, static_cast<float*>(dbo),
                  static_cast<const float*>(gamma))) != cudaSuccess)
    return (int)e;
  // da = bf16(dy Wo^T); dWo = ctx^T dy
  if ((e = tgemm<false, true, TG_BF16>(st, dyb, D, wob, D, M, D, D, 1, D,
                                       nullptr, dab, nullptr)) != cudaSuccess)
    return (int)e;
  split_rows(M, cdiv(D, TG_BM) * cdiv(D, TG_BN), &S1, &c1);
  if ((e = tgemm<true, false, TG_F32>(st, ctxb, D, dyb, D, D, D, M, S1, c1,
                                      nullptr, nullptr, pt)) != cudaSuccess ||
      (e = reduce(st, pt, S1, (size_t)D * D, static_cast<float*>(dwo))) !=
          cudaSuccess)
    return (int)e;
  // dgamma = sum g (ctx Wo + bo), y recomputed in f32
  if ((e = tgemm<false, false, TG_GY>(st, ctxb, D, wob, D, M, D, D, 1, D,
                                      static_cast<const float*>(bo), nullptr, pt,
                                      gb)) != cudaSuccess ||
      (e = reduce(st, pt, cdiv(M, TG_BM), D, static_cast<float*>(dgamma))) !=
          cudaSuccess)
    return (int)e;
  // the attention core: dqkv
  if ((e = vit_core_bwd(st, static_cast<const bf16*>(qkv), dab, dqkvb,
                        static_cast<float4*>(astats), B, N, D, H, scale)) !=
      cudaSuccess)
    return (int)e;
  // LN recompute, dWqkv = h^T dqkv, dbqkv = sum dqkv
  ln_stats_kernel<<<cdiv(M, 8), 256, 0, st>>>(
      xb, static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      eps, M, D, hb, static_cast<float2*>(stats));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  split_rows(M, cdiv(D, TG_BM) * cdiv(3 * D, TG_BN), &S1, &c1);
  if ((e = tgemm<true, false, TG_F32>(st, hb, D, dqkvb, 3 * D, D, 3 * D, M, S1,
                                      c1, nullptr, nullptr, pt)) != cudaSuccess ||
      (e = reduce(st, pt, S1, (size_t)D * 3 * D, static_cast<float*>(dwqkv))) !=
          cudaSuccess ||
      (e = colsum(st, dqkvb, M, 3 * D, pt, static_cast<float*>(dbqkv))) !=
          cudaSuccess)
    return (int)e;
  // dh = bf16(dqkv Wqkv^T) into the da buffer, then the LN VJP with + g
  if ((e = tgemm<false, true, TG_BF16>(st, dqkvb, 3 * D,
                                       static_cast<const bf16*>(wqkv), 3 * D, M,
                                       D, 3 * D, 1, 3 * D, nullptr, dab,
                                       nullptr)) != cudaSuccess)
    return (int)e;
  const int parts = LN_VJP_BLOCKS * LN_VJP_WARPS;
  float* pls = pt;
  float* plb = pt + (size_t)parts * D;
  if ((e = ln_vjp(st, xb, dab, static_cast<const float2*>(stats),
                  static_cast<const float*>(ln_scale), gb, M, D,
                  static_cast<bf16*>(dx), pls, plb)) != cudaSuccess ||
      (e = reduce(st, pls, parts, D, static_cast<float*>(dls))) != cudaSuccess)
    return (int)e;
  return (int)reduce(st, plb, parts, D, static_cast<float*>(dlb));
}
