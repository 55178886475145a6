// The row-stream pieces of the training kernels K9c (swin_train.cu) and
// K8c (mhsa_train.cu), for Hopper (sm_90a): the fixed row chunks of a
// weight gradient's partial sums (their products run on hopper_gemm.cuh)
// and their fixed-order reduction, column sums, and the LayerNorm
// recompute and VJP, one warp per row. No atomics: every cross-CTA sum is
// a partial per CTA and one reduce_partials launch that adds the partials
// in order, so a training step repeats bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

// TG_BM x TG_BN are the output tiles over which split_rows sizes a weight
// gradient's row chunks (the first port's WMMA GEMM's), TG_BK their step.
constexpr int TG_BM = 64, TG_BN = 64, TG_BK = 32;

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[e] = sum_s part[s * n + e], s in order: the deterministic reduction
// of every partial sum of the training kernels.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int S,
                                       size_t n, float* __restrict__ out) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < S; ++i) s += part[(size_t)i * n + e];
    out[e] = s;
  }
}

// part[z][c] = sum over rows [z * rchunk, (z + 1) * rchunk) of x[row][c],
// each term times mul[c] in f32 where mul is given
__global__ void colsum_partials_kernel(const bf16* __restrict__ x, int M,
                                       int C, int rchunk,
                                       float* __restrict__ part,
                                       const float* __restrict__ mul) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int r1 = min(M, (blockIdx.y + 1) * rchunk);
  float s = 0.f;
  if (mul) {
    const float m = mul[c];
    for (int r = blockIdx.y * rchunk; r < r1; ++r)
      s += __bfloat162float(x[(size_t)r * C + c]) * m;
  } else {
    for (int r = blockIdx.y * rchunk; r < r1; ++r)
      s += __bfloat162float(x[(size_t)r * C + c]);
  }
  part[(size_t)blockIdx.y * C + c] = s;
}

// The LayerNorm of K9a's launch 0 and K9c's LN recompute, one warp per
// row: f32 two-pass statistics (each lane's columns l, l + 32, ... in
// order, then warp_sum's butterfly: the first port's order), h =
// bf16(xhat * ls + lb), and, where stats is given, each row's mean and
// 1/std for the VJP.
__global__ void ln_stats_kernel(const bf16* __restrict__ x,
                               const float* __restrict__ ls,
                               const float* __restrict__ lb, float eps, int M,
                               int C, bf16* __restrict__ h,
                               float2* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += __bfloat162float(xr[c]);
  const float mu = warp_sum(s) / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = __bfloat162float(xr[c]) - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
  for (int c = lane; c < C; c += 32) {
    const float d = __bfloat162float(xr[c]) - mu;
    h[(size_t)row * C + c] = __float2bfloat16(d * rstd * ls[c] + lb[c]);
  }
  if (stats && lane == 0) stats[row] = make_float2(mu, rstd);
}

// The LN VJP of K9c and K8c, one warp per row, CPL = C / 32 columns a lane:
// dx = rstd (dh ls - mean(dh ls) - xhat mean(dh ls xhat)) [+ resid, in
// f32] (bf16), and the
// warp's partial sums of dh xhat (dls) and dh (dlb) over its rows, written
// to part_ls / part_lb at row blockIdx.x * warps + warp.
template <int CPL>
__global__ void __launch_bounds__(256)
ln_vjp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dh,
              const float2* __restrict__ stats, const float* __restrict__ ls,
              const bf16* __restrict__ resid, int M, bf16* __restrict__ dx,
              float* __restrict__ part_ls, float* __restrict__ part_lb) {
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
      xh[i] = (__bfloat162float(x[o]) - st.x) * st.y;
      const float d = __bfloat162float(dh[o]);
      acc_ls[i] += d * xh[i];
      acc_lb[i] += d;
      dxh[i] = d * lsv[i];
      s1 += dxh[i];
      s2 += dxh[i] * xh[i];
    }
    const float m1 = warp_sum(s1) / C;
    const float m2 = warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const size_t o = (size_t)row * C + lane + 32 * i;
      float v = st.y * (dxh[i] - m1 - xh[i] * m2);
      if (resid) v += __bfloat162float(resid[o]);
      dx[o] = __float2bfloat16(v);
    }
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    part_ls[(size_t)wid * C + lane + 32 * i] = acc_ls[i];
    part_lb[(size_t)wid * C + lane + 32 * i] = acc_lb[i];
  }
}


// ---------------------------------------------------------------- host ----

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// split of a reduction over `rows` rows into S chunks (multiples of 32) so
// that about 4 CTAs per SM run: S = ceil(528 / tiles), at most rows / 32,
// tiles counted in TG_BM x TG_BN output tiles (the first port's; K9c's and
// K8c's weight gradients keep these chunks, and so their bits)
void split_rows(int rows, int tiles, int* S, int* chunk) {
  int s = cdiv(528, tiles);
  s = std::max(1, std::min(s, cdiv(rows, TG_BK)));
  int c = cdiv(cdiv(rows, s), TG_BK) * TG_BK;
  *S = cdiv(rows, c);
  *chunk = c;
}

cudaError_t reduce(cudaStream_t st, const float* part, int S, size_t n, float* out) {
  reduce_partials_kernel<<<std::min(cdiv(n, 256), 4096), 256, 0, st>>>(part, S, n, out);
  return cudaGetLastError();
}

// the number of partials `colsum` writes for an (M, C) matrix
int colsum_parts(int M, int C) {
  int S, chunk;
  split_rows(M, cdiv(C, 128), &S, &chunk);
  return S;
}

// column sums of a bf16 (M, C) matrix, each term times mul[c] where mul is
// given, into out (C) through part (colsum_parts * C)
cudaError_t colsum(cudaStream_t st, const bf16* x, int M, int C, float* part,
                   float* out, const float* mul = nullptr) {
  int S, chunk;
  split_rows(M, cdiv(C, 128), &S, &chunk);
  colsum_partials_kernel<<<dim3(cdiv(C, 128), S), 128, 0, st>>>(x, M, C, chunk, part,
                                                                  mul);
  cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : reduce(st, part, S, C, out);
}

constexpr int LN_VJP_BLOCKS = 132;
constexpr int LN_VJP_WARPS = 8;

// ln_vjp_kernel at C = 64 .. 832 (a multiple of 64): dx (bf16, plus resid
// where given) and the partial sums of dls / dlb, LN_VJP_BLOCKS *
// LN_VJP_WARPS rows of C each, at part_ls / part_lb
cudaError_t ln_vjp(cudaStream_t st, const bf16* x, const bf16* dh,
                   const float2* stats, const float* ls, const bf16* resid,
                   int M, int C, bf16* dx, float* part_ls, float* part_lb) {
  switch (C / 32) {
#define GEOVPR_LN_VJP(cpl)                                                   \
  case cpl:                                                                  \
    ln_vjp_kernel<cpl><<<LN_VJP_BLOCKS, LN_VJP_WARPS * 32, 0, st>>>(         \
        x, dh, stats, ls, resid, M, dx, part_ls, part_lb);                   \
    break;
    GEOVPR_LN_VJP(2) GEOVPR_LN_VJP(4) GEOVPR_LN_VJP(6) GEOVPR_LN_VJP(8)
    GEOVPR_LN_VJP(10) GEOVPR_LN_VJP(12) GEOVPR_LN_VJP(14) GEOVPR_LN_VJP(16)
    GEOVPR_LN_VJP(18) GEOVPR_LN_VJP(20) GEOVPR_LN_VJP(22) GEOVPR_LN_VJP(24)
    GEOVPR_LN_VJP(26)
#undef GEOVPR_LN_VJP
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
