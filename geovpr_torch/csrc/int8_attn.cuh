// The two projections of the w8a8 ViT attention half-block K2
// (mhsa_int8.cu) for Hopper (sm_90a), on int8_common.cuh's GEMM:
//   int8_qkv_kernel:  LN -> int8 -> @ Wqkv_q -> dequant; q|k to int8, v to
//                     bf16 scratch;
//   int8_proj_kernel: int8 ctx @ Wo_q -> dequant [* gamma] + residual.

#pragma once

#include "int8_common.cuh"

namespace {

// 64 rows x 128 columns per CTA.
constexpr int I8_THREADS = 256;
using ProjGemm = Int8Gemm<2, 4>;

__host__ __device__ inline size_t int8_proj_smem_bytes(int D) {
  return (size_t)ProjGemm::BM * (D + 16) + (size_t)ProjGemm::SMEM_B;
}

// x (M, D) bf16 -> LN -> int8 (folded scales) -> @ Wqkv_q (3D x D, k-
// contiguous) -> * sqkv + bqkv; columns [0, 2D) to qk8 (M, 2D) int8,
// [2D, 3D) to v (M, D) bf16.
__global__ void __launch_bounds__(I8_THREADS)
int8_qkv_kernel(const bf16* __restrict__ x,
                const float* __restrict__ ln_scale,
                const float* __restrict__ ln_bias, float eps,
                const int8_t* __restrict__ wt, const float* __restrict__ sc,
                const float* __restrict__ bias, int8_t* __restrict__ qk8,
                bf16* __restrict__ v, int M, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = D + 16;
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + ProjGemm::BM * lda;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * ProjGemm::BN;
  const int m0 = blockIdx.y * ProjGemm::BM;

  for (int r = warp; r < ProjGemm::BM; r += I8_THREADS / 32) {
    if (m0 + r < M) {
      ln_quant_row(x + (size_t)(m0 + r) * D, D, ln_scale, ln_bias, eps,
                   As + r * lda, lane);
    } else {
      for (int c = lane; c < D; c += 32) As[r * lda + c] = 0;
    }
  }
  __syncthreads();

  const int N3 = 3 * D;
  int acc[2][4][4];
  ProjGemm::run(As, lda, wt, n0, N3, D, Bs, acc);
  const int wm = warp / 4;
  const int wn = warp % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      if (col >= N3) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + wm * 32 + mi * 16 + g + 8 * hr;
        if (row >= M) continue;
        const float f0 = (float)acc[mi][ni][2 * hr] * sc[col] + bias[col];
        const float f1 = (float)acc[mi][ni][2 * hr + 1] * sc[col + 1] + bias[col + 1];
        if (col < 2 * D) {
          *reinterpret_cast<char2*>(qk8 + (size_t)row * 2 * D + col) =
              make_char2(round_clip_i8(f0), round_clip_i8(f1));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(v + (size_t)row * D + col - 2 * D) =
              __floats2bfloat162_rn(f0, f1);
        }
      }
    }
}

// ctx8 (M, D) int8 @ Wo_q (D x D, k-contiguous) -> * so + bo -> * gamma
// (when given) + x -> out (M, D) bf16.
__global__ void __launch_bounds__(I8_THREADS)
int8_proj_kernel(const int8_t* __restrict__ ctx8,
                 const int8_t* __restrict__ wt, const float* __restrict__ so,
                 const float* __restrict__ bo,
                 const float* __restrict__ gamma, const bf16* __restrict__ x,
                 bf16* __restrict__ out, int M, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = D + 16;
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + ProjGemm::BM * lda;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * ProjGemm::BN;
  const int m0 = blockIdx.y * ProjGemm::BM;

  const int kc = D / 16;
  for (int i = threadIdx.x; i < ProjGemm::BM * kc; i += I8_THREADS) {
    const int r = i / kc;
    const int c = i % kc;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m0 + r < M)
      val = *reinterpret_cast<const uint4*>(ctx8 + (size_t)(m0 + r) * D + c * 16);
    *reinterpret_cast<uint4*>(As + r * lda + c * 16) = val;
  }
  __syncthreads();

  int acc[2][4][4];
  ProjGemm::run(As, lda, wt, n0, D, D, Bs, acc);
  const int wm = warp / 4;
  const int wn = warp % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
      if (col >= D) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + wm * 32 + mi * 16 + g + 8 * hr;
        if (row >= M) continue;
        const size_t o = (size_t)row * D + col;
        const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(x + o);
        float y0 = (float)acc[mi][ni][2 * hr] * so[col] + bo[col];
        float y1 = (float)acc[mi][ni][2 * hr + 1] * so[col + 1] + bo[col + 1];
        if (gamma) {
          y0 *= gamma[col];
          y1 *= gamma[col + 1];
        }
        y0 += __low2float(r2);
        y1 += __high2float(r2);
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(y0, y1);
      }
    }
}

}  // namespace
