// The bf16 block GEMM with a LayerNorm prologue of K9a's forward
// (swin_train.cu), and the warp helpers and WMMA set-up that
// train_gemm.cuh (K9a's out projection, the row passes of K9c and K8c)
// includes it for, for Hopper (sm_90a):
//
//   qkv(M, Nc) = LN(x)(M, K) @ W(K, Nc) + bias, and q_s = that * qscale on
//   the first qcols columns
//
// x is LayerNorm-ed on load (f32 two-pass statistics, rounded to bf16 in
// shared memory); W is row-major bf16. A 64-row block of x is held whole
// (K + 8 columns) in shared memory and multiplied against 32-row slabs of
// W with WMMA 16x16x16 bf16 tiles and f32 accumulators, 8 warps as 2 x 4
// warp tiles of 32 x 32. The epilogue writes acc + bias to `out` unscaled
// on every column, and (acc + bias) * qscale on the first qcols columns
// to `out2` ((M, qcols), K9a's scaled-q copy), both rounded once from f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 256;  // 8 warps as 2 (rows) x 4 (cols), 32x32 each
constexpr int A_PAD = 8;           // bf16 elements of row padding in smem
constexpr int B_LD = GEMM_BN + 8;
constexpr int C_LD = GEMM_BN + 4;

__host__ __device__ inline size_t gemm_smem_bytes(int K) {
  return (size_t)GEMM_BM * (K + A_PAD) * sizeof(bf16) +
         (size_t)GEMM_BK * B_LD * sizeof(bf16) +
         (size_t)GEMM_BM * C_LD * sizeof(float);
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// qkv = LN(x)(M, K) @ W(K, Nc) + bias into out, and its first qcols
// columns times qscale into out2; W row-major. Requires K % 16 == 0 and
// Nc % 8 == 0.
__global__ void __launch_bounds__(GEMM_THREADS)
ln_qkv_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias, float eps,
                   bf16* __restrict__ out, int M, int K, int Nc, float qscale,
                   int qcols, bf16* __restrict__ out2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = K + A_PAD;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + GEMM_BM * lda;
  float* Cs = reinterpret_cast<float*>(Bs + GEMM_BK * B_LD);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * GEMM_BN;
  const int m0 = blockIdx.y * GEMM_BM;

  // A row block, whole K width, 16 bytes per thread per step; rows past M
  // and the padding columns are zero.
  const int kc = K / 8;
  for (int i = tid; i < GEMM_BM * (lda / 8); i += GEMM_THREADS) {
    const int r = i / (lda / 8);
    const int c8 = i % (lda / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M && c8 < kc)
      v = *reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * K + c8 * 8);
    *reinterpret_cast<uint4*>(As + r * lda + c8 * 8) = v;
  }
  __syncthreads();

  // two-pass f32 statistics per row (mean, then mean squared deviation),
  // as the oracle computes them; one warp per row
  for (int r = warp; r < GEMM_BM; r += GEMM_THREADS / 32) {
    if (m0 + r >= M) continue;
    bf16* row = As + r * lda;
    float s = 0.f;
    for (int c = lane; c < K; c += 32) s += __bfloat162float(row[c]);
    const float mu = warp_sum(s) / K;
    float q = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float d = __bfloat162float(row[c]) - mu;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / K + eps);
    for (int c = lane; c < K; c += 32) {
      const float d = __bfloat162float(row[c]) - mu;
      row[c] = __float2bfloat16(d * rstd * ln_scale[c] + ln_bias[c]);
    }
  }
  __syncthreads();

  const int wm = warp / 4;  // 0..1 -> rows wm*32
  const int wn = warp % 4;  // 0..3 -> cols wn*32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    for (int i = tid; i < GEMM_BK * (GEMM_BN / 8); i += GEMM_THREADS) {
      const int r = i / (GEMM_BN / 8);
      const int c8 = i % (GEMM_BN / 8);
      const int col = n0 + c8 * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k0 + r < K && col < Nc)
        v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * Nc + col);
      *reinterpret_cast<uint4*>(Bs + r * B_LD + c8 * 8) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      if (k0 + kk < K) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * lda + k0 + kk, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < GEMM_BM * GEMM_BN; i += GEMM_THREADS) {
    const int r = i / GEMM_BN;
    const int c = i % GEMM_BN;
    const int row = m0 + r;
    const int col = n0 + c;
    if (row >= M || col >= Nc) continue;
    const float v = Cs[r * C_LD + c] + bias[col];
    if (col < qcols)
      out2[(size_t)row * qcols + col] = __float2bfloat16(v * qscale);
    out[(size_t)row * Nc + col] = __float2bfloat16(v);
  }
}

}  // namespace
