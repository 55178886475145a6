// The f32 FFMA GEMM and warp helpers of the f32 kernels for Hopper
// (sm_90a): the serving forms of K1, K4 and K6 (f32_serving.cu) and the
// training backward K8c (f32_train.cu). f32 operands, f32 sums on the CUDA
// cores, each output a sequential sum over k; no TF32 (a single-pass TF32
// product keeps a 10-bit mantissa).
//
// f32_gemm_kernel<kEpi, kTA, kTW>: out (M, N) = epilogue(A W), 128 x 128
// tiles of 256 threads, 8 x 8 outputs a thread (two 4 x 4 quadrants 64
// apart, so that the fragments are float4 reads without bank conflicts),
// k tiles of 8 double-buffered in shared memory with the next tile's
// global loads in registers during the current tile's FFMAs. The operand
// layouts:
// - A (M, K) row-major; with kTA, A^T (K, M) row-major: the weight
//   gradient a^T b summed over K rows, each blockIdx.z one chunk of
//   `kchunk` rows whose f32 partial goes to out + z M N (the partials are
//   added in order by the caller: no atomics);
// - W (K, N) row-major (an (in, out) weight); with kTW, W^T (N, K)
//   row-major: the product A W_t^T with an (in, out) weight W_t read
//   transposed, as the backward's da = dy Wo^T and dh = dqkv Wqkv^T.
// Epilogues: none, + bias (QKV), + bias + res (K4's out projection),
// (+ bias) * gamma + res (K1's), and EPI_GY: no output tile, but the
// column sums over the tile's rows of res (M, N) * (A W + bias), one
// partial row a row tile at out + blockIdx.y N (K8c's dgamma).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float4 f32_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float f32_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float f32_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int GB_M = 128, GB_N = 128, GB_K = 8, GB_THREADS = 256;
enum {
  EPI_NONE = 0,
  EPI_BIAS = 1,
  EPI_BIAS_RESID = 2,
  EPI_GAMMA_RESID = 3,
  EPI_GY = 4
};

// N % 4 == 0, every pointer 16-byte aligned; K % 8 == 0 unless kTA (a
// chunk's rows past K read as zero), M % 4 == 0 with kTA. Rows past M read
// as zero and are not stored; columns past N likewise, in whole float4s.
template <int kEpi, bool kTA = false, bool kTW = false>
__global__ void __launch_bounds__(GB_THREADS)
f32_gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias,
                const float* __restrict__ gamma,
                const float* __restrict__ res, float* __restrict__ out,
                int M, int N, int K, int kchunk) {
  __shared__ __align__(16) float As[2][GB_K][GB_M];  // A tile, k-major
  __shared__ __align__(16) float Bs[2][GB_K][GB_N];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;
  const int k_begin = kTA ? blockIdx.z * kchunk : 0;
  const int k_end = kTA ? min(K, k_begin + kchunk) : K;
  // this thread's global loads. A: row ar, k columns ac..ac+3; A^T: k
  // row br, columns bc..bc+3 of M. W: k row br, columns bc..bc+3; W^T:
  // row ar (of N), k columns ac..ac+3
  const int ar = tid >> 1, ac = (tid & 1) * 4;
  const int br = tid >> 5, bc = (tid & 31) * 4;
  const bool a_in = kTA ? m0 + bc < M : m0 + ar < M;
  const bool b_in = kTW ? n0 + ar < N : n0 + bc < N;
  const float* a_src =
      kTA ? A + (long long)(k_begin + br) * M + (a_in ? m0 + bc : 0)
          : A + (long long)(a_in ? m0 + ar : 0) * K + ac;
  const float* b_src =
      kTW ? W + (long long)(b_in ? n0 + ar : 0) * K + ac
          : W + (long long)(k_begin + br) * N + (b_in ? n0 + bc : 0);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // this thread's outputs: rows ty*4 + i and 64 + ty*4 + i, columns tx*4 +
  // j and 64 + tx*4 + j
  const int ty = tid / 16, tx = tid % 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // the k tile at k0 (relative to k_begin) into registers
  // (with kTA, rows of A^T and W past the chunk's end read as zero)
  auto load_a = [&](int k0) -> float4 {
    if (kTA)
      return a_in && k_begin + k0 + br < k_end
                 ? f32_ld4(a_src + (long long)k0 * M) : zero;
    return a_in ? f32_ld4(a_src + k0) : zero;
  };
  auto load_b = [&](int k0) -> float4 {
    if (kTW) return b_in ? f32_ld4(b_src + k0) : zero;
    return b_in && (!kTA || k_begin + k0 + br < k_end)
               ? f32_ld4(b_src + (long long)k0 * N) : zero;
  };
  float4 ra = load_a(0);
  float4 rb = load_b(0);
  auto stage = [&](int buf) {
    if (kTA) {
      *reinterpret_cast<float4*>(&As[buf][br][bc]) = ra;
    } else {
      As[buf][ac + 0][ar] = ra.x;
      As[buf][ac + 1][ar] = ra.y;
      As[buf][ac + 2][ar] = ra.z;
      As[buf][ac + 3][ar] = ra.w;
    }
    if (kTW) {
      Bs[buf][ac + 0][ar] = rb.x;
      Bs[buf][ac + 1][ar] = rb.y;
      Bs[buf][ac + 2][ar] = rb.z;
      Bs[buf][ac + 3][ar] = rb.w;
    } else {
      *reinterpret_cast<float4*>(&Bs[buf][br][bc]) = rb;
    }
  };
  stage(0);
  __syncthreads();
  const int ktiles = (k_end - k_begin + GB_K - 1) / GB_K;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) {
      ra = load_a((kt + 1) * GB_K);
      rb = load_b((kt + 1) * GB_K);
    }
#pragma unroll
    for (int k = 0; k < GB_K; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stage(cur ^ 1);
    __syncthreads();
  }

  if (kEpi == EPI_GY) {
    // each column's sum over this thread's rows (in row order), then over
    // the 16 row groups in order, through the A tile's shared memory
    float* colp = &As[0][0][0];  // [16][GB_N]
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      float4 b4 = zero;
      if (n < N) b4 = f32_ld4(bias + n);
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
      float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        if (m >= M || n >= N) continue;
        const float4 g4 = f32_ld4(res + (long long)m * N + n);
        const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cs[j] = fmaf(gg[j], __fadd_rn(acc[i][4 * half + j], bb[j]), cs[j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        colp[ty * GB_N + half * 64 + tx * 4 + j] = cs[j];
    }
    __syncthreads();
    if (tid < GB_N && n0 + tid < N) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += colp[r * GB_N + tid];
      out[(long long)blockIdx.y * N + n0 + tid] = s;
    }
    return;
  }

  float* o_base = out + (kTA ? (long long)blockIdx.z * M * N : 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      if (n >= N) continue;
      float v[4] = {acc[i][4 * half], acc[i][4 * half + 1],
                    acc[i][4 * half + 2], acc[i][4 * half + 3]};
      if (kEpi != EPI_NONE) {
        const float4 b4 = f32_ld4(bias + n);
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(v[j], bb[j]);
      }
      if (kEpi == EPI_GAMMA_RESID) {
        const float4 g4 = f32_ld4(gamma + n);
        const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(v[j], gg[j]);
      }
      if (kEpi == EPI_BIAS_RESID || kEpi == EPI_GAMMA_RESID) {
        const float4 r4 = f32_ld4(res + (long long)m * N + n);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(v[j], rr[j]);
      }
      *reinterpret_cast<float4*>(o_base + (long long)m * N + n) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// kchunk: with kTA, the rows of K each partial sums (a multiple of 8), and
// the partials cdiv(K, kchunk) are written at out + z M N; else unused.
template <int kEpi, bool kTA = false, bool kTW = false>
cudaError_t launch_gemm_f32(const float* A, const float* W, const float* bias,
                            const float* gamma, const float* res, float* out,
                            int M, int N, int K, cudaStream_t s,
                            int kchunk = 0) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || (M + GB_M - 1) / GB_M > 65535 ||
      (kTA ? (M % 4 || kchunk <= 0 || kchunk % GB_K ||
              (K + kchunk - 1) / kchunk > 65535)
           : K % GB_K))
    return cudaErrorInvalidValue;
  const dim3 grid((N + GB_N - 1) / GB_N, (M + GB_M - 1) / GB_M,
                  kTA ? (K + kchunk - 1) / kchunk : 1);
  f32_gemm_kernel<kEpi, kTA, kTW><<<grid, GB_THREADS, 0, s>>>(
      A, W, bias, gamma, res, out, M, N, K, kchunk);
  return cudaGetLastError();
}

}  // namespace
