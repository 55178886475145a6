// The f32 FFMA GEMM and warp helpers of the f32 kernels for Hopper
// (sm_90a): the serving forms of K1, K4 and K6 (f32_serving.cu) and the
// training backward K8c (f32_train.cu). f32 operands, f32 sums on the CUDA
// cores, each output a sequential sum over k; no TF32 (a single-pass TF32
// product keeps a 10-bit mantissa).
//
// f32_gemm_kernel<kEpi, kTA, kTW>: out (M, N) = epilogue(A W), 128 x 64
// output tiles of 128 threads (four warps), 8 x 8 outputs a thread; k
// tiles of 16 through a three-stage ring in shared memory that every
// thread fills by 16-byte cp.async (zero-filled past the matrix's edges),
// each stage's completion counted on an mbarrier (cp.async.mbarrier.
// arrive.noinc, one arrival a thread), one __syncthreads a k tile before
// its stage is refilled. The ring is 46 KB, under the 48 KB of static
// shared memory, so three CTAs share an SM: at M = 4112 and N = 768 (K8c's
// da, dh and dgamma products at DINOv2-B/14's B = 16) the 33 x 12 = 396
// tiles are one wave of three CTAs on each of the 132 SMs. An operand
// whose k runs along its rows in memory (A, W^T) is stored as it is read,
// rows padded to 20 floats, and read as float4s over 4 k; one whose k is
// its row index (A^T, W) as k-major rows of 128 or 64 floats, read as
// float4s along m or n. A thread's rows or columns are strided (16 or 8
// apart) where it reads along k, contiguous quads where it reads along m
// or n: either way a warp's 16-byte reads touch distinct banks. The
// operand layouts:
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
// partial row a 128-row tile at out + blockIdx.y N (K8c's dgamma).
//
// f32_gemm_wide_kernel<kEpi>: the same product for A (M, K) and W (K, N)
// with an output tile, in 128 x 128 tiles of 256 threads, 8 x 8 outputs a
// thread; k tiles of 8 double-buffered in shared memory, A's stored
// k-major (each thread's 16-byte global read of 4 k transposed into four
// columns), so that a thread reads its 8 rows and 8 columns of each k as
// four float4s; the next tile's global loads wait in registers during
// the current tile's FFMAs. Each A tile is read from L2 once a 128-column
// tile, half as often as the 128 x 64 tiles read it.
//
// launch_gemm_f32 chooses the tile by the grid (gemm_f32_wide_tiles): the
// 128 x 128 tiles where the product allows them and its 128 x 64 tiles
// would take more than three waves of three CTAs on each SM (K1.f32's
// projections at B = 64, most of K4.f32's and K9a.f32's, K6.f32's at C <=
// 256), the 128 x 64 tiles elsewhere (every product of M = 4112,
// K8a.f32's and K8c.f32's, where three waves are whole). Each output is the same sequential sum
// over k in either kernel, so the choice changes no bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// a 16-byte cp.async of src into shared dst, `bytes` (16, or 0: all
// zero-filled, src unread) of it read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes)
               : "memory");
}

// one arrival on bar once this thread's earlier cp.asyncs have landed (the
// barrier's expected count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// element q (0..3, known at compile time) of a float4
__device__ __forceinline__ float f4_at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

constexpr int GB_M = 128, GB_N = 64, GB_K = 16, GB_THREADS = 128;
constexpr int GB_STAGES = 3;
constexpr int GB_LDK = GB_K + 4;  // row stride of a k-contiguous tile
enum {
  EPI_NONE = 0,
  EPI_BIAS = 1,
  EPI_BIAS_RESID = 2,
  EPI_GAMMA_RESID = 3,
  EPI_GY = 4
};

// N % 4 == 0, every pointer 16-byte aligned; K % 8 == 0 unless kTA (a
// chunk's rows past K read as zero), M % 4 == 0 with kTA. Rows past M read
// as zero and are not stored; columns past N likewise.
template <int kEpi, bool kTA = false, bool kTW = false>
__global__ void __launch_bounds__(GB_THREADS, 3)
f32_gemm_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias,
                const float* __restrict__ gamma,
                const float* __restrict__ res, float* __restrict__ out,
                int M, int N, int K, int kchunk) {
  // a stage: A's tile (k-major [k][m] with kTA, else [m][k]) and W's
  // ([n][k] with kTW, else [k][n])
  constexpr int kAF = kTA ? GB_K * GB_M : GB_M * GB_LDK;
  constexpr int kBF = kTW ? GB_N * GB_LDK : GB_K * GB_N;
  __shared__ __align__(16) float As[GB_STAGES][kAF];
  __shared__ __align__(16) float Bs[GB_STAGES][kBF];
  __shared__ __align__(8) uint64_t full[GB_STAGES];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;
  const int k_begin = kTA ? blockIdx.z * kchunk : 0;
  const int k_end = kTA ? min(K, k_begin + kchunk) : K;
  const int ktiles = (k_end - k_begin + GB_K - 1) / GB_K;
  // this thread's outputs: rows row(i), columns col(j) of the tile
  const int ty = tid >> 3, tx = tid & 7;
  auto row = [&](int i) {
    return kTA ? (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4) : ty + 16 * i;
  };
  auto col = [&](int j) {
    return kTW ? tx + 8 * j : (j < 4 ? 4 * tx + j : 32 + 4 * tx + j - 4);
  };
  if (tid < GB_STAGES) mbar_init(&full[tid], GB_THREADS);
  mbar_fence_init();
  __syncthreads();

  // k tile kt (relative to k_begin) into stage s: 512 chunks of A's tile
  // and 256 of W's, 16 bytes each, those past the edges zero-filled
  auto load = [&](int kt, int s) {
    const int k0 = k_begin + kt * GB_K;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + GB_THREADS * i;
      if (kTA) {
        const int kr = c >> 5, mc = (c & 31) * 4;
        const bool in = k0 + kr < k_end && m0 + mc < M;
        cp_async16(&As[s][kr * GB_M + mc],
                   in ? A + (long long)(k0 + kr) * M + m0 + mc : A,
                   in ? 16 : 0);
      } else {
        const int r = c >> 2, kc = (c & 3) * 4;
        const bool in = m0 + r < M && k0 + kc < k_end;
        cp_async16(&As[s][r * GB_LDK + kc],
                   in ? A + (long long)(m0 + r) * K + k0 + kc : A,
                   in ? 16 : 0);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + GB_THREADS * i;
      if (kTW) {
        const int r = c >> 2, kc = (c & 3) * 4;
        const bool in = n0 + r < N && k0 + kc < k_end;
        cp_async16(&Bs[s][r * GB_LDK + kc],
                   in ? W + (long long)(n0 + r) * K + k0 + kc : W,
                   in ? 16 : 0);
      } else {
        const int kr = c >> 4, nc = (c & 15) * 4;
        const bool in = k0 + kr < k_end && n0 + nc < N;
        cp_async16(&Bs[s][kr * GB_N + nc],
                   in ? W + (long long)(k0 + kr) * N + n0 + nc : W,
                   in ? 16 : 0);
      }
    }
    cp_async_arrive(&full[s]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < GB_STAGES - 1 && s < ktiles; ++s) load(s, s);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % GB_STAGES;
    mbar_wait(&full[s], (kt / GB_STAGES) & 1);
    // every thread is past tile kt - 1, whose stage the next load refills
    __syncthreads();
    if (kt + GB_STAGES - 1 < ktiles)
      load(kt + GB_STAGES - 1, (kt + GB_STAGES - 1) % GB_STAGES);
    const float* as = As[s];
    const float* bs = Bs[s];
#pragma unroll
    for (int k4 = 0; k4 < GB_K; k4 += 4) {
      float4 av[8], bv[8];  // the k-contiguous operands' quads over 4 k
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!kTA) av[i] = f32_ld4(as + (ty + 16 * i) * GB_LDK + k4);
        if (kTW) bv[i] = f32_ld4(bs + (tx + 8 * i) * GB_LDK + k4);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float a[8], b[8];
        if (kTA) {
          const float4 a0 = f32_ld4(as + (k4 + q) * GB_M + 4 * ty);
          const float4 a1 = f32_ld4(as + (k4 + q) * GB_M + 64 + 4 * ty);
          a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
          a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = f4_at(av[i], q);
        }
        if (kTW) {
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = f4_at(bv[j], q);
        } else {
          const float4 b0 = f32_ld4(bs + (k4 + q) * GB_N + 4 * tx);
          const float4 b1 = f32_ld4(bs + (k4 + q) * GB_N + 32 + 4 * tx);
          b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
          b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  if (kEpi == EPI_GY) {
    // each column's sum over this thread's rows (in i order), then over
    // the 16 row groups in order, through the ring's shared memory
    __syncthreads();
    float* colp = &As[0][0];  // [16][GB_N]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + col(j);
      float cs = 0.f;
      if (n < N) {
        const float bb = bias[n];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = m0 + row(i);
          if (m < M)
            cs = fmaf(res[(long long)m * N + n], __fadd_rn(acc[i][j], bb),
                      cs);
        }
      }
      colp[ty * GB_N + col(j)] = cs;
    }
    __syncthreads();
    if (tid < GB_N && n0 + tid < N) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += colp[r * GB_N + tid];
      out[(long long)blockIdx.y * N + n0 + tid] = s;
    }
    return;
  }

  // the epilogue of output (m, n)
  auto epi = [&](float v, int m, int n) {
    if (kEpi != EPI_NONE) v = __fadd_rn(v, bias[n]);
    if (kEpi == EPI_GAMMA_RESID) v = __fmul_rn(v, gamma[n]);
    if (kEpi == EPI_BIAS_RESID || kEpi == EPI_GAMMA_RESID)
      v = __fadd_rn(v, res[(long long)m * N + n]);
    return v;
  };
  float* o_base = out + (kTA ? (long long)blockIdx.z * M * N : 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + row(i);
    if (m >= M) continue;
    float* o = o_base + (long long)m * N;
    if (kTW) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + col(j);
        if (n < N) o[n] = epi(acc[i][j], m, n);
      }
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = n0 + col(4 * half);
        if (n >= N) continue;
        *reinterpret_cast<float4*>(o + n) = make_float4(
            epi(acc[i][4 * half], m, n), epi(acc[i][4 * half + 1], m, n + 1),
            epi(acc[i][4 * half + 2], m, n + 2),
            epi(acc[i][4 * half + 3], m, n + 3));
      }
    }
  }
}

constexpr int GW_N = 128, GW_K = 8, GW_THREADS = 256;

// N % 4 == 0, K % 8 == 0, every pointer 16-byte aligned; rows past M read
// as zero and are not stored, columns past N likewise in whole float4s.
template <int kEpi>
__global__ void __launch_bounds__(GW_THREADS)
f32_gemm_wide_kernel(const float* __restrict__ A, const float* __restrict__ W,
                     const float* __restrict__ bias,
                     const float* __restrict__ gamma,
                     const float* __restrict__ res, float* __restrict__ out,
                     int M, int N, int K) {
  static_assert(kEpi != EPI_GY, "an output tile");
  __shared__ __align__(16) float As[2][GW_K][GB_M];  // A tile, k-major
  __shared__ __align__(16) float Bs[2][GW_K][GW_N];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GW_N;
  // this thread's global loads: A row ar, k columns ac..ac+3; W k row br,
  // columns bc..bc+3
  const int ar = tid >> 1, ac = (tid & 1) * 4;
  const int br = tid >> 5, bc = (tid & 31) * 4;
  const bool a_in = m0 + ar < M, b_in = n0 + bc < N;
  const float* a_src = A + (long long)(a_in ? m0 + ar : 0) * K + ac;
  const float* b_src = W + (long long)br * N + (b_in ? n0 + bc : 0);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // this thread's outputs: rows ty*4 + i and 64 + ty*4 + i, columns tx*4 +
  // j and 64 + tx*4 + j
  const int ty = tid / 16, tx = tid % 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // the k tile at k0 into registers, then into shared memory
  const int ktiles = K / GW_K;
  float4 ra = a_in ? f32_ld4(a_src) : zero;
  float4 rb = b_in ? f32_ld4(b_src) : zero;
  auto stage = [&](int buf) {
    As[buf][ac + 0][ar] = ra.x;
    As[buf][ac + 1][ar] = ra.y;
    As[buf][ac + 2][ar] = ra.z;
    As[buf][ac + 3][ar] = ra.w;
    *reinterpret_cast<float4*>(&Bs[buf][br][bc]) = rb;
  };
  stage(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) {
      const int k0 = (kt + 1) * GW_K;
      ra = a_in ? f32_ld4(a_src + k0) : zero;
      rb = b_in ? f32_ld4(b_src + (long long)k0 * N) : zero;
    }
#pragma unroll
    for (int k = 0; k < GW_K; ++k) {
      const float4 a0 = f32_ld4(&As[cur][k][ty * 4]);
      const float4 a1 = f32_ld4(&As[cur][k][64 + ty * 4]);
      const float4 b0 = f32_ld4(&Bs[cur][k][tx * 4]);
      const float4 b1 = f32_ld4(&Bs[cur][k][64 + tx * 4]);
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
      *reinterpret_cast<float4*>(out + (long long)m * N + n) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// whether an (M, N) product of A (M, K) and W (K, N) takes the 128 x 128
// tiles: where its 128 x 64 tiles would take more than three waves of
// three CTAs on each of the 132 SMs
constexpr bool gemm_f32_wide_tiles(int M, int N) {
  return (long long)((M + GB_M - 1) / GB_M) * ((N + GB_N - 1) / GB_N) >
         3LL * 3 * 132;
}

// kchunk: with kTA, the rows of K each partial sums (a multiple of 16),
// and the partials cdiv(K, kchunk) are written at out + z M N; else unused.
template <int kEpi, bool kTA = false, bool kTW = false>
cudaError_t launch_gemm_f32(const float* A, const float* W, const float* bias,
                            const float* gamma, const float* res, float* out,
                            int M, int N, int K, cudaStream_t s,
                            int kchunk = 0) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || (M + GB_M - 1) / GB_M > 65535 ||
      (kTA ? (M % 4 || kchunk <= 0 || kchunk % GB_K ||
              (K + kchunk - 1) / kchunk > 65535)
           : K % 8))
    return cudaErrorInvalidValue;
  if constexpr (!kTA && !kTW && kEpi != EPI_GY) {
    if (gemm_f32_wide_tiles(M, N)) {
      const dim3 grid((N + GW_N - 1) / GW_N, (M + GB_M - 1) / GB_M);
      f32_gemm_wide_kernel<kEpi><<<grid, GW_THREADS, 0, s>>>(
          A, W, bias, gamma, res, out, M, N, K);
      return cudaGetLastError();
    }
  }
  const dim3 grid((N + GB_N - 1) / GB_N, (M + GB_M - 1) / GB_M,
                  kTA ? (K + kchunk - 1) / kchunk : 1);
  f32_gemm_kernel<kEpi, kTA, kTW><<<grid, GB_THREADS, 0, s>>>(
      A, W, bias, gamma, res, out, M, N, K, kchunk);
  return cudaGetLastError();
}

}  // namespace
