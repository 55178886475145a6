// Fused Swin PatchMerging for Hopper (sm_90a), kernel K6:
//
//   out = LN(concat[x00, x10, x01, x11]) @ W        (W (4C, 2C), no bias)
//
// on the raster token stream: x is one stage's (B, S*S, C), out the next
// stage's (B, S/2*S/2, 2C), both in raster order; x_ij is the token at
// (2y + i, 2x + j) for the output token (y, x), the HF SwinPatchMerging
// concat order. Replaces geovpr/ops/pallas_patch_merge.py::
// fused_patch_merge_rolled (body _merge_kernel), whose three-operand row
// split and VMEM slicing exist to read the 2x2 neighbours out of the
// shifted window layout and write the next stage's windows; in the raster
// layout the neighbours are four rows at fixed offsets and nothing needs to
// be un-rolled. Numerics follow _merge_kernel: LN over the 4C values in f32
// with two-pass statistics, the normalised row rounded to bf16, the product
// accumulated in f32 and rounded to bf16.
//
// What bounds it on the H100: at Swin-B-384, B=64 the 0->1 boundary reads
// 151 MB and writes 75 MB (0.068 ms at 3.35 TB/s) for 38.7 GFLOP (0.039 ms
// at 989 TFLOP/s): memory bound; the later boundaries are smaller.
//
// Design (first, simple version; one launch): a CTA owns 64 output rows x
// 128 output columns. It finds the four source rows of each output row,
// takes each row's LN statistics with one warp per row (the 4C values read
// twice from device memory or L2), then streams K = 4C in chunks of 32:
// the A chunk gathered, normalised and rounded to bf16 into shared memory,
// the W chunk beside it, WMMA 16x16x16 bf16 products with f32 accumulators
// (8 warps as 2 x 4 tiles of 32 x 32, as K1's GEMM). Unlike K1's GEMM no
// whole row block is pinned in shared memory, so any C works (K = 2048 at
// the 2->3 boundary). Each column block redoes the statistics of its rows:
// 2C/128 times at each boundary, the first thing a faster version removes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int PM_BM = 64;
constexpr int PM_BN = 128;
constexpr int PM_BK = 32;
constexpr int PM_THREADS = 256;
constexpr int PA_LD = PM_BK + 8;   // bf16
constexpr int PB_LD = PM_BN + 8;   // bf16
constexpr int PC_LD = PM_BN + 4;   // f32

// The f32 accumulator tile is staged through the same shared memory as the
// A and B chunks, after the last product.
constexpr size_t PM_TILE_BYTES =
    (size_t)PM_BM * PC_LD * sizeof(float) >
            (size_t)(PM_BM * PA_LD + PM_BK * PB_LD) * sizeof(bf16)
        ? (size_t)PM_BM * PC_LD * sizeof(float)
        : (size_t)(PM_BM * PA_LD + PM_BK * PB_LD) * sizeof(bf16);
constexpr size_t PM_SMEM = PM_TILE_BYTES + (size_t)PM_BM * (4 + 2) * 4;
// under the default 48 KB of dynamic shared memory: no set-up call needed
static_assert(PM_SMEM <= 48 * 1024, "patch_merge_kernel shared memory");

__device__ inline float pm_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// x (B*S*S, C) bf16, w (4C, 2C) bf16 row-major, ln_scale/ln_bias (4C,) f32,
// out (B*S*S/4, 2C) bf16. C % 8 == 0, S even.
__global__ void __launch_bounds__(PM_THREADS)
patch_merge_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                   const float* __restrict__ ln_bias, const bf16* __restrict__ w,
                   bf16* __restrict__ out, int B, int S, int C, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + PM_BM * PA_LD;
  float* Cs = reinterpret_cast<float*>(smem);
  int* src_s = reinterpret_cast<int*>(smem + PM_TILE_BYTES);  // (64, 4)
  float* mu_s = reinterpret_cast<float*>(src_s + PM_BM * 4);
  float* rstd_s = mu_s + PM_BM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int S2 = S / 2;
  const int M2 = B * S2 * S2;
  const int K = 4 * C;
  const int N2 = 2 * C;
  const int n0 = blockIdx.x * PM_BN;
  const int m0 = blockIdx.y * PM_BM;

  // source rows of x00, x10, x01, x11; -1 past the last output row
  for (int r = tid; r < PM_BM; r += PM_THREADS) {
    const int m = m0 + r;
    int base = -1;
    if (m < M2) {
      const int bb = m / (S2 * S2);
      const int y2 = (m / S2) % S2;
      const int x2 = m % S2;
      base = (bb * S + 2 * y2) * S + 2 * x2;
    }
    src_s[r * 4 + 0] = base;
    src_s[r * 4 + 1] = base < 0 ? -1 : base + S;
    src_s[r * 4 + 2] = base < 0 ? -1 : base + 1;
    src_s[r * 4 + 3] = base < 0 ? -1 : base + S + 1;
  }
  __syncthreads();

  // LN statistics, one warp per row, two passes over the 4C values
  for (int r = warp; r < PM_BM; r += PM_THREADS / 32) {
    if (src_s[r * 4] < 0) {
      if (lane == 0) mu_s[r] = rstd_s[r] = 0.f;
      continue;
    }
    float s = 0.f;
    for (int k = lane; k < K; k += 32)
      s += __bfloat162float(x[(size_t)src_s[r * 4 + k / C] * C + k % C]);
    const float mu = pm_warp_sum(s) / K;
    float q = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float d =
          __bfloat162float(x[(size_t)src_s[r * 4 + k / C] * C + k % C]) - mu;
      q += d * d;
    }
    const float var = pm_warp_sum(q) / K;
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rsqrtf(var + eps);
    }
  }
  __syncthreads();

  const int wm = warp / 4;  // rows wm*32
  const int wn = warp % 4;  // cols wn*32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += PM_BK) {
    // A chunk: 64 rows x 32 columns, one 8-value chunk per thread; the 8
    // columns lie in one quadrant (C % 8 == 0)
    {
      const int r = tid >> 2;
      const int k = k0 + (tid & 3) * 8;
      const int src = src_s[r * 4 + k / C];
      __align__(16) bf16 vals[8];
      if (src >= 0) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(x + (size_t)src * C + k % C);
        const bf16* xv = reinterpret_cast<const bf16*>(&raw);
        const float mu = mu_s[r];
        const float rstd = rstd_s[r];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          vals[e] = __float2bfloat16((__bfloat162float(xv[e]) - mu) * rstd *
                                         ln_scale[k + e] + ln_bias[k + e]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(As + r * PA_LD + (tid & 3) * 8) =
          *reinterpret_cast<const uint4*>(vals);
    }
    // W chunk: 32 rows x 128 columns
    for (int i = tid; i < PM_BK * (PM_BN / 8); i += PM_THREADS) {
      const int r = i / (PM_BN / 8);
      const int c8 = i % (PM_BN / 8);
      const int col = n0 + c8 * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (col < N2)
        v = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N2 + col);
      *reinterpret_cast<uint4*>(Bs + r * PB_LD + c8 * 8) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * PA_LD + kk, PA_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * PB_LD + wn * 32 + j * 16, PB_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * PC_LD + wn * 32 + j * 16,
                              acc[i][j], PC_LD, wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < PM_BM * PM_BN; i += PM_THREADS) {
    const int r = i / PM_BN;
    const int c = i % PM_BN;
    const int row = m0 + r;
    const int col = n0 + c;
    if (row >= M2 || col >= N2) continue;
    out[(size_t)row * N2 + col] = __float2bfloat16(Cs[r * PC_LD + c]);
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 when the launch was accepted. x
// (B*S*S, C) and out (B*S*S/4, 2C) bf16; w (4C, 2C) bf16 (in, out);
// ln_scale, ln_bias (4C,) f32. C % 8 == 0, S even.
extern "C" int geovpr_patch_merge(const void* x, const void* ln_scale,
                                  const void* ln_bias, const void* w, void* out,
                                  int B, int S, int C, float eps, void* stream) {
  if (B <= 0 || S <= 0 || S % 2 || C <= 0 || C % 8)
    return (int)cudaErrorInvalidValue;
  const long long m2 = (long long)B * (S / 2) * (S / 2);
  const long long m_blocks = (m2 + PM_BM - 1) / PM_BM;
  if (m_blocks > 65535 || (long long)B * S * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  patch_merge_kernel<<<dim3((2 * C + PM_BN - 1) / PM_BN, (int)m_blocks),
                       PM_THREADS, PM_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), B, S, C, eps);
  return (int)cudaGetLastError();
}
