// K1's LayerNorm and projection GEMMs for Hopper (sm_90a), bf16:
//
//   ln_rows_kernel:     y(M, D) = bf16(LN(x) * ln_scale + ln_bias)
//   hopper_gemm_kernel: out(M, Nc) = epilogue(A(M, K) @ W(K, Nc))
//
// LayerNorm runs once per row in a kernel of its own (one warp a row, the
// row in registers, two-pass f32 statistics: the mean, then the mean
// squared deviation), writing bf16 LN(x), the oracle's rounding point, to
// a buffer the QKV GEMM then reads by TMA. Folding it into the GEMM's
// prologue would recompute it in each of the 18 (D = 768) column tiles of
// a row block and keep the A operand off TMA's path; the separate pass
// costs one round trip of 2 M D bytes (0.015 ms at 3.35 TB/s for
// 64 x 257 x 768).
//
// The GEMM: a 128 x BN output tile (BN = 128, or 64 where Nc is not a
// multiple of 128) per CTA, two CTAs an SM. One producer warp
// keeps a ring of kStages shared-memory stages full by TMA (A: a 128 x 64
// K-major box; W, row-major (K, Nc) as the port stores wqkv and wo: BN/64
// boxes of 64 k x 64 columns, the MN-major B operand), each stage's
// completion counted on an mbarrier; two consumer warpgroups each multiply
// their 64 rows with wgmma m64n{BN}k16 (f32 accumulators in registers),
// keep one k tile's products in flight and hand a stage back to the
// producer on a second mbarrier when its products are done. The M tail
// comes from TMA's zero fill; the epilogue, from the registers in f32,
// masks rows >= M and stores bf16 pairs:
//   EPI_QKV:  acc + bias;
//   EPI_PROJ: (acc + bias) * gamma + resid.
// What bounds it: at 64 x 257 x 768 the QKV GEMM is 58.2 GFLOP against
// ~105 MB (tensor cores: 0.059 ms at the bf16 peak), the out projection
// 19.4 GFLOP against ~77 MB (memory: 0.023 ms).

#pragma once

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum { HG_EPI_QKV = 0, HG_EPI_PROJ = 1 };

constexpr int HG_BM = 128;        // rows of an output tile
constexpr int HG_BK = 64;         // k of a stage: one 128-byte swizzle row
constexpr int HG_CONSUMERS = 2;   // warpgroups, 64 rows each
constexpr int HG_THREADS = 128 * HG_CONSUMERS + 32;  // + the producer warp

template <int BN>
struct HgTile {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kABytes = HG_BM * HG_BK * 2;
  static constexpr int kBBytes = HG_BK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the ring, its 2 kStages barriers, and the slack of align1024
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

constexpr int LN_ROWS = 8;        // rows (warps) of a LayerNorm block
constexpr int LN_MAX_CHUNKS = 4;  // 8-element chunks a lane holds: D <= 1024
constexpr int HG_MAX_DIM = 32 * 8 * LN_MAX_CHUNKS;

__device__ __forceinline__ float hg_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = LN(x) rounded to bf16, one warp a row; D % 8 == 0, D <= HG_MAX_DIM
__global__ void __launch_bounds__(32 * LN_ROWS)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, bf16* __restrict__ y, int M,
               int D, float eps) {
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int chunks = D / 8;
  const bf16* xr = x + (size_t)row * D;
  float v[LN_MAX_CHUNKS][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (c < chunks) u = *reinterpret_cast<const uint4*>(xr + 8 * c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[i][k] = __bfloat162float(e[k]);
      s += v[i][k];
    }
  }
  const float mu = hg_warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_CHUNKS; ++i)
    if (lane + 32 * i < chunks)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = v[i][k] - mu;
        q += d * d;
      }
  const float rstd = rsqrtf(hg_warp_sum(q) / D + eps);
  bf16* yr = y + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < LN_MAX_CHUNKS; ++i) {
    const int c = lane + 32 * i;
    if (c >= chunks) continue;
    const float4 s0 = *reinterpret_cast<const float4*>(scale + 8 * c);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + 8 * c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bias + 8 * c);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + 8 * c + 4);
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 u;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = __floats2bfloat162_rn(
          (v[i][2 * k] - mu) * rstd * sc[2 * k] + bi[2 * k],
          (v[i][2 * k + 1] - mu) * rstd * sc[2 * k + 1] + bi[2 * k + 1]);
    *reinterpret_cast<uint4*>(yr + 8 * c) = u;
  }
}

// out(M, Nc) = epilogue(A @ W): tm_a maps A (M, K) in 64 x 128 boxes, tm_w
// W (K, Nc) in 64 x 64 boxes (both 128-byte swizzled). Grid (Nc / BN,
// ceil(M / 128)); K % 64 == 0, Nc % BN == 0.
template <int BN, int kEpi>
__global__ void __launch_bounds__(HG_THREADS, 2)
hopper_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_w,
                   const float* __restrict__ bias,
                   const float* __restrict__ gamma,
                   const bf16* __restrict__ resid, bf16* __restrict__ out,
                   int M, int K, int Nc) {
  using T = HgTile<BN>;
  extern __shared__ unsigned char hg_smem[];
  unsigned char* ring = align1024(hg_smem);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + T::kStages * T::kStageBytes);
  uint64_t* empty = full + T::kStages;
  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * HG_BM;
  const int ktiles = K / HG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, HG_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * HG_CONSUMERS) {
    // the producer: one lane keeps the ring full
    if ((threadIdx.x & 31) == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % T::kStages;
        mbar_wait(empty + s, ((kt / T::kStages) & 1) ^ 1);
        unsigned char* a = ring + s * T::kStageBytes;
        mbar_expect_tx(full + s, T::kStageBytes);
        tma_load_2d(a, &tm_a, full + s, kt * HG_BK, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(a + T::kABytes + c * HG_BK * 128, &tm_w, full + s,
                      n0 + 64 * c, kt * HG_BK);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % T::kStages;
    mbar_wait(full + s, (kt / T::kStages) & 1);
    const unsigned char* a = ring + s * T::kStageBytes + wg * 64 * 128;
    const unsigned char* b = ring + s * T::kStageBytes + T::kABytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HG_BK / 16; ++kk) {
      const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
      const uint64_t db = sw128_desc(b + kk * 2048, HG_BK * 128, 1024);
      if constexpr (BN == 128)
        wgmma_m64n128<1>(acc, da, db, 1);
      else
        wgmma_m64n64<1>(acc, da, db, 1);
    }
    wgmma_commit();
    // the previous k tile's products are done: hand its stage back
    wgmma_wait<1>();
    fence_regs(acc);
    if (kt > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(empty + (kt - 1) % T::kStages);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int tid = threadIdx.x & 127;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int r0 = m0 + wg * 64 + (tid >> 5) * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
    float2 gg = make_float2(1.f, 1.f);
    if (kEpi == HG_EPI_PROJ) gg = *reinterpret_cast<const float2*>(gamma + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 8 * half;
      if (row >= M) continue;
      const size_t at = (size_t)row * Nc + col;
      float v0 = acc[4 * j + 2 * half] + bb.x;
      float v1 = acc[4 * j + 2 * half + 1] + bb.y;
      if (kEpi == HG_EPI_PROJ) {
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(resid + at));
        v0 = v0 * gg.x + r.x;
        v1 = v1 * gg.y + r.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + at) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

}  // namespace
