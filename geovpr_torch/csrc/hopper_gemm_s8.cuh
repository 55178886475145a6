// The LN-quant pass and the int8 projection GEMM of K2 (mhsa_int8.cu), K5
// (swin_attn.cu) and K3 (mlp_int8.cu) for Hopper (sm_90a), w8a8:
//
//   ln_quant_kernel:       xq(M, D) = int8(LN(x) * s' + b')
//   hopper_gemm_s8_kernel: out(M, Nc) = epilogue(A(M, K) @ W(Nc, K)^T)
//
// ln_quant_kernel runs LayerNorm once per row, writing the int8 row the
// GEMM then reads by TMA (a LayerNorm prologue in the GEMM would run in
// each of the QKV GEMM's 3C / 128 column tiles: 3x at Swin stage 0, 24x
// at stage 3, 18x at DINOv2-B, as the first port's K2 did). A warp takes a
// run of R = 4096 / (D x the element's bytes) rows (at most 16; D <= 1024:
// up to 4 KB), reads them by 16-byte loads, all in flight at once (one
// 256-byte row a warp kept too few loads in flight in K4's LayerNorm), and
// stages them in shared memory. The stream is bf16 or f32 (a model built
// with compute_dtype="float32"); the staged bytes are the same in both, so
// an f32 warp stages half the rows (R = 8 at D <= 128 ... 1 at D = 768 and
// 1024), the block keeps its 32 KB of static shared memory (64 KB would
// pass the 48 KB static limit) and each lane its eight 16-byte loads. The
// statistics keep
// int8_common.cuh::ln_quant_row's two-pass f32 arithmetic in its order:
// lane l sums elements l, l + 32, ... of the row, then the warp's xor
// butterfly; the same for the squared deviations. So the mean, 1/std and
// every int8 value equal ln_quant_row's bit for bit. The R rows' sums and
// butterflies run side by side (one row at a time left the shuffles'
// latency exposed: 0.171 ms at Swin stage 0 against 0.068 of bytes). Each
// lane then quantises its own 16-byte chunks (8 bf16 or 4 f32 elements)
// and stores 8 or 4 bytes.
//
// The GEMM keeps hopper_gemm.cuh's structure: 128 x 128 output tiles, two
// persistent CTAs an SM walking their share of the tiles, one producer
// warp keeping a ring of three 32 KB stages full by TMA, two consumer
// warpgroups of 64 rows each. int8 wgmma (m64n128k32, s32 accumulators)
// takes both operands K-major, and the port's int8 weights are (out, in)
// with k contiguous (int8_common.cuh), so A (M, K) and W (Nc, K) are both
// 2-d tensor maps in 128 x 128-byte boxes, one 128-byte swizzle row deep:
// four k32 products a stage. M, K and column tails are TMA's zero fill;
// the int32 sums are exact in any order. The epilogue works from the
// registers in f32 with the plain versions' rounding points, in the
// expressions of the first port's K2 projections, stages the output tile
// in the last k tile's stage (128-byte swizzle) and stores it by TMA, which
// drops rows >= M and columns past the output:
//   EPI_QK8V:    acc * s + b; columns below qk_cols (K2's and K5's q | k,
//                2C) round_clip_i8 into qk8 (M, 2C), the rest rounded to
//                bf16 into v (M, C); with qk_cols = Nc (the int8 P.V mode's
//                q | k | v, 3C) every column into qk8 (M, 3C) and no v;
//   EPI_QKV16:   (acc * s + b) * qscale on the columns below qk_cols (the
//                bf16-score mode's q, C; qscale = dh^-0.5 log2(e), JAX's
//                srow), the rest as they are, rounded once to bf16 into
//                qkv (M, 3C);
//   EPI_GELU8:   h = acc * s + b, tanh GELU in f32 (tanhf), * inv_a_mid,
//                round_clip_i8 into K3's int8 hidden;
//   EPI_RESID:   acc * s + b + resid (K5's out projection);
//   EPI_RESID_G: (acc * s + b) * gamma + resid (K3's fc2 and K2's out
//                projection, gamma a compile-time choice so the product
//                keeps its fused multiply-add).
// The two residual epilogues read the residual and write the output in
// the stream's type TS, a template argument: bf16, or f32 (JAX's bodies'
// `(y + xf).astype(o_ref.dtype)`: the sum in f32, rounded once, which for
// f32 is no rounding). A warpgroup's 64 x 128 f32 tile is 32 KB, twice its
// half of a stage: it is stored in two 64-column halves, each as two
// 32-column boxes (128 bytes, the swizzle's width) of one f32 tensor map,
// the second half staged once the first's stores have read the stage
// (bulk_wait_read). Spanning two stages would take one the producer is
// filling for the next tile; the halves keep the ring as it is.
// What bounds it on the H100: at DINOv2-B/14, B=64, K3's fc1 and fc2 are
// 77.6 GOP each (0.039 ms at 1,979 int8 TOP/s) against 65 / 104 MB (0.020
// / 0.031 ms at 3.35 TB/s): operations; at Swin-B-384 stage 0 (589,824 x
// 128, hidden 512) the 302 MB int8 hidden bounds fc1 and fc2 by bytes.

#pragma once

#include <type_traits>

#include "hopper_gemm.cuh"
#include "int8_common.cuh"

namespace {

enum { HS_EPI_QK8V, HS_EPI_GELU8, HS_EPI_RESID, HS_EPI_RESID_G,
       HS_EPI_QKV16 };

// What the epilogue uses (see the header note); unused fields are ignored.
struct HsEpilogue {
  const float* scale;  // (Nc,) dequant row
  const float* bias;   // (Nc,)
  const float* gamma;  // (Nc,), EPI_RESID_G
  const void* resid;   // (M, Nc) in the stream's type, EPI_RESID and
                       // EPI_RESID_G
  float inv_a_mid;     // EPI_GELU8
  int qk_cols;         // EPI_QK8V: a multiple of HS_BN, or Nc; EPI_QKV16:
                       // the q columns, even
  float qscale;        // EPI_QKV16
};

constexpr int HS_BM = 128;   // rows of an output tile
constexpr int HS_BN = 128;   // columns of an output tile
constexpr int HS_BK = 128;   // k of a stage: one 128-byte swizzle row
constexpr int HS_STAGES = 3;
constexpr int HS_ABYTES = HS_BM * HS_BK;
constexpr int HS_STAGE = HS_ABYTES + HS_BN * HS_BK;
// the ring, its 2 HS_STAGES barriers and the slack of align1024
constexpr int HS_SMEM = HS_STAGES * HS_STAGE + 2 * HS_STAGES * 8 + 1024;
static_assert(HS_BM * HS_BN * 2 <= HS_STAGE, "bf16 output tile");
static_assert(HS_BM * HS_BN / 2 * 4 <= HS_STAGE, "f32 half output tile");

constexpr int LQ_WARPS = 8;      // warps of an LN-quant block
constexpr int LQ_BYTES = 4096;   // bytes of the stream a warp stages
constexpr int LQ_CHUNKS = LQ_BYTES / 16 / 32;  // 16-byte loads a lane

__device__ __forceinline__ float lq_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float lq_float(float v) { return v; }

// The sum over the warp of each of a lane's kR values, in hg_warp_sum's
// order (xor 16, 8, 4, 2, 1), the kR butterflies interleaved
template <int kR>
__device__ __forceinline__ void lq_warp_sums(float (&v)[kR]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < kR; ++r) v[r] += __shfl_xor_sync(0xffffffffu, v[r], o);
}

// xq = round_clip_i8(LN(x) * scale + bias) of a bf16 or f32 stream T, D a
// multiple of the kV = 16 / sizeof(T) elements of a 16-byte chunk, D <=
// kSpan / kR (kSpan = LQ_BYTES / sizeof(T)); warp w of block b takes rows
// [(b LQ_WARPS + w) kR, + kR). The kR rows' statistics run side by side,
// each in ln_quant_row's order.
template <typename T, int kR>
__global__ void __launch_bounds__(32 * LQ_WARPS)
ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, int8_t* __restrict__ y,
                int M, int D, float eps) {
  constexpr int kV = 16 / (int)sizeof(T);
  constexpr int kSpan = LQ_BYTES / (int)sizeof(T);
  // the 8 or 4 int8 values a chunk quantises to, stored at once
  typedef typename std::conditional<kV == 8, uint2, uint32_t>::type Out;
  __shared__ __align__(16) T xs[LQ_WARPS][kSpan];
  __shared__ float2 stat[LQ_WARPS][kR];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long row0 = ((long long)blockIdx.x * LQ_WARPS + warp) * kR;
  if (row0 >= M) return;
  const int nrows = (int)min((long long)kR, M - row0);
  const int chunks = nrows * D / kV;
  const T* xr = x + row0 * D;
  T* sx = xs[warp];
  uint4 u[LQ_CHUNKS];
#pragma unroll
  for (int k = 0; k < LQ_CHUNKS; ++k) {
    const int c = lane + 32 * k;
    if (c < chunks) u[k] = *reinterpret_cast<const uint4*>(xr + kV * c);
  }
#pragma unroll
  for (int k = 0; k < LQ_CHUNKS; ++k) {
    const int c = lane + 32 * k;
    if (c < chunks) *reinterpret_cast<uint4*>(sx + kV * c) = u[k];
  }
  __syncwarp();
  // ln_quant_row's statistics, in its order: lane l sums elements l, l +
  // 32, ... of a row (rows past M read what the span holds and are not
  // written)
  float mu[kR], rstd[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) mu[r] = 0.f;
  for (int c = lane; c < D; c += 32)
#pragma unroll
    for (int r = 0; r < kR; ++r) mu[r] += lq_float(sx[r * D + c]);
  lq_warp_sums(mu);
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    mu[r] = mu[r] / D;
    rstd[r] = 0.f;
  }
  for (int c = lane; c < D; c += 32)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float d = lq_float(sx[r * D + c]) - mu[r];
      rstd[r] += d * d;
    }
  lq_warp_sums(rstd);
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < kR; ++r)
      stat[warp][r] = make_float2(mu[r], rsqrtf(rstd[r] / D + eps));
  __syncwarp();
  // each lane quantises its own kV-element chunks: chunk lane + 32 k sits
  // at element e = kV lane + 32 kV k of the span, row e / D
  int8_t* yr = y + row0 * D;
  int row = kV * lane / D;
  int col = kV * lane - row * D;
#pragma unroll
  for (int k = 0; k < LQ_CHUNKS; ++k) {
    const int c = lane + 32 * k;
    if (c < chunks) {
      const float2 st = stat[warp][row];
      float sc[kV], bi[kV];
#pragma unroll
      for (int i = 0; i < kV / 4; ++i) {
        const float4 s4 = *reinterpret_cast<const float4*>(scale + col + 4 * i);
        const float4 b4 = *reinterpret_cast<const float4*>(bias + col + 4 * i);
        sc[4 * i] = s4.x;
        sc[4 * i + 1] = s4.y;
        sc[4 * i + 2] = s4.z;
        sc[4 * i + 3] = s4.w;
        bi[4 * i] = b4.x;
        bi[4 * i + 1] = b4.y;
        bi[4 * i + 2] = b4.z;
        bi[4 * i + 3] = b4.w;
      }
      const uint4 xu = *reinterpret_cast<const uint4*>(sx + kV * c);
      const T* e = reinterpret_cast<const T*>(&xu);
      Out out;
      int8_t* o = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int i = 0; i < kV; ++i)
        o[i] = round_clip_i8((lq_float(e[i]) - st.x) * st.y * sc[i] + bi[i]);
      *reinterpret_cast<Out*>(yr + kV * c) = out;
    }
    for (col += 32 * kV; col >= D; col -= D) ++row;
  }
}

// kR = kSpan / D rows a warp, at most 16: bf16 16 rows at D <= 128, 8 at
// 256, 4 at 512, 2 at 768 and 1024; f32 half as many (8 at D <= 128 ... 1
// at 768 and 1024)
template <typename T>
inline cudaError_t launch_ln_quant(const T* x, const float* scale,
                                   const float* bias, int8_t* y, int M, int D,
                                   float eps, cudaStream_t s) {
  constexpr int kSpan = LQ_BYTES / (int)sizeof(T);
  const int r = D <= kSpan / 16  ? 16
                : D <= kSpan / 8 ? 8
                : D <= kSpan / 4 ? 4
                : D <= kSpan / 2 ? 2
                                 : 1;
  const unsigned grid =
      (unsigned)((M + (long long)LQ_WARPS * r - 1) / (LQ_WARPS * r));
  if (r == 16)
    ln_quant_kernel<T, 16><<<grid, 32 * LQ_WARPS, 0, s>>>(x, scale, bias, y,
                                                          M, D, eps);
  else if (r == 8)
    ln_quant_kernel<T, 8><<<grid, 32 * LQ_WARPS, 0, s>>>(x, scale, bias, y,
                                                         M, D, eps);
  else if (r == 4)
    ln_quant_kernel<T, 4><<<grid, 32 * LQ_WARPS, 0, s>>>(x, scale, bias, y,
                                                         M, D, eps);
  else if (r == 2)
    ln_quant_kernel<T, 2><<<grid, 32 * LQ_WARPS, 0, s>>>(x, scale, bias, y,
                                                         M, D, eps);
  else
    ln_quant_kernel<T, 1><<<grid, 32 * LQ_WARPS, 0, s>>>(x, scale, bias, y,
                                                         M, D, eps);
  return cudaGetLastError();
}

// K3's hidden: the tanh GELU of the dequantised fc1 sum, quantised, in the
// plain version's order of operations
__device__ __forceinline__ int8_t gelu_quant(int acc, float s1, float b1,
                                             float inv_a_mid) {
  const float h = (float)acc * s1 + b1;
  const float gl = 0.5f * h *
      (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  return round_clip_i8(gl * inv_a_mid);
}

__device__ __forceinline__ uint16_t pack_i8x2(int8_t lo, int8_t hi) {
  return (uint16_t)((uint8_t)lo | ((uint16_t)(uint8_t)hi << 8));
}

__device__ __forceinline__ void st_shared_f32x2(uint32_t addr, float a,
                                                float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}

// out = epilogue(A @ W^T): tm_a maps A (M, K) and tm_w W (Nc, K) in
// 128-byte x 128-row boxes; tm_o8 an int8 output in 128 x 64 boxes, tm_o16
// a bf16 output in 64 x 64 boxes or, for an f32 stream TS (the EPI_RESIDs
// only), an f32 output in 32 x 64 boxes (all 128-byte swizzled; EPI_QK8V
// uses both, EPI_GELU8 tm_o8, the EPI_RESIDs tm_o16). Persistent: CTA c
// takes the output tiles c, c + gridDim.x, ... of the ceil(M / 128) x
// ceil(Nc / 128) tiles, column tiles fastest.
template <int kEpi, typename TS = bf16>
__global__ void __launch_bounds__(HG_THREADS, 2)
hopper_gemm_s8_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_o8,
                      const __grid_constant__ CUtensorMap tm_o16,
                      const HsEpilogue ep, int M, int K, int Nc) {
  extern __shared__ unsigned char hs_smem[];
  unsigned char* ring = align1024(hs_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + HS_STAGES * HS_STAGE);
  uint64_t* empty = full + HS_STAGES;
  const int warp = threadIdx.x / 32;
  const int ktiles = (K + HS_BK - 1) / HS_BK;
  const int ntiles = (Nc + HS_BN - 1) / HS_BN;
  const int tiles = ntiles * ((M + HS_BM - 1) / HS_BM);

  if (threadIdx.x == 0) {
    for (int s = 0; s < HS_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, HG_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * HG_CONSUMERS) {
    // the producer: one lane keeps the ring full, across tiles
    if ((threadIdx.x & 31) == 0) {
      int step = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % ntiles) * HS_BN;
        const int m0 = (tile / ntiles) * HS_BM;
        for (int kt = 0; kt < ktiles; ++kt, ++step) {
          const int s = step % HS_STAGES;
          mbar_wait(empty + s, ((step / HS_STAGES) & 1) ^ 1);
          unsigned char* a = ring + s * HS_STAGE;
          mbar_expect_tx(full + s, HS_STAGE);
          tma_load_2d(a, &tm_a, full + s, kt * HS_BK, m0);
          tma_load_2d(a + HS_ABYTES, &tm_w, full + s, kt * HS_BK, n0);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile
  const int wg = warp / 4;
  const int tid = threadIdx.x & 127;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int lr0 = (tid >> 5) * 16 + g;  // rows lr0, lr0 + 8 of the 64
  int step = 0;
  int held = -1;  // the stage the last tile's stores may still be reading
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % ntiles) * HS_BN;
    const int m0 = (tile / ntiles) * HS_BM;
    int acc[HS_BN / 2];
#pragma unroll
    for (int i = 0; i < HS_BN / 2; ++i) acc[i] = 0;
    int s = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      s = (step + kt) % HS_STAGES;
      mbar_wait(full + s, ((step + kt) / HS_STAGES) & 1);
      const unsigned char* a = ring + s * HS_STAGE + wg * 64 * 128;
      const unsigned char* b = ring + s * HS_STAGE + HS_ABYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HS_BK / 32; ++kk)
        wgmma_m64n128_s8(acc, sw128_desc(a + kk * 32, 16, 1024),
                         sw128_desc(b + kk * 32, 16, 1024), 1);
      wgmma_commit();
      if (held >= 0 && tid == 0) {
        // the last tile's stores have read their stage by now, mostly
        bulk_wait_read();
        mbar_arrive(empty + held);
      }
      held = -1;
      // the previous k tile's products are done: hand its stage back
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > 0 && tid == 0)
        mbar_arrive(empty + (step + kt - 1) % HS_STAGES);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    step += ktiles;
    // both warpgroups' products are done: the last k tile's stage s holds
    // the output tile while the producer fills the others
    named_sync(1, 128 * HG_CONSUMERS);

    const int r0 = m0 + wg * 64 + lr0;
    unsigned char* out_s = ring + s * HS_STAGE + wg * 64 * HS_BN * 2;
    if constexpr (sizeof(TS) == 4) {
      static_assert(kEpi == HS_EPI_RESID || kEpi == HS_EPI_RESID_G,
                    "an f32 output is the residual epilogues'");
      // the f32 tile in two 64-column halves, each two 32-column boxes of
      // 64 rows in this warpgroup's 16 KB of the stage: column 8 jj + 2 t
      // of a half sits in box jj / 4, 16-byte chunk 2 (jj % 4) + t / 2 of
      // the box's 128-byte row, at byte 8 (t % 2) of it
      const float* res = static_cast<const float*>(ep.resid);
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        if (hc == 1) {
          // the first half's stores have read the staging before it is
          // written again
          if (tid == 0) bulk_wait_read();
          named_sync(2 + wg, 128);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = n0 + 64 * hc + 8 * jj + 2 * t;
          if (col >= Nc) continue;
          const float2 sc = *reinterpret_cast<const float2*>(ep.scale + col);
          const float2 bb = *reinterpret_cast<const float2*>(ep.bias + col);
          float2 gg = make_float2(1.f, 1.f);
          if (kEpi == HS_EPI_RESID_G)
            gg = *reinterpret_cast<const float2*>(ep.gamma + col);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = r0 + 8 * half;
            if (row >= M) continue;
            const int lr = lr0 + 8 * half;
            const int j = 8 * hc + jj;
            float v0 = (float)acc[4 * j + 2 * half] * sc.x + bb.x;
            float v1 = (float)acc[4 * j + 2 * half + 1] * sc.y + bb.y;
            const float2 r =
                *reinterpret_cast<const float2*>(res + (size_t)row * Nc + col);
            if (kEpi == HS_EPI_RESID_G) {
              v0 = v0 * gg.x + r.x;
              v1 = v1 * gg.y + r.y;
            } else {
              v0 += r.x;
              v1 += r.y;
            }
            st_shared_f32x2(
                smem_u32(out_s + (jj / 4) * 8192 + lr * 128 +
                         (((2 * (jj & 3) + (t >> 1)) ^ (lr & 7)) << 4) +
                         (t & 1) * 8),
                v0, v1);
          }
        }
        fence_proxy_async();
        named_sync(2 + wg, 128);
        if (tid == 0) {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            tma_store_2d(&tm_o16, out_s + c * 8192, n0 + 64 * hc + 32 * c,
                         m0 + wg * 64);
          bulk_commit();
        }
      }
      held = s;
      continue;
    }
    const bool to8 =
        kEpi == HS_EPI_GELU8 || (kEpi == HS_EPI_QK8V && n0 < ep.qk_cols);
#pragma unroll
    for (int j = 0; j < HS_BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= Nc) continue;
      const float2 sc = *reinterpret_cast<const float2*>(ep.scale + col);
      const float2 bb = *reinterpret_cast<const float2*>(ep.bias + col);
      float2 gg = make_float2(1.f, 1.f);
      if (kEpi == HS_EPI_RESID_G)
        gg = *reinterpret_cast<const float2*>(ep.gamma + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row >= M) continue;
        const int lr = lr0 + 8 * half;
        const int a0 = acc[4 * j + 2 * half];
        const int a1 = acc[4 * j + 2 * half + 1];
        if (to8) {
          int8_t q0, q1;
          if (kEpi == HS_EPI_GELU8) {
            q0 = gelu_quant(a0, sc.x, bb.x, ep.inv_a_mid);
            q1 = gelu_quant(a1, sc.y, bb.y, ep.inv_a_mid);
          } else {
            q0 = round_clip_i8((float)a0 * sc.x + bb.x);
            q1 = round_clip_i8((float)a1 * sc.y + bb.y);
          }
          // one 128-byte row of 128 int8 columns a tile row
          st_shared_u16(smem_u32(out_s + lr * 128 +
                                 (((j >> 1) ^ (lr & 7)) << 4) +
                                 (j & 1) * 8 + 2 * t),
                        pack_i8x2(q0, q1));
        } else {
          float v0 = (float)a0 * sc.x + bb.x;
          float v1 = (float)a1 * sc.y + bb.y;
          if (kEpi == HS_EPI_QKV16 && col < ep.qk_cols) {
            v0 *= ep.qscale;
            v1 *= ep.qscale;
          }
          if (kEpi == HS_EPI_RESID || kEpi == HS_EPI_RESID_G) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const bf16*>(ep.resid) + (size_t)row * Nc +
                    col));
            if (kEpi == HS_EPI_RESID_G) {
              v0 = v0 * gg.x + r.x;
              v1 = v1 * gg.y + r.y;
            } else {
              v0 += r.x;
              v1 += r.y;
            }
          }
          __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          st_shared_u32(smem_u32(out_s + (j / 8) * 8192 + lr * 128 +
                                 (((j % 8) ^ (lr & 7)) << 4) + 4 * t),
                        *reinterpret_cast<uint32_t*>(&v));
        }
      }
    }
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (tid == 0) {
      if (to8) {
        tma_store_2d(&tm_o8, out_s, n0, m0 + wg * 64);
      } else {
        const int c0 = kEpi == HS_EPI_QK8V ? n0 - ep.qk_cols : n0;
#pragma unroll
        for (int c = 0; c < HS_BN / 64; ++c)
          tma_store_2d(&tm_o16, out_s + c * 8192, c0 + 64 * c, m0 + wg * 64);
      }
      bulk_commit();
    }
    // the stage goes back to the producer once the stores have read it,
    // which the next tile's first k step waits for
    held = s;
  }
  if (tid == 0) bulk_wait_read();
}

// an int8 (rows, cols) matrix, `box_rows` rows of 128 bytes a box
inline bool map_s8(CUtensorMap* m, const void* a, int rows, int cols,
                   int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {HS_BK, (cuuint32_t)box_rows};
  return make_tmap_of(m, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                      CU_TENSOR_MAP_SWIZZLE_128B, a, 2, dims, strides, box);
}

// out = epilogue(A @ W^T), A (M, K) int8 and W (Nc, K) int8 (K % 16 ==
// 0); out8 (M, qk_cols or Nc) int8 and out16 (M, Nc - qk_cols or Nc) bf16
// (or, TS float, the EPI_RESIDs' f32 output (M, Nc), Nc % 4 == 0) as the
// epilogue writes them (no out16 map where that width is 0)
template <int kEpi, typename TS = bf16>
cudaError_t launch_gemm_s8(const int8_t* a, const int8_t* w, int M, int K,
                           int Nc, const HsEpilogue& ep, int8_t* out8,
                           void* out16, cudaStream_t s) {
  CUtensorMap ta, tw, t8{}, t16{};
  if (!map_s8(&ta, a, M, K, HS_BM) || !map_s8(&tw, w, Nc, K, HS_BN))
    return cudaErrorInvalidValue;
  const int n8 = kEpi == HS_EPI_QK8V ? ep.qk_cols : Nc;
  if ((kEpi == HS_EPI_QK8V || kEpi == HS_EPI_GELU8) &&
      !map_s8(&t8, out8, M, n8, 64))
    return cudaErrorInvalidValue;
  const int n16 = kEpi == HS_EPI_GELU8 ? 0
                  : Nc - (kEpi == HS_EPI_QK8V ? ep.qk_cols : 0);
  if (n16 > 0) {
    const cuuint64_t dims[2] = {(cuuint64_t)n16, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)n16 * sizeof(TS)};
    const cuuint32_t box[2] = {128 / (cuuint32_t)sizeof(TS), 64};
    if (!(sizeof(TS) == 4
              ? make_tmap_of(&t16, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                             CU_TENSOR_MAP_SWIZZLE_128B, out16, 2, dims,
                             strides, box)
              : make_tmap(&t16, out16, 2, dims, strides, box)))
      return cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const long long tiles =
      (long long)((Nc + HS_BN - 1) / HS_BN) * ((M + HS_BM - 1) / HS_BM);
  const int grid = (int)(tiles < 2 * sms ? tiles : 2 * sms);
  hopper_gemm_s8_kernel<kEpi, TS><<<grid, HG_THREADS, HS_SMEM, s>>>(
      ta, tw, t8, t16, ep, M, K, Nc);
  return cudaGetLastError();
}

// raises the dynamic shared-memory limit of this translation unit's int8
// GEMM with epilogue kEpi on a TS stream
template <int kEpi, typename TS = bf16>
cudaError_t allow_gemm_s8_smem() {
  return cudaFuncSetAttribute(hopper_gemm_s8_kernel<kEpi, TS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              HS_SMEM);
}

}  // namespace
