// The LayerNorm and projection GEMMs of K1 (mhsa.cu), K4 (swin_attn.cu)
// and K6 (patch_merge.cu), K9a's projections and K9c's four products
// (swin_train.cu), for Hopper (sm_90a), bf16:
//
//   ln_rows_kernel:     y(M, D) = bf16(LN(x) * ln_scale + ln_bias)
//   hopper_gemm_kernel: out(M, Nc) = epilogue(A(M, K) @ W(K, Nc))
//
// LayerNorm runs once per row in a kernel of its own (a warp, or where
// D <= 256 a part of one, a row; the row in registers, two-pass f32 statistics:
// the mean, then the mean squared deviation), writing bf16 LN(x), the
// oracle's rounding point, to a buffer the QKV GEMM then reads by TMA.
// Folding it into the GEMM's prologue would recompute it in each of the
// 18 (D = 768) column tiles of a row block and keep the A operand off
// TMA's path; the separate pass costs one round trip of 2 M D bytes (0.015
// ms at 3.35 TB/s for 64 x 257 x 768).
//
// The GEMM: 128 x BN output tiles (BN = 128, or 64 where Nc is not a
// multiple of 128), two persistent CTAs an SM, each walking its share of
// the tiles. One producer warp keeps a ring of kStages shared-memory
// stages full by TMA (A: a 128 x 64 K-major box; W, row-major (K, Nc) as
// the port stores wqkv, wo and the merge reduction: BN/64 boxes of 64 k x
// 64 columns, the MN-major B operand), each stage's completion counted on
// an mbarrier; two consumer warpgroups each multiply their 64 rows with
// wgmma m64n{BN}k16 (f32 accumulators in registers), keep one k tile's
// products in flight and hand a stage back to the producer on a second
// mbarrier when its products are done; the producer runs on into the next
// tile's k tiles. The M tail, a K tail (ceil(K / 64) k tiles) and a
// column tail come from TMA's zero fill. The epilogue works from the
// registers in f32, rounds once to bf16 into the tile's last stage (handed
// back only after it) as 64 x 64 boxes with the 128-byte swizzle, and
// stores each warpgroup's boxes by TMA, which drops rows >= M and columns
// >= Nc: the rounding of a direct store, but whole 128-byte rows instead
// of 4-byte pairs, and the next tile's loads overlap the epilogue:
//   EPI_QKV:   acc + bias, times qscale on the first qcols columns (K4's
//              dh^-0.5 log2 e on q; K1, and K9a's out projection, pass
//              qcols = 0);
//   EPI_QKV2:  K9a's QKV: acc + bias to out on every column, and on the
//              tiles of the first qcols columns (qcols a multiple of the
//              tile width) also (acc + bias) * qscale to out2 (M, qcols),
//              each rounded once from f32: the tile is staged and stored
//              twice, unscaled first;
//   EPI_PROJ:  (acc + bias) * gamma + resid (K1's LayerScale);
//   EPI_RESID: acc + bias + resid (K4: no LayerScale);
//   EPI_NONE:  acc (K6, no bias; K9c's and K8c's da and dh);
//   EPI_F32:   acc in f32 to chunk z's slice of ep.part, unrounded (K9c's
//              and K8c's weight gradients, below);
//   EPI_GY:    K8c's dgamma partials: no output tile; each warpgroup
//              stages its 64 rows of acc in f32, 32 columns at a time, in
//              the tile's last stage, and 32 of its threads write, for its
//              64-row block y,
//              ep.part[y Nc + col] = the sum over the block's rows (< M),
//              in row order, of resid[row][col] (acc + bias[col]) (the
//              first port's TG_GY: dgamma = sum g (ctx Wo + bo) with y
//              recomputed in f32).
// Two operand forms serve the training backward's products, the same
// kernel with the major-ness of each operand a template parameter: kBK
// reads W K-major, stored (Nc, K) (da = g Wo^T with Wo stored (in, out):
// the descriptor without the transpose bit), and kAT reads A MN-major,
// stored (K, M) (dWo = ctx^T g: A's 64 x 64 boxes of rows of ctx, the
// transpose bit set). A weight gradient sums over all rows: K is split into
// fixed chunks of whole k16 steps (the caller's), each work item writes the
// f32 partial of one output tile over its chunk, and the caller's
// reduce_partials launch adds the partials in chunk order: no atomics, so
// the sums repeat bit for bit. Every output element takes its k16 steps in
// order, one wgmma each, as the first port's WMMA GEMM took them in
// mma.sync steps.
// What bounds it: at 64 x 257 x 768 the QKV GEMM is 58.2 GFLOP against
// ~105 MB (tensor cores: 0.059 ms at the bf16 peak), the out projection
// 19.4 GFLOP against ~77 MB (memory: 0.023 ms).

#pragma once

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum {
  HG_EPI_QKV,
  HG_EPI_PROJ,
  HG_EPI_RESID,
  HG_EPI_NONE,
  HG_EPI_F32,
  HG_EPI_GY,
  HG_EPI_QKV2
};

// What the epilogue adds (see the header note); unused fields are ignored.
struct HgEpilogue {
  const float* bias;   // (Nc,); null with HG_EPI_NONE and HG_EPI_F32
  const float* gamma;  // (Nc,), HG_EPI_PROJ
  const bf16* resid;   // (M, Nc), HG_EPI_PROJ, HG_EPI_RESID and HG_EPI_GY
  float qscale;
  int qcols;
  float* part;         // f32 partial sums: (splits, M, Nc) with HG_EPI_F32,
                       // (ceil(M / 64), Nc) with HG_EPI_GY
};

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
  // the epilogue stages the bf16 output tile in one stage (HG_EPI_GY: 32
  // f32 columns of it at a time)
  static_assert(HG_BM * BN * 2 <= kStageBytes, "output tile");
  static_assert(HG_BM * 32 * 4 <= kStageBytes, "GY columns");
};

constexpr int LN_ROWS = 8;        // rows (warps) of a LayerNorm block
constexpr int LN_MAX_CHUNKS = 4;  // 8-element chunks a lane holds: D <= 1024
constexpr int HG_MAX_DIM = 32 * 8 * LN_MAX_CHUNKS;

__device__ __forceinline__ float hg_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over each aligned group of kLanes lanes (hg_warp_sum at 32)
template <int kLanes>
__device__ __forceinline__ float hg_group_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y = LN(x) rounded to bf16, kLanes lanes a row (32 / kLanes rows a
// warp, so that a narrow row still uses every lane and a warp keeps ~1 KB
// of loads in flight), kChunks 8-element chunks a lane; D % 8 == 0,
// D <= 8 kLanes kChunks
template <int kLanes, int kChunks>
__global__ void __launch_bounds__(32 * LN_ROWS)
ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, bf16* __restrict__ y, int M,
               int D, float eps) {
  const int row = blockIdx.x * (LN_ROWS * 32 / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const bool live = row < M;  // the group's shuffles need every lane
  if (kLanes == 32 && !live) return;
  const int chunks = D / 8;
  const bf16* xr = x + (size_t)row * D;
  float v[kChunks][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + kLanes * i;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (live && c < chunks) u = *reinterpret_cast<const uint4*>(xr + 8 * c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[i][k] = __bfloat162float(e[k]);
      s += v[i][k];
    }
  }
  const float mu = hg_group_sum<kLanes>(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
    if (lane + kLanes * i < chunks)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = v[i][k] - mu;
        q += d * d;
      }
  const float rstd = rsqrtf(hg_group_sum<kLanes>(q) / D + eps);
  if (!live) return;
  bf16* yr = y + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + kLanes * i;
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

template <int kLanes, int kChunks>
void launch_ln(const bf16* x, const float* scale, const float* bias, bf16* y,
               int M, int D, float eps, cudaStream_t s) {
  constexpr int kRows = LN_ROWS * 32 / kLanes;  // rows of a block
  ln_rows_kernel<kLanes, kChunks><<<(M + kRows - 1) / kRows, 32 * LN_ROWS, 0,
                                    s>>>(x, scale, bias, y, M, D, eps);
}

// ln_rows_kernel at two chunks a lane up to D = 512 (D = 128: four rows a
// warp), four above (K1's D = 768 and 1024: a warp a row)
inline cudaError_t launch_ln_rows(const bf16* x, const float* scale,
                                  const float* bias, bf16* y, int M, int D,
                                  float eps, cudaStream_t s) {
  if (D <= 128)
    launch_ln<8, 2>(x, scale, bias, y, M, D, eps, s);
  else if (D <= 256)
    launch_ln<16, 2>(x, scale, bias, y, M, D, eps, s);
  else if (D <= 512)
    launch_ln<32, 2>(x, scale, bias, y, M, D, eps, s);
  else
    launch_ln<32, LN_MAX_CHUNKS>(x, scale, bias, y, M, D, eps, s);
  return cudaGetLastError();
}

// out(M, Nc) = epilogue(A @ W), all boxes 128-byte swizzled. A (M, K):
// tm_a maps it K-major, (M, K) in 128-row x 64-k boxes, or with kAT
// MN-major, a stored (K, M) in 64 x 64 boxes (the transpose of a weight
// gradient, ctx^T of dWo = ctx^T g). W (K, Nc): tm_w maps it MN-major,
// stored (K, Nc) in 64 x 64 boxes, or with kBK K-major, stored (Nc, K) in
// 64-k x BN-row boxes (the (in, out) weight of da = g Wo^T). tm_out maps
// out (M, Nc) in 64 x 64 boxes (tm_out2 HG_EPI_QKV2's out2 (M, qcols));
// HG_EPI_F32 writes f32 partial sums to
// ep.part instead. K splits into chunks of kchunk (a multiple of 16):
// the work items are the ceil(M / 128) x ceil(Nc / BN) output tiles of
// each chunk, column tiles fastest, then row tiles, then chunks; item i
// of chunk z adds A's and W's k in [z kchunk, (z + 1) kchunk) into
// partial z. Persistent: CTA c takes the items c, c + gridDim.x, ...; Nc
// even.
template <int BN, int kEpi, bool kBK = false, bool kAT = false>
__global__ void __launch_bounds__(HG_THREADS, 2)
hopper_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_out,
                   const __grid_constant__ CUtensorMap tm_out2,
                   const HgEpilogue ep, int M, int K, int Nc, int kchunk) {
  using T = HgTile<BN>;
  extern __shared__ unsigned char hg_smem[];
  unsigned char* ring = align1024(hg_smem);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + T::kStages * T::kStageBytes);
  uint64_t* empty = full + T::kStages;
  const int warp = threadIdx.x / 32;
  const int ntiles = (Nc + BN - 1) / BN;
  const int tiles = ntiles * ((M + HG_BM - 1) / HG_BM);
  const int items = tiles * ((K + kchunk - 1) / kchunk);

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
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
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int tile = item % tiles;
        const int n0 = (tile % ntiles) * BN;
        const int m0 = (tile / ntiles) * HG_BM;
        const int k0 = item / tiles * kchunk;
        const int ktiles = (min(K - k0, kchunk) + HG_BK - 1) / HG_BK;
        for (int kt = 0; kt < ktiles; ++kt, ++step) {
          const int s = step % T::kStages;
          const int k = k0 + kt * HG_BK;
          mbar_wait(empty + s, ((step / T::kStages) & 1) ^ 1);
          unsigned char* a = ring + s * T::kStageBytes;
          mbar_expect_tx(full + s, T::kStageBytes);
          if (kAT) {
            tma_load_2d(a, &tm_a, full + s, m0, k);
            tma_load_2d(a + HG_BK * 128, &tm_a, full + s, m0 + 64, k);
          } else {
            tma_load_2d(a, &tm_a, full + s, k, m0);
          }
          if (kBK) {
            tma_load_2d(a + T::kABytes, &tm_w, full + s, k, n0);
          } else {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(a + T::kABytes + c * HG_BK * 128, &tm_w, full + s,
                          n0 + 64 * c, k);
          }
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
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item % tiles;
    const int n0 = (tile % ntiles) * BN;
    const int m0 = (tile / ntiles) * HG_BM;
    const int z = item / tiles;
    const int kend = min(K, z * kchunk + kchunk);
    const int ktiles = (kend - z * kchunk + HG_BK - 1) / HG_BK;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int s = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      s = (step + kt) % T::kStages;
      mbar_wait(full + s, ((step + kt) / T::kStages) & 1);
      // warpgroup wg's 64 rows of A: 64 K-major rows, or with kAT the
      // second 64 x 64 box
      const unsigned char* a = ring + s * T::kStageBytes + wg * 64 * 128;
      const unsigned char* b = ring + s * T::kStageBytes + T::kABytes;
      // a chunk that ends inside K ends on a k16 step: its last tile takes
      // only its own rows (the rest of the box is the next chunk's)
      const int k = z * kchunk + kt * HG_BK;
      const int ksteps =
          kend < K && kend - k < HG_BK ? (kend - k) / 16 : HG_BK / 16;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HG_BK / 16; ++kk) {
        if (kk >= ksteps) break;
        const uint64_t da = kAT ? sw128_desc(a + kk * 2048, HG_BK * 128, 1024)
                                : sw128_desc(a + kk * 32, 16, 1024);
        const uint64_t db = kBK ? sw128_desc(b + kk * 32, 16, 1024)
                                : sw128_desc(b + kk * 2048, HG_BK * 128, 1024);
        if constexpr (BN == 128)
          wgmma_m64n128<kBK ? 0 : 1, kAT ? 1 : 0>(acc, da, db, 1);
        else
          wgmma_m64n64<kBK ? 0 : 1, kAT ? 1 : 0>(acc, da, db, 1);
      }
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
        mbar_arrive(empty + (step + kt - 1) % T::kStages);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    step += ktiles;
    // both warpgroups' products are done: the last k tile's stage s, not
    // yet handed back, holds the output tile while the producer fills the
    // others with the next tile
    named_sync(1, 128 * HG_CONSUMERS);

    const int r0 = m0 + wg * 64 + lr0;
    if constexpr (kEpi == HG_EPI_F32) {
      // chunk z's partial of the tile, straight from the registers
      float* part = ep.part + (size_t)z * M * Nc;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          if (col < Nc && r0 + 8 * half < M)
            *reinterpret_cast<float2*>(part + (size_t)(r0 + 8 * half) * Nc +
                                       col) =
                make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
      held = s;
      continue;
    }
    if constexpr (kEpi == HG_EPI_GY) {
      // 32 columns at a time: the warpgroup's 64 x 32 f32 block of acc in
      // its part of stage s (8-column chunks XOR-swizzled by row), then
      // thread c < 32 sums column c down the block's rows in order
      float* cs = reinterpret_cast<float*>(ring + s * T::kStageBytes) +
                  wg * 64 * 32;
      const int row0 = m0 + wg * 64;
#pragma unroll
      for (int hc = 0; hc < BN / 32; ++hc) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int lr = lr0 + 8 * half;
            *reinterpret_cast<float2*>(
                cs + lr * 32 + ((8 * jj) ^ (8 * (lr & 3))) + 2 * t) =
                make_float2(acc[4 * (4 * hc + jj) + 2 * half],
                            acc[4 * (4 * hc + jj) + 2 * half + 1]);
          }
        named_sync(2 + wg, 128);
        const int col = n0 + 32 * hc + tid;
        if (tid < 32 && col < Nc && row0 < M) {
          const float bc = ep.bias[col];
          float sum = 0.f;
          for (int r = 0; r < 64 && row0 + r < M; ++r)
            sum += __bfloat162float(ep.resid[(size_t)(row0 + r) * Nc + col]) *
                   (cs[r * 32 + (tid ^ (8 * (r & 3)))] + bc);
          ep.part[(size_t)(row0 / 64) * Nc + col] = sum;
        }
        named_sync(2 + wg, 128);
      }
      held = s;
      continue;
    }
    unsigned char* out_s =
        ring + s * T::kStageBytes + wg * 64 * BN * 2;  // BN / 64 boxes
    // HG_EPI_QKV2 stages and stores a q tile twice: qkv, then the scaled
    // copy once the first stores have read the stage
    const int rounds = kEpi == HG_EPI_QKV2 && n0 < ep.qcols ? 2 : 1;
    for (int round = 0; round < rounds; ++round) {
      if (round == 1) {
        if (tid == 0) bulk_wait_read();
        named_sync(2 + wg, 128);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= Nc) continue;
        float2 bb = make_float2(0.f, 0.f);
        if (kEpi != HG_EPI_NONE)
          bb = *reinterpret_cast<const float2*>(ep.bias + col);
        float2 gg = make_float2(1.f, 1.f);
        if (kEpi == HG_EPI_PROJ)
          gg = *reinterpret_cast<const float2*>(ep.gamma + col);
        const bool scaled = (kEpi == HG_EPI_QKV && col < ep.qcols) ||
                            (kEpi == HG_EPI_QKV2 && round == 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * half;
          if (row >= M) continue;
          const size_t at = (size_t)row * Nc + col;
          const int lr = lr0 + 8 * half;
          float v0 = acc[4 * j + 2 * half];
          float v1 = acc[4 * j + 2 * half + 1];
          if (kEpi != HG_EPI_NONE) {
            v0 += bb.x;
            v1 += bb.y;
          }
          if (scaled) {
            v0 *= ep.qscale;
            v1 *= ep.qscale;
          }
          if (kEpi == HG_EPI_PROJ || kEpi == HG_EPI_RESID) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(ep.resid + at));
            if (kEpi == HG_EPI_PROJ) {
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
      fence_proxy_async();
      named_sync(2 + wg, 128);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_store_2d(round == 1 ? &tm_out2 : &tm_out, out_s + c * 8192,
                       n0 + 64 * c, m0 + wg * 64);
        bulk_commit();
      }
    }
    // the stage goes back to the producer once the stores have read it,
    // which the next tile's first k step waits for
    held = s;
  }
  if (tid == 0) bulk_wait_read();
}

// 128-wide column tiles where Nc allows them (every DINOv2 width: 3D and
// D are multiples of 128), else 64-wide (D = 64 H with H odd; Swin-T's
// 2C = 192; a column tail masked). 64-wide tiles where they leave fewer
// tiles to the busiest SM (K8a's B = 16) were no faster on an H100 80GB at
// 700 W. kchunk 0 is K (no split); a split's kchunk is a multiple of 16.
// With kBK, w is stored (Nc, K); else (K, Nc).
template <int kEpi, bool kBK = false, bool kAT = false>
cudaError_t launch_gemm(const CUtensorMap& ta, const bf16* w, int K, int Nc,
                        const HgEpilogue& ep, bf16* out, int M,
                        cudaStream_t s, int kchunk = 0,
                        bf16* out2 = nullptr) {
  const int bn = Nc % 128 == 0 ? 128 : 64;
  if (kchunk <= 0) kchunk = K;
  CUtensorMap tw;
  const cuuint64_t dims[2] = {(cuuint64_t)(kBK ? K : Nc),
                              (cuuint64_t)(kBK ? Nc : K)};
  const cuuint64_t strides[1] = {(cuuint64_t)(kBK ? K : Nc) * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)(kBK ? bn : HG_BK)};
  if (!make_tmap(&tw, w, 2, dims, strides, box)) return cudaErrorInvalidValue;
  CUtensorMap to{};
  if (kEpi != HG_EPI_F32 && kEpi != HG_EPI_GY) {
    const cuuint64_t odims[2] = {(cuuint64_t)Nc, (cuuint64_t)M};
    const cuuint64_t ostrides[1] = {(cuuint64_t)Nc * 2};
    const cuuint32_t obox[2] = {64, 64};
    if (!make_tmap(&to, out, 2, odims, ostrides, obox))
      return cudaErrorInvalidValue;
  }
  CUtensorMap to2{};
  if (kEpi == HG_EPI_QKV2) {
    const cuuint64_t dims2[2] = {(cuuint64_t)ep.qcols, (cuuint64_t)M};
    const cuuint64_t strides2[1] = {(cuuint64_t)ep.qcols * 2};
    const cuuint32_t obox[2] = {64, 64};
    if (ep.qcols % bn != 0 ||
        !make_tmap(&to2, out2, 2, dims2, strides2, obox))
      return cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const long long items = (long long)((Nc + bn - 1) / bn) *
                          ((M + HG_BM - 1) / HG_BM) *
                          ((K + kchunk - 1) / kchunk);
  const int grid = (int)(items < 2 * sms ? items : 2 * sms);
  if (bn == 128)
    hopper_gemm_kernel<128, kEpi, kBK, kAT>
        <<<grid, HG_THREADS, HgTile<128>::kSmem, s>>>(ta, tw, to, to2, ep, M,
                                                       K, Nc, kchunk);
  else
    hopper_gemm_kernel<64, kEpi, kBK, kAT>
        <<<grid, HG_THREADS, HgTile<64>::kSmem, s>>>(ta, tw, to, to2, ep, M,
                                                      K, Nc, kchunk);
  return cudaGetLastError();
}

// a bf16 (rows, cols) matrix in 64 x 64 boxes: the MN-major A of a weight
// gradient (rows = K, cols = M)
bool map_tiles64(CUtensorMap* m, const bf16* a, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  return make_tmap(m, a, 2, dims, strides, box);
}

// the A operand (M, K) of a GEMM in 64 x 128 boxes
bool map_rows(CUtensorMap* m, const bf16* a, int M, int K) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {HG_BK, HG_BM};
  return make_tmap(m, a, 2, dims, strides, box);
}

// raises the dynamic shared-memory limit of this translation unit's GEMMs
// with epilogue kEpi and operand forms kBK, kAT (both tile widths)
template <int kEpi, bool kBK = false, bool kAT = false>
cudaError_t allow_gemm_smem() {
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const cudaError_t e = cudaFuncSetAttribute(
      hopper_gemm_kernel<128, kEpi, kBK, kAT>, a, HgTile<128>::kSmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(hopper_gemm_kernel<64, kEpi, kBK, kAT>, a,
                              HgTile<64>::kSmem);
}

}  // namespace
