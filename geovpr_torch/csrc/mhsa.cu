// Fused pre-LN ViT attention half-block for Hopper (sm_90a), bf16:
//
//     out = x + gamma * (MHSA(LN(x)) @ Wo + bo)
//
// Replaces geovpr/ops/pallas_mhsa.py::fused_mhsa_block (serving forward,
// Pallas bodies _mhsa_kernel_v3 and _mhsa_kernel). Numerics follow the
// oracle _mhsa_block_xla: LN in f32 rounded to bf16; qkv = LN(x) Wqkv + bqkv
// with f32 accumulation rounded to bf16; per head softmax(q k^T dh^-0.5) in
// f32 with the max-shift; P V with f32 accumulation; ctx Wo + bo, times
// gamma, plus x in f32, rounded to bf16.
//
// What bounds it on the H100: at DINOv2-B/14 shapes (B*N = 64*257 rows,
// D = 768, 12 heads of 64) one call is ~91 GFLOP (qkv 58, attention 13,
// out projection 19) against ~0.25 GB of traffic even with the qkv/ctx
// round trip below, so it is tensor-core bound; the two projections carry
// ~86% of the FLOPs. The TPU kernel exists to
// keep the (B, H, N, N) score planes out of device memory; this design keeps
// that property with a flash-style online softmax over key tiles, so any N
// works and no score ever reaches device memory.
//
// Design (first, simple version; three launches on the caller's stream):
//   1. gemm_kernel<LN, QKV> (bf16_gemm.cuh): a 64-row block of x is
//      LayerNorm-ed in f32 straight into shared memory as bf16 (the whole
//      K = D row width stays resident), then multiplied against 32-row
//      slabs of Wqkv with WMMA 16x16x16 bf16 tensor-core tiles and f32
//      accumulators; + bqkv -> qkv.
//   2. attention_kernel: grid (query tile of 64, head, batch); four warps
//      each own 16 query rows; key/value tiles of 64 rows stream through
//      shared memory; keys past N are masked in the kernel (no padding of
//      the token stream). Output context is normalised by the row sum at
//      the end (deferred normalisation, as in _mhsa_kernel_v3).
//   3. gemm_kernel<plain, PROJ>: ctx @ Wo with the + bo, * gamma, + x
//      epilogue in f32 and the bf16 store.
// qkv and ctx round-trip through device memory between the launches, and
// WMMA stands in for wgmma/TMA: both are the first things a faster version
// changes. The kernels allocate nothing; the caller passes qkv/ctx scratch.

#include "bf16_gemm.cuh"

namespace {

// ----------------------------------------------------------- attention ----
constexpr int DH = 64;       // head dim (every DINOv2 variant)
constexpr int ATT_BQ = 64;   // query rows per block, 16 per warp
constexpr int ATT_BKV = 64;  // key rows per tile
constexpr int ATT_THREADS = 128;
constexpr int T_LD = DH + 8;       // bf16 q/k/v tiles
constexpr int P_LD = ATT_BKV + 8;  // bf16 probabilities
constexpr int S_LD = ATT_BKV + 4;  // f32 scores
constexpr int O_LD = DH + 4;       // f32 running context

constexpr size_t att_smem_bytes() {
  return (size_t)(3 * ATT_BQ * T_LD + ATT_BQ * P_LD) * sizeof(bf16) +
         (size_t)(ATT_BQ * S_LD + ATT_BQ * O_LD) * sizeof(float);
}

__device__ inline void load_tile(bf16* dst, const bf16* src, int row0, int nrows,
                                 size_t ld) {
  for (int i = threadIdx.x; i < 64 * (DH / 8); i += ATT_THREADS) {
    const int r = i / (DH / 8);
    const int c8 = i % (DH / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < nrows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * T_LD + c8 * 8) = v;
  }
}

// qkv: (B*N, 3D) with q|k|v column blocks, head h at columns h*DH of each;
// ctx: (B*N, D).
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ ctx, int N,
                 int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + ATT_BQ * T_LD;
  bf16* Vs = Ks + ATT_BKV * T_LD;
  bf16* Ps = Vs + ATT_BKV * T_LD;
  float* Ss = reinterpret_cast<float*>(Ps + ATT_BQ * P_LD);
  float* Os = Ss + ATT_BQ * S_LD;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * ATT_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t ld = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * N * ld;

  load_tile(Qs, base + h * DH, q0, N, ld);

  // softmax state: lane pair (2r, 2r+1) owns row warp*16 + r, each lane
  // half of its 64 columns; columns visited in a lane-rotated order so the
  // 32 lanes hit 32 distinct shared-memory banks
  const int r_loc = warp * 16 + (lane >> 1);
  const int half = (lane & 1) * 32;
  float* srow = Ss + r_loc * S_LD + half;
  float* orow = Os + r_loc * O_LD + half;
  bf16* prow = Ps + r_loc * P_LD + half;
  for (int i = 0; i < 32; ++i) orow[i] = 0.f;
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int kv0 = 0; kv0 < N; kv0 += ATT_BKV) {
    __syncthreads();  // previous tile's K/V reads are done
    load_tile(Ks, base + D + h * DH, kv0, N, ld);
    load_tile(Vs, base + 2 * D + h * DH, kv0, N, ld);
    __syncthreads();

    // S (16 x 64 per warp) = Q K^T
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(s[j], 0.f);
#pragma unroll
      for (int kd = 0; kd < DH; kd += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq;
        wmma::load_matrix_sync(fq, Qs + warp * 16 * T_LD + kd, T_LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
          wmma::load_matrix_sync(fk, Ks + j * 16 * T_LD + kd, T_LD);
          wmma::mma_sync(s[j], fq, fk, s[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * S_LD + j * 16, s[j], S_LD,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile (f32, max-shifted, keys >= N masked);
    // the tile always holds key kv0 < N, so the pair's max is finite
    float mx = -INFINITY;
    for (int i = 0; i < 32; ++i) {
      const int c = (i + lane) & 31;
      if (kv0 + half + c < N) mx = fmaxf(mx, srow[c] * scale);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float sum = 0.f;
    for (int i = 0; i < 32; ++i) {
      const int c = (i + lane) & 31;
      float p = 0.f;
      if (kv0 + half + c < N) p = expf(srow[c] * scale - m_new);
      prow[c] = __float2bfloat16(p);
      sum += p;
      orow[c] *= alpha;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    __syncwarp();

    // O (16 x 64 per warp) = alpha * O + P V
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(o[j], Os + warp * 16 * O_LD + j * 16, O_LD,
                               wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < ATT_BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
        wmma::load_matrix_sync(fp, Ps + warp * 16 * P_LD + kk, P_LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
          wmma::load_matrix_sync(fv, Vs + kk * T_LD + j * 16, T_LD);
          wmma::mma_sync(o[j], fp, fv, o[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Os + warp * 16 * O_LD + j * 16, o[j], O_LD,
                                wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int row = q0 + r_loc;
  if (row < N) {
    const float inv = 1.f / l_i;
    bf16* dst = ctx + ((size_t)b * N + row) * D + h * DH + half;
    for (int i = 0; i < 32; ++i) dst[i] = __float2bfloat16(orow[i] * inv);
  }
}

}  // namespace

// Largest row width D the GEMMs take: the whole A row block sits in shared
// memory, so D is bounded by the 227 KB a block may use.
extern "C" int geovpr_mhsa_max_dim(void) {
  int d = 0;
  while (gemm_smem_bytes(d + DH) <= 232448) d += DH;
  return d;
}

// Raises the three kernels' dynamic shared-memory limit on the current
// device to what the largest D needs. Called once per device before the
// first launch; returns a cudaError_t as int.
extern "C" int geovpr_mhsa_init(void) {
  const int gsmem = (int)gemm_smem_bytes(geovpr_mhsa_max_dim());
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(gemm_kernel<true, EPI_QKV>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                gsmem)) != cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(gemm_kernel<false, EPI_PROJ>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                gsmem)) != cudaSuccess)
    return (int)e;
  return (int)cudaFuncSetAttribute(attention_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)att_smem_bytes());
}

// Returns a cudaError_t as int: 0 when every launch was accepted. Pointers
// are device pointers; x/wqkv/wo/qkv/ctx/out are bf16, the vectors f32.
// qkv is (B*N, 3D) scratch, ctx (B*N, D) scratch. geovpr_mhsa_init must have
// run on the current device.
extern "C" int geovpr_mhsa_block_bf16(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* gamma,
    void* qkv, void* ctx, void* out, int B, int N, int D, int H, float eps,
    void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D != H * DH || D > geovpr_mhsa_max_dim())
    return (int)cudaErrorInvalidValue;
  const int M = B * N;
  const int m_blocks = (M + GEMM_BM - 1) / GEMM_BM;
  if (m_blocks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const size_t gsmem = gemm_smem_bytes(D);
  const size_t asmem = att_smem_bytes();
  cudaError_t e;

  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* ctxb = static_cast<bf16*>(ctx);

  gemm_kernel<true, EPI_QKV>
      <<<dim3((3 * D + GEMM_BN - 1) / GEMM_BN, m_blocks), GEMM_THREADS, gsmem, s>>>(
          xb, static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
          static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
          eps, nullptr, nullptr, qkvb, M, D, 3 * D, 1.f, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  attention_kernel<<<dim3((N + ATT_BQ - 1) / ATT_BQ, H, B), ATT_THREADS, asmem, s>>>(
      qkvb, ctxb, N, D, 1.f / sqrtf((float)DH));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  gemm_kernel<false, EPI_PROJ>
      <<<dim3((D + GEMM_BN - 1) / GEMM_BN, m_blocks), GEMM_THREADS, gsmem, s>>>(
          ctxb, static_cast<const bf16*>(wo), static_cast<const float*>(bo),
          nullptr, nullptr, 0.f, static_cast<const float*>(gamma), xb,
          static_cast<bf16*>(out), M, D, D, 1.f, 0);
  return (int)cudaGetLastError();
}
