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
// that property with a two-pass softmax over key tiles (vit_attn.cuh), so
// any N works and no score ever reaches device memory.
//
// Design (first, simple version; three launches on the caller's stream):
//   1. gemm_kernel<LN, QKV> (bf16_gemm.cuh): a 64-row block of x is
//      LayerNorm-ed in f32 straight into shared memory as bf16 (the whole
//      K = D row width stays resident), then multiplied against 32-row
//      slabs of Wqkv with WMMA 16x16x16 bf16 tensor-core tiles and f32
//      accumulators; + bqkv -> qkv.
//   2. vit_attn_fwd_kernel (vit_attn.cuh): grid (query tile of 64, head,
//      batch); four warps each own 16 query rows; key tiles of 64 rows
//      stream through shared memory twice, first for each row's max and
//      sum, then for p = exp(s - max) / sum rounded to bf16 (as the oracle
//      rounds it) times V by mma.sync; keys past N are masked in the kernel
//      (no padding of the token stream).
//   3. gemm_kernel<plain, PROJ>: ctx @ Wo with the + bo, * gamma, + x
//      epilogue in f32 and the bf16 store.
// qkv and ctx round-trip through device memory between the launches, and
// WMMA stands in for wgmma/TMA: both are the first things a faster version
// changes. The kernels allocate nothing; the caller passes the qkv and ctx
// buffers, which the training forward (K8a) keeps as its residuals.

#include "bf16_gemm.cuh"
#include "vit_attn.cuh"

// Largest row width D the GEMMs take: the whole A row block sits in shared
// memory, so D is bounded by the 227 KB a block may use.
extern "C" int geovpr_mhsa_max_dim(void) {
  int d = 0;
  while (gemm_smem_bytes(d + VT_DH) <= 232448) d += VT_DH;
  return d;
}

// Raises the two GEMMs' dynamic shared-memory limit on the current
// device to what the largest D needs. Called once per device before the
// first launch; returns a cudaError_t as int.
extern "C" int geovpr_mhsa_init(void) {
  const int gsmem = (int)gemm_smem_bytes(geovpr_mhsa_max_dim());
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(gemm_kernel<true, EPI_QKV>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                gsmem)) != cudaSuccess)
    return (int)e;
  return (int)cudaFuncSetAttribute(gemm_kernel<false, EPI_PROJ>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   gsmem);
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
  if (B <= 0 || N <= 0 || H <= 0 || D != H * VT_DH || D > geovpr_mhsa_max_dim())
    return (int)cudaErrorInvalidValue;
  const int M = B * N;
  const int m_blocks = (M + GEMM_BM - 1) / GEMM_BM;
  if (m_blocks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const size_t gsmem = gemm_smem_bytes(D);
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

  vit_attn_fwd_kernel<<<dim3((N + VT_CH - 1) / VT_CH, H, B), VT_THREADS, 0, s>>>(
      qkvb, ctxb, N, D, 1.f / sqrtf((float)VT_DH));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  gemm_kernel<false, EPI_PROJ>
      <<<dim3((D + GEMM_BN - 1) / GEMM_BN, m_blocks), GEMM_THREADS, gsmem, s>>>(
          ctxb, static_cast<const bf16*>(wo), static_cast<const float*>(bo),
          nullptr, nullptr, 0.f, static_cast<const float*>(gamma), xb,
          static_cast<bf16*>(out), M, D, D, 1.f, 0);
  return (int)cudaGetLastError();
}
