// Fused w8a8 pre-LN attention half-block for Hopper (sm_90a), kernel K2:
//
//   out = x + gamma * ((int8(MHSA(int8(LN(x)*s + b) @ Wqkv_q)) @ Wo_q)
//                      * so + bo)
//
// Replaces geovpr/ops/pallas_mhsa.py::fused_mhsa_block_int8 (:554, its
// pallas_call at :609; body _mhsa_kernel_v3_int8 :476 with qk8=True,
// pv8=False and skip_max=True, the JAX defaults). The static scales arrive
// folded by DinoV2Block's int8 fold (geovpr/models/dinov2.py:201-249): 1/a_x
// in the LN scale and bias; a_x * column scale in sqkv, with 1/a_q, 1/a_k
// and 1/a_ctx folded into the q, k and v thirds; a_ctx * column scale in
// so; cs2 = a_q a_k dh^-0.5 log2(e), the score dequant constant in the
// exp2 domain. In order:
//   1. LN -> * ln_scale + ln_bias -> int8 (round half to even);
//   2. int8 GEMM with Wqkv_q -> * sqkv + bqkv;
//   3. q and k rounded and clipped to int8; v rounded to bf16;
//   4. per head, int8 q.k^T over dh = 64 (s32), times cs2;
//   5. p = exp2(min(s, 100)), with no max-shift: the clamp keeps p below
//      2^100, and p, held in f32 and rounded to bf16 for the product (never
//      fp16, whose range ends at 65504), cannot overflow; one pass over the
//      keys and no rescaling;
//   6. ctx = (bf16(p) @ v) / sum(p), the sum taken over the f32 p;
//   7. ctx -> int8;
//   8. int8 GEMM with Wo_q -> * so + bo -> * gamma + x, bf16 store.
// The TPU kernel splits off the last key (na = n - 1) to fit its 256-wide
// tiles and keeps that key's p in f32; this kernel masks keys past N for
// any N, as K1 does, and rounds every p to bf16; the tolerance of its
// checks covers the difference.
//
// Four launches on the caller's stream, K3's and K5's int8 pieces and an
// int8-score form of K1's attention (`geovpr_mhsa_int8_parts` runs a range
// of them, for timing one by one):
//   0. ln_quant_kernel (hopper_gemm_s8.cuh): int8(LN(x) s' + b') into the
//      ctx8 buffer, free until the attention writes it, once per row;
//   1. hopper_gemm_s8_kernel<EPI_QK8V>: acc sqkv + bqkv, q | k rounded to
//      int8 -> qk8 (M, 2D), v rounded to bf16 -> v (M, D);
//   2. vit_attn8_tma_kernel (below): qk8, v -> ctx8 (M, D) int8;
//   3. hopper_gemm_s8_kernel<EPI_RESID_G>: (ctx8 Wo^T so + bo) gamma + x.
// Launches 0, 1 and 3 keep the first port's expressions (ln_quant_row's
// order of f32 sums; acc * s + b fused; (acc * s + b) * gamma + x with
// gamma a compile-time epilogue, so it is one fused multiply-add).
//
// What bounds each launch on the H100 (DINOv2-B/14, B=64: 16,448 rows, D
// 768, 12 heads): the LN-quant pass by bytes (0.011 ms at 3.35 TB/s); the
// QKV GEMM by operations (58 GOP, 0.029 ms at 1,979 TOP/s); the attention
// by bytes (qk8 and v read, ctx8 written: 63 MB, 0.019 ms; 6.5 GOP of int8
// scores and 6.5 GFLOP of bf16 P V); the out projection by bytes (ctx8, x
// read, out written: 0.019 ms). The first port re-ran the LayerNorm in
// each of the QKV kernel's 18 column blocks (half the int8 retrieve's
// device time).
//
// vit_attn8_tma_kernel: one CTA per (64 query rows, head, image); a
// producer warp loads the head's q8 tile, then streams 64-key tiles of k8
// and v through a 4-stage ring by TMA, counted on mbarriers, from 3-d
// tensor maps of qk8 (2D bytes, N tokens, B) and v (D, N, B), so keys past
// N read as zero and the shared memory does not grow with N. A head's q8
// or k8 row is 64 bytes: 64-byte boxes with the 64-byte swizzle, read by
// ldmatrix (a 16 x 32 int8 tile as 16 x 16 of b16) without bank conflicts,
// as K5's; v comes in K1's 64 x 64 bf16 box with the 128-byte swizzle. The
// consumer warpgroup: each warp forms its 16 rows' scores, exact int32
// sums of mma.sync m16n8k32 (two k steps over dh = 64), s = si * cs2 as
// the plain version rounds it, p = 2^min(s, 100) by the SFU's ex2 (which
// flushes p < 2^-126 to zero where exp2f kept a subnormal: no bf16 p or
// f32 row sum it could change occurs), keys >= N set to 0, the f32 row
// sums, and p rounded to bf16 straight into the A fragments of O += P V
// (the accumulator layout of the scores is theirs), a warpgroup wgmma with
// V the MN-major B operand, as K1's. The context, divided by the f32 row
// sum and rounded once to int8, is written over the q8 tile (each warp its
// own rows) and stored by TMA, which drops the rows past N.

#include "hopper_gemm_s8.cuh"

namespace {

constexpr int A8_DH = 64;          // head dim of every DINOv2 variant
constexpr int A8_ROWS = 64;        // query rows of a CTA: one warpgroup
constexpr int A8_KEYS = 64;        // keys of a tile
constexpr int A8_STAGES = 4;
constexpr int A8_THREADS = 128 + 32;  // the consumer warpgroup + a producer
constexpr int A8_QK = A8_ROWS * A8_DH;         // bytes of a q8 or k8 tile
constexpr int A8_STAGE = A8_QK + A8_KEYS * A8_DH * 2;  // k8 and v
// q8, the ring, 2 A8_STAGES + 1 barriers and align1024's slack
constexpr int A8_SMEM =
    A8_QK + A8_STAGES * A8_STAGE + (2 * A8_STAGES + 1) * 8 + 1024;
constexpr int A8_MAX_DIM = 1024;   // the LN-quant pass stages a row a warp

// Shared-memory address of 16-byte chunk c (dims 16 c .. 16 c + 15) of row
// r of a q8 or k8 tile at `base`, through the 64-byte swizzle (chunk c of
// a 64-byte row r sits at c ^ ((r / 2) % 4))
__device__ __forceinline__ uint32_t a8_addr(uint32_t base, int r, int c) {
  return base + r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t a8_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ctx8 (B*N, D) int8 from qk8 (B*N, 2D) int8 and v (B*N, D) bf16: tm_qk
// maps qk8 as (2D, N, B) and tm_ctx ctx8 as (D, N, B) in (64, 64, 1) boxes
// of bytes with the 64-byte swizzle, tm_v v as (D, N, B) in (64, 64, 1)
// bf16 boxes with the 128-byte swizzle; head h of q, k and v at columns
// h*64, D + h*64 and h*64. Grid (ceil(N / 64), H, B).
__global__ void __launch_bounds__(A8_THREADS, 3)
vit_attn8_tma_kernel(const __grid_constant__ CUtensorMap tm_qk,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_ctx, int N,
                     int D, float cs2) {
  extern __shared__ unsigned char a8_smem[];
  unsigned char* q_s = align1024(a8_smem);
  unsigned char* ring = q_s + A8_QK;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + A8_STAGES * A8_STAGE);
  uint64_t* empty = full + A8_STAGES;
  uint64_t* q_bar = empty + A8_STAGES;
  const int q0 = blockIdx.x * A8_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (N + A8_KEYS - 1) / A8_KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < A8_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer: the q8 tile, then k8 and v tiles
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_bar, A8_QK);
      tma_load_3d(q_s, &tm_qk, q_bar, h * A8_DH, q0, b);
      for (int i = 0; i < tiles; ++i) {
        const int s = i % A8_STAGES;
        unsigned char* st = ring + s * A8_STAGE;
        mbar_wait(empty + s, ((i / A8_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, A8_STAGE);
        tma_load_3d(st, &tm_qk, full + s, D + h * A8_DH, i * A8_KEYS, b);
        tma_load_3d(st + A8_QK, &tm_v, full + s, h * A8_DH, i * A8_KEYS, b);
      }
    }
    return;
  }

  // the consumer warpgroup: thread 32 w + 4 g + t holds query rows 16 w + g
  // (half 0) and 16 w + g + 8 (half 1), keys 8 j + 2 t (+ 1) of each 8-key
  // group j of a tile
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  const uint32_t qs = smem_u32(q_s);
  mbar_wait(q_bar, 0);
  // this warp's 16 query rows as the A fragments of the two k32 steps
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldmatrix_x4<false>(qa[kk], a8_addr(qs, 16 * warp + (lane & 15),
                                       2 * kk + (lane >> 4)));

  float o[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  float l[2] = {0.f, 0.f};
  for (int i = 0; i < tiles; ++i) {
    const int st = i % A8_STAGES;
    unsigned char* k_s = ring + st * A8_STAGE;
    const uint32_t ks = smem_u32(k_s);
    const int k0 = i * A8_KEYS;
    mbar_wait(full + st, (i / A8_STAGES) & 1);
    // per 16-key slice kc: exact int32 scores, p, and p in bf16 as the A
    // fragment of the slice (rows g / g + 8, keys 2t / 2t + 8)
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      int si[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // kb[0..1]: keys 16 kc .. + 7, kb[2..3]: the next 8
        uint32_t kb[4];
        ldmatrix_x4<false>(kb, a8_addr(ks, 16 * kc + (lane & 7) +
                                               ((lane >> 4) << 3),
                                       2 * kk + ((lane >> 3) & 1)));
        mma_s8(si[0], qa[kk], kb[0], kb[1]);
        mma_s8(si[1], qa[kk], kb[2], kb[3]);
      }
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 16 * kc + 8 * j + 2 * t + (e & 1);
          p[j][e] = key < N
                        ? exp2_ftz(fminf((float)si[j][e] * cs2, 100.f))
                        : 0.f;
          l[e >> 1] += p[j][e];
        }
      pa[kc][0] = a8_pack_bf16(p[0][0], p[0][1]);
      pa[kc][1] = a8_pack_bf16(p[0][2], p[0][3]);
      pa[kc][2] = a8_pack_bf16(p[1][0], p[1][1]);
      pa[kc][3] = a8_pack_bf16(p[1][2], p[1][3]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_m64n64_rs<1>(o, pa[kc],
                         sw128_desc(k_s + A8_QK + kc * 2048, 1024, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) fence_regs(pa[kc]);
    if (tid == 0) mbar_arrive(empty + st);
  }

  // the four lanes of a row hold its partial sums; ctx / l rounded once to
  // int8 over this warp's rows of the q8 tile, then stored by TMA
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float& lh = l[half];
    lh += __shfl_xor_sync(0xffffffffu, lh, 1);
    lh += __shfl_xor_sync(0xffffffffu, lh, 2);
    const int r = 16 * warp + (lane >> 2) + 8 * half;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st_shared_u16(a8_addr(qs, r, j >> 1) + (j & 1) * 8 + 2 * t,
                    pack_i8x2(round_clip_i8(o[4 * j + 2 * half] / lh),
                              round_clip_i8(o[4 * j + 2 * half + 1] / lh)));
  }
  fence_proxy_async();
  named_sync(1, 128);
  if (tid == 0) {
    tma_store_3d(&tm_ctx, q_s, h * A8_DH, q0, b);
    bulk_commit();
    bulk_wait_read();
  }
}

// the (cols, N, B) view of a (B*N, cols) matrix of `elem` bytes an element
// in (64, 64, 1) boxes
bool a8_map(CUtensorMap* m, const void* a, int cols, int N, int B, int elem) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem,
                                 (cuuint64_t)N * cols * elem};
  const cuuint32_t box[3] = {64, 64, 1};
  return elem == 2 ? make_tmap(m, a, 3, dims, strides, box)
                   : make_tmap_of(m, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                  CU_TENSOR_MAP_SWIZZLE_64B, a, 3, dims,
                                  strides, box);
}

cudaError_t launch_vit_attn8(const int8_t* qk8, const bf16* v, int8_t* ctx8,
                             int B, int N, int D, int H, float cs2,
                             cudaStream_t s) {
  CUtensorMap tq, tv, tc;
  if (!a8_map(&tq, qk8, 2 * D, N, B, 1) || !a8_map(&tv, v, D, N, B, 2) ||
      !a8_map(&tc, ctx8, D, N, B, 1))
    return cudaErrorInvalidValue;
  vit_attn8_tma_kernel<<<dim3((N + A8_ROWS - 1) / A8_ROWS, H, B), A8_THREADS,
                         A8_SMEM, s>>>(tq, tv, tc, N, D, cs2);
  return cudaGetLastError();
}

}  // namespace

// Raises the kernels' dynamic shared-memory limits on the current device
// and finds the CUDA driver's tensor-map encoder. Called once per device
// before the first launch; returns a cudaError_t as int.
extern "C" int geovpr_mhsa_int8_init(void) {
  cudaError_t e;
  if (tmap_encode_fn() == nullptr) return (int)cudaErrorSymbolNotFound;
  if ((e = allow_gemm_s8_smem<HS_EPI_QK8V>()) != cudaSuccess ||
      (e = allow_gemm_s8_smem<HS_EPI_RESID_G>()) != cudaSuccess)
    return (int)e;
  return (int)cudaFuncSetAttribute(vit_attn8_tma_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   A8_SMEM);
}

// K2's launches first..last (0 LN-quant, 1 QKV GEMM, 2 int8-score
// attention, 3 out projection); returns a cudaError_t as int: 0 when every
// launch was accepted. x and out (B*N, D) bf16; wqkv_t (3D, D) and wo_t
// (D, D) int8, k-contiguous; ln_scale, ln_bias (1/a_x folded in), sqkv,
// bqkv, so, bo and gamma f32; all 16-byte aligned. Scratch: qk8 (B*N, 2D)
// int8, v (B*N, D) bf16, ctx8 (B*N, D) int8 (the LN-quant output until the
// attention writes ctx8). D = 64 H <= 1024. cs2 = a_q a_k dh^-0.5
// log2(e). A launch alone reads what the earlier launches of an earlier
// call left in the scratch. geovpr_mhsa_int8_init must have run on the
// current device.
extern "C" int geovpr_mhsa_int8_parts(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* wqkv_t, const void* sqkv, const void* bqkv, const void* wo_t,
    const void* so, const void* bo, const void* gamma, void* qk8, void* v,
    void* ctx8, void* out, int B, int N, int D, int H, float eps, float cs2,
    int first, int last, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D != H * A8_DH || D > A8_MAX_DIM ||
      B > 65535 || first < 0 || last > 3 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* c8 = static_cast<int8_t*>(ctx8);
  cudaError_t e;
  for (int part = first; part <= last; ++part) {
    switch (part) {
      case 0:
        e = launch_ln_quant(static_cast<const bf16*>(x),
                            static_cast<const float*>(ln_scale),
                            static_cast<const float*>(ln_bias), c8, M, D, eps,
                            s);
        break;
      case 1:
        e = launch_gemm_s8<HS_EPI_QK8V>(
            c8, static_cast<const int8_t*>(wqkv_t), M, D, 3 * D,
            HsEpilogue{static_cast<const float*>(sqkv),
                       static_cast<const float*>(bqkv), nullptr, nullptr, 0.f,
                       2 * D},
            static_cast<int8_t*>(qk8), static_cast<bf16*>(v), s);
        break;
      case 2:
        e = launch_vit_attn8(static_cast<const int8_t*>(qk8),
                             static_cast<const bf16*>(v), c8, B, N, D, H, cs2,
                             s);
        break;
      default:
        e = launch_gemm_s8<HS_EPI_RESID_G>(
            c8, static_cast<const int8_t*>(wo_t), M, D, D,
            HsEpilogue{static_cast<const float*>(so),
                       static_cast<const float*>(bo),
                       static_cast<const float*>(gamma),
                       static_cast<const bf16*>(x), 0.f, 0},
            nullptr, static_cast<bf16*>(out), s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// K2, all four launches (the whole half-block).
extern "C" int geovpr_mhsa_block_int8(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* wqkv_t, const void* sqkv, const void* bqkv, const void* wo_t,
    const void* so, const void* bo, const void* gamma, void* qk8, void* v,
    void* ctx8, void* out, int B, int N, int D, int H, float eps, float cs2,
    void* stream) {
  return geovpr_mhsa_int8_parts(x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv,
                                wo_t, so, bo, gamma, qk8, v, ctx8, out, B, N,
                                D, H, eps, cs2, 0, 3, stream);
}
