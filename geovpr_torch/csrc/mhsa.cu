// Fused pre-LN ViT attention half-block for Hopper (sm_90a), bf16:
//
//     out = x + gamma * (MHSA(LN(x)) @ Wo + bo)
//
// Replaces geovpr/ops/pallas_mhsa.py::fused_mhsa_block (:904, its
// pallas_call at :1064; serving) and, as K8a, ::_fused_mhsa_pallas_train
// (:1094, pallas_call at :1129; the training forward, which also keeps
// qkv and ctx). Numerics follow the oracle _mhsa_block_xla (:871) and the
// masked training body _mhsa_train_kernel (:644): LN in f32 rounded to
// bf16; qkv = LN(x) Wqkv + bqkv with f32 accumulation, rounded to bf16
// (post-bias, unscaled); per head s = f32(q k^T) * dh^-0.5, each row's max
// and sum taken over all N keys before any p is formed, p = exp(s - max) /
// sum in f32 rounded to bf16, P V with f32 accumulation, ctx rounded to
// bf16; out = (ctx Wo + bo) * gamma + x in f32, rounded once.
//
// What bounds it on the H100: at DINOv2-B/14 shapes (B*N = 64*257 rows,
// D = 768, 12 heads of 64) one call is ~91 GFLOP (qkv 58, attention 13,
// out projection 19) against ~0.25 GB of traffic with the qkv/ctx round
// trips, so the tensor cores bound it (0.092 ms at 989 TFLOP/s); the two
// projections carry ~86% of the FLOPs. The TPU kernel exists to keep the
// (B, H, N, N) score planes out of device memory; this design keeps that
// property. As built, the attention's exact softmax (below), ~20
// instructions a score over the two passes, and not its products, is what
// the attention's time is spent on.
//
// Four launches on the caller's stream (`geovpr_mhsa_block_parts` runs a
// range of them, for timing one by one):
//   0. ln_rows_kernel (hopper_gemm.cuh): bf16 LN(x) into the ctx buffer,
//      which is free until the attention writes it;
//   1. hopper_gemm_kernel<EPI_QKV>: LN(x) Wqkv + bqkv -> qkv, by TMA into
//      a shared-memory ring and wgmma (hopper_gemm.cuh);
//   2. vit_attn_tma_kernel (below): ctx, the exact two-pass softmax;
//   3. hopper_gemm_kernel<EPI_PROJ>: (ctx Wo + bo) * gamma + x -> out.
// The attention: one CTA per (64 query rows, head, batch element); a
// producer warp streams 64-key K tiles (pass 1), then K and V tiles (pass
// 2), by TMA from a 3-d tensor map of qkv (columns, token, batch: keys
// past N read as zero) through a 4-stage ring, so the shared memory does
// not grow with N and loads overlap the math; one consumer warpgroup
// computes S = Q K^T by wgmma (Q and K K-major), pass 1 the rows' max and
// sum (the four lanes of a row combined by quad shuffles), pass 2 p =
// exp(s - max) / sum with expf and a correctly rounded division, as the
// oracle (and torch.softmax) forms it, rounded to bf16 and kept in
// registers as the A operand of O += P V (wgmma, V the MN-major B operand:
// no transpose). A p formed as exp2 with log2 e folded into the scale, and
// a multiply by 1 / sum, is cheaper but rounds differently from the plain
// version often enough that DINOv2 training's kernel-vs-plain gradients
// drifted apart (chip_smoke.py on an H100: cosine 0.9963 at one tensor
// against the bound of 0.999).
// Keys >= N are masked in both passes, query rows >= N are not stored.
// The kernels allocate nothing; the caller passes the qkv and ctx buffers,
// which the training forward (K8a) keeps as its residuals.

#include "hopper_gemm.cuh"

namespace {

constexpr int AT_DH = 64;         // head dim of every DINOv2 variant
constexpr int AT_ROWS = 64;       // query rows of a CTA: one warpgroup
constexpr int AT_KEYS = 64;       // keys of a tile
constexpr int AT_STAGES = 4;
constexpr int AT_THREADS = 128 + 32;  // the consumer warpgroup + a producer
constexpr int AT_TILE = AT_ROWS * AT_DH * 2;  // bytes of a Q, K or V tile
// Q, the ring's K and V tiles, 2 AT_STAGES + 1 barriers, align1024's slack
constexpr int AT_SMEM =
    (1 + 2 * AT_STAGES) * AT_TILE + (2 * AT_STAGES + 1) * 8 + 1024;

constexpr float AT_LOG2E = 1.4426950408889634f;

// one row's softmax statistics over this lane's keys: the max of the
// scaled scores x and the sum of exp(x - max), taken as exp2((x - max)
// log2 e) (the sum's order differs from the oracle's anyway); `tmax` the
// max of the new tile's x
__device__ __forceinline__ void at_stat_add(float& m, float& l, float tmax,
                                            const float (&x)[32], int half) {
  const float mn = fmaxf(m, tmax);
  if (mn == -INFINITY) return;  // no key of this lane is valid yet
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    sum += exp2f((x[4 * j + 2 * half] - mn) * AT_LOG2E) +
           exp2f((x[4 * j + 2 * half + 1] - mn) * AT_LOG2E);
  l = l * exp2f((m - mn) * AT_LOG2E) + sum;
  m = mn;
}

// combine the statistics of the four lanes of a quad (the same row)
__device__ __forceinline__ void at_stat_reduce(float& m, float& l) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const float mm = fmaxf(m, m2);
    l = (l == 0.f ? 0.f : l * exp2f((m - mm) * AT_LOG2E)) +
        (l2 == 0.f ? 0.f : l2 * exp2f((m2 - mm) * AT_LOG2E));
    m = mm;
  }
}

// s (64 x 64) = Q (64 x dh) K^T, both K-major tiles
__device__ __forceinline__ void at_scores(float (&s)[32],
                                          const unsigned char* q,
                                          const unsigned char* k) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < AT_DH / 16; ++kk)
    wgmma_m64n64<0>(s, sw128_desc(q + kk * 32, 16, 1024),
                    sw128_desc(k + kk * 32, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// ctx (B*N, D) from qkv mapped as (3D columns, N tokens, B) in 64 x 64 x 1
// boxes; head h of q, k, v at columns h*64, D + h*64, 2D + h*64. Grid
// (ceil(N / 64), H, B). scale = dh^-0.5.
__global__ void __launch_bounds__(AT_THREADS, 3)
vit_attn_tma_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                    bf16* __restrict__ ctx, int N, int D, float scale) {
  extern __shared__ unsigned char at_smem[];
  unsigned char* q_s = align1024(at_smem);
  unsigned char* k_s = q_s + AT_TILE;
  unsigned char* v_s = k_s + AT_STAGES * AT_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + AT_STAGES * AT_TILE);
  uint64_t* empty = full + AT_STAGES;
  uint64_t* q_bar = empty + AT_STAGES;
  const int q0 = blockIdx.x * AT_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (N + AT_KEYS - 1) / AT_KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < AT_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer: Q, then K tiles for pass 1, then K and V for pass 2
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_bar, AT_TILE);
      tma_load_3d(q_s, &tm_qkv, q_bar, h * AT_DH, q0, b);
      for (int i = 0; i < 2 * tiles; ++i) {
        const int s = i % AT_STAGES;
        const bool pass2 = i >= tiles;
        const int k0 = (pass2 ? i - tiles : i) * AT_KEYS;
        mbar_wait(empty + s, ((i / AT_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, pass2 ? 2 * AT_TILE : AT_TILE);
        tma_load_3d(k_s + s * AT_TILE, &tm_qkv, full + s, D + h * AT_DH, k0, b);
        if (pass2)
          tma_load_3d(v_s + s * AT_TILE, &tm_qkv, full + s, 2 * D + h * AT_DH,
                      k0, b);
      }
    }
    return;
  }

  // the consumer warpgroup: thread 32 w + 4 g + t holds query rows 16 w + g
  // (half 0) and 16 w + g + 8 (half 1), keys 8 j + 2 t (+ 1) of each tile
  const int tid = threadIdx.x;
  const int t = tid & 3;
  mbar_wait(q_bar, 0);

  float s[32];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int i = 0; i < tiles; ++i) {
    const int st = i % AT_STAGES;
    mbar_wait(full + st, (i / AT_STAGES) & 1);
    at_scores(s, q_s, k_s + st * AT_TILE);
    if (tid == 0) mbar_arrive(empty + st);
    const int k0 = i * AT_KEYS;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int key = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      s[e] = key < N ? s[e] * scale : -INFINITY;
      tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], s[e]);
    }
    at_stat_add(m[0], l[0], tmax[0], s, 0);
    at_stat_add(m[1], l[1], tmax[1], s, 1);
  }
  at_stat_reduce(m[0], l[0]);
  at_stat_reduce(m[1], l[1]);
  // x / sum correctly rounded from one reciprocal a row: q = x r, then q +
  // (x - q sum) r with the remainder exact by fma (Markstein), the f32
  // quotient that the oracle's division gives, bit for bit, in less time
  // than the division takes on an H100
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

  float o[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  for (int i = tiles; i < 2 * tiles; ++i) {
    const int st = i % AT_STAGES;
    mbar_wait(full + st, (i / AT_STAGES) & 1);
    at_scores(s, q_s, k_s + st * AT_TILE);
    const int k0 = (i - tiles) * AT_KEYS;
    // p = exp(x - max) / sum in f32 as the oracle forms it, then rounded
    // to bf16 into the A fragments of the four 16-key slices (the
    // accumulator layout of s is theirs)
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 8 * kc + 2 * r;
        const int half = r & 1;
        const int key = k0 + 16 * kc + 8 * (r >> 1) + 2 * t;
        float p[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (key + c < N) {
            const float x = expf(s[e + c] * scale - m[half]);
            const float q = __fmul_rn(x, rl[half]);
            p[c] = __fmaf_rn(__fmaf_rn(-q, l[half], x), rl[half], q);
          }
        __nv_bfloat162 pp = __floats2bfloat162_rn(p[0], p[1]);
        pa[kc][r] = *reinterpret_cast<uint32_t*>(&pp);
      }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_m64n64_rs<1>(o, pa[kc],
                         sw128_desc(v_s + st * AT_TILE + kc * 2048, 1024, 1024),
                         1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) fence_regs(pa[kc]);
    if (tid == 0) mbar_arrive(empty + st);
  }

  const int r0 = q0 + (tid >> 5) * 16 + ((tid & 31) >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= N) continue;
    bf16* dst = ctx + ((size_t)b * N + row) * D + h * AT_DH + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
  }
}

}  // namespace

// Largest row width D the kernels take (the LayerNorm keeps a row in a
// warp's registers) and the card tests cover.
extern "C" int geovpr_mhsa_max_dim(void) { return HG_MAX_DIM; }

// Raises the kernels' dynamic shared-memory limits on the current device
// and finds the CUDA driver's tensor-map encoder. Called once per device before
// the first launch; returns a cudaError_t as int.
extern "C" int geovpr_mhsa_init(void) {
  cudaError_t e;
  if (tmap_encode_fn() == nullptr) return (int)cudaErrorSymbolNotFound;
  if ((e = allow_gemm_smem<HG_EPI_QKV>()) != cudaSuccess ||
      (e = allow_gemm_smem<HG_EPI_PROJ>()) != cudaSuccess)
    return (int)e;
  return (int)cudaFuncSetAttribute(
      vit_attn_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      AT_SMEM);
}

// K1's launches first..last (0 LayerNorm, 1 QKV GEMM, 2 attention, 3 out
// projection); returns a cudaError_t as int: 0 when every launch was
// accepted. Pointers are device pointers; x/wqkv/wo/qkv/ctx/out are bf16,
// the vectors f32, all 16-byte aligned. qkv is (B*N, 3D) scratch, ctx
// (B*N, D) scratch (LN(x) until the attention writes ctx). A launch alone
// reads what the earlier launches of an earlier call left in qkv and ctx.
// geovpr_mhsa_init must have run on the current device.
extern "C" int geovpr_mhsa_block_parts(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* gamma,
    void* qkv, void* ctx, void* out, int B, int N, int D, int H, float eps,
    int first, int last, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D != H * AT_DH || D > HG_MAX_DIM ||
      B > 65535 || H > 65535 || first < 0 || last > 3 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * N;
  if ((M + HG_BM - 1) / HG_BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* ctxb = static_cast<bf16*>(ctx);
  CUtensorMap tm;
  cudaError_t e;
  for (int part = first; part <= last; ++part) {
    switch (part) {
      case 0:
        e = launch_ln_rows(xb, static_cast<const float*>(ln_scale),
                           static_cast<const float*>(ln_bias), ctxb, M, D,
                           eps, s);
        break;
      case 1:
        if (!map_rows(&tm, ctxb, M, D)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_QKV>(
            tm, static_cast<const bf16*>(wqkv), D, 3 * D,
            HgEpilogue{static_cast<const float*>(bqkv), nullptr, nullptr, 1.f,
                       0},
            qkvb, M, s);
        break;
      case 2: {
        const cuuint64_t dims[3] = {(cuuint64_t)3 * D, (cuuint64_t)N,
                                    (cuuint64_t)B};
        const cuuint64_t strides[2] = {(cuuint64_t)3 * D * 2,
                                       (cuuint64_t)N * 3 * D * 2};
        const cuuint32_t box[3] = {AT_DH, AT_KEYS, 1};
        if (!make_tmap(&tm, qkvb, 3, dims, strides, box))
          return (int)cudaErrorInvalidValue;
        vit_attn_tma_kernel<<<dim3((N + AT_ROWS - 1) / AT_ROWS, H, B),
                              AT_THREADS, AT_SMEM, s>>>(
            tm, ctxb, N, D, 1.f / sqrtf((float)AT_DH));
        e = cudaGetLastError();
        break;
      }
      default:
        if (!map_rows(&tm, ctxb, M, D)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_PROJ>(
            tm, static_cast<const bf16*>(wo), D, D,
            HgEpilogue{static_cast<const float*>(bo),
                       static_cast<const float*>(gamma), xb, 1.f, 0},
            static_cast<bf16*>(out), M, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// All four launches (the whole half-block).
extern "C" int geovpr_mhsa_block_bf16(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* gamma,
    void* qkv, void* ctx, void* out, int B, int N, int D, int H, float eps,
    void* stream) {
  return geovpr_mhsa_block_parts(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                 gamma, qkv, ctx, out, B, N, D, H, eps, 0, 3,
                                 stream);
}
