// Fused w8a8 pre-LN attention half-block for Hopper (sm_90a), kernel K2:
//
//   out = x + gamma * ((int8(MHSA(int8(LN(x)*s + b) @ Wqkv_q)) @ Wo_q)
//                      * so + bo)
//
// Replaces geovpr/ops/pallas_mhsa.py::fused_mhsa_block_int8 (:554, its
// pallas_call at :609; body _mhsa_kernel_v3_int8 :476, skip_max=True) in
// its three attention modes, geovpr_torch.ops.quant.ATTN_MODES (mode codes
// 0, 1, 2): int8 scores (qk8=True, pv8=False, the JAX default), int8 P.V
// (qk8=True, pv8=True: GEOVPR_INT8_PV=1) and bf16 scores (qk8=False:
// GEOVPR_INT8_QK=0). The static scales arrive folded by DinoV2Block's int8
// fold (geovpr/models/dinov2.py:201-249): 1/a_x in the LN scale and bias;
// a_x * column scale in sqkv, with its thirds scaled per mode (int8 scores:
// 1/a_q, 1/a_k, 1/a_ctx; int8 P.V: 1/a_q, 1/a_k, 1/a_v; bf16 scores: 1, 1,
// 1/a_ctx); a_ctx * column scale in so; cs2 = a_q a_k dh^-0.5 log2(e), the
// score dequant constant in the exp2 domain; cpv = a_v / (127 a_ctx) and
// cpl = a_v / a_ctx in int8 P.V. In order:
//   1. LN -> * ln_scale + ln_bias -> int8 (round half to even);
//   2. int8 GEMM with Wqkv_q -> * sqkv + bqkv; then q and k rounded and
//      clipped to int8 and v rounded to bf16 (int8 scores), q, k and v to
//      int8 (int8 P.V), or q times qscale = dh^-0.5 log2(e) and q, k, v
//      rounded to bf16 (bf16 scores, JAX's srow);
//   3. per head, s = int8 q.k^T over dh = 64 (s32) times cs2, or the f32
//      sum of the bf16 q.k^T;
//   4. int8 scores and bf16 scores: p = exp2(min(s, 100)), with no
//      max-shift: the clamp keeps p below 2^100, and p, held in f32 and
//      rounded to bf16 for the product (never fp16, whose range ends at
//      65504), cannot overflow; one pass over the keys and no rescaling;
//      ctx = (bf16(p) @ v) / sum(p), the sum taken over the f32 p;
//      int8 P.V: p = exp2(s - max_j s) <= 1 against every key's max, z the
//      f32 sum of p, the p of keys < N - 1 rounded to 127ths and multiplied
//      by the int8 v exactly, the last key's p kept in f32 (JAX's key
//      split): ctx = (ci cpv + (p_last cpl) v_last) / z;
//   5. ctx -> int8, rounded once;
//   6. int8 GEMM with Wo_q -> * so + bo -> * gamma + x, bf16 store.
// The TPU kernel splits off the last key (na = n - 1) to fit its 256-wide
// tiles and keeps that key's p in f32; this kernel masks keys past N for
// any N, as K1 does, and rounds every p to bf16 but in int8 P.V, where the
// split is kept: there the last key's p would otherwise be quantized to
// 127ths too. The tolerance of its checks covers the difference.
//
// Four launches on the caller's stream, K3's and K5's int8 pieces and an
// int8-score form of K1's attention (`geovpr_mhsa_int8_parts` runs a range
// of them, for timing one by one):
//   0. ln_quant_kernel (hopper_gemm_s8.cuh): int8(LN(x) s' + b') into the
//      ctx8 buffer, free until the attention writes it, once per row;
//   1. hopper_gemm_s8_kernel<EPI_QK8V>: acc sqkv + bqkv, q | k rounded to
//      int8 -> qk8 (M, 2D), v rounded to bf16 -> v (M, D); in int8 P.V the
//      same epilogue with every column int8 -> qkv8 (M, 3D); in bf16
//      scores hopper_gemm_s8_kernel<EPI_QKV16> -> qkv (M, 3D) bf16;
//   2. vit_attn8_tma_kernel<mode> (below): -> ctx8 (M, D) int8;
//   3. hopper_gemm_s8_kernel<EPI_RESID_G>: (ctx8 Wo^T so + bo) gamma + x.
// Launches 0, 1 and 3 keep the first port's expressions (ln_quant_row's
// order of f32 sums; acc * s + b fused; (acc * s + b) * gamma + x with
// gamma a compile-time epilogue, so it is one fused multiply-add).
// The f32 form (`geovpr_mhsa_int8_parts` with f32 set; JAX's kernel takes
// an f32 x and writes x.dtype, pallas_mhsa.py:611) runs the same launches
// on an f32 x and out: launch 0 reads f32 rows, launch 3 adds the f32
// residual and stores f32, unrounded; launches 1 and 2 read and write int8
// and bf16 as in the bf16 form. The models hand K2 a bf16 stream
// (DinoV2Block casts around it, as JAX's does), so the f32 form is the
// op's, not the path's.
//
// What bounds each launch on the H100 (DINOv2-B/14, B=64: 16,448 rows, D
// 768, 12 heads): the LN-quant pass by bytes (0.011 ms at 3.35 TB/s); the
// QKV GEMM by operations (58 GOP, 0.029 ms at 1,979 TOP/s; bf16 scores
// write 76 MB of bf16 qkv, 0.027 ms); the attention by bytes: int8 scores
// 63 MB (qk8 and v read, ctx8 written), 0.019 ms, against 6.5 GOP of int8
// scores and 6.5 GFLOP of bf16 P V; int8 P.V 51 MB (qkv8, ctx8), 0.015 ms,
// against 13 GOP of int8 products; bf16 scores 88 MB (the bf16 qkv, ctx8),
// 0.026 ms, against 13 GFLOP of bf16 products; the out projection by bytes
// (ctx8, x read, out written: 0.019 ms). The first port re-ran the
// LayerNorm in each of the QKV kernel's 18 column blocks (half the int8
// retrieve's device time).
//
// vit_attn8_tma_kernel: one CTA per (64 query rows, head, image); a
// producer warp loads the head's q tile, then streams 64-key tiles of k
// and v through a 4-stage ring by TMA, counted on mbarriers, from 3-d
// tensor maps of the QKV launch's output ((2D or 3D columns, N tokens, B))
// and of v (D, N, B), so keys past N read as zero and the shared memory
// does not grow with N. A head's q8 or k8 row is 64 bytes: 64-byte boxes
// with the 64-byte swizzle, read by ldmatrix (a 16 x 32 int8 tile as 16 x
// 16 of b16) without bank conflicts, as K5's; a bf16 v, q or k tile comes
// in K1's 64 x 64 bf16 box with the 128-byte swizzle. The consumer
// warpgroup, in int8 scores: each warp forms its 16 rows' scores, exact
// int32 sums of mma.sync m16n8k32 (two k steps over dh = 64), s = si * cs2
// as the plain version rounds it, p = 2^min(s, 100) by the SFU's ex2
// (which flushes p < 2^-126 to zero where exp2f kept a subnormal: no bf16
// p or f32 row sum it could change occurs), keys >= N set to 0, the f32
// row sums, and p rounded to bf16 straight into the A fragments of O += P
// V (the accumulator layout of the scores is theirs), a warpgroup wgmma
// with V the MN-major B operand, as K1's. In bf16 scores the same with
// the scores of mma.sync m16n8k16 on the bf16 q and k (four k steps); the
// int8 context's rows are half as wide as q's, so the warpgroup has read
// q before any warp writes it. In int8 P.V two passes over the keys (the
// producer streams the k tiles twice, the second time with v): pass 1
// takes every row's max, pass 2 forms p, z and the int8 P fragment, whose
// k slots keep the score registers' keys (8 j + 2 t + c of a 16-key slice
// in slot 4 t + 2 j + c), while each lane gathers the same keys of its v
// column byte by byte into its B fragment: the int8 MMA takes B only
// K-major and ldmatrix does not transpose bytes. The warps release a
// stage one by one there (no wgmma joins them). The context, divided as
// its mode says and rounded once to int8, is written over the q tile in
// the int8 layout (each warp its own rows) and stored by TMA, which drops
// the rows past N.

#include "hopper_gemm_s8.cuh"
#include "window_attn.cuh"

namespace {

constexpr int A8_DH = 64;          // head dim of every DINOv2 variant
constexpr int A8_ROWS = 64;        // query rows of a CTA: one warpgroup
constexpr int A8_KEYS = 64;        // keys of a tile
constexpr int A8_STAGES = 4;
constexpr int A8_THREADS = 128 + 32;  // the consumer warpgroup + a producer
constexpr int A8_QK = A8_ROWS * A8_DH;         // bytes of a q8 or k8 tile
constexpr int A8_MAX_DIM = 1024;   // the LN-quant pass stages a row a warp

// The attention modes, in the order of geovpr_torch.ops.quant.ATTN_MODES
enum { A8_MODE_QK8 = 0, A8_MODE_PV8 = 1, A8_MODE_BF16 = 2 };

// The tiles of the attention in a mode: q and k as int8 (64-byte rows) or
// bf16 (128-byte rows) tiles of 64 rows; v as a bf16 tile (int8 scores,
// bf16 scores) or an int8 one (int8 P.V); a stage holds a k and a v tile.
template <int kMode>
struct A8Tiles {
  static constexpr int kQ = kMode == A8_MODE_BF16 ? 2 * A8_QK : A8_QK;
  static constexpr int kV = kMode == A8_MODE_PV8 ? A8_QK : 2 * A8_QK;
  static constexpr int kStage = kQ + kV;
  // q, the ring, 2 A8_STAGES + 1 barriers and align1024's slack
  static constexpr int kSmem =
      kQ + A8_STAGES * kStage + (2 * A8_STAGES + 1) * 8 + 1024;
};

// Shared-memory address of 16-byte chunk c (dims 16 c .. 16 c + 15) of row
// r of a q8 or k8 tile at `base`, through the 64-byte swizzle (chunk c of
// a 64-byte row r sits at c ^ ((r / 2) % 4))
__device__ __forceinline__ uint32_t a8_addr(uint32_t base, int r, int c) {
  return base + r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// Shared-memory address of 16-byte chunk c (dims 8 c .. 8 c + 7) of row r
// of a bf16 q or k tile at `base`, through the 128-byte swizzle (chunk c of
// a 128-byte row r sits at c ^ (r % 8))
__device__ __forceinline__ uint32_t a16_addr(uint32_t base, int r, int c) {
  return base + r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t a8_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// This warp's exact int32 scores of 16-key slice kc of a k8 tile at ks
// against its q8 rows `qa` (two k32 steps over dh = 64): si[j][e] is
// query row g + 8 (e >> 1), key 16 kc + 8 j + 2 t + (e & 1)
__device__ __forceinline__ void a8_scores8(int (&si)[2][4],
                                           const uint32_t (&qa)[2][4],
                                           uint32_t ks, int kc, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) si[j][e] = 0;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t kb[4];
    ldmatrix_x4<false>(kb, a8_addr(ks, 16 * kc + (lane & 7) +
                                           ((lane >> 4) << 3),
                                   2 * kk + ((lane >> 3) & 1)));
    mma_s8(si[0], qa[kk], kb[0], kb[1]);
    mma_s8(si[1], qa[kk], kb[2], kb[3]);
  }
}

// The four lanes of a row hold its partial sums: the row's context over l,
// rounded once to int8, written over this warp's rows of the q tile in the
// int8 layout (64-byte rows, 64-byte swizzle) that tm_ctx stores
__device__ __forceinline__ void a8_store_ctx(uint32_t qs, const float (&o)[32],
                                             float (&l)[2], int warp,
                                             int lane) {
  const int t = lane & 3;
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
}

// The bf16-score consumer (K2 with cs None): per 16-key slice, s = f32(q
// k^T) of the bf16 q (dh^-0.5 log2(e) folded in by the QKV launch) and k
// by mma.sync m16n8k16 (four k16 steps over dh = 64), then the int8-score
// consumer's p = 2^min(s, 100), row sums and O += P V by wgmma; the
// context is rounded once to int8 over the q tile once the warpgroup has
// read q.
__device__ __forceinline__ void a8_attend_bf16(unsigned char* ring,
                                               uint64_t* full,
                                               uint64_t* empty, uint32_t qs,
                                               int N, int tiles, int tid) {
  using T = A8Tiles<A8_MODE_BF16>;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4<false>(qa[kk], a16_addr(qs, 16 * warp + (lane & 15),
                                        2 * kk + (lane >> 4)));
  float o[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;
  float l[2] = {0.f, 0.f};
  for (int i = 0; i < tiles; ++i) {
    const int st = i % A8_STAGES;
    unsigned char* k_s = ring + st * T::kStage;
    const uint32_t ks = smem_u32(k_s);
    const int k0 = i * A8_KEYS;
    mbar_wait(full + st, (i / A8_STAGES) & 1);
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // K of keys 16 kc + 8 j .. + 7: kb[0] dims 0-31, kb[1] dims 32-63
        uint32_t kb[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          ldmatrix_x4<false>(kb[hh], a16_addr(ks, 16 * kc + 8 * j +
                                                      (lane & 7),
                                              4 * hh + (lane >> 3)));
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        mma_bf16(s[j], qa[0], kb[0][0], kb[0][1]);
        mma_bf16(s[j], qa[1], kb[0][2], kb[0][3]);
        mma_bf16(s[j], qa[2], kb[1][0], kb[1][1]);
        mma_bf16(s[j], qa[3], kb[1][2], kb[1][3]);
      }
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = k0 + 16 * kc + 8 * j + 2 * t + (e & 1) < N;
          p[j][e] = valid ? exp2_ftz(fminf(s[j][e], 100.f)) : 0.f;
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
                         sw128_desc(k_s + T::kQ + kc * 2048, 1024, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) fence_regs(pa[kc]);
    if (tid == 0) mbar_arrive(empty + st);
  }
  // the int8 context's rows are half as wide as q's: wait until every warp
  // has read its q rows
  named_sync(1, 128);
  a8_store_ctx(qs, o, l, warp, lane);
}

// The int8-P.V consumer (K2 with cs, cpv and cpl): two passes over the
// keys. Pass 1 takes each row's max of s = si cs2 over every key < N (the
// four lanes of a row combined by quad shuffles). Pass 2 forms p =
// 2^(s - max) <= 1, sums it in f32 (z), rounds the p of keys < N - 1 to
// 127ths and multiplies them by the int8 v exactly (mma.sync m16n8k32, 32
// keys a step), while the last key's p stays in f32 (JAX's key split).
// The int8 MMA takes B only K-major and ldmatrix does not transpose bytes:
// the P fragment keeps the score registers' keys (8 j + 2 t + c of a
// 16-key slice in k slots 4 t + 2 j + c, the slice's other half of the
// step 16 slots on), and each lane gathers the same keys of its v column
// byte by byte into its B fragment; the sum is exact in any order. The
// context (ci cpv + (pb cpl) v_last) / z is rounded once to int8 over the
// warp's own q8 rows. vl: the image's v row of key N - 1, head h (global).
__device__ __forceinline__ void a8_attend_pv8(unsigned char* ring,
                                              uint64_t* full,
                                              uint64_t* empty, uint32_t qs,
                                              const int8_t* __restrict__ vl,
                                              int N, int tiles, int tid,
                                              float cs2, float cpv,
                                              float cpl) {
  using T = A8Tiles<A8_MODE_PV8>;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldmatrix_x4<false>(qa[kk], a8_addr(qs, 16 * warp + (lane & 15),
                                       2 * kk + (lane >> 4)));
  float mx[2] = {-INFINITY, -INFINITY};
  for (int i = 0; i < tiles; ++i) {
    const int st = i % A8_STAGES;
    const uint32_t ks = smem_u32(ring + st * T::kStage);
    const int k0 = i * A8_KEYS;
    mbar_wait(full + st, (i / A8_STAGES) & 1);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      int si[2][4];
      a8_scores8(si, qa, ks, kc, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 16 * kc + 8 * j + 2 * t + (e & 1) < N)
            mx[e >> 1] =
                fmaxf(mx[e >> 1], __fmul_rn((float)si[j][e], cs2));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
  }

  int o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0;
  float z[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
  for (int i = tiles; i < 2 * tiles; ++i) {
    const int st = i % A8_STAGES;
    unsigned char* k_s = ring + st * T::kStage;
    const uint32_t ks = smem_u32(k_s);
    const unsigned char* v_s = k_s + T::kQ;
    const int k0 = (i - tiles) * A8_KEYS;
    mbar_wait(full + st, (i / A8_STAGES) & 1);
#pragma unroll
    for (int step = 0; step < 2; ++step) {
      uint32_t pa[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kc = 2 * step + r;
        int si[2][4];
        a8_scores8(si, qa, ks, kc, lane);
        uint32_t row[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 16 * kc + 8 * j + 2 * t + (e & 1);
            float p = 0.f;
            if (key < N) {
              p = exp2_ftz(__fmul_rn((float)si[j][e], cs2) - mx[e >> 1]);
              z[e >> 1] += p;
            }
            if (key == N - 1) {
              pb[e >> 1] = p;
              p = 0.f;
            }
            const uint32_t q = (uint32_t)(int)rintf(p * 127.f);
            row[e >> 1] |= q << (8 * (2 * j + (e & 1)));
          }
        pa[2 * r] = row[0];
        pa[2 * r + 1] = row[1];
      }
      // v column d = 8 nt + g of this step's keys, in the P fragment's
      // order: key 32 step + 16 r + 8 j + 2 t + c in byte 2 j + c
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int d = 8 * nt + g;
        uint32_t vb[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t w = 0u;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kr = 32 * step + 16 * r + 8 * j + 2 * t + c;
              w |= (uint32_t)v_s[kr * 64 + (((d >> 4) ^ ((kr >> 1) & 3))
                                            << 4) + (d & 15)]
                   << (8 * (2 * j + c));
            }
          vb[r] = w;
        }
        mma_s8(o[nt], pa, vb[0], vb[1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    z[half] += __shfl_xor_sync(0xffffffffu, z[half], 1);
    z[half] += __shfl_xor_sync(0xffffffffu, z[half], 2);
    pb[half] += __shfl_xor_sync(0xffffffffu, pb[half], 1);
    pb[half] += __shfl_xor_sync(0xffffffffu, pb[half], 2);
    const float pl = __fmul_rn(pb[half], cpl);
    const int r = 16 * warp + g + 8 * half;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      int8_t c8[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float v = (float)vl[8 * nt + 2 * t + c];
        c8[c] = round_clip_i8(__fdiv_rn(
            __fadd_rn(__fmul_rn((float)o[nt][2 * half + c], cpv),
                      __fmul_rn(pl, v)),
            z[half]));
      }
      st_shared_u16(a8_addr(qs, r, nt >> 1) + (nt & 1) * 8 + 2 * t,
                    pack_i8x2(c8[0], c8[1]));
    }
  }
}

// The int8-score consumer (K2's default mode), as the first Hopper design
// wrote it.
__device__ __forceinline__ void a8_attend_qk8(unsigned char* ring,
                                              uint64_t* full,
                                              uint64_t* empty, uint32_t qs,
                                              int N, int tiles, int tid,
                                              float cs2) {
  using T = A8Tiles<A8_MODE_QK8>;
  // the consumer warpgroup: thread 32 w + 4 g + t holds query rows 16 w + g
  // (half 0) and 16 w + g + 8 (half 1), keys 8 j + 2 t (+ 1) of each 8-key
  // group j of a tile
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
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
    unsigned char* k_s = ring + st * T::kStage;
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

  a8_store_ctx(qs, o, l, warp, lane);
}

// ctx8 (B*N, D) int8 from the QKV launch's output in mode kMode, tm_ctx
// mapping ctx8 as (D, N, B) in (64, 64, 1) boxes of bytes with the 64-byte
// swizzle. int8 scores: tm_qk maps qk8 (B*N, 2D) as (2D, N, B) in such
// boxes, tm_v v (B*N, D) bf16 as (D, N, B) in (64, 64, 1) bf16 boxes with
// the 128-byte swizzle; int8 P.V: tm_qk maps qkv8 (B*N, 3D) int8 as (3D,
// N, B), qkv8 also read directly for the last key's v; bf16 scores: tm_qk
// maps qkv (B*N, 3D) bf16 as (3D, N, B) in bf16 boxes. Head h of q, k and
// v at columns h*64, D + h*64 and h*64 (int8 scores) or 2D + h*64. Grid
// (ceil(N / 64), H, B).
template <int kMode>
__global__ void __launch_bounds__(A8_THREADS, 3)
vit_attn8_tma_kernel(const __grid_constant__ CUtensorMap tm_qk,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_ctx,
                     const int8_t* __restrict__ qkv8, int N, int D,
                     float cs2, float cpv, float cpl) {
  using T = A8Tiles<kMode>;
  extern __shared__ unsigned char a8_smem[];
  unsigned char* q_s = align1024(a8_smem);
  unsigned char* ring = q_s + T::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + A8_STAGES * T::kStage);
  uint64_t* empty = full + A8_STAGES;
  uint64_t* q_bar = empty + A8_STAGES;
  const int q0 = blockIdx.x * A8_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (N + A8_KEYS - 1) / A8_KEYS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < A8_STAGES; ++s) {
      mbar_init(full + s, 1);
      // the int8-P.V consumer's warps release a stage one by one; the
      // others' warpgroup wgmma has read it when thread 0 arrives
      mbar_init(empty + s, kMode == A8_MODE_PV8 ? 4 : 1);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer: the q tile, then k and v tiles (int8 P.V: k tiles for
    // pass 1, then k and v tiles for pass 2)
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_bar, T::kQ);
      tma_load_3d(q_s, &tm_qk, q_bar, h * A8_DH, q0, b);
      const int loads = kMode == A8_MODE_PV8 ? 2 * tiles : tiles;
      for (int i = 0; i < loads; ++i) {
        const int s = i % A8_STAGES;
        const bool with_v = kMode != A8_MODE_PV8 || i >= tiles;
        const int k0 = (i < tiles ? i : i - tiles) * A8_KEYS;
        unsigned char* st = ring + s * T::kStage;
        mbar_wait(empty + s, ((i / A8_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, with_v ? T::kStage : T::kQ);
        tma_load_3d(st, &tm_qk, full + s, D + h * A8_DH, k0, b);
        if (kMode == A8_MODE_QK8)
          tma_load_3d(st + T::kQ, &tm_v, full + s, h * A8_DH, k0, b);
        else if (with_v)
          tma_load_3d(st + T::kQ, &tm_qk, full + s, 2 * D + h * A8_DH, k0,
                      b);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const uint32_t qs = smem_u32(q_s);
  if constexpr (kMode == A8_MODE_BF16) {
    mbar_wait(q_bar, 0);
    a8_attend_bf16(ring, full, empty, qs, N, tiles, tid);
  } else if constexpr (kMode == A8_MODE_PV8) {
    mbar_wait(q_bar, 0);
    a8_attend_pv8(ring, full, empty, qs,
                  qkv8 + ((size_t)b * N + N - 1) * 3 * D + 2 * D + h * A8_DH,
                  N, tiles, tid, cs2, cpv, cpl);
  } else {
    mbar_wait(q_bar, 0);
    a8_attend_qk8(ring, full, empty, qs, N, tiles, tid, cs2);
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

// The attention launch in mode kMode: qk is qk8 (int8 scores), qkv8 (int8
// P.V) or the bf16 qkv (bf16 scores); v is read in int8 scores only.
template <int kMode>
cudaError_t launch_vit_attn8(const void* qk, const bf16* v, int8_t* ctx8,
                             int B, int N, int D, int H, float cs2, float cpv,
                             float cpl, cudaStream_t s) {
  CUtensorMap tq, tv{}, tc;
  if (!a8_map(&tq, qk, kMode == A8_MODE_QK8 ? 2 * D : 3 * D, N, B,
              kMode == A8_MODE_BF16 ? 2 : 1) ||
      (kMode == A8_MODE_QK8 && !a8_map(&tv, v, D, N, B, 2)) ||
      !a8_map(&tc, ctx8, D, N, B, 1))
    return cudaErrorInvalidValue;
  vit_attn8_tma_kernel<kMode>
      <<<dim3((N + A8_ROWS - 1) / A8_ROWS, H, B), A8_THREADS,
         A8Tiles<kMode>::kSmem, s>>>(tq, tv, tc,
                                     static_cast<const int8_t*>(qk), N, D,
                                     cs2, cpv, cpl);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t allow_attn8_smem() {
  return cudaFuncSetAttribute(vit_attn8_tma_kernel<kMode>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              A8Tiles<kMode>::kSmem);
}

}  // namespace

// Raises the kernels' dynamic shared-memory limits on the current device
// and finds the CUDA driver's tensor-map encoder. Called once per device
// before the first launch; returns a cudaError_t as int.
extern "C" int geovpr_mhsa_int8_init(void) {
  cudaError_t e;
  if (tmap_encode_fn() == nullptr) return (int)cudaErrorSymbolNotFound;
  if ((e = allow_gemm_s8_smem<HS_EPI_QK8V>()) != cudaSuccess ||
      (e = allow_gemm_s8_smem<HS_EPI_QKV16>()) != cudaSuccess ||
      (e = allow_gemm_s8_smem<HS_EPI_RESID_G>()) != cudaSuccess ||
      (e = allow_gemm_s8_smem<HS_EPI_RESID_G, float>()) != cudaSuccess ||
      (e = allow_attn8_smem<A8_MODE_QK8>()) != cudaSuccess ||
      (e = allow_attn8_smem<A8_MODE_PV8>()) != cudaSuccess)
    return (int)e;
  return (int)allow_attn8_smem<A8_MODE_BF16>();
}

namespace {

// K2's launches first..last on a stream of type T (bf16 or f32), the
// arguments of geovpr_mhsa_int8_parts
template <typename T>
int mhsa_int8_parts(const void* x, const void* ln_scale, const void* ln_bias,
                    const void* wqkv_t, const void* sqkv, const void* bqkv,
                    const void* wo_t, const void* so, const void* bo,
                    const void* gamma, void* qk, void* v, void* ctx8,
                    void* out, int B, int N, int D, int H, float eps,
                    float cs2, int mode, float qscale, float cpv, float cpl,
                    int first, int last, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || D != H * A8_DH || D > A8_MAX_DIM ||
      B > 65535 || mode < A8_MODE_QK8 || mode > A8_MODE_BF16 || first < 0 ||
      last > 3 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* c8 = static_cast<int8_t*>(ctx8);
  const HsEpilogue qkv_ep{static_cast<const float*>(sqkv),
                          static_cast<const float*>(bqkv),
                          nullptr,
                          nullptr,
                          0.f,
                          mode == A8_MODE_QK8   ? 2 * D
                          : mode == A8_MODE_PV8 ? 3 * D
                                                : D,
                          qscale};
  const bf16* vb = static_cast<const bf16*>(v);
  cudaError_t e;
  for (int part = first; part <= last; ++part) {
    switch (part) {
      case 0:
        e = launch_ln_quant(static_cast<const T*>(x),
                            static_cast<const float*>(ln_scale),
                            static_cast<const float*>(ln_bias), c8, M, D, eps,
                            s);
        break;
      case 1:
        e = mode == A8_MODE_BF16
                ? launch_gemm_s8<HS_EPI_QKV16>(
                      c8, static_cast<const int8_t*>(wqkv_t), M, D, 3 * D,
                      qkv_ep, nullptr, qk, s)
                : launch_gemm_s8<HS_EPI_QK8V>(
                      c8, static_cast<const int8_t*>(wqkv_t), M, D, 3 * D,
                      qkv_ep, static_cast<int8_t*>(qk), v, s);
        break;
      case 2:
        e = mode == A8_MODE_QK8
                ? launch_vit_attn8<A8_MODE_QK8>(qk, vb, c8, B, N, D, H, cs2,
                                                cpv, cpl, s)
            : mode == A8_MODE_PV8
                ? launch_vit_attn8<A8_MODE_PV8>(qk, vb, c8, B, N, D, H, cs2,
                                                cpv, cpl, s)
                : launch_vit_attn8<A8_MODE_BF16>(qk, vb, c8, B, N, D, H,
                                                 cs2, cpv, cpl, s);
        break;
      default:
        e = launch_gemm_s8<HS_EPI_RESID_G, T>(
            c8, static_cast<const int8_t*>(wo_t), M, D, D,
            HsEpilogue{static_cast<const float*>(so),
                       static_cast<const float*>(bo),
                       static_cast<const float*>(gamma), x, 0.f, 0},
            nullptr, out, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// K2's launches first..last (0 LN-quant, 1 QKV GEMM, 2 attention, 3 out
// projection) in attention mode `mode` (0 int8 scores, 1 int8 P.V, 2 bf16
// scores) and the form of the stream's type (f32 0: bf16 x and out; 1:
// f32, the scratch and the middle launches the bf16 form's); returns a
// cudaError_t as int: 0 when every launch was accepted. x and out (B*N,
// D); wqkv_t (3D, D) and wo_t (D, D) int8, k-contiguous; ln_scale, ln_bias
// (1/a_x folded in), sqkv, bqkv, so, bo and gamma f32; all 16-byte
// aligned. Scratch: qk and v as the QKV launch writes them (int8 scores:
// qk8 (B*N, 2D) int8 and v (B*N, D) bf16; int8 P.V: qkv8 (B*N, 3D) int8;
// bf16 scores: qkv (B*N, 3D) bf16; v unused in the last two), ctx8 (B*N,
// D) int8 (the LN-quant output until the attention writes ctx8). D = 64 H
// <= 1024. cs2 = a_q a_k dh^-0.5 log2(e) (int8 scores and P.V); qscale =
// dh^-0.5 log2(e) (bf16 scores); cpv = a_v / (127 a_ctx) and cpl = a_v /
// a_ctx (int8 P.V). A launch alone reads what the earlier launches of an
// earlier call left in the scratch; the whole half-block is parts 0..3.
// geovpr_mhsa_int8_init must have run on the current device.
extern "C" int geovpr_mhsa_int8_parts(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* wqkv_t, const void* sqkv, const void* bqkv, const void* wo_t,
    const void* so, const void* bo, const void* gamma, void* qk, void* v,
    void* ctx8, void* out, int B, int N, int D, int H, float eps, float cs2,
    int mode, float qscale, float cpv, float cpl, int f32, int first,
    int last, void* stream) {
  return (f32 ? mhsa_int8_parts<float> : mhsa_int8_parts<bf16>)(
      x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wo_t, so, bo, gamma, qk, v,
      ctx8, out, B, N, D, H, eps, cs2, mode, qscale, cpv, cpl, first, last,
      stream);
}
