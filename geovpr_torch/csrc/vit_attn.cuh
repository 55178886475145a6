// The per-thread arithmetic of K8b, the ViT attention-core backward
// (mhsa_train.cu), for Hopper (sm_90a), head dim 64, in the accumulator
// layout of wgmma m64nNk16 (thread 32 w + 4 g + t of the warpgroup holds
// rows 16 w + g and 16 w + g + 8 and columns 8 j + 2 t, + 1 of each 8-wide
// group j: d[4 j + 2 half + c]), which is mma.sync m16n8k16's for each
// warp's 16 rows. The softmax p = exp(s - max) / sum is recomputed in f32
// from s = f32(q k^T) * dh^-0.5 with the keys >= N masked, each row's max
// and sum taken in a first pass over the keys (walked in each thread's
// column order, then stat_reduce across the quad), as K1's
// forward (mhsa.cu, which K8a launches) formed the p it rounded to bf16
// and as JAX's oracle `_mhsa_block_xla` and its masked training body
// `_mhsa_train_kernel` do. The statistics keep the first port's order of
// operations, so that the core's sums repeat its bits; the division by the
// row sum is a multiply by its reciprocal with one correction step
// (vt_prob), which gives the quotient of a correctly rounded division.

#pragma once

#include "hopper.cuh"

namespace {

constexpr int VT_DH = 64;        // head dim of every DINOv2 variant
constexpr int VT_ROWS = 64;      // rows of a query or key tile
constexpr int VT_TILE = VT_ROWS * VT_DH * 2;  // bytes of a bf16 tile

// the softmax statistics of one query row over this lane's keys: the
// running max of the scaled scores and the sum of exp(s - max), each key
// added as the first port's stat_add did: where it raises the max, l = l
// exp(max - s) + 1 and max = s, else l += exp(s - max)
struct RowStat {
  float m, l;
};

// combine the statistics of the four lanes of a quad (the same row)
__device__ __forceinline__ void stat_reduce(RowStat& st) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, st.m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, st.l, o);
    const float m = fmaxf(st.m, m2);
    st.l = (st.l == 0.f ? 0.f : st.l * expf(st.m - m)) +
           (l2 == 0.f ? 0.f : l2 * expf(m2 - m));
    st.m = m;
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// p = exp(s scale - m) / l in f32: the quotient as q = x rl, then q + (x -
// q l) rl with the remainder exact by fma (Markstein), rl = 1 / l
// correctly rounded: the correctly rounded quotient, as K1's attention
// forms it, in a third of the division's instructions
__device__ __forceinline__ float vt_prob(float s, float scale, float m,
                                         float l, float rl) {
  const float x = expf(s * scale - m);
  const float q = __fmul_rn(x, rl);
  return __fmaf_rn(__fmaf_rn(-q, l, x), rl, q);
}

__device__ __forceinline__ uint32_t vt_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64, f32) = A (64 x 64) B^T over dh, both 64 x 64 K-major tiles
// of 128-byte-swizzled rows (a: the warpgroup's 64 rows, b: 64 rows of
// the other operand), one k16 step after another onto zeros, as the first
// port's mma.sync tiles summed; committed as one group, not waited for
__device__ __forceinline__ void vt_product(float (&d)[32],
                                           const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int e = 0; e < 32; ++e) d[e] = 0.f;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < VT_DH / 16; ++kk)
    wgmma_m64n64<0>(d, sw128_desc(a + kk * 32, 16, 1024),
                    sw128_desc(b + kk * 32, 16, 1024), 1);
}

// d (64 x 32) = A (64 x 64) B^T over dh, B the 32 rows at b of a K-major
// tile (vt_product's, N = 32)
__device__ __forceinline__ void vt_product32(float (&d)[16],
                                             const unsigned char* a,
                                             const unsigned char* b) {
#pragma unroll
  for (int e = 0; e < 16; ++e) d[e] = 0.f;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < VT_DH / 16; ++kk)
    wgmma_m64n32<0>(d, sw128_desc(a + kk * 32, 16, 1024),
                    sw128_desc(b + kk * 32, 16, 1024), 1);
}

// acc (64 x 64) += A (the warpgroup's 64 x 16 slice kc, in registers) times
// rows [16 kc, 16 kc + 16) of a 64 x 64 tile read as the MN-major B operand
// (rows the contraction, columns the head dim), as K1's P V
__device__ __forceinline__ void vt_acc(float (&acc)[32], const uint32_t (&a)[4],
                                       const unsigned char* tile, int kc) {
  wgmma_m64n64_rs<1>(acc, a, sw128_desc(tile + kc * 2048, 1024, 1024), 1);
}

// writes this thread's rows of a 64 x 64 f32 accumulator, rounded to bf16,
// into a 128-byte-swizzled tile (the layout TMA stores from)
__device__ __forceinline__ void vt_stage(unsigned char* tile,
                                         const float (&d)[32], int lr0,
                                         int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = lr0 + 8 * half;
      st_shared_u32(smem_u32(tile + lr * 128 + ((j ^ (lr & 7)) << 4) + 4 * t),
                    vt_pack(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]));
    }
}

}  // namespace
