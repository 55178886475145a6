// The ViT attention core of K8b/K8c (mhsa_train.cu, the half-block
// backward) for Hopper (sm_90a), head dim 64: 64-row query and key tiles
// in shared memory, scores and products by mma.sync m16n8k16 in
// registers, and the softmax p = exp(s - max) / sum in f32 from s =
// f32(q k^T) * dh^-0.5 with the keys >= N masked (no padding of the token
// stream), each row's max and sum taken in a first pass over the keys.
// The backward recomputes the p that K1's forward (mhsa.cu, which K8a
// launches) rounded to bf16 after its normalisation, as JAX's oracle
// `_mhsa_block_xla` and its masked training body `_mhsa_train_kernel` do.
// Fragment layout (PTX ISA, m16n8k16): lane = 4 g + t holds rows g and
// g + 8 and columns 2t, 2t + 1 of each 8-wide tile.

#pragma once

#include "bf16_gemm.cuh"
#include "window_attn.cuh"

namespace {

constexpr int VT_DH = 64;            // head dim of every DINOv2 variant
constexpr int VT_RLD = VT_DH + 8;    // bf16 elements per q/k/v/da row in smem
constexpr int VT_CH = 64;            // rows of a query or key tile
constexpr int VT_TLD = VT_CH + 8;    // bf16 elements per row of a transposed tile
constexpr int VT_THREADS = 128;      // 4 warps of 16 rows
constexpr int VT_TILE = VT_CH * VT_RLD;

// rows [r0, r0 + 64) of one head's 64 columns (row stride ld) into a bf16
// tile of row stride VT_RLD; rows >= nrows are zero
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0,
                                          int nrows, size_t ld) {
  for (int i = threadIdx.x; i < VT_CH * 8; i += VT_THREADS) {
    const int r = i >> 3;
    const int c8 = (i & 7) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < nrows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c8);
    *reinterpret_cast<uint4*>(dst + r * VT_RLD + c8) = v;
  }
}

// the same rows transposed, dst[c * VT_TLD + r]
__device__ __forceinline__ void load_cols(bf16* dst, const bf16* src, int r0,
                                          int nrows, size_t ld) {
  for (int i = threadIdx.x; i < VT_CH * 8; i += VT_THREADS) {
    const int r = i >> 3;
    const int c8 = (i & 7) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < nrows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c8);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[(c8 + k) * VT_TLD + r] = e[k];
  }
}

// mma.sync m16n8k16 A fragments of tile rows r0 and r0 + 8 (16 x 64)
__device__ __forceinline__ void a_frags(const bf16* s, int r0, int t,
                                        uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* p0 = s + r0 * VT_RLD + kk * 16 + 2 * t;
    const bf16* p1 = p0 + 8 * VT_RLD;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }
}

// one 16 x 8 tile of A (a_frags) times B^T over the 64 columns, B's row kr
// (this lane's g) from a tile of row stride VT_RLD: s[e] is row g (e < 2)
// or g + 8, column 2t + (e & 1)
__device__ __forceinline__ void tile_dot(const uint32_t (&a)[4][4],
                                         const bf16* b, int kr, int t,
                                         float (&s)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* bp = b + kr * VT_RLD + kk * 16 + 2 * t;
    mma_bf16(s, a[kk], *reinterpret_cast<const uint32_t*>(bp),
             *reinterpret_cast<const uint32_t*>(bp + 8));
  }
}

// acc (16 x 64) += A (16 x 16, packed from two score tiles) times the
// 16-row slab at column c0 of a transposed tile (64 rows of VT_TLD)
__device__ __forceinline__ void acc_tile(float (&acc)[8][4],
                                         const uint32_t (&a)[4],
                                         const bf16* bt, int c0, int g,
                                         int t) {
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const bf16* bp = bt + (jn * 8 + g) * VT_TLD + c0 + 2 * t;
    mma_bf16(acc[jn], a, *reinterpret_cast<const uint32_t*>(bp),
             *reinterpret_cast<const uint32_t*>(bp + 8));
  }
}

__device__ __forceinline__ void pack_a(const float (&p)[2][4], uint32_t (&a)[4]) {
  a[0] = pack_bf16(p[0][0], p[0][1]);
  a[1] = pack_bf16(p[0][2], p[0][3]);
  a[2] = pack_bf16(p[1][0], p[1][1]);
  a[3] = pack_bf16(p[1][2], p[1][3]);
}

// the softmax statistics of one query row over this lane's keys: the
// running max of the scaled scores and the sum of exp(s - max)
struct RowStat {
  float m, l;
};

__device__ __forceinline__ void stat_add(RowStat& st, float v) {
  if (v > st.m) {
    st.l = st.l * expf(st.m - v) + 1.f;
    st.m = v;
  } else {
    st.l += expf(v - st.m);
  }
}

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

// pass 1 of the dq half: the row statistics of the warp's rows
// (query rows g, g + 8 of qa) over all N keys, k tiles through k_s
__device__ __forceinline__ void row_stats(const uint32_t (&qa)[4][4],
                                          bf16* k_s, const bf16* kbase,
                                          int N, size_t ld, float scale,
                                          RowStat& st0, RowStat& st1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  st0 = RowStat{-INFINITY, 0.f};
  st1 = RowStat{-INFINITY, 0.f};
  for (int k0 = 0; k0 < N; k0 += VT_CH) {
    __syncthreads();
    load_rows(k_s, kbase, k0, N, ld);
    __syncthreads();
#pragma unroll
    for (int kg = 0; kg < VT_CH / 8; ++kg) {
      float s[4];
      tile_dot(qa, k_s, kg * 8 + g, t, s);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + kg * 8 + 2 * t + (e & 1) < N)
          stat_add(e >= 2 ? st1 : st0, s[e] * scale);
    }
  }
  stat_reduce(st0);
  stat_reduce(st1);
}

__device__ __forceinline__ float prob(float s, float scale, const RowStat& st) {
  return expf(s * scale - st.m) / st.l;
}

}  // namespace
