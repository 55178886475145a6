// The per-warp window-attention tile loop of K7 (window_attn.cu), and the
// mma.sync and fragment helpers it shares with K4/K5 (swin_attn.cu) and
// K9 (swin_train.cu), for Hopper (sm_90a).
//
// One warp owns 16 query rows of one (window, head) at head dim 32 and
// walks the keys in tiles of 16: scores by mma.sync m16n8k16 into registers
// (the caller's `scores`), the caller's
// `prob` turning each score into p (bias, mask, exp2 with no max-shift, or
// 0 for a key it excludes), row sums of p in registers, and p repacked as
// the bf16 A operand of the P.V mma.sync, accumulated over all tiles.
// Without a max-shift no rescale is needed between tiles; P is bf16, never
// fp16, because p reaches 2^100. Fragment layout (PTX ISA, m16n8k16): lane
// = 4 g + t holds query rows g and g + 8 and key columns 2t, 2t + 1 of each
// 8-key half tile.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SW_DH = 32;        // head dim of every window-attention call
constexpr int QK_LD_BF16 = 80;   // bytes per bf16 q/k row in smem: 64 + 16 pad

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of query rows r0 and r0 + 8 (both head-dim halves) from bf16
// rows of QK_LD_BF16 bytes in shared memory.
__device__ __forceinline__ void load_q_frags_bf16(const unsigned char* q_s,
                                                  int r0, int t,
                                                  uint32_t (&qa)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const unsigned char* p0 = q_s + r0 * QK_LD_BF16 + kk * 32 + t * 4;
    const unsigned char* p1 = p0 + 8 * QK_LD_BF16;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
  }
}

// f32 scores (one 16 x 8 tile) of the warp's query rows against key rows
// kr (this lane's g) in bf16 rows of QK_LD_BF16 bytes.
__device__ __forceinline__ void scores_bf16(const uint32_t (&qa)[2][4],
                                            const unsigned char* k_s, int kr,
                                            int t, float (&s)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const unsigned char* kp = k_s + kr * QK_LD_BF16 + kk * 32 + t * 4;
    mma_bf16(s, qa[kk], *reinterpret_cast<const uint32_t*>(kp),
             *reinterpret_cast<const uint32_t*>(kp + 16));
  }
}

// The tile loop over keys [0, n_keys) (a multiple of 16). scores(kr, s)
// fills one 16 x 8 score tile for key row kr = k0 + 8 j + g; prob(key, hi,
// s) returns p for query row g (hi false) or g + 8 (hi true). v^T is bf16
// in shared memory, 32 rows of vt_ld (>= n_keys) elements. On return o
// holds this lane's unnormalised context (o[jn][0..1] row g, [2..3] row
// g + 8, columns 8 jn + 2t, + 1) and l0, l1 the full row sums of p.
template <class Scores, class Prob>
__device__ __forceinline__ void warp_window_attention(
    int n_keys, const bf16* vt_s, int vt_ld, Scores scores, Prob prob,
    float (&o)[4][4], float& l0, float& l1) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  l0 = 0.f;  // partial row sums of rows g, g + 8 (this lane's keys)
  l1 = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += 16) {
    // S (16 x 16 per warp) as two 16 x 8 tiles: key k0 + 8j + 2t + (e & 1)
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) scores(k0 + j * 8 + g, s[j]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const bool hi = e >= 2;
        const float p = prob(key, hi, s[j][e]);
        if (hi) l1 += p; else l0 += p;
        s[j][e] = p;
      }
    // P as the A operand (16 x 16 keys) of P.V
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const bf16* vp = vt_s + (jn * 8 + g) * vt_ld + k0 + 2 * t;
      mma_bf16(o[jn], pa, *reinterpret_cast<const uint32_t*>(vp),
               *reinterpret_cast<const uint32_t*>(vp + 8));
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
}

}  // namespace
