// The mma.sync and fragment helpers that K7 (window_attn.cu) shares with
// K4/K5 (swin_attn.cu) and K9 (swin_train.cu), for Hopper (sm_90a).
//
// A warp computes a 16 x 8 tile of scores or context by mma.sync m16n8k16
// with f32 accumulation; P is repacked from the score registers as the
// bf16 A operand of P V (bf16, never fp16: p = 2^min(s, 100) reaches
// 2^100). Fragment layout (PTX ISA, m16n8k16): lane = 4 g + t holds query
// rows g and g + 8 and key columns 2t, 2t + 1 of each 8-key half tile.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SW_DH = 32;  // head dim of every window-attention call

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

}  // namespace
