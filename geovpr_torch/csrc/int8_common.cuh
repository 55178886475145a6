// Shared pieces of the w8a8 kernels for Hopper (sm_90a): the int8
// rounding and the tensor-core product mma.sync.m16n8k32 (s8 x s8 -> s32)
// of K2, K3 and K5 (mhsa_int8.cu, hopper_gemm_s8.cuh, swin_attn.cu), and
// ln_quant_row, the first port's LayerNorm -> int8 row, which spells out
// the f32 order of sums that hopper_gemm_s8.cuh's LN-quant pass keeps bit
// for bit.
//
// Weights arrive transposed, (out, in) row-major (nn.Linear's layout), so
// both operands of an int8 product are k-contiguous: mma.sync takes int8
// operands only in the row.col form and int8 wgmma only K-major. The
// models store the transposed copy once, when the quantized state is
// installed.
//
// Rounding to int8 uses rintf (round half to even), as jnp.round and
// torch.round do; CUDA's roundf rounds half away from zero and would move
// every .5 case by one step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int8_t round_clip_i8(float v) {
  return (int8_t)(int)fminf(fmaxf(rintf(v), -127.f), 127.f);
}

// c += a (16x32, row) * b (32x8, col), int8 in, int32 accumulate. Fragment
// layouts (PTX ISA, mma.m16n8k32 .s8), g = lane / 4, t = lane % 4:
//   a[0]: row g,   k 4t..4t+3      a[1]: row g+8, k 4t..4t+3
//   a[2]: row g,   k 16+4t..       a[3]: row g+8, k 16+4t..
//   b0:   col g,   k 4t..4t+3      b1:   col g,   k 16+4t..
//   c[0], c[1]: row g, cols 2t, 2t+1;   c[2], c[3]: row g+8, same cols
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Largest row width ln_quant_row holds in registers (32 lanes x 32
// values).
constexpr int LN_MAX_D = 1024;

// One warp LayerNorms one row of D <= LN_MAX_D bf16 values in f32 with
// two-pass statistics (mean, then mean squared deviation), as the JAX
// kernels do, and writes int8(round(normed * ln_scale + ln_bias)) to dst.
// The static activation scale 1/a_x is already folded into ln_scale and
// ln_bias by the caller.
__device__ __forceinline__ void ln_quant_row(const bf16* __restrict__ src,
                                             int D,
                                             const float* __restrict__ ln_scale,
                                             const float* __restrict__ ln_bias,
                                             float eps, int8_t* dst,
                                             int lane) {
  float v[LN_MAX_D / 32];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_D / 32; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < D ? __bfloat162float(src[c]) : 0.f;
    s += v[i];
  }
  const float mu = warp_sum_f(s) / D;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAX_D / 32; ++i) {
    const int c = lane + 32 * i;
    const float d = c < D ? v[i] - mu : 0.f;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum_f(q) / D + eps);
#pragma unroll
  for (int i = 0; i < LN_MAX_D / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < D) dst[c] = round_clip_i8((v[i] - mu) * rstd * ln_scale[c] + ln_bias[c]);
  }
}

}  // namespace
