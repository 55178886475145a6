// Shared pieces of the w8a8 kernels for Hopper (sm_90a): the int8 rounding
// and tensor-core product mma.sync.m16n8k32 (s8 x s8 -> s32) of K2, K3 and
// K5 (mhsa_int8.cu, hopper_gemm_s8.cuh, swin_attn.cu), and K2's block GEMM
// that streams k-contiguous int8 weights through shared memory with
// cp.async double buffering and its LayerNorm -> int8 row prologue, whose
// f32 order hopper_gemm_s8.cuh's LN-quant pass keeps.
//
// Weights arrive transposed, (out, in) row-major (nn.Linear's layout), so
// both mma operands are k-contiguous: mma.sync takes int8 operands only in
// the row.col form, and a (in, out) weight would need a byte transpose on
// every tile load. The models store the transposed copy once, when the
// quantized state is installed.
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

// 16-byte global -> shared copy; with ok == false the 16 bytes are zeroed
// and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Largest row width the LayerNorm prologue holds in registers (32 lanes x
// 32 values).
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

// Block GEMM: acc (BM x BN, as 32x32 warp tiles in registers) = A (BM x K
// int8 in shared memory, row pitch lda bytes) x W[n0 .. n0+BN) (W is N x K
// int8, row-major, k contiguous, in device memory). W streams through
// shared memory in 64-byte k chunks, two stages deep (cp.async). Rows of W
// past N read as zero. K % 64 == 0; lda % 16 == 0.
//
// Bank conflicts: the B stage pitch is 80 bytes (20 words), so the 8 rows x
// 4 words a fragment load touches fall in 32 distinct banks; with
// lda = K + 16 and K % 64 == 0 the same holds for the A fragments.
template <int WM, int WN>
struct Int8Gemm {
  static constexpr int BM = 32 * WM;
  static constexpr int BN = 32 * WN;
  static constexpr int BK = 64;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int B_LD = BK + 16;
  static constexpr int B_STAGE = BN * B_LD;
  static constexpr int SMEM_B = 2 * B_STAGE;

  __device__ static void load_b(int8_t* bs, const int8_t* __restrict__ w,
                                int n0, int N, int K, int k0) {
    for (int i = threadIdx.x; i < BN * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16);
      const int c = i % (BK / 16);
      const bool ok = n0 + r < N;
      const int8_t* src = ok ? w + (size_t)(n0 + r) * K + k0 + c * 16 : w;
      cp_async16(bs + r * B_LD + c * 16, src, ok);
    }
  }

  // acc[mi][ni][i]: row wm*32 + mi*16 + g + 8*(i/2), col wn*32 + ni*8 +
  // 2t + i%2 of the block tile (wm = warp / WN, wn = warp % WN).
  __device__ static void run(const int8_t* As, int lda,
                             const int8_t* __restrict__ w, int n0, int N,
                             int K, int8_t* Bs, int (&acc)[2][4][4]) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int wm = warp / WN;
    const int wn = warp % WN;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

    const int nk = K / BK;
    load_b(Bs, w, n0, N, K, 0);
    cp_async_commit();
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk)
        load_b(Bs + ((kc + 1) & 1) * B_STAGE, w, n0, N, K, (kc + 1) * BK);
      cp_async_commit();
      cp_async_wait1();  // every group but the newest: stage kc has landed
      __syncthreads();
      const int8_t* bs = Bs + (kc & 1) * B_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int8_t* ap = As + (wm * 32 + mi * 16 + g) * lda + kc * BK + kk + t * 4;
          a[mi][0] = lds32(ap);
          a[mi][1] = lds32(ap + 8 * lda);
          a[mi][2] = lds32(ap + 16);
          a[mi][3] = lds32(ap + 8 * lda + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int8_t* bp = bs + (wn * 32 + ni * 8 + g) * B_LD + kk + t * 4;
          const uint32_t b0 = lds32(bp);
          const uint32_t b1 = lds32(bp + 16);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
        }
      }
      __syncthreads();  // stage kc is read before iteration kc+1 refills it
    }
  }
};

}  // namespace
