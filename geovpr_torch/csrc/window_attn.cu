// K7: the window-attention core for Hopper (sm_90a), on pre-split windows:
//
//   out[w, h] = softmax(q[w, h] k[w, h]^T dh^-0.5 + bias[h] [+ mask[w mod nW]])
//               v[w, h]
//
// q, k, v and out are (BW, H, N, dh) bf16 with dh = 32, bias (H, N, N) f32,
// mask (nW, N, N) f32 (0 / -100) or null; window w of the batch takes mask
// w mod nW (images one after another, the windows of an image in order).
// Replaces geovpr/ops/pallas_window_attention.py::window_attention_pallas
// (body _kernel), in its serving form (_SKIP_MAX): q is bf16 from the
// projection and rounded again after the f32 scale, qs = bf16(f32(q) *
// dh^-0.5 log2(e)); s = f32(qs k^T) + f32(bias) log2(e) [+ f32(mask)
// log2(e)], each product rounded and each sum rounded (no fused
// multiply-add), as JAX and the plain version round them; p = exp2(min(s,
// 100)) with no max-shift, so P is rounded to bf16 (never fp16) for P.V; the
// f32 row sum divides the context, rounded to bf16. Forward only: the JAX
// backward is an XLA recompute, not a kernel.
//
// What bounds it on the H100: at Swin-T-224 stage 0, B=64 (BW 4096, H 3,
// N 49), q, k, v in and out out are 4 x 38.5 MB (0.046 ms at 3.35 TB/s)
// against 4 BW H N^2 dh = 3.8 GFLOP (0.004 ms at 989 TFLOP/s): bytes-bound.
//
// Design (first, simple version): one CTA per (window, head), ceil(N/16)
// warps of 16 query rows. The window's q (scaled and rounded), k and v^T
// are copied into shared memory, padded with zero rows to a multiple of 16
// (49 -> 64); window_attn.cuh's tile loop, K4's, does the rest in registers.
// For a key >= N or a query row >= N, p is forced to 0 before the row sum
// and P.V (a zero key would give p = exp2(bias) otherwise), and the bias
// and mask are read, from device memory through the read-only cache, only
// for i, j < N; only rows < N are stored. The operands keep the JAX
// layout, so the windows' partition and shift stay outside the kernel.

#include <cuda_runtime.h>

#include "window_attn.cuh"

namespace {

constexpr int WA_MAX_N = 256;  // window tokens (16 warps)
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// q and k (NP rows of QK_LD_BF16 bytes) and v^T (32 rows of NP + 8 bf16)
__host__ __device__ inline size_t wa_smem_bytes(int n) {
  const int np = pad16(n);
  return (size_t)2 * np * QK_LD_BF16 + (size_t)SW_DH * (np + 8) * sizeof(bf16);
}

__global__ void __launch_bounds__(WA_MAX_N * 2)
window_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, bf16* __restrict__ out,
                        int H, int N, int nW, float qscale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NP = pad16(N);
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + (size_t)NP * QK_LD_BF16;
  bf16* vt_s = reinterpret_cast<bf16*>(k_s + (size_t)NP * QK_LD_BF16);
  const int vt_ld = NP + 8;
  const size_t base = ((size_t)w * H + h) * N * SW_DH;

  // q (scaled, rounded to bf16 again), k and v^T in 16-byte chunks; pad
  // rows zero
  for (int i = tid; i < NP * 4; i += nthreads) {
    const int r = i >> 2;
    const int c = i & 3;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u);
    uint4 kv = qv;
    uint4 vv = qv;
    if (r < N) {
      const size_t off = base + (size_t)r * SW_DH + c * 8;
      qv = *reinterpret_cast<const uint4*>(q + off);
      kv = *reinterpret_cast<const uint4*>(k + off);
      vv = *reinterpret_cast<const uint4*>(v + off);
      bf16* qe = reinterpret_cast<bf16*>(&qv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qe[e] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(qe[e]), qscale));
    }
    *reinterpret_cast<uint4*>(q_s + r * QK_LD_BF16 + c * 16) = qv;
    *reinterpret_cast<uint4*>(k_s + r * QK_LD_BF16 + c * 16) = kv;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) vt_s[(c * 8 + e) * vt_ld + r] = ve[e];
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;
  uint32_t qa[2][4];
  load_q_frags_bf16(q_s, r0, t, qa);
  const float* bias_h = bias + (size_t)h * N * N;
  const float* mask_w = mask ? mask + (size_t)(w % nW) * N * N : nullptr;

  float o[4][4];
  float l0, l1;
  warp_window_attention(
      NP, vt_s, vt_ld,
      [&](int kr, float (&sj)[4]) { scores_bf16(qa, k_s, kr, t, sj); },
      // + bias [+ mask] (exp2 domain), p = exp2(min(s, 100)); 0 off the
      // window
      [&](int key, bool hi, float sv) {
        const int row = hi ? r1 : r0;
        if (key >= N || row >= N) return 0.f;
        const int ij = row * N + key;
        float x = __fadd_rn(sv, __fmul_rn(__ldg(bias_h + ij), kLog2e));
        if (mask_w) x = __fadd_rn(x, __fmul_rn(__ldg(mask_w + ij), kLog2e));
        return exp2f(fminf(x, 100.f));
      },
      o, l0, l1);

  bf16* dst = out + base + 2 * t;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    if (r0 < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r0 * SW_DH + jn * 8) =
          __floats2bfloat162_rn(o[jn][0] / l0, o[jn][1] / l0);
    if (r1 < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r1 * SW_DH + jn * 8) =
          __floats2bfloat162_rn(o[jn][2] / l1, o[jn][3] / l1);
  }
}

}  // namespace

// Raises the kernel's dynamic shared-memory limit (above 48 KB from N =
// 209 on) on the current device; returns a cudaError_t.
extern "C" int geovpr_window_attention_init(void) {
  return (int)cudaFuncSetAttribute(window_attention_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)wa_smem_bytes(WA_MAX_N));
}

// K7. Returns a cudaError_t as int: 0 when the launch was accepted. q, k, v
// and out (BW, H, N, 32) bf16, contiguous; bias (H, N, N) f32; mask (nW, N,
// N) f32 or null (nW ignored), with BW a multiple of nW; 1 <= N <= 256.
// qscale = dh^-0.5 log2(e) in f32.
extern "C" int geovpr_window_attention(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* mask, void* out, int BW,
                                       int H, int N, int nW, float qscale,
                                       void* stream) {
  if (BW <= 0 || H <= 0 || H > 65535 || N <= 0 || N > WA_MAX_N ||
      (mask && (nW <= 0 || BW % nW)))
    return (int)cudaErrorInvalidValue;
  window_attention_kernel<<<dim3(BW, H), 2 * pad16(N), wa_smem_bytes(N),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out), H, N,
      mask ? nW : 1, qscale);
  return (int)cudaGetLastError();
}
