// Fused w8a8 MLP half-block for Hopper (sm_90a), kernel K3:
//
//   out = res + gamma * ((int8(gelu_tanh((int8(LN(x)*s + b) @ W1q) * s1 + b1)
//                             * inv_a_mid) @ W2q) * s2 + b2)
//
// res is x itself (transformer blocks) or a separate residual stream
// (ConvNeXt's block shape). Replaces geovpr/ops/pallas_mlp.py::
// fused_mlp_block_int8 (bodies _mlp_int8_kernel and _mlp_int8_res_kernel,
// arithmetic _mlp_int8_core). The static scales arrive folded as
// geovpr/models/layers.py:148-158 passes them: 1/a_in in the LN scale and
// bias, a_in*s1 and a_mid*s2 in the dequant rows, 1/a_mid as a scalar.
//
// What bounds it on the H100: at DINOv2-B/14, B=64 (16,448 rows x 768,
// hidden 3,072) one call is 155 GOP of int8 products against ~55 MB of
// traffic (x in, out out, 4.7 MB of int8 weights): ~0.078 ms at 1,979
// int8 TOP/s against ~0.017 ms at 3.35 TB/s, so it is tensor-core bound.
//
// What the TPU kernel keeps on chip is the (rows, 4D) hidden activation: a
// 512-row f32 block (6 MB) in VMEM. 227 KB of shared memory cannot hold
// that, so this kernel keeps the hidden in int8: a_mid is a static
// per-tensor scale, so the int8 hidden is exactly the TPU kernel's gq, and
// one 32-row block's int8 hidden (32 x 3,072 = 96 KB) sits in shared
// memory between the two GEMMs. Nothing of the hidden reaches device
// memory.
//
// Design (first, simple version; one launch, one 32-row block per CTA):
//   1. LayerNorm each row in f32, fold in the scales, round to int8 into
//      shared memory (whole row width resident).
//   2. fc1 in 256-column slabs with mma.sync int8 (s32 accumulate), W1q
//      streamed through shared memory by cp.async; epilogue dequant + b1,
//      tanh GELU in f32 (tanhf), round to int8 into the resident hidden.
//   3. fc2 over the resident hidden in 256-column slabs; epilogue dequant
//      + b2, * gamma, + res in f32, bf16 store.
// int32 sums are exact in any order, so the kernel and its plain version
// differ only where LayerNorm's f32 reductions or tanhf move a value
// across a rounding boundary. Each CTA reads both weight matrices from L2
// (4.7 MB for 32 rows) and one CTA runs per SM (165 KB of shared memory):
// larger row blocks (a second stage of hidden tiles accumulating fc2 in
// registers) and wgmma/TMA are the first things a faster version changes.

#include "int8_common.cuh"

namespace {

constexpr int MLP_BM = 32;
constexpr int MLP_THREADS = 256;
using MlpGemm = Int8Gemm<1, 8>;  // 32 rows x 256 columns per pass

__host__ __device__ inline size_t mlp_smem_bytes(int D, int HID) {
  return (size_t)MLP_BM * (D + 16) + (size_t)MLP_BM * (HID + 16) +
         (size_t)MlpGemm::SMEM_B;
}

__global__ void __launch_bounds__(MLP_THREADS)
mlp_int8_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
                const float* __restrict__ ln_scale,
                const float* __restrict__ ln_bias,
                const int8_t* __restrict__ w1t, const float* __restrict__ s1,
                const float* __restrict__ b1, const int8_t* __restrict__ w2t,
                const float* __restrict__ s2, const float* __restrict__ b2,
                const float* __restrict__ gamma, bf16* __restrict__ out,
                int M, int D, int HID, float inv_a_mid, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = D + 16;
  const int ldh = HID + 16;
  int8_t* Xs = reinterpret_cast<int8_t*>(smem);
  int8_t* Hs = Xs + MLP_BM * ldx;
  int8_t* Bs = Hs + MLP_BM * ldh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * MLP_BM;

  // 1. LayerNorm -> int8, one warp per row; rows past M are zero
  for (int r = warp; r < MLP_BM; r += MLP_THREADS / 32) {
    if (m0 + r < M) {
      ln_quant_row(x + (size_t)(m0 + r) * D, D, ln_scale, ln_bias, eps,
                   Xs + r * ldx, lane);
    } else {
      for (int c = lane; c < D; c += 32) Xs[r * ldx + c] = 0;
    }
  }
  __syncthreads();

  // 2. fc1 -> tanh GELU -> int8 hidden, resident in shared memory
  for (int n0 = 0; n0 < HID; n0 += MlpGemm::BN) {
    int acc[2][4][4];
    MlpGemm::run(Xs, ldx, w1t, n0, HID, D, Bs, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + warp * 32 + ni * 8 + 2 * t;
        if (col >= HID) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = mi * 16 + g + 8 * hr;
          int8_t q[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float h = (float)acc[mi][ni][2 * hr + e] * s1[col + e] + b1[col + e];
            const float gl = 0.5f * h *
                (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
            q[e] = round_clip_i8(gl * inv_a_mid);
          }
          *reinterpret_cast<char2*>(Hs + row * ldh + col) = make_char2(q[0], q[1]);
        }
      }
  }
  __syncthreads();

  // 3. fc2 -> dequant -> LayerScale -> + residual -> bf16
  for (int n0 = 0; n0 < D; n0 += MlpGemm::BN) {
    int acc[2][4][4];
    MlpGemm::run(Hs, ldh, w2t, n0, D, HID, Bs, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + warp * 32 + ni * 8 + 2 * t;
        if (col >= D) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m0 + mi * 16 + g + 8 * hr;
          if (row >= M) continue;
          const size_t o = (size_t)row * D + col;
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + o);
          float y0 = (float)acc[mi][ni][2 * hr] * s2[col] + b2[col];
          float y1 = (float)acc[mi][ni][2 * hr + 1] * s2[col + 1] + b2[col + 1];
          y0 = y0 * gamma[col] + __low2float(r2);
          y1 = y1 * gamma[col + 1] + __high2float(r2);
          *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(y0, y1);
        }
      }
  }
}

}  // namespace

// Largest dynamic shared memory a block may use on the H100.
static const int kMaxSmem = 232448;

// Raises the kernel's dynamic shared-memory limit on the current device.
// Called once per device before the first launch; returns a cudaError_t.
extern "C" int geovpr_mlp_int8_init(void) {
  return (int)cudaFuncSetAttribute(
      mlp_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

// Returns a cudaError_t as int: 0 when the launch was accepted. x, res and
// out are (M, D) bf16 (res may equal x); w1t is (HID, D) and w2t (D, HID)
// int8, k-contiguous; the vectors are f32. D and HID must be multiples of
// 64, D <= 1024, and the 32-row block's resident buffers must fit in
// shared memory (D + HID <= ~5,900).
extern "C" int geovpr_mlp_block_int8(
    const void* x, const void* res, const void* ln_scale, const void* ln_bias,
    const void* w1t, const void* s1, const void* b1, const void* w2t,
    const void* s2, const void* b2, const void* gamma, void* out, int M,
    int D, int HID, float inv_a_mid, float eps, void* stream) {
  if (M <= 0 || D <= 0 || HID <= 0 || D % 64 || HID % 64 || D > LN_MAX_D ||
      mlp_smem_bytes(D, HID) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int blocks = (M + MLP_BM - 1) / MLP_BM;
  mlp_int8_kernel<<<blocks, MLP_THREADS, mlp_smem_bytes(D, HID),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(res),
      static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
      static_cast<const int8_t*>(w1t), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2t),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<const float*>(gamma), static_cast<bf16*>(out), M, D, HID,
      inv_a_mid, eps);
  return (int)cudaGetLastError();
}
