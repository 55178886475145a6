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
// Three launches on the caller's stream (`geovpr_mlp_int8_parts` runs a
// range of them), on hopper_gemm_s8.cuh's pieces:
//   0. ln_quant_kernel: int8(LN(x) s + b) -> xq (M, D), once per row;
//   1. hopper_gemm_s8_kernel<EPI_GELU8> (fc1): xq W1q^T s1 + b1, tanh
//      GELU in f32 (tanhf), * inv_a_mid, round_clip_i8 -> the int8 hidden
//      (M, HID);
//   2. hopper_gemm_s8_kernel<EPI_RESID_G> (fc2): (hidden W2q^T s2 + b2)
//      gamma + res -> out (M, D) bf16.
// The int32 sums are exact, the epilogues round where the plain version
// rounds, and the LN-quant pass keeps ln_quant_row's order of f32 sums
// (hopper_gemm_s8.cuh). The f32 form (`geovpr_mlp_int8_parts` with f32
// set, for a model built with compute_dtype="float32", as JAX's kernel
// takes an f32 x and writes x.dtype) runs the same three launches on an
// f32 x, res and out:
// the LN-quant pass reads f32 rows and fc2's epilogue adds the f32
// residual and stores f32, unrounded; fc1 and the int8 hidden are the
// bf16 form's.
//
// What the TPU kernel keeps on chip is the (rows, 4D) hidden activation: a
// 512-row f32 block (6 MB) in VMEM. Here the int8 hidden (a_mid is a
// static per-tensor scale, so it is exactly the TPU kernel's gq) goes
// through device memory: a wgmma-sized row block's hidden does not fit in
// shared memory (64 x 3,072 int8 is 192 KB); a fused form would stream
// hidden chunks and hold fc2's accumulators in registers, and a 32-row
// block whose hidden fits streams both weight matrices from L2 for every
// 32 rows (M D^2 / 4 bytes a call: 2.4 GB at every Swin-B-384 stage).
// What bounds the split on the H100 (bytes of each launch's inputs and
// outputs at 3.35 TB/s against its int8 operations at 1,979 TOP/s): at
// DINOv2-B/14, B=64 (16,448 x 768, hidden 3,072) 0.011 + 0.039 + 0.039 =
// 0.090 ms (the whole call's operations: 0.078); at Swin-B-384 stage 0
// (589,824 x 128, hidden 512) 0.068 + 0.113 + 0.180 = 0.360 ms, the 302
// MB hidden written and read (the whole call's bytes: 0.09).

#include "hopper_gemm_s8.cuh"

// Raises the GEMMs' dynamic shared-memory limits on the current device and
// finds the CUDA driver's tensor-map encoder. Called once per device before
// the first launch; returns a cudaError_t.
extern "C" int geovpr_mlp_int8_init(void) {
  if (tmap_encode_fn() == nullptr) return (int)cudaErrorSymbolNotFound;
  cudaError_t e;
  if ((e = allow_gemm_s8_smem<HS_EPI_GELU8>()) != cudaSuccess ||
      (e = allow_gemm_s8_smem<HS_EPI_RESID_G>()) != cudaSuccess)
    return (int)e;
  return (int)allow_gemm_s8_smem<HS_EPI_RESID_G, float>();
}

namespace {

// K3's launches first..last on a stream of type T (bf16 or f32), the
// arguments of geovpr_mlp_int8_parts
template <typename T>
int mlp_int8_parts(const void* x, const void* res, const void* ln_scale,
                   const void* ln_bias, const void* w1t, const void* s1,
                   const void* b1, const void* w2t, const void* s2,
                   const void* b2, const void* gamma, void* xq, void* hidden,
                   void* out, int M, int D, int HID, float inv_a_mid,
                   float eps, int first, int last, void* stream) {
  if (M <= 0 || D <= 0 || HID <= 0 || D % 16 || HID % 16 ||
      D > HG_MAX_DIM || first < 0 || last > 2 || first > last)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* xq8 = static_cast<int8_t*>(xq);
  int8_t* h8 = static_cast<int8_t*>(hidden);
  cudaError_t e;
  for (int part = first; part <= last; ++part) {
    switch (part) {
      case 0:
        e = launch_ln_quant(static_cast<const T*>(x),
                            static_cast<const float*>(ln_scale),
                            static_cast<const float*>(ln_bias), xq8, M, D, eps,
                            s);
        break;
      case 1:
        e = launch_gemm_s8<HS_EPI_GELU8>(
            xq8, static_cast<const int8_t*>(w1t), M, D, HID,
            HsEpilogue{static_cast<const float*>(s1),
                       static_cast<const float*>(b1), nullptr, nullptr,
                       inv_a_mid, 0},
            h8, nullptr, s);
        break;
      default:
        e = launch_gemm_s8<HS_EPI_RESID_G, T>(
            h8, static_cast<const int8_t*>(w2t), M, HID, D,
            HsEpilogue{static_cast<const float*>(s2),
                       static_cast<const float*>(b2),
                       static_cast<const float*>(gamma), res, 0.f, 0},
            nullptr, out, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// K3's launches first..last (0 LN-quant, 1 fc1, 2 fc2) in the form of the
// stream's type (f32 0: bf16 x, res and out; 1: f32); returns a
// cudaError_t as int: 0 when every launch was accepted. x, res and out are
// (M, D) (res may equal x); w1t is (HID, D) and w2t (D, HID) int8,
// k-contiguous; the vectors are f32; all 16-byte aligned. Scratch: xq (M,
// D) and hidden (M, HID) int8. D and HID multiples of 16, D <= 1024. A
// launch alone reads what the earlier launches of an earlier call left in
// the scratch; the whole half-block is parts 0..2. geovpr_mlp_int8_init
// must have run on the current device.
extern "C" int geovpr_mlp_int8_parts(
    const void* x, const void* res, const void* ln_scale, const void* ln_bias,
    const void* w1t, const void* s1, const void* b1, const void* w2t,
    const void* s2, const void* b2, const void* gamma, void* xq, void* hidden,
    void* out, int M, int D, int HID, float inv_a_mid, float eps, int f32,
    int first, int last, void* stream) {
  return (f32 ? mlp_int8_parts<float> : mlp_int8_parts<bf16>)(
      x, res, ln_scale, ln_bias, w1t, s1, b1, w2t, s2, b2, gamma, xq, hidden,
      out, M, D, HID, inv_a_mid, eps, first, last, stream);
}
