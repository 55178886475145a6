// Fused Swin PatchMerging for Hopper (sm_90a), kernel K6:
//
//   out = LN(concat[x00, x10, x01, x11]) @ W        (W (4C, 2C), no bias)
//
// on the raster token stream: x is one stage's (B, S*S, C), out the next
// stage's (B, S/2*S/2, 2C), both in raster order; x_ij is the token at
// (2y + i, 2x + j) for the output token (y, x), the HF SwinPatchMerging
// concat order. Replaces geovpr/ops/pallas_patch_merge.py::
// fused_patch_merge_rolled (:112, pallas_call :143, body _merge_kernel
// :54), whose three-operand row split and VMEM slicing exist to read the
// 2x2 neighbours out of the shifted window layout and write the next
// stage's windows; in the raster layout the neighbours are four rows at
// fixed offsets and nothing needs to be un-rolled. Numerics follow
// _merge_kernel: LN over the 4C values in f32 with two-pass statistics,
// the normalised row rounded to bf16, the product accumulated in f32 and
// rounded to bf16.
//
// What bounds it on the H100 (Swin-B-384, B=64): 38.7 GFLOP at every
// boundary (0.039 ms at 989 TFLOP/s) against bytes that halve from one
// boundary to the next. As two launches (M2 = B S^2 / 4 merged rows):
//   0. merge_ln_kernel: reads x once (2 M2 4C bytes) and writes bf16
//      LN(merged) (M2, 4C): 0.090 / 0.045 / 0.023 ms by bytes at C = 128 /
//      256 / 512;
//   1. hopper_gemm_kernel<EPI_NONE> (hopper_gemm.cuh, K1's TMA + wgmma
//      GEMM): (M2, 4C) x (4C, 2C): 0.068 ms by bytes at C = 128, 0.039 by
//      operations at C = 256 and 512.
// The split costs one round trip of LN(merged) (the 0.09 ms of launch 0
// at C = 128, against 0.068 of one fused pass); it buys the statistics
// once a row and a GEMM whose A comes by TMA.
//
// merge_ln_kernel: one warp a merged row. Each lane holds chunks c = lane
// + 32 i of the row's 4C / 8 16-byte chunks as raw bf16 in registers,
// read once with 16-byte loads from the four source rows (the quadrant of
// a chunk found by comparisons, no division by C), for the mean, the
// squared deviations and the normalised store.
//
// Gone from the first version (one launch): the per-column-block
// recomputation of each row's statistics (2C / 128 times), the 2-byte
// loads with a division and a modulo by C per element, the WMMA k loop
// with synchronous loads and two __syncthreads a step, and the f32
// epilogue staged through shared memory and stored 2 bytes at a time.

#include "hopper_gemm.cuh"

namespace {

constexpr int PM_ROWS = 8;        // merged rows (warps) of a block
constexpr int PM_MAX_C = 1024;    // 16 chunks a lane

// y (M2, 4C) = bf16(LN(concat[x00, x10, x01, x11]) * scale + bias), one
// warp a row; 8 * 32 * kChunks >= 4C, C % 8 == 0, S even.
template <int kChunks>
__global__ void __launch_bounds__(32 * PM_ROWS)
merge_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, bf16* __restrict__ y, int B,
                int S, int C, float eps) {
  const int S2 = S / 2;
  const int m = blockIdx.x * PM_ROWS + threadIdx.x / 32;
  if (m >= B * S2 * S2) return;
  const int lane = threadIdx.x & 31;
  const int q8 = C / 8;  // chunks of one source row
  const int chunks = 4 * q8;
  const int K = 4 * C;
  const int img = m / (S2 * S2);
  const int y2 = (m / S2) % S2;
  const int x2 = m % S2;
  const size_t base = ((size_t)img * S + 2 * y2) * S + 2 * x2;
  const bf16* r00 = x + base * C;            // (2y, 2x)
  const bf16* r10 = x + (base + S) * C;      // (2y + 1, 2x)
  const bf16* r01 = x + (base + 1) * C;      // (2y, 2x + 1)
  const bf16* r11 = x + (base + S + 1) * C;  // (2y + 1, 2x + 1)

  uint4 u[kChunks];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    u[i] = make_uint4(0, 0, 0, 0);
    if (c < chunks) {
      const int quad = (c >= q8) + (c >= 2 * q8) + (c >= 3 * q8);
      const bf16* row =
          quad == 0 ? r00 : quad == 1 ? r10 : quad == 2 ? r01 : r11;
      u[i] = *reinterpret_cast<const uint4*>(row + 8 * (c - quad * q8));
    }
    const bf16* e = reinterpret_cast<const bf16*>(&u[i]);
#pragma unroll
    for (int k = 0; k < 8; ++k) s += __bfloat162float(e[k]);
  }
  const float mu = hg_warp_sum(s) / K;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (lane + 32 * i >= chunks) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&u[i]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = __bfloat162float(e[k]) - mu;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(hg_warp_sum(q) / K + eps);
  bf16* yr = y + (size_t)m * K;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i;
    if (c >= chunks) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&u[i]);
    const float4 s0 = *reinterpret_cast<const float4*>(scale + 8 * c);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + 8 * c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bias + 8 * c);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + 8 * c + 4);
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 o;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      op[k] = __floats2bfloat162_rn(
          (__bfloat162float(e[2 * k]) - mu) * rstd * sc[2 * k] + bi[2 * k],
          (__bfloat162float(e[2 * k + 1]) - mu) * rstd * sc[2 * k + 1] +
              bi[2 * k + 1]);
    *reinterpret_cast<uint4*>(yr + 8 * c) = o;
  }
}

template <int kChunks>
void launch_merge_ln(const bf16* x, const float* scale, const float* bias,
                     bf16* y, int B, int S, int C, float eps, int M2,
                     cudaStream_t s) {
  merge_ln_kernel<kChunks><<<(M2 + PM_ROWS - 1) / PM_ROWS, 32 * PM_ROWS, 0,
                             s>>>(x, scale, bias, y, B, S, C, eps);
}

}  // namespace

// Raises the GEMM's dynamic shared-memory limits on the current device and
// finds the CUDA driver's tensor-map encoder. Called once per device
// before the first launch; returns a cudaError_t as int.
extern "C" int geovpr_patch_merge_init(void) {
  if (tmap_encode_fn() == nullptr) return (int)cudaErrorSymbolNotFound;
  return (int)allow_gemm_smem<HG_EPI_NONE>();
}

// K6's launches first..last (0 merge-LN, 1 GEMM); returns a cudaError_t
// as int: 0 when every launch was accepted. x (B*S*S, C), ln (B*S*S/4,
// 4C) scratch, out (B*S*S/4, 2C) and w (4C, 2C) bf16 (in, out); ln_scale,
// ln_bias (4C,) f32; all 16-byte aligned. C % 8 == 0, C <= 1024, S even.
// A launch alone reads what the earlier launch of an earlier call left in
// ln. geovpr_patch_merge_init must have run on the current device.
extern "C" int geovpr_patch_merge_parts(const void* x, const void* ln_scale,
                                        const void* ln_bias, const void* w,
                                        void* ln, void* out, int B, int S,
                                        int C, float eps, int first, int last,
                                        void* stream) {
  if (B <= 0 || S <= 0 || S % 2 || C <= 0 || C % 8 || C > PM_MAX_C ||
      first < 0 || last > 1 || first > last)
    return (int)cudaErrorInvalidValue;
  const long long m2 = (long long)B * (S / 2) * (S / 2);
  if ((m2 + HG_BM - 1) / HG_BM > 65535 || (long long)B * S * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int M2 = (int)m2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* lnb = static_cast<bf16*>(ln);
  if (first == 0) {
    const float* sc = static_cast<const float*>(ln_scale);
    const float* bi = static_cast<const float*>(ln_bias);
    if (C <= 128)
      launch_merge_ln<2>(xb, sc, bi, lnb, B, S, C, eps, M2, s);
    else if (C <= 256)
      launch_merge_ln<4>(xb, sc, bi, lnb, B, S, C, eps, M2, s);
    else if (C <= 512)
      launch_merge_ln<8>(xb, sc, bi, lnb, B, S, C, eps, M2, s);
    else
      launch_merge_ln<16>(xb, sc, bi, lnb, B, S, C, eps, M2, s);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (last == 1) {
    CUtensorMap tm;
    if (!map_rows(&tm, lnb, M2, 4 * C)) return (int)cudaErrorInvalidValue;
    return (int)launch_gemm<HG_EPI_NONE>(
        tm, static_cast<const bf16*>(w), 4 * C, 2 * C,
        HgEpilogue{nullptr, nullptr, nullptr, 1.f, 0}, static_cast<bf16*>(out),
        M2, s);
  }
  return 0;
}

// Both launches (the whole boundary).
extern "C" int geovpr_patch_merge(const void* x, const void* ln_scale,
                                  const void* ln_bias, const void* w, void* ln,
                                  void* out, int B, int S, int C, float eps,
                                  void* stream) {
  return geovpr_patch_merge_parts(x, ln_scale, ln_bias, w, ln, out, B, S, C,
                                  eps, 0, 1, stream);
}
