// Fused Swin attention half-blocks for Hopper (sm_90a), on the raster
// token stream of one stage, (B, S*S, C) with S the stage's side:
//
//   K4 (bf16):  out = x + (W-MSA(LN(x)) @ Wo + bo)
//   K5 (w8a8):  out = x + (int8(W-MSA(int8(LN(x)*s + b) @ Wqkv_q)) @ Wo_q)
//                         * so + bo
//
// W-MSA is window attention per head with the relative-position bias and,
// on shifted blocks, the SW-MSA mask. Replaces geovpr/ops/
// pallas_swin_block.py::fused_swin_attn_block and _rolled (bodies _kernel,
// _kernel_rolled) and fused_swin_attn_block_int8 (_kernel_int8 with
// qk8 = True, pv8 = False: the JAX defaults). Numerics follow those bodies:
// LN in f32 (two-pass), qkv with f32 accumulation, dh^-0.5 * log2(e)
// folded into the q columns in f32 before the bf16 rounding (K4) or the
// score constant cs2 = a_q a_k dh^-0.5 log2(e) applied to the exact int32
// q8.k8 scores (K5); bias and mask in the exp2 domain (times log2(e) in
// f32); p = exp2(min(s, 100)) with no max-shift, so p < 2^100 and P is
// rounded to bf16 (never fp16) for P.V; the f32 row sum divides the
// context, which is rounded to bf16 (K4) or once to int8 (K5).
//
// Layout. The TPU kernels take the stream window-partitioned, or in an
// "alternating" layout whose shifted windows they assemble in VMEM from two
// adjacent window rows; both exist for Mosaic and VMEM. Here the stream
// stays in raster order and the window partition and the cyclic shift are
// row-index arithmetic in the attention kernel: token (ry, rx) of window
// (wy, wx) of image b is raster row
//   b*S*S + ((wy*w + ry + shift) mod S) * S + (wx*w + rx + shift) mod S,
// its bias index (y_i - y_j + w - 1)(2w - 1) + (x_i - x_j + w - 1) into the
// ((2w-1)^2, H) table, and its shift-mask region label 3*ry' + rx' from its
// rolled-frame position (geovpr/models/swin.py:88-104). One kernel covers
// the shifted, unshifted and rolled JAX entries; no relayout copy and no
// (nW, N, N) mask exist on the device.
//
// What bounds it on the H100: at Swin-B-384, B=64 a layer is
// 8 BW N C^2 + 4 BW H N^2 dh operations (stage 0: 121 GFLOP, 0.122 ms at
// 989 TFLOP/s) against 2 x 151 MB of stream (0.090 ms at 3.35 TB/s):
// tensor-core bound in the projections, which carry ~80% of the work; the
// attention core is 144-key windows at head dim 32, small products that
// mma.sync m16n8k16 takes whole.
//
// Design (first, simple version; three launches on the caller's stream):
//   1. qkv: K4 gemm_kernel<LN, QKV> (bf16_gemm.cuh, K1's LN GEMM, with the
//      q-column scale); K5 int8_qkv_kernel (int8_attn.cuh, K2's).
//   2. swin_window_attention_kernel: one CTA per (window, head), N/16 warps
//      of 16 query rows; the window's q, k and v^T (head dim 32) gathered
//      into shared memory by the raster addressing above, the head's bias
//      table and the tokens' positions and labels beside them. Each warp
//      runs window_attn.cuh's tile loop (shared with K7), walking the keys
//      in tiles of 16: scores by mma.sync (bf16 m16n8k16, or
//      s8 m16n8k32 for K5) in registers, bias + mask + exp2 in registers,
//      the probabilities repacked as the A operand of the P.V mma.sync
//      (no rescale is needed without a max-shift), context accumulated in
//      registers across all tiles.
//   3. out projection + residual: K4 gemm_kernel<plain, PROJ>; K5
//      int8_proj_kernel.
// qkv and ctx round-trip through device memory between the launches, and
// mma.sync/WMMA stand in for wgmma/TMA: the first things a faster version
// changes. The kernels allocate nothing; the caller passes the scratch.

#include "bf16_gemm.cuh"
#include "int8_attn.cuh"
#include "window_attn.cuh"

namespace {

constexpr int SW_MAX_N = 256;         // window tokens (16 warps)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskL2 = -100.f * kLog2e;
constexpr int QK_LD_I8 = 48;          // bytes per q/k row: 32 + 16 pad

__host__ __device__ inline size_t round16(size_t v) { return (v + 15) & ~(size_t)15; }

// Shared memory of one (window, head): token rows, positions and labels
// (3 N ints), the head's bias table ((2w-1)^2 floats), q and k (N rows each)
// and v^T (32 rows of N + 8 bf16).
__host__ __device__ inline size_t win_smem_bytes(int win, bool int8) {
  const int n = win * win;
  const int t = 2 * win - 1;
  return round16((size_t)(3 * n + t * t) * 4) +
         (size_t)2 * n * (int8 ? QK_LD_I8 : QK_LD_BF16) +
         (size_t)SW_DH * (n + 8) * sizeof(bf16);
}

// kInt8 == false (K4): qk is qkv (M, 3C) bf16 with q|k|v column blocks,
// head h at columns h*32 of each (q pre-scaled by dh^-0.5 log2 e); vsrc
// unused; ctx (M, C) bf16.
// kInt8 == true (K5): qk is qk8 (M, 2C) int8 (q|k), vsrc (M, C) bf16,
// ctx (M, C) int8; cs2 dequantizes the int32 scores into the exp2 domain.
// table: ((2w-1)^2, H) f32, natural-log domain. Grid (B * nW, H); N/16
// warps.
template <bool kInt8>
__global__ void __launch_bounds__(SW_MAX_N * 2)
swin_window_attention_kernel(const void* __restrict__ qk,
                             const bf16* __restrict__ vsrc,
                             void* __restrict__ ctx,
                             const float* __restrict__ table, int C, int H,
                             int S, int win, int shift, float cs2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = win * win;
  const int T = 2 * win - 1;
  const int nwx = S / win;
  const int h = blockIdx.y;
  const int b = blockIdx.x / (nwx * nwx);
  const int wy = (blockIdx.x / nwx) % nwx;
  const int wx = blockIdx.x % nwx;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  int* rows_s = reinterpret_cast<int*>(smem);
  int* pos_s = rows_s + N;
  int* lab_s = pos_s + N;
  float* tab_s = reinterpret_cast<float*>(lab_s + N);
  unsigned char* q_s = smem + round16((size_t)(3 * N + T * T) * 4);
  const int qk_ld = kInt8 ? QK_LD_I8 : QK_LD_BF16;
  unsigned char* k_s = q_s + (size_t)N * qk_ld;
  bf16* vt_s = reinterpret_cast<bf16*>(k_s + (size_t)N * qk_ld);
  const int vt_ld = N + 8;

  for (int r = tid; r < N; r += nthreads) {
    const int ry = r / win;
    const int rx = r % win;
    const int Y = wy * win + ry;  // rolled frame
    const int X = wx * win + rx;
    int y = Y + shift;
    int x = X + shift;
    if (y >= S) y -= S;
    if (x >= S) x -= S;
    rows_s[r] = (b * S + y) * S + x;
    pos_s[r] = ry * T + rx;
    lab_s[r] = shift ? 3 * (Y < S - win ? 0 : (Y < S - shift ? 1 : 2)) +
                           (X < S - win ? 0 : (X < S - shift ? 1 : 2))
                     : 0;
  }
  for (int i = tid; i < T * T; i += nthreads) tab_s[i] = table[i * H + h] * kLog2e;
  __syncthreads();

  // q, k (16-byte chunks) and v transposed, gathered by raster row
  if (!kInt8) {
    const bf16* src = static_cast<const bf16*>(qk);
    const size_t ld = 3 * (size_t)C;
    for (int i = tid; i < N * 4; i += nthreads) {
      const int r = i >> 2;
      const int c = i & 3;
      const bf16* row = src + (size_t)rows_s[r] * ld + h * SW_DH + c * 8;
      *reinterpret_cast<uint4*>(q_s + r * QK_LD_BF16 + c * 16) =
          *reinterpret_cast<const uint4*>(row);
      *reinterpret_cast<uint4*>(k_s + r * QK_LD_BF16 + c * 16) =
          *reinterpret_cast<const uint4*>(row + C);
      const uint4 vv = *reinterpret_cast<const uint4*>(row + 2 * C);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(c * 8 + e) * vt_ld + r] = ve[e];
    }
  } else {
    const int8_t* src = static_cast<const int8_t*>(qk);
    const size_t ld = 2 * (size_t)C;
    for (int i = tid; i < N * 2; i += nthreads) {
      const int r = i >> 1;
      const int c = i & 1;
      const int8_t* row = src + (size_t)rows_s[r] * ld + h * SW_DH + c * 16;
      *reinterpret_cast<uint4*>(q_s + r * QK_LD_I8 + c * 16) =
          *reinterpret_cast<const uint4*>(row);
      *reinterpret_cast<uint4*>(k_s + r * QK_LD_I8 + c * 16) =
          *reinterpret_cast<const uint4*>(row + C);
    }
    for (int i = tid; i < N * 4; i += nthreads) {
      const int r = i >> 2;
      const int c = i & 3;
      const uint4 vv = *reinterpret_cast<const uint4*>(
          vsrc + (size_t)rows_s[r] * C + h * SW_DH + c * 8);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(c * 8 + e) * vt_ld + r] = ve[e];
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;

  // A fragments of the warp's 16 query rows, held for every key tile
  uint32_t qa[2][4];
  if (!kInt8) {
    load_q_frags_bf16(q_s, r0, t, qa);
  } else {
    const unsigned char* p0 = q_s + r0 * QK_LD_I8 + t * 4;
    const unsigned char* p1 = q_s + r1 * QK_LD_I8 + t * 4;
    qa[0][0] = *reinterpret_cast<const uint32_t*>(p0);
    qa[0][1] = *reinterpret_cast<const uint32_t*>(p1);
    qa[0][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
    qa[0][3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
  }
  const int base = (win - 1) * (T + 1);
  const int pos0 = pos_s[r0] + base;
  const int pos1 = pos_s[r1] + base;
  const int lab0 = lab_s[r0];
  const int lab1 = lab_s[r1];

  float o[4][4];
  float l0, l1;
  warp_window_attention(
      N, vt_s, vt_ld,
      [&](int kr, float (&sj)[4]) {
        if (!kInt8) {
          scores_bf16(qa, k_s, kr, t, sj);
        } else {
          int si[4] = {0, 0, 0, 0};
          const unsigned char* kp = k_s + kr * QK_LD_I8 + t * 4;
          mma_s8(si, qa[0], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 16));
          // rounded product, then the sums below: no fused multiply-add, so
          // that s rounds as the plain version's and JAX's do
#pragma unroll
          for (int e = 0; e < 4; ++e) sj[e] = __fmul_rn((float)si[e], cs2);
        }
      },
      // + bias [+ mask], p = exp2(min(s, 100))
      [&](int key, bool hi, float sv) {
        float v = __fadd_rn(sv, tab_s[(hi ? pos1 : pos0) - pos_s[key]]);
        if (shift && (hi ? lab1 : lab0) != lab_s[key]) v = __fadd_rn(v, kMaskL2);
        return exp2f(fminf(v, 100.f));
      },
      o, l0, l1);

  const size_t out0 = (size_t)rows_s[r0] * C + h * SW_DH + 2 * t;
  const size_t out1 = (size_t)rows_s[r1] * C + h * SW_DH + 2 * t;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    const float a0 = o[jn][0] / l0;
    const float a1 = o[jn][1] / l0;
    const float b0 = o[jn][2] / l1;
    const float b1 = o[jn][3] / l1;
    if (!kInt8) {
      bf16* dst = static_cast<bf16*>(ctx);
      *reinterpret_cast<__nv_bfloat162*>(dst + out0 + jn * 8) =
          __floats2bfloat162_rn(a0, a1);
      *reinterpret_cast<__nv_bfloat162*>(dst + out1 + jn * 8) =
          __floats2bfloat162_rn(b0, b1);
    } else {
      int8_t* dst = static_cast<int8_t*>(ctx);
      *reinterpret_cast<char2*>(dst + out0 + jn * 8) =
          make_char2(round_clip_i8(a0), round_clip_i8(a1));
      *reinterpret_cast<char2*>(dst + out1 + jn * 8) =
          make_char2(round_clip_i8(b0), round_clip_i8(b1));
    }
  }
}

const int kMaxSmem = 232448;

template <typename Kernel>
cudaError_t allow_max_smem(Kernel* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

// What both entries take: C = 32 H, windows of N = win^2 tokens with N a
// multiple of 16 up to SW_MAX_N, a square stage of whole windows, a shift
// in [0, win), and row blocks within the grid's y limit.
bool swin_shapes_ok(int B, int S, int C, int H, int win, int shift) {
  const int n = win * win;
  return B > 0 && H > 0 && C == H * SW_DH && win > 0 && n % 16 == 0 &&
         n <= SW_MAX_N && S > 0 && S % win == 0 && shift >= 0 &&
         shift < win && (long long)B * S * S / 64 + 1 <= 65535 &&
         (long long)B * (S / win) * (S / win) <= 0x7fffffff;
}

}  // namespace

// Raises the kernels' dynamic shared-memory limits on the current device.
// Called once per device before the first launch; returns a cudaError_t.
extern "C" int geovpr_swin_init(void) {
  cudaError_t e;
  if ((e = allow_max_smem(gemm_kernel<true, EPI_QKV>)) != cudaSuccess ||
      (e = allow_max_smem(gemm_kernel<false, EPI_PROJ>)) != cudaSuccess ||
      (e = allow_max_smem(int8_qkv_kernel)) != cudaSuccess ||
      (e = allow_max_smem(int8_proj_kernel)) != cudaSuccess ||
      (e = allow_max_smem(swin_window_attention_kernel<false>)) != cudaSuccess)
    return (int)e;
  return (int)allow_max_smem(swin_window_attention_kernel<true>);
}

// K4. Returns a cudaError_t as int: 0 when every launch was accepted. x and
// out are (B*S*S, C) bf16 raster rows; wqkv (C, 3C) and wo (C, C) bf16
// (in, out); ln_scale, ln_bias, bqkv, bo f32; table ((2w-1)^2, H) f32.
// Scratch: qkv (B*S*S, 3C), ctx (B*S*S, C) bf16. qscale = dh^-0.5 log2(e).
extern "C" int geovpr_swin_attn_bf16(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* table,
    void* qkv, void* ctx, void* out, int B, int S, int C, int H, int win,
    int shift, float eps, float qscale, void* stream) {
  if (!swin_shapes_ok(B, S, C, H, win, shift) || C % 16 ||
      gemm_smem_bytes(C) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  const int m_blocks = (M + GEMM_BM - 1) / GEMM_BM;
  const int N = win * win;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t gsmem = gemm_smem_bytes(C);
  const bf16* xb = static_cast<const bf16*>(x);
  cudaError_t e;

  gemm_kernel<true, EPI_QKV>
      <<<dim3((3 * C + GEMM_BN - 1) / GEMM_BN, m_blocks), GEMM_THREADS, gsmem, s>>>(
          xb, static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
          static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias),
          eps, nullptr, nullptr, static_cast<bf16*>(qkv), M, C, 3 * C, qscale, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  swin_window_attention_kernel<false>
      <<<dim3(B * (S / win) * (S / win), H), 2 * N, win_smem_bytes(win, false), s>>>(
          qkv, nullptr, ctx, static_cast<const float*>(table), C, H, S, win,
          shift, 0.f);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  gemm_kernel<false, EPI_PROJ>
      <<<dim3((C + GEMM_BN - 1) / GEMM_BN, m_blocks), GEMM_THREADS, gsmem, s>>>(
          static_cast<const bf16*>(ctx), static_cast<const bf16*>(wo),
          static_cast<const float*>(bo), nullptr, nullptr, 0.f, nullptr, xb,
          static_cast<bf16*>(out), M, C, C, 1.f, 0);
  return (int)cudaGetLastError();
}

// K5. Returns a cudaError_t as int. x and out (B*S*S, C) bf16; wqkv_t
// (3C, C) and wo_t (C, C) int8, k-contiguous; vectors and table f32.
// Scratch: qk8 (B*S*S, 2C) int8, v (B*S*S, C) bf16, ctx8 (B*S*S, C) int8.
// C a multiple of 64 up to 1024. cs2 = a_q a_k dh^-0.5 log2(e).
extern "C" int geovpr_swin_attn_int8(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* wqkv_t, const void* sqkv, const void* bqkv, const void* wo_t,
    const void* so, const void* bo, const void* table, void* qk8, void* v,
    void* ctx8, void* out, int B, int S, int C, int H, int win, int shift,
    float eps, float cs2, void* stream) {
  if (!swin_shapes_ok(B, S, C, H, win, shift) || C % 64 || C > LN_MAX_D ||
      int8_proj_smem_bytes(C) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  const int m_blocks = (M + ProjGemm::BM - 1) / ProjGemm::BM;
  const int N = win * win;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t gsmem = int8_proj_smem_bytes(C);
  cudaError_t e;

  int8_qkv_kernel<<<dim3((3 * C + ProjGemm::BN - 1) / ProjGemm::BN, m_blocks),
                    I8_THREADS, gsmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), eps,
      static_cast<const int8_t*>(wqkv_t), static_cast<const float*>(sqkv),
      static_cast<const float*>(bqkv), static_cast<int8_t*>(qk8),
      static_cast<bf16*>(v), M, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  swin_window_attention_kernel<true>
      <<<dim3(B * (S / win) * (S / win), H), 2 * N, win_smem_bytes(win, true), s>>>(
          qk8, static_cast<const bf16*>(v), ctx8,
          static_cast<const float*>(table), C, H, S, win, shift, cs2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  int8_proj_kernel<<<dim3((C + ProjGemm::BN - 1) / ProjGemm::BN, m_blocks),
                     I8_THREADS, gsmem, s>>>(
      static_cast<const int8_t*>(ctx8), static_cast<const int8_t*>(wo_t),
      static_cast<const float*>(so), static_cast<const float*>(bo), nullptr,
      static_cast<const bf16*>(x), static_cast<bf16*>(out), M, C);
  return (int)cudaGetLastError();
}
