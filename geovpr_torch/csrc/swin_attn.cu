// Fused Swin attention half-blocks for Hopper (sm_90a), on the raster
// token stream of one stage, (B, S*S, C) with S the stage's side:
//
//   K4 (bf16):  out = x + (W-MSA(LN(x)) @ Wo + bo)
//   K5 (w8a8):  out = x + (int8(W-MSA(int8(LN(x)*s + b) @ Wqkv_q)) @ Wo_q)
//                         * so + bo
//
// W-MSA is window attention per head with the relative-position bias and,
// on shifted blocks, the SW-MSA mask. Replaces geovpr/ops/
// pallas_swin_block.py::fused_swin_attn_block (:1125) and _rolled (:1104;
// both through _forward :1026, pallas_call :1070, bodies _kernel :418 and
// _kernel_rolled) and fused_swin_attn_block_int8 (:1159, _kernel_int8 with
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
// stays in raster order; the window partition and the cyclic shift are
// addressing in the attention kernels, which cover the shifted, unshifted
// and rolled JAX entries; no relayout copy and no (nW, N, N) mask exist on
// the device.
//
// K4 (four launches on the caller's stream; `geovpr_swin_attn_parts` runs
// a range of them, for timing one by one):
//   0. ln_rows_kernel (hopper_gemm.cuh): bf16 LN(x) into the ctx buffer,
//      free until the attention writes it (C <= 1024);
//   1. hopper_gemm_kernel<EPI_QKV> (hopper_gemm.cuh, K1's TMA + wgmma
//      GEMM): LN(x) Wqkv + bqkv, times dh^-0.5 log2 e on the C q columns,
//      rounded once -> qkv (M, 3C);
//   2. swin_attn_tma_kernel (below): qkv -> ctx;
//   3. hopper_gemm_kernel<EPI_RESID>: ctx Wo + bo + x (no LayerScale).
// What bounds each launch on the H100 (Swin-B-384, B=64; stages 0 / 1 / 2
// / 3 at C = 128 / 256 / 512 / 1024): LayerNorm by bytes (0.090 / 0.045 /
// 0.023 / 0.011 ms at 3.35 TB/s); the QKV GEMM by bytes at stage 0 (0.180
// ms; 58 GFLOP at every stage, 0.059 ms at 989 TFLOP/s, bounds stages 1-3);
// the attention by bytes at every stage (qkv read and ctx written: 0.180 /
// 0.090 / 0.045 / 0.023 ms, against 43.5 / 21.7 / 10.9 / 5.4 GFLOP); the
// out projection by bytes (0.135 / 0.068 / 0.034 ms; 0.020 by operations
// at stage 3). The sum, 0.586 / 0.293 / 0.160 / 0.112 ms, is what this
// split can reach; one fused pass could reach 0.12 / 0.10 / 0.09 / 0.08.
//
// swin_attn_tma_kernel. The stream stays in raster order: a 4-d tensor map
// of qkv (3C columns, x, y, image) in boxes of (64 columns = two heads,
// w/2, w/2, 1) reads a window as its four quarters, each from its own
// raster origin. Swin shifts by w/2 or not at all, so the cyclic shift
// never splits a quarter: the wrapped quarters of the last window row and
// column are boxes at the wrapped origin, no relayout copy exists, and the
// shift mask is a property of the quarters (two tokens of a wrapped
// window differ in mask region iff their quarters differ in a wrapped
// direction). A CTA per SM takes a contiguous run of (head pair, window)
// tasks (so the pair's bias tables seldom change) through a ring of 2-3
// stages (q, k and v of a task: 12 boxes, 55 KB at w = 12), counted on
// mbarriers: thread 0 fills the ring, and whoever stores a task's ctx from
// a stage reloads it with the task kStages on, so the next windows' loads
// overlap this window's math and no producer warp holds registers. Each
// box lands at a 1024-byte aligned slot with the 128-byte swizzle, so
// ldmatrix reads it without bank conflicts. Two consumer groups take
// alternate tasks; in a group, a warp takes kR query tiles of 16 rows of
// one head (kR = 3 at w = 12: six warps a group, 168 registers a thread),
// so that each 16-key tile's K and V fragments (ldmatrix, V by
// ldmatrix.trans: no element-by-element transpose) serve three tiles and
// the three tiles' dependency chains interleave. Per tile: S = Q K^T by
// mma.sync m16n8k16; bias [+ mask] in the exp2 domain in f32, as the old
// kernel and the plain version add them; p = 2^min(s, 100) by the SFU's
// ex2 (which flushes p < 2^-126 to zero where exp2f kept a subnormal: no
// bf16 p or f32 row sum it could change occurs); the f32 row sums; O += P
// V. The mask costs nothing in the windows it spares (a branch per task).
// mma.sync, not wgmma: a quarter of a 12-token window is 36 rows, not a
// whole number of wgmma's 8-row core matrices, while ldmatrix takes a row
// address per lane; and the attention is bound by its bytes, its exp2s
// and its issue rate, not by the tensor cores. The context, divided by the
// f32 row sum and rounded once, is written over the task's q slot (each
// warp over the rows and head it read) and stored by TMA in the same
// boxes; stores past the C columns (odd H) are dropped by TMA.
//
// Gone from the first version: K4's WMMA GEMMs (bf16_gemm.cuh), which pinned
// a 64 x (C + 8) A block and an f32 C tile in shared memory (one CTA an SM
// at C = 1024); the attention's per-(window, head) CTA, its synchronous
// gathers of 64-byte head slices and its element-by-element V transpose.
//
// K5 (three launches, unchanged since its port): int8_qkv_kernel
// (int8_attn.cuh, K2's), swin_window_attention_kernel<true> (one CTA per
// (window, head), q8/k8 and v^T gathered by the raster addressing below
// into shared memory, window_attn.cuh's mma.sync tile loop, shared with
// K7), int8_proj_kernel. Token (ry, rx) of window (wy, wx) of image b is
// raster row
//   b*S*S + ((wy*w + ry + shift) mod S) * S + (wx*w + rx + shift) mod S,
// its bias index (y_i - y_j + w - 1)(2w - 1) + (x_i - x_j + w - 1) into the
// ((2w-1)^2, H) table, and its shift-mask region label 3*ry' + rx' from its
// rolled-frame position (geovpr/models/swin.py:88-104). The kernels
// allocate nothing; the caller passes the scratch.

#include "hopper_gemm.cuh"
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

// ------------------------------------------------ K4's window attention --

// Geometry of swin_attn_tma_kernel at window side W (4, 8, 12 or 16: N =
// W^2 a multiple of 16 up to 256).
template <int W>
struct SwTile {
  static constexpr int kH = W / 2;                // side of a quarter (box)
  static constexpr int kN = W * W;                // tokens of a window
  static constexpr int kBoxRows = kH * kH;
  static constexpr int kBoxBytes = kBoxRows * 128;  // rows of two heads
  static constexpr int kSlot = (kBoxBytes + 1023) / 1024 * 1024;
  static constexpr int kTensor = 4 * kSlot;       // q, k or v of a task
  static constexpr int kStageBytes = 3 * kTensor;
  static constexpr int kStages = W == 16 ? 2 : 3;
  static constexpr int kT = 2 * W - 1;            // side of the bias grid
  static constexpr int kTiles = kN / 16;          // query tiles of a head
  // query tiles a warp takes at once (sharing each key tile's K and V
  // fragments), warps of a consumer group (a task: two heads), groups
  static constexpr int kR = W == 12 ? 3 : W == 4 ? 1 : 2;
  static constexpr int kGroupWarps = 2 * kTiles / kR;
  static constexpr int kGroups = W == 16 ? 1 : 2;
  static constexpr int kGroupThreads = 32 * kGroupWarps;
  static constexpr int kThreads = kGroups * kGroupThreads;
  // the ring, each group's two bias tables, the tokens' bias positions,
  // kStages barriers and align1024's slack
  static constexpr int kSmem = kStages * kStageBytes +
                               kGroups * 2 * kT * kT * 4 + kN * 4 +
                               kStages * 8 + 1024;
};

// Raster origin (x, y) of quarter `box` of window (wx, wy) in the rolled
// frame: (box >> 1, box & 1) is the quarter's row and column in the
// window, token (ly, lx) of the box is raster token (x + lx, y + ly).
template <int W>
__device__ __forceinline__ int2 sw_box_origin(int wx, int wy, int box, int S,
                                              int shift) {
  int x = wx * W + shift + (box & 1) * (W / 2);
  int y = wy * W + shift + (box >> 1) * (W / 2);
  if (x >= S) x -= S;  // the cyclic shift wraps the last window column
  if (y >= S) y -= S;  // and the last window row
  return make_int2(x, y);
}

// Shared-memory address of chunk c (16 bytes: chunk 4 hh + j holds dims
// 8 j .. 8 j + 7 of head hh of the pair) of token r (box-major: r =
// box * kBoxRows + ly * kH + lx) of a q, k or v tile at `base`, through
// the 128-byte swizzle of the 1024-byte-aligned box slot.
template <int W>
__device__ __forceinline__ uint32_t sw_addr(uint32_t base, int r, int c) {
  using T = SwTile<W>;
  const int lr = r % T::kBoxRows;
  return base + (r / T::kBoxRows) * T::kSlot + lr * 128 +
         ((c ^ (lr & 7)) << 4);
}

// 2^x for x <= 100 by the SFU's ex2, flushing a result below 2^-126 to 0
// (exp2f keeps it as a subnormal: an f32 row sum, or a bf16 p, that a
// term below 2^-126 would change does not occur here)
__device__ __forceinline__ float sw_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One warp: query rows [r_base, r_base + 16 kR) of head hh of a task
// against all kN keys; writes bf16 ctx over the same rows and head of the
// q tile. tab: the head's ((2W-1)^2) bias table in the exp2 domain; wrap:
// the quarter-index bits (2: row, 1: column) whose difference puts two
// tokens of this window in different shift-mask regions (0 unshifted;
// kMasked: wrap != 0, decided once a task).
template <int W, bool kMasked>
__device__ __forceinline__ void sw_attend(uint32_t qs, uint32_t ks,
                                          uint32_t vs, const float* tab,
                                          const int* pos_s, int r_base,
                                          int hh, int wrap, int lane) {
  using T = SwTile<W>;
  constexpr int R = T::kR;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int base = (W - 1) * (T::kT + 1);
  uint32_t qa[R][2][4];
  int pos[R][2], box[R][2];  // of this lane's query rows 16 i + g (+ 8)
  float o[R][4][4];
  float l[R][2];  // partial row sums (this lane's keys)
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldmatrix_x4<false>(qa[i][kk],
                         sw_addr<W>(qs, r_base + 16 * i + (lane & 15),
                                    4 * hh + 2 * kk + (lane >> 4)));
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = r_base + 16 * i + g + 8 * hi;
      pos[i][hi] = pos_s[r] + base;
      box[i][hi] = r / T::kBoxRows;
      l[i][hi] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
  }

#pragma unroll 1
  for (int k0 = 0; k0 < T::kN; k0 += 16) {
    // the key tile's K (two 8-key halves) and V (by ldmatrix.trans: no
    // element-by-element transpose) fragments, and its keys' positions
    uint32_t kb[2][4], vb[2][4];
    int pk[2][2], bk[2][2];  // key k0 + 8 j + 2 t + c
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ldmatrix_x4<false>(kb[j], sw_addr<W>(ks, k0 + 8 * j + (lane & 7),
                                           4 * hh + (lane >> 3)));
      ldmatrix_x4<true>(vb[j], sw_addr<W>(vs, k0 + (lane & 7) + (lane & 8),
                                          4 * hh + 2 * j + (lane >> 4)));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t + c;
        pk[j][c] = pos_s[key];
        bk[j][c] = key / T::kBoxRows;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      // S (16 x 16) as two 16 x 8 tiles: key k0 + 8 j + 2 t + (e & 1)
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        mma_bf16(s[j], qa[i][0], kb[j][0], kb[j][1]);
        mma_bf16(s[j], qa[i][1], kb[j][2], kb[j][3]);
      }
      // + bias [+ mask], p = exp2(min(s, 100)), as the plain version
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            float v = __fadd_rn(s[j][2 * hi + c],
                                tab[pos[i][hi] - pk[j][c]]);
            if (kMasked && ((box[i][hi] ^ bk[j][c]) & wrap))
              v = __fadd_rn(v, kMaskL2);
            const float p = sw_exp2(fminf(v, 100.f));
            l[i][hi] += p;
            s[j][2 * hi + c] = p;
          }
      // P as the A operand (16 x 16 keys) of P V
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma_bf16(o[i][2 * j], pa, vb[j][0], vb[j][1]);
        mma_bf16(o[i][2 * j + 1], pa, vb[j][2], vb[j][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float& li = l[i][hi];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int r = r_base + 16 * i + g + 8 * hi;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        st_shared_u32(sw_addr<W>(qs, r, 4 * hh + jn) + 4 * t,
                      pack_bf16(o[i][jn][2 * hi] / li,
                                o[i][jn][2 * hi + 1] / li));
    }
}

// Loads task `task`'s q, k and v (12 boxes) into stage `st`, counted on
// `bar`.
template <int W>
__device__ __forceinline__ void sw_load_task(unsigned char* st, uint64_t* bar,
                                             const CUtensorMap* tm, int task,
                                             int n_windows, int C, int S,
                                             int shift) {
  using T = SwTile<W>;
  const int nw = S / W;
  const int pair = task / n_windows;
  const int win = task % n_windows;
  const int img = win / (nw * nw);
  const int wy = (win / nw) % nw;
  const int wx = win % nw;
  mbar_expect_tx(bar, 12 * T::kBoxBytes);
  for (int box = 0; box < 4; ++box) {
    const int2 from = sw_box_origin<W>(wx, wy, box, S, shift);
    for (int q = 0; q < 3; ++q)
      tma_load_4d(st + q * T::kTensor + box * T::kSlot, tm, bar,
                  q * C + 64 * pair, from.x, from.y, img);
  }
}

// ctx (B*S*S, C) from qkv (B*S*S, 3C) with q pre-scaled: tm_qkv maps qkv
// as (3C, S, S, B) and tm_ctx ctx as (C, S, S, B), both in (64, W/2, W/2,
// 1) boxes; table ((2W-1)^2, H) f32, natural-log domain. Task = pair *
// n_windows + window, pair = heads 2 pair, 2 pair + 1; CTA c takes the
// `chunk` tasks from c * chunk on (so its pair, and with it the bias
// tables, seldom changes), its i-th task going to consumer group i %
// kGroups. The ring needs no producer warp: thread 0 fills it, and the
// group that has stored a task's ctx from a stage reloads the stage with
// the task kStages on.
template <int W>
__global__ void __launch_bounds__(SwTile<W>::kThreads, 1)
swin_attn_tma_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                     const __grid_constant__ CUtensorMap tm_ctx,
                     const float* __restrict__ table, int C, int H, int S,
                     int shift, int n_windows, int n_tasks, int chunk) {
  using T = SwTile<W>;
  constexpr int kTab = 2 * T::kT * T::kT;  // floats of a pair's tables
  extern __shared__ unsigned char sw_smem[];
  unsigned char* ring = align1024(sw_smem);
  float* tab_s =
      reinterpret_cast<float*>(ring + T::kStages * T::kStageBytes);
  int* pos_s = reinterpret_cast<int*>(tab_s + T::kGroups * kTab);
  uint64_t* full = reinterpret_cast<uint64_t*>(pos_s + T::kN);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int nw = S / W;
  const int first = blockIdx.x * chunk;
  const int count = min(chunk, n_tasks - first);

  // each token's position in the (2W-1)^2 bias grid
  for (int r = threadIdx.x; r < T::kN; r += T::kThreads) {
    const int box = r / T::kBoxRows;
    const int lr = r % T::kBoxRows;
    pos_s[r] = ((box >> 1) * T::kH + lr / T::kH) * T::kT +
               (box & 1) * T::kH + lr % T::kH;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
    for (int i = 0; i < T::kStages && i < count; ++i)
      sw_load_task<W>(ring + i * T::kStageBytes, full + i, &tm_qkv,
                      first + i, n_windows, C, S, shift);
  }
  __syncthreads();

  // group grp takes the CTA's tasks grp, grp + kGroups, ...; its warp w
  // the query tiles kR (w % (kGroupWarps / 2)) + 0..kR-1 of head
  // w / (kGroupWarps / 2)
  const int grp = warp / T::kGroupWarps;
  const int gw = warp % T::kGroupWarps;
  const int gtid = threadIdx.x % T::kGroupThreads;
  const int hh = gw / (T::kGroupWarps / 2);
  const int r_base = 16 * T::kR * (gw % (T::kGroupWarps / 2));
  float* tab = tab_s + grp * kTab;
  int pair_loaded = -1;
  for (int i = grp; i < count; i += T::kGroups) {
    const int task = first + i;
    const int s = i % T::kStages;
    const int pair = task / n_windows;
    const int win = task % n_windows;
    const int img = win / (nw * nw);
    const int wy = (win / nw) % nw;
    const int wx = win % nw;
    if (pair != pair_loaded) {
      // the pair's bias tables, times log2(e); the group's previous task's
      // last barrier has retired every reader of the old ones
      for (int k = gtid; k < kTab; k += T::kGroupThreads) {
        const int h = 2 * pair + k / (T::kT * T::kT);
        tab[k] = h < H ? table[(k % (T::kT * T::kT)) * H + h] * kLog2e : 0.f;
      }
      named_sync(1 + grp, T::kGroupThreads);
      pair_loaded = pair;
    }
    mbar_wait(full + s, (i / T::kStages) & 1);
    unsigned char* st = ring + s * T::kStageBytes;
    const uint32_t qs = smem_u32(st);
    const int wrap =
        shift ? (wy == nw - 1 ? 2 : 0) | (wx == nw - 1 ? 1 : 0) : 0;
    const float* tab_h = tab + hh * T::kT * T::kT;
    if (2 * pair + hh >= H) {
      // odd H: the last pair has one head
    } else if (wrap) {
      sw_attend<W, true>(qs, qs + T::kTensor, qs + 2 * T::kTensor, tab_h,
                         pos_s, r_base, hh, wrap, lane);
    } else {
      sw_attend<W, false>(qs, qs + T::kTensor, qs + 2 * T::kTensor, tab_h,
                          pos_s, r_base, hh, 0, lane);
    }
    fence_proxy_async();
    named_sync(1 + grp, T::kGroupThreads);
    if (gtid == 0) {
      // ctx by TMA from the q slots; once the stores have read the stage
      // it takes the task kStages on
      for (int box = 0; box < 4; ++box) {
        const int2 to = sw_box_origin<W>(wx, wy, box, S, shift);
        tma_store_4d(&tm_ctx, st + box * T::kSlot, 64 * pair, to.x, to.y,
                     img);
      }
      bulk_commit();
      bulk_wait_read();
      if (i + T::kStages < count)
        sw_load_task<W>(st, full + s, &tm_qkv, task + T::kStages, n_windows,
                        C, S, shift);
    }
  }
}

template <int W>
cudaError_t launch_swin_attn(const bf16* qkv, bf16* ctx, const float* table,
                             int B, int S, int C, int H, int shift,
                             cudaStream_t s) {
  using T = SwTile<W>;
  CUtensorMap tq, tc;
  const cuuint32_t box[4] = {64, T::kH, T::kH, 1};
  const cuuint64_t dq[4] = {(cuuint64_t)3 * C, (cuuint64_t)S, (cuuint64_t)S,
                            (cuuint64_t)B};
  const cuuint64_t sq[3] = {(cuuint64_t)3 * C * 2, (cuuint64_t)S * 3 * C * 2,
                            (cuuint64_t)S * S * 3 * C * 2};
  const cuuint64_t dc[4] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)S,
                            (cuuint64_t)B};
  const cuuint64_t sc[3] = {(cuuint64_t)C * 2, (cuuint64_t)S * C * 2,
                            (cuuint64_t)S * S * C * 2};
  if (!make_tmap(&tq, qkv, 4, dq, sq, box) ||
      !make_tmap(&tc, ctx, 4, dc, sc, box))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const int n_windows = B * (S / W) * (S / W);
  const int n_tasks = n_windows * ((H + 1) / 2);
  const int chunk = (n_tasks + sms - 1) / sms;
  swin_attn_tma_kernel<W><<<(n_tasks + chunk - 1) / chunk, T::kThreads,
                            T::kSmem, s>>>(tq, tc, table, C, H, S, shift,
                                           n_windows, n_tasks, chunk);
  return cudaGetLastError();
}

const int kMaxSmem = 232448;

template <typename Kernel>
cudaError_t allow_max_smem(Kernel* kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

// What K5 takes: C = 32 H, windows of N = win^2 tokens with N a multiple
// of 16 up to SW_MAX_N, a square stage of whole windows, a shift in [0,
// win), and row blocks within the grid's y limit. K4 takes the same
// geometry with C <= 1024 (its LayerNorm keeps a row in a warp's
// registers) and a shift of 0 or win / 2 (Swin's own: a quarter of a
// window is one TMA box).
bool swin_shapes_ok(int B, int S, int C, int H, int win, int shift) {
  const int n = win * win;
  return B > 0 && H > 0 && C == H * SW_DH && win > 0 && n % 16 == 0 &&
         n <= SW_MAX_N && S > 0 && S % win == 0 && shift >= 0 &&
         shift < win && (long long)B * S * S / 64 + 1 <= 65535 &&
         (long long)B * (S / win) * (S / win) <= 0x7fffffff;
}

bool k4_shapes_ok(int B, int S, int C, int H, int win, int shift) {
  return swin_shapes_ok(B, S, C, H, win, shift) && C <= HG_MAX_DIM &&
         (shift == 0 || 2 * shift == win) &&
         ((long long)B * S * S + HG_BM - 1) / HG_BM <= 65535;
}

}  // namespace

// Raises the kernels' dynamic shared-memory limits on the current device
// and finds the CUDA driver's tensor-map encoder. Called once per device
// before the first launch; returns a cudaError_t.
extern "C" int geovpr_swin_init(void) {
  cudaError_t e;
  if (tmap_encode_fn() == nullptr) return (int)cudaErrorSymbolNotFound;
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if ((e = allow_gemm_smem<HG_EPI_QKV>()) != cudaSuccess ||
      (e = allow_gemm_smem<HG_EPI_RESID>()) != cudaSuccess ||
      (e = cudaFuncSetAttribute(swin_attn_tma_kernel<4>, a,
                                SwTile<4>::kSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(swin_attn_tma_kernel<8>, a,
                                SwTile<8>::kSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(swin_attn_tma_kernel<12>, a,
                                SwTile<12>::kSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(swin_attn_tma_kernel<16>, a,
                                SwTile<16>::kSmem)) != cudaSuccess ||
      (e = allow_max_smem(int8_qkv_kernel)) != cudaSuccess ||
      (e = allow_max_smem(int8_proj_kernel)) != cudaSuccess)
    return (int)e;
  return (int)allow_max_smem(swin_window_attention_kernel<true>);
}

// K4's launches first..last (0 LayerNorm, 1 QKV GEMM, 2 window attention,
// 3 out projection); returns a cudaError_t as int: 0 when every launch was
// accepted. x and out are (B*S*S, C) bf16 raster rows; wqkv (C, 3C) and wo
// (C, C) bf16 (in, out); ln_scale, ln_bias, bqkv, bo f32; table ((2w-1)^2,
// H) f32; all 16-byte aligned. Scratch: qkv (B*S*S, 3C), ctx (B*S*S, C)
// bf16 (LN(x) until the attention writes ctx). qscale = dh^-0.5 log2(e).
// A launch alone reads what the earlier launches of an earlier call left
// in qkv and ctx. geovpr_swin_init must have run on the current device.
extern "C" int geovpr_swin_attn_parts(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* table,
    void* qkv, void* ctx, void* out, int B, int S, int C, int H, int win,
    int shift, float eps, float qscale, int first, int last, void* stream) {
  if (!k4_shapes_ok(B, S, C, H, win, shift) || first < 0 || last > 3 ||
      first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkvb = static_cast<bf16*>(qkv);
  bf16* ctxb = static_cast<bf16*>(ctx);
  const float* tab = static_cast<const float*>(table);
  CUtensorMap tm;
  cudaError_t e;
  for (int part = first; part <= last; ++part) {
    switch (part) {
      case 0:
        e = launch_ln_rows(xb, static_cast<const float*>(ln_scale),
                           static_cast<const float*>(ln_bias), ctxb, M, C,
                           eps, s);
        break;
      case 1:
        if (!map_rows(&tm, ctxb, M, C)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_QKV>(
            tm, static_cast<const bf16*>(wqkv), C, 3 * C,
            HgEpilogue{static_cast<const float*>(bqkv), nullptr, nullptr,
                       qscale, C},
            qkvb, M, s);
        break;
      case 2:
        e = win == 4    ? launch_swin_attn<4>(qkvb, ctxb, tab, B, S, C, H,
                                              shift, s)
            : win == 8  ? launch_swin_attn<8>(qkvb, ctxb, tab, B, S, C, H,
                                              shift, s)
            : win == 12 ? launch_swin_attn<12>(qkvb, ctxb, tab, B, S, C, H,
                                               shift, s)
                        : launch_swin_attn<16>(qkvb, ctxb, tab, B, S, C, H,
                                               shift, s);
        break;
      default:
        if (!map_rows(&tm, ctxb, M, C)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_RESID>(
            tm, static_cast<const bf16*>(wo), C, C,
            HgEpilogue{static_cast<const float*>(bo), nullptr, xb, 1.f, 0},
            static_cast<bf16*>(out), M, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// K4, all four launches (the whole half-block).
extern "C" int geovpr_swin_attn_bf16(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* table,
    void* qkv, void* ctx, void* out, int B, int S, int C, int H, int win,
    int shift, float eps, float qscale, void* stream) {
  return geovpr_swin_attn_parts(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                table, qkv, ctx, out, B, S, C, H, win, shift,
                                eps, qscale, 0, 3, stream);
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
