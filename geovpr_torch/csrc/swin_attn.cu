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
// _kernel_rolled) and fused_swin_attn_block_int8 (:1159, _kernel_int8) in
// its three attention modes, geovpr_torch.ops.quant.ATTN_MODES (mode codes
// 0, 1, 2): int8 scores (qk8 = True, pv8 = False, the JAX default), int8
// P.V (pv8 = True: GEOVPR_INT8_PV=1) and bf16 scores (qk8 = False:
// GEOVPR_INT8_QK=0). Numerics follow those bodies:
// LN in f32 (two-pass), qkv with f32 accumulation, dh^-0.5 * log2(e)
// folded into the q columns in f32 before the bf16 rounding (K4) or the
// score constant cs2 = a_q a_k dh^-0.5 log2(e) applied to the exact int32
// q8.k8 scores (K5); bias and mask in the exp2 domain (times log2(e) in
// f32); p = exp2(min(s, 100)) with no max-shift, so p < 2^100 and P is
// rounded to bf16 (never fp16) for P.V; the f32 row sum divides the
// context, which is rounded to bf16 (K4) or once to int8 (K5). K5 in bf16
// scores is K4's arithmetic on the dequantised qkv (q times dh^-0.5
// log2(e) in f32 before its bf16 rounding) with the context rounded once
// to int8; in int8 P.V, p = exp2(s - max_j s) <= 1 against every key's
// max, rounded to 127ths and multiplied by the int8 v exactly, and ctx =
// ci (cpv / z) with z the f32 sum of p.
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
// swin_attn_tma_kernel (its window geometry, SwTile, sw_box_origin and
// sw_addr, in swin_window.cuh, which K9's kernels share). The stream stays
// in raster order: a 4-d tensor map
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
// Gone from the first version: K4's WMMA GEMMs (a bf16_gemm.cuh since
// removed), which pinned
// a 64 x (C + 8) A block and an f32 C tile in shared memory (one CTA an SM
// at C = 1024); the attention's per-(window, head) CTA, its synchronous
// gathers of 64-byte head slices and its element-by-element V transpose.
//
// K5 (four launches on the caller's stream, as K4's;
// `geovpr_swin_attn_int8_parts` runs a range of them):
//   0. ln_quant_kernel (hopper_gemm_s8.cuh): int8(LN(x) s' + b') into the
//      ctx8 buffer, free until the attention writes it, once per row;
//   1. hopper_gemm_s8_kernel<EPI_QK8V> (the TMA + wgmma int8 GEMM):
//      acc sqkv + bqkv, q | k rounded to int8 -> qk8 (M, 2C), v rounded to
//      bf16 -> v (M, C); in int8 P.V every column int8 -> qkv8 (M, 3C); in
//      bf16 scores hopper_gemm_s8_kernel<EPI_QKV16> -> qkv (M, 3C) bf16,
//      q times dh^-0.5 log2(e);
//   2. swin_attn8_tma_kernel (below): qk8, v -> ctx8 (M, C) int8; in int8
//      P.V swin_attn8_tma_kernel<W, true> on qkv8; in bf16 scores K4's
//      swin_attn_tma_kernel<W, true> on qkv, its context rounded to int8;
//   3. hopper_gemm_s8_kernel<EPI_RESID>: ctx8 Wo^T so + bo + x.
// K5's f32 form (`geovpr_swin_attn_int8_parts` with f32 set; JAX's kernel
// writes xw.dtype, pallas_swin_block.py:1230) runs the same launches on an
// f32 x and out: launch 0 reads f32 rows, launch 3 adds the f32 residual and
// stores f32, unrounded; launches 1 and 2 are the bf16 form's. The models
// hand K5 a bf16 stream (SwinBlock casts around it, as JAX's does).
// What bounds each launch on the H100 (Swin-B-384, B=64; stages 0 / 1 / 2
// / 3): the LN-quant pass by bytes (0.068 / 0.034 / 0.017 / 0.008 ms); the
// QKV GEMM by bytes at stages 0-1 (0.113 / 0.056 ms: qk8 and v written;
// int8 P.V 0.090 / 0.045, bf16 scores 0.158 / 0.079 / 0.040) and by
// operations at 2-3 (58 GOP, 0.029 ms at 1,979 TOP/s); the attention by
// bytes (qk8 and v read, ctx8 written: 0.113 / 0.056 / 0.028 / 0.014 ms;
// int8 P.V 0.090 / 0.045 / 0.023 / 0.011, bf16 scores 0.158 / 0.079 /
// 0.039 / 0.020); the out projection by bytes (0.113 / 0.056 / 0.028 /
// 0.014). The sum, 0.406 / 0.203 / 0.103 / 0.066 ms in int8 scores, is
// what the split can reach.
//
// swin_attn8_tma_kernel is swin_attn_tma_kernel's task walk, ring and
// consumer groups on int8 q and k: a 4-d tensor map of qk8 in boxes of
// (64 bytes = two heads, w/2, w/2, 1) with the 64-byte swizzle reads a
// window's q8 and k8 as four quarters each, K4's bf16 boxes its v; wrapped
// quarters are boxes at their wrapped origin and the shift mask is a
// comparison of quarter indices, as in K4. Scores are exact int32 sums of
// one mma.sync m16n8k32 a 16 x 8 tile (ldmatrix reads the int8 tiles as
// b16), then __fmul_rn by cs2 and __fadd_rn of bias [+ mask], as the plain
// version rounds; P V, the row sums and the division are K4's; the context
// is rounded once to int8 over the q8 slot and stored by TMA (a 64-byte
// box a quarter). In int8 P.V (kPv8) v8 comes in q8's boxes, and each
// warp makes two passes over the window's keys (sw8pv_attend): the rows'
// max, then p, z, P in 127ths and O += P V by mma.sync m16n8k32 per 32
// keys (144 = 4.5 of them: the missing half is P = 0), the B fragment
// gathered byte by byte from v8 in the P fragment's key order (see K2's
// note in mhsa_int8.cu). In bf16 scores K4's kernel runs with kOut8: the
// context is rounded once to int8 and written in K5's ctx8 boxes over the
// q slots once every warp of the group has read its q rows.
//
// Token (ry, rx) of window
// (wy, wx) of image b is raster row
//   b*S*S + ((wy*w + ry + shift) mod S) * S + (wx*w + rx + shift) mod S,
// its bias index (y_i - y_j + w - 1)(2w - 1) + (x_i - x_j + w - 1) into the
// ((2w-1)^2, H) table, and its shift-mask region label 3*ry' + rx' from its
// rolled-frame position (geovpr/models/swin.py:88-104). The kernels
// allocate nothing; the caller passes the scratch.

#include "hopper_gemm_s8.cuh"
#include "swin_window.cuh"
#include "window_attn.cuh"

namespace {

constexpr int SW_MAX_N = 256;         // window tokens
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskL2 = -100.f * kLog2e;

// ------------------------------------------------ K4's window attention --

// Shared-memory address of chunk c (16 bytes: chunk 2 hh + j holds dims
// 16 j .. 16 j + 15 of head hh of the pair) of token r (box-major, as
// sw_addr) of an int8 tile of two heads (64-byte rows, the 64-byte
// swizzle: chunk c of row lr sits at c ^ ((lr / 2) % 4)) whose four boxes
// lie kSlotBytes apart from `base`.
template <int W, int kSlotBytes>
__device__ __forceinline__ uint32_t sw8_slot_addr(uint32_t base, int r,
                                                  int c) {
  constexpr int kRows = SwTile<W>::kBoxRows;
  const int lr = r % kRows;
  return base + (r / kRows) * kSlotBytes + lr * 64 +
         ((c ^ ((lr >> 1) & 3)) << 4);
}

// One warp: query rows [r_base, r_base + 16 kR) of head hh of a task
// against all kN keys; writes bf16 ctx over the same rows and head of the
// q tile (K4) or, with kOut8, the int8 context in K5's ctx8 boxes (64-byte
// rows, one box a q slot) over the q tile once every warp of the group
// (named barrier `bar`) has read its q rows (K5 in bf16 scores). tab: the
// head's ((2W-1)^2) bias table in the exp2 domain; wrap: the quarter-index
// bits (2: row, 1: column) whose difference puts two tokens of this window
// in different shift-mask regions (0 unshifted; kMasked: wrap != 0,
// decided once a task).
template <int W, bool kMasked, bool kOut8 = false>
__device__ __forceinline__ void sw_attend(uint32_t qs, uint32_t ks,
                                          uint32_t vs, const float* tab,
                                          const int* pos_s, int r_base,
                                          int hh, int wrap, int lane,
                                          int bar = 0) {
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
            const float p = exp2_ftz(fminf(v, 100.f));
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
  if constexpr (kOut8) named_sync(bar, T::kGroupThreads);
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
        if constexpr (kOut8)
          st_shared_u16(sw8_slot_addr<W, T::kSlot>(qs, r, 2 * hh + (jn >> 1)) +
                            (jn & 1) * 8 + 2 * t,
                        pack_i8x2(round_clip_i8(o[i][jn][2 * hi] / li),
                                  round_clip_i8(o[i][jn][2 * hi + 1] / li)));
        else
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
// 1) boxes (kOut8, K5 in bf16 scores: ctx8 int8, tm_ctx in K5's boxes of
// 64 bytes with the 64-byte swizzle; H even); table ((2W-1)^2, H) f32,
// natural-log domain. Task = pair *
// n_windows + window, pair = heads 2 pair, 2 pair + 1; CTA c takes the
// `chunk` tasks from c * chunk on (so its pair, and with it the bias
// tables, seldom changes), its i-th task going to consumer group i %
// kGroups. The ring needs no producer warp: thread 0 fills it, and the
// group that has stored a task's ctx from a stage reloads the stage with
// the task kStages on.
template <int W, bool kOut8 = false>
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
      sw_attend<W, true, kOut8>(qs, qs + T::kTensor, qs + 2 * T::kTensor,
                                tab_h, pos_s, r_base, hh, wrap, lane, 1 + grp);
    } else {
      sw_attend<W, false, kOut8>(qs, qs + T::kTensor, qs + 2 * T::kTensor,
                                 tab_h, pos_s, r_base, hh, 0, lane, 1 + grp);
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

// K4's attention launch, or with kOut8 K5's in bf16 scores (ctx the
// int8 ctx8)
template <int W, bool kOut8 = false>
cudaError_t launch_swin_attn(const bf16* qkv, void* ctx, const float* table,
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
  const cuuint64_t s1[3] = {(cuuint64_t)C, (cuuint64_t)S * C,
                            (cuuint64_t)S * S * C};
  if (!make_tmap(&tq, qkv, 4, dq, sq, box) ||
      !(kOut8 ? make_tmap_of(&tc, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                             CU_TENSOR_MAP_SWIZZLE_64B, ctx, 4, dc, s1, box)
              : make_tmap(&tc, ctx, 4, dc, sc, box)))
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
  swin_attn_tma_kernel<W, kOut8><<<(n_tasks + chunk - 1) / chunk,
                                   T::kThreads, T::kSmem, s>>>(
      tq, tc, table, C, H, S, shift, n_windows, n_tasks, chunk);
  return cudaGetLastError();
}

// ---------------------------------------- K5's int8-score attention --

// Shared memory of swin_attn8_tma_kernel at window side W, on K4's thread
// geometry and ring depth (SwTile<W>): a task's q8 and k8 are four boxes
// each of two heads' int8 rows (64 bytes, the 64-byte swizzle), its v four
// of K4's bf16 boxes (two heads, 128 bytes, the 128-byte swizzle).
template <int W>
struct SwTile8 {
  using G = SwTile<W>;
  static constexpr int kQSlot = (G::kBoxRows * 64 + 1023) / 1024 * 1024;
  static constexpr int kQ = 4 * kQSlot;  // q8 or k8 of a task
  static constexpr int kStageBytes = 2 * kQ + 4 * G::kSlot;
  static constexpr int kTx = 4 * G::kBoxRows * (64 + 64 + 128);
  static constexpr int kSmem = G::kStages * kStageBytes +
                               G::kGroups * 2 * G::kT * G::kT * 4 +
                               G::kN * 4 + G::kStages * 8 + 1024;
};

// Shared-memory address of chunk c (16 bytes: chunk 2 hh + j holds dims
// 16 j .. 16 j + 15 of head hh of the pair) of token r (box-major, as
// sw_addr) of a q8 or k8 tile at `base`, through the 64-byte swizzle
// (16-byte chunk c of a 64-byte row lr sits at c ^ ((lr / 2) % 4)).
template <int W>
__device__ __forceinline__ uint32_t sw8_addr(uint32_t base, int r, int c) {
  constexpr int kRows = SwTile<W>::kBoxRows;
  const int lr = r % kRows;
  return base + (r / kRows) * SwTile8<W>::kQSlot + lr * 64 +
         ((c ^ ((lr >> 1) & 3)) << 4);
}

// One warp of K5: query rows [r_base, r_base + 16 kR) of head hh of a
// task against all kN keys, as sw_attend but with int8 q and k: the
// scores are exact int32 sums of one mma.sync m16n8k32 a 16 x 8 tile (dh
// = 32, one k step; ldmatrix reads a 16 x 32 int8 tile as a 16 x 16 tile
// of b16), dequantised by the rounded product si * cs2, then bias [+ mask]
// added in the exp2 domain in f32, rounding as the plain version does;
// p = 2^min(s, 100) rounded to bf16 for P V; the context, divided by the
// f32 row sum, is rounded once to int8 over the same rows and head of the
// q8 tile.
template <int W, bool kMasked>
__device__ __forceinline__ void sw8_attend(uint32_t qs, uint32_t ks,
                                           uint32_t vs, const float* tab,
                                           const int* pos_s, int r_base,
                                           int hh, int wrap, float cs2,
                                           int lane) {
  using T = SwTile<W>;
  constexpr int R = T::kR;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int base = (W - 1) * (T::kT + 1);
  uint32_t qa[R][4];
  int pos[R][2], box[R][2];  // of this lane's query rows 16 i + g (+ 8)
  float o[R][4][4];
  float l[R][2];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    ldmatrix_x4<false>(qa[i], sw8_addr<W>(qs, r_base + 16 * i + (lane & 15),
                                          2 * hh + (lane >> 4)));
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
    // K8 of the 16 keys (kb[0..1]: keys k0 .. k0 + 7, kb[2..3]: the next
    // 8), V by ldmatrix.trans, and the keys' positions and quarters
    uint32_t kb[4], vb[2][4];
    int kpos[2][2], kbox[2][2];  // key k0 + 8 j + 2 t + c
    ldmatrix_x4<false>(kb, sw8_addr<W>(ks, k0 + (lane & 7) + ((lane >> 4) << 3),
                                       2 * hh + ((lane >> 3) & 1)));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ldmatrix_x4<true>(vb[j], sw_addr<W>(vs, k0 + (lane & 7) + (lane & 8),
                                          4 * hh + 2 * j + (lane >> 4)));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t + c;
        kpos[j][c] = pos_s[key];
        kbox[j][c] = key / T::kBoxRows;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int si[2][4];
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) si[j][e] = 0;
        mma_s8(si[j], qa[i], kb[2 * j], kb[2 * j + 1]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            float v = __fadd_rn(__fmul_rn((float)si[j][2 * hi + c], cs2),
                                tab[pos[i][hi] - kpos[j][c]]);
            if (kMasked && ((box[i][hi] ^ kbox[j][c]) & wrap))
              v = __fadd_rn(v, kMaskL2);
            const float p = exp2_ftz(fminf(v, 100.f));
            l[i][hi] += p;
            s[j][2 * hi + c] = p;
          }
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
        st_shared_u16(sw8_addr<W>(qs, r, 2 * hh + (jn >> 1)) + (jn & 1) * 8 +
                          2 * t,
                      pack_i8x2(round_clip_i8(o[i][jn][2 * hi] / li),
                                round_clip_i8(o[i][jn][2 * hi + 1] / li)));
    }
}

// One warp of K5 in int8 P.V: sw8_attend's rows, scores, bias and mask,
// in two passes over the keys. Pass 1 takes each row's max of s = si cs2
// + bias [+ mask] over all kN keys (the four lanes of a row combined by
// quad shuffles); pass 2 forms p = 2^(s - max) <= 1, sums it in f32 (z),
// rounds it to 127ths and multiplies it by the int8 v exactly, by
// mma.sync m16n8k32 per 32 keys (kN = 144 is 4.5 of them: the missing
// half is P = 0). As in K2's: the P fragment keeps the score registers'
// keys (8 j + 2 t + c of a 16-key slice in k slots 4 t + 2 j + c, the
// step's second slice 16 slots on), each lane gathers the same keys of its
// v column byte by byte from the v8 boxes `v8` (q8's layout) into its B
// fragment, and the sum is exact in any order. The context ci (cpv / z)
// is rounded once to int8 over the same rows and head of the q8 tile.
template <int W, bool kMasked>
__device__ __forceinline__ void sw8pv_attend(uint32_t qs, uint32_t ks,
                                             const unsigned char* v8,
                                             const float* tab,
                                             const int* pos_s, int r_base,
                                             int hh, int wrap, float cs2,
                                             float cpv, int lane) {
  using T = SwTile<W>;
  using T8 = SwTile8<W>;
  constexpr int R = T::kR;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int base = (W - 1) * (T::kT + 1);
  uint32_t qa[R][4];
  int pos[R][2], box[R][2];  // of this lane's query rows 16 i + g (+ 8)
  float mx[R][2], z[R][2];
  int o[R][4][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    ldmatrix_x4<false>(qa[i], sw8_addr<W>(qs, r_base + 16 * i + (lane & 15),
                                          2 * hh + (lane >> 4)));
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = r_base + 16 * i + g + 8 * hi;
      pos[i][hi] = pos_s[r] + base;
      box[i][hi] = r / T::kBoxRows;
      mx[i][hi] = -INFINITY;
      z[i][hi] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0;
  }
  // s of key 8 j + 2 t + c of the slice whose K8 fragment is kb, for query
  // tile i, as sw8_attend rounds it
  auto scores = [&](float (&sv)[2][4], const uint32_t (&kb)[4],
                    const int (&kpos)[2][2], const int (&kbox)[2][2],
                    int i) {
    int si[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) si[j][e] = 0;
      mma_s8(si[j], qa[i], kb[2 * j], kb[2 * j + 1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float v = __fadd_rn(__fmul_rn((float)si[j][2 * hi + c], cs2),
                              tab[pos[i][hi] - kpos[j][c]]);
          const bool other_region = (box[i][hi] ^ kbox[j][c]) & wrap;
          if (kMasked && other_region) v = __fadd_rn(v, kMaskL2);
          sv[j][2 * hi + c] = v;
        }
  };
  // K8 of the 16 keys from k0 (kb[0..1]: keys k0 .. k0 + 7, kb[2..3]: the
  // next 8) and the keys' positions and quarters
  auto keys = [&](uint32_t (&kb)[4], int (&kpos)[2][2], int (&kbox)[2][2],
                  int k0) {
    ldmatrix_x4<false>(kb, sw8_addr<W>(ks, k0 + (lane & 7) +
                                               ((lane >> 4) << 3),
                                       2 * hh + ((lane >> 3) & 1)));
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t + c;
        kpos[j][c] = pos_s[key];
        kbox[j][c] = key / T::kBoxRows;
      }
  };

#pragma unroll 1
  for (int k0 = 0; k0 < T::kN; k0 += 16) {
    uint32_t kb[4];
    int kpos[2][2], kbox[2][2];
    keys(kb, kpos, kbox, k0);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float sv[2][4];
      scores(sv, kb, kpos, kbox, i);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[i][e >> 1] = fmaxf(mx[i][e >> 1], sv[j][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[i][hi] =
          fmaxf(mx[i][hi], __shfl_xor_sync(0xffffffffu, mx[i][hi], 1));
      mx[i][hi] =
          fmaxf(mx[i][hi], __shfl_xor_sync(0xffffffffu, mx[i][hi], 2));
    }

#pragma unroll 1
  for (int k0 = 0; k0 < T::kN; k0 += 32) {
    const bool two = k0 + 16 < T::kN;  // the step's second 16-key slice
    uint32_t kb[2][4];
    int kpos[2][2][2], kbox[2][2][2];
    keys(kb[0], kpos[0], kbox[0], k0);
    if (two) keys(kb[1], kpos[1], kbox[1], k0 + 16);
    // v8 column d = 8 nt + g of head hh for the step's keys, in the P
    // fragment's order: key k0 + 16 r + 8 j + 2 t + c in byte 2 j + c
    uint32_t vb[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = 8 * nt + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t w = 0u;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = k0 + 16 * r + 8 * j + 2 * t + c;
            if (key < T::kN) {
              const int lr = key % T::kBoxRows;
              const int ch = 2 * hh + (d >> 4);
              w |= (uint32_t)v8[(key / T::kBoxRows) * T8::kQSlot + lr * 64 +
                                ((ch ^ ((lr >> 1) & 3)) << 4) + (d & 15)]
                   << (8 * (2 * j + c));
            }
          }
        vb[nt][r] = w;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      uint32_t pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 1 && !two) break;
        float sv[2][4];
        scores(sv, kb[r], kpos[r], kbox[r], i);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2_ftz(sv[j][e] - mx[i][e >> 1]);
            z[i][e >> 1] += p;
            pa[2 * r + (e >> 1)] |= (uint32_t)(int)rintf(p * 127.f)
                                    << (8 * (2 * j + (e & 1)));
          }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_s8(o[i][nt], pa, vb[nt][0], vb[nt][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float& zi = z[i][hi];
      zi += __shfl_xor_sync(0xffffffffu, zi, 1);
      zi += __shfl_xor_sync(0xffffffffu, zi, 2);
      const float rz = __fdiv_rn(cpv, zi);
      const int r = r_base + 16 * i + g + 8 * hi;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        st_shared_u16(
            sw8_addr<W>(qs, r, 2 * hh + (jn >> 1)) + (jn & 1) * 8 + 2 * t,
            pack_i8x2(round_clip_i8(__fmul_rn((float)o[i][jn][2 * hi], rz)),
                      round_clip_i8(
                          __fmul_rn((float)o[i][jn][2 * hi + 1], rz))));
    }
}

// Loads task `task`'s q8, k8 (from qk8) and v into stage `st`, counted on
// `bar`; with kPv8 (int8 P.V) q8, k8 and v8 from qkv8, v8 in q8's boxes.
template <int W, bool kPv8 = false>
__device__ __forceinline__ void sw8_load_task(unsigned char* st, uint64_t* bar,
                                              const CUtensorMap* tm_qk,
                                              const CUtensorMap* tm_v,
                                              int task, int n_windows, int C,
                                              int S, int shift) {
  using T8 = SwTile8<W>;
  const int nw = S / W;
  const int pair = task / n_windows;
  const int win = task % n_windows;
  const int img = win / (nw * nw);
  const int wy = (win / nw) % nw;
  const int wx = win % nw;
  mbar_expect_tx(bar, kPv8 ? 4 * SwTile<W>::kBoxRows * 3 * 64 : T8::kTx);
  for (int box = 0; box < 4; ++box) {
    const int2 at = sw_box_origin<W>(wx, wy, box, S, shift);
    tma_load_4d(st + box * T8::kQSlot, tm_qk, bar, 64 * pair, at.x, at.y,
                img);
    tma_load_4d(st + T8::kQ + box * T8::kQSlot, tm_qk, bar, C + 64 * pair,
                at.x, at.y, img);
    if (kPv8)
      tma_load_4d(st + 2 * T8::kQ + box * T8::kQSlot, tm_qk, bar,
                  2 * C + 64 * pair, at.x, at.y, img);
    else
      tma_load_4d(st + 2 * T8::kQ + box * SwTile<W>::kSlot, tm_v, bar,
                  64 * pair, at.x, at.y, img);
  }
}

// ctx8 (B*S*S, C) int8 from qk8 (B*S*S, 2C) int8 and v (B*S*S, C) bf16:
// tm_qk maps qk8 as (2C, S, S, B) and tm_ctx ctx8 as (C, S, S, B) in (64,
// W/2, W/2, 1) boxes of bytes with the 64-byte swizzle, tm_v v as (C, S,
// S, B) in K4's bf16 boxes; H even. With kPv8 (int8 P.V) tm_qk maps qkv8
// (B*S*S, 3C) int8 as (3C, S, S, B) and tm_v is unused. The task walk,
// ring and consumer groups are swin_attn_tma_kernel's.
template <int W, bool kPv8 = false>
__global__ void __launch_bounds__(SwTile<W>::kThreads, 1)
swin_attn8_tma_kernel(const __grid_constant__ CUtensorMap tm_qk,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_ctx,
                      const float* __restrict__ table, int C, int H, int S,
                      int shift, float cs2, float cpv, int n_windows,
                      int n_tasks, int chunk) {
  using T = SwTile<W>;
  using T8 = SwTile8<W>;
  constexpr int kTab = 2 * T::kT * T::kT;  // floats of a pair's tables
  extern __shared__ unsigned char sw_smem[];
  unsigned char* ring = align1024(sw_smem);
  float* tab_s =
      reinterpret_cast<float*>(ring + T::kStages * T8::kStageBytes);
  int* pos_s = reinterpret_cast<int*>(tab_s + T::kGroups * kTab);
  uint64_t* full = reinterpret_cast<uint64_t*>(pos_s + T::kN);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int nw = S / W;
  const int first = blockIdx.x * chunk;
  const int count = min(chunk, n_tasks - first);

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
      sw8_load_task<W, kPv8>(ring + i * T8::kStageBytes, full + i, &tm_qk,
                             &tm_v, first + i, n_windows, C, S, shift);
  }
  __syncthreads();

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
      for (int k = gtid; k < kTab; k += T::kGroupThreads)
        tab[k] = table[(k % (T::kT * T::kT)) * H + 2 * pair +
                       k / (T::kT * T::kT)] * kLog2e;
      named_sync(1 + grp, T::kGroupThreads);
      pair_loaded = pair;
    }
    mbar_wait(full + s, (i / T::kStages) & 1);
    unsigned char* st = ring + s * T8::kStageBytes;
    const uint32_t qs = smem_u32(st);
    const int wrap =
        shift ? (wy == nw - 1 ? 2 : 0) | (wx == nw - 1 ? 1 : 0) : 0;
    const float* tab_h = tab + hh * T::kT * T::kT;
    if (kPv8 && wrap)
      sw8pv_attend<W, true>(qs, qs + T8::kQ, st + 2 * T8::kQ, tab_h, pos_s,
                            r_base, hh, wrap, cs2, cpv, lane);
    else if (kPv8)
      sw8pv_attend<W, false>(qs, qs + T8::kQ, st + 2 * T8::kQ, tab_h, pos_s,
                             r_base, hh, 0, cs2, cpv, lane);
    else if (wrap)
      sw8_attend<W, true>(qs, qs + T8::kQ, qs + 2 * T8::kQ, tab_h, pos_s,
                          r_base, hh, wrap, cs2, lane);
    else
      sw8_attend<W, false>(qs, qs + T8::kQ, qs + 2 * T8::kQ, tab_h, pos_s,
                           r_base, hh, 0, cs2, lane);
    fence_proxy_async();
    named_sync(1 + grp, T::kGroupThreads);
    if (gtid == 0) {
      // ctx8 by TMA from the q8 slots; once the stores have read the
      // stage it takes the task kStages on
      for (int box = 0; box < 4; ++box) {
        const int2 to = sw_box_origin<W>(wx, wy, box, S, shift);
        tma_store_4d(&tm_ctx, st + box * T8::kQSlot, 64 * pair, to.x, to.y,
                     img);
      }
      bulk_commit();
      bulk_wait_read();
      if (i + T::kStages < count)
        sw8_load_task<W, kPv8>(st, full + s, &tm_qk, &tm_v,
                               task + T::kStages, n_windows, C, S, shift);
    }
  }
}

// K5's attention launch in int8 scores, or with kPv8 in int8 P.V (qk8 the
// qkv8 (B*S*S, 3C), v unused)
template <int W, bool kPv8 = false>
cudaError_t launch_swin_attn8(const int8_t* qk8, const bf16* v, int8_t* ctx8,
                              const float* table, int B, int S, int C, int H,
                              int shift, float cs2, float cpv,
                              cudaStream_t s) {
  using T = SwTile<W>;
  CUtensorMap tq, tv{}, tc;
  const int cq = kPv8 ? 3 * C : 2 * C;  // columns of qk8 or qkv8
  const cuuint32_t box[4] = {64, T::kH, T::kH, 1};
  const cuuint64_t dq[4] = {(cuuint64_t)cq, (cuuint64_t)S, (cuuint64_t)S,
                            (cuuint64_t)B};
  const cuuint64_t dc[4] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)S,
                            (cuuint64_t)B};
  // 2C bytes a row of qk8 and of v (3C of qkv8), C of ctx8
  const cuuint64_t s2[3] = {(cuuint64_t)2 * C, (cuuint64_t)S * 2 * C,
                            (cuuint64_t)S * S * 2 * C};
  const cuuint64_t sq[3] = {(cuuint64_t)cq, (cuuint64_t)S * cq,
                            (cuuint64_t)S * S * cq};
  const cuuint64_t s1[3] = {(cuuint64_t)C, (cuuint64_t)S * C,
                            (cuuint64_t)S * S * C};
  if (!make_tmap_of(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                    CU_TENSOR_MAP_SWIZZLE_64B, qk8, 4, dq, sq, box) ||
      (!kPv8 && !make_tmap(&tv, v, 4, dc, s2, box)) ||
      !make_tmap_of(&tc, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                    CU_TENSOR_MAP_SWIZZLE_64B, ctx8, 4, dc, s1, box))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const int n_windows = B * (S / W) * (S / W);
  const int n_tasks = n_windows * (H / 2);
  const int chunk = (n_tasks + sms - 1) / sms;
  swin_attn8_tma_kernel<W, kPv8><<<(n_tasks + chunk - 1) / chunk,
                                   T::kThreads, SwTile8<W>::kSmem, s>>>(
      tq, tv, tc, table, C, H, S, shift, cs2, cpv, n_windows, n_tasks,
      chunk);
  return cudaGetLastError();
}

// What K4 and K5 take: C = 32 H up to 1024 (the LayerNorms hold a row in
// a warp's registers or a warp's staging), windows of N = win^2 tokens
// with N a multiple of 16 up to SW_MAX_N, a square stage of whole windows,
// and a shift of 0 or win / 2 (Swin's own: a quarter of a window is one
// TMA box). K5 also takes only even H (C % 64 == 0): its q8 and k8 boxes
// are head pairs of 64 bytes, and its QKV GEMM's 128-column tiles end
// where qk8 ends.
bool k4_shapes_ok(int B, int S, int C, int H, int win, int shift) {
  const int n = win * win;
  return B > 0 && H > 0 && C == H * SW_DH && C <= HG_MAX_DIM && win > 0 &&
         n % 16 == 0 && n <= SW_MAX_N && S > 0 && S % win == 0 &&
         (shift == 0 || 2 * shift == win) &&
         ((long long)B * S * S + HG_BM - 1) / HG_BM <= 65535;
}

bool k5_shapes_ok(int B, int S, int C, int H, int win, int shift) {
  return k4_shapes_ok(B, S, C, H, win, shift) && C % 64 == 0;
}


// The dynamic shared-memory limits of the window attentions at window W:
// K4's, K5's in bf16 scores (K4's kernel with the int8 context) and K5's
// in int8 scores and in int8 P.V.
template <int W>
cudaError_t allow_swin_attn_smem() {
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(swin_attn_tma_kernel<W>, a,
                                SwTile<W>::kSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(swin_attn_tma_kernel<W, true>, a,
                                SwTile<W>::kSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(swin_attn8_tma_kernel<W>, a,
                                SwTile8<W>::kSmem)) != cudaSuccess)
    return e;
  return cudaFuncSetAttribute(swin_attn8_tma_kernel<W, true>, a,
                              SwTile8<W>::kSmem);
}

// K5's launch of its window attention in `mode` at window W
template <int W>
cudaError_t launch_k5_attention(int mode, const void* qk, const bf16* v,
                                int8_t* ctx8, const float* table, int B,
                                int S, int C, int H, int shift, float cs2,
                                float cpv, cudaStream_t s) {
  const int8_t* qk8 = static_cast<const int8_t*>(qk);
  return mode == 0 ? launch_swin_attn8<W>(qk8, v, ctx8, table, B, S, C, H,
                                          shift, cs2, cpv, s)
         : mode == 1
             ? launch_swin_attn8<W, true>(qk8, v, ctx8, table, B, S, C, H,
                                          shift, cs2, cpv, s)
             : launch_swin_attn<W, true>(static_cast<const bf16*>(qk), ctx8,
                                         table, B, S, C, H, shift, s);
}

}  // namespace

// Raises the kernels' dynamic shared-memory limits on the current device
// and finds the CUDA driver's tensor-map encoder. Called once per device
// before the first launch; returns a cudaError_t.
extern "C" int geovpr_swin_init(void) {
  cudaError_t e;
  if (tmap_encode_fn() == nullptr) return (int)cudaErrorSymbolNotFound;
  if ((e = allow_gemm_smem<HG_EPI_QKV>()) != cudaSuccess ||
      (e = allow_gemm_smem<HG_EPI_RESID>()) != cudaSuccess ||
      (e = allow_gemm_s8_smem<HS_EPI_QK8V>()) != cudaSuccess ||
      (e = allow_gemm_s8_smem<HS_EPI_QKV16>()) != cudaSuccess ||
      (e = allow_gemm_s8_smem<HS_EPI_RESID>()) != cudaSuccess ||
      (e = allow_gemm_s8_smem<HS_EPI_RESID, float>()) != cudaSuccess ||
      (e = allow_swin_attn_smem<4>()) != cudaSuccess ||
      (e = allow_swin_attn_smem<8>()) != cudaSuccess ||
      (e = allow_swin_attn_smem<12>()) != cudaSuccess)
    return (int)e;
  return (int)allow_swin_attn_smem<16>();
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

namespace {

// K5's launches first..last on a stream of type T (bf16 or f32), the
// arguments of geovpr_swin_attn_int8_parts
template <typename T>
int swin_attn_int8_parts(const void* x, const void* ln_scale,
                         const void* ln_bias, const void* wqkv_t,
                         const void* sqkv, const void* bqkv, const void* wo_t,
                         const void* so, const void* bo, const void* table,
                         void* qk, void* v, void* ctx8, void* out, int B,
                         int S, int C, int H, int win, int shift, float eps,
                         float cs2, int mode, float qscale, float cpv,
                         int first, int last, void* stream) {
  if (!k5_shapes_ok(B, S, C, H, win, shift) || mode < 0 || mode > 2 ||
      first < 0 || last > 3 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* vb = static_cast<const bf16*>(v);
  int8_t* c8 = static_cast<int8_t*>(ctx8);
  const float* tab = static_cast<const float*>(table);
  const HsEpilogue qkv_ep{static_cast<const float*>(sqkv),
                          static_cast<const float*>(bqkv),
                          nullptr,
                          nullptr,
                          0.f,
                          mode == 0 ? 2 * C : mode == 1 ? 3 * C : C,
                          qscale};
  cudaError_t e;
  for (int part = first; part <= last; ++part) {
    switch (part) {
      case 0:
        e = launch_ln_quant(static_cast<const T*>(x),
                            static_cast<const float*>(ln_scale),
                            static_cast<const float*>(ln_bias), c8, M, C, eps,
                            s);
        break;
      case 1:
        e = mode == 2 ? launch_gemm_s8<HS_EPI_QKV16>(
                            c8, static_cast<const int8_t*>(wqkv_t), M, C,
                            3 * C, qkv_ep, nullptr, qk, s)
                      : launch_gemm_s8<HS_EPI_QK8V>(
                            c8, static_cast<const int8_t*>(wqkv_t), M, C,
                            3 * C, qkv_ep, static_cast<int8_t*>(qk), v, s);
        break;
      case 2:
        e = win == 4    ? launch_k5_attention<4>(mode, qk, vb, c8, tab, B, S,
                                                 C, H, shift, cs2, cpv, s)
            : win == 8  ? launch_k5_attention<8>(mode, qk, vb, c8, tab, B, S,
                                                 C, H, shift, cs2, cpv, s)
            : win == 12 ? launch_k5_attention<12>(mode, qk, vb, c8, tab, B, S,
                                                  C, H, shift, cs2, cpv, s)
                        : launch_k5_attention<16>(mode, qk, vb, c8, tab, B, S,
                                                  C, H, shift, cs2, cpv, s);
        break;
      default:
        e = launch_gemm_s8<HS_EPI_RESID, T>(
            c8, static_cast<const int8_t*>(wo_t), M, C, C,
            HsEpilogue{static_cast<const float*>(so),
                       static_cast<const float*>(bo), nullptr, x, 0.f, 0},
            nullptr, out, s);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// K5's launches first..last (0 LN-quant, 1 QKV GEMM, 2 window attention, 3
// out projection) in attention mode `mode` (0 int8 scores, 1 int8 P.V, 2
// bf16 scores) and the form of the stream's type (f32 0: bf16 x and out;
// 1: f32, the scratch and the middle launches the bf16 form's); returns a
// cudaError_t as int. x and out (B*S*S, C); wqkv_t (3C, C) and wo_t (C, C)
// int8, k-contiguous; ln_scale, ln_bias (1/a_x folded in), sqkv, bqkv, so,
// bo and the table f32; all 16-byte aligned. Scratch: qk and v as the QKV
// launch writes them (int8 scores: qk8 (B*S*S, 2C) int8 and v (B*S*S, C)
// bf16; int8 P.V: qkv8 (B*S*S, 3C) int8; bf16 scores: qkv (B*S*S, 3C)
// bf16; v unused in the last two), ctx8 (B*S*S, C) int8 (the LN-quant
// output until the attention writes ctx8). cs2 = a_q a_k dh^-0.5 log2(e)
// (int8 scores and P.V); qscale = dh^-0.5 log2(e) (bf16 scores); cpv = a_v
// / (127 a_ctx) (int8 P.V). A launch alone reads what the earlier launches
// of an earlier call left in the scratch; the whole half-block is parts
// 0..3. geovpr_swin_init must have run on the current device.
extern "C" int geovpr_swin_attn_int8_parts(
    const void* x, const void* ln_scale, const void* ln_bias,
    const void* wqkv_t, const void* sqkv, const void* bqkv, const void* wo_t,
    const void* so, const void* bo, const void* table, void* qk, void* v,
    void* ctx8, void* out, int B, int S, int C, int H, int win, int shift,
    float eps, float cs2, int mode, float qscale, float cpv, int f32,
    int first, int last, void* stream) {
  return (f32 ? swin_attn_int8_parts<float> : swin_attn_int8_parts<bf16>)(
      x, ln_scale, ln_bias, wqkv_t, sqkv, bqkv, wo_t, so, bo, table, qk, v,
      ctx8, out, B, S, C, H, win, shift, eps, cs2, mode, qscale, cpv, first,
      last, stream);
}
