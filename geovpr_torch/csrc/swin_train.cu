// The Swin attention half-block's training forward and backward for Hopper
// (sm_90a), on the raster token stream of one stage, (B, S*S, C):
//
//   K9a (forward):   y = W-MSA(LN(x)) @ Wo + bo        (no residual)
//                    saving qkv (post-bias, unscaled), ctx and the
//                    normalised probabilities p
//   K9b (core bwd):  dqkv, dbias from qkv, p and da = dL/dctx
//   K9c (all bwd):   da = g Wo^T, dWo, dbo, the core, the LN recompute,
//                    dWqkv, dbqkv, dh = dqkv Wqkv^T, the LN VJP -> dx, dls, dlb
//
// Replaces geovpr/ops/pallas_swin_block.py::_swin_train_fwd_pallas
// (_train_kernel), _swin_attn_bwd_pallas (_train_bwd_kernel) and
// _swin_attn_bwd_all_pallas (_train_bwd_all_kernel), and covers the rolled
// entries (_train_kernel_rolled, roll_relayout): the stream stays in raster
// order and every kernel that touches windows reads a window as its four
// quarters, each a TMA box at its own (wrapped) raster origin
// (swin_window.cuh, as K4 in swin_attn.cu), so the partition, the cyclic
// shift and its inverse for dx are addressing, not copies. A window's
// tokens are taken in window order (r = ry w + rx, JAX's), whatever the
// box-major order they land in shared memory: ldmatrix takes a row address
// per lane, so each sum runs over the same terms in the same order as the
// first version, and p keeps its (BW, H, N, N) layout.
//
// Numerics follow the JAX bodies. K9a: LN in f32; qkv in f32 stored as bf16
// unscaled, q scaled by dh^-0.5 log2(e) from the f32 value and rounded to
// bf16 on a separate copy; bias and mask in the exp2 domain; p =
// exp2f(min(s, 100)) with no max-shift (exp2f, not the SFU's ex2.approx:
// a masked key's p can be a bf16 subnormal, and the stored p feeds ds and
// the table's gradient), normalised by the reciprocal of its f32 row sum,
// stored as bf16 and used in bf16 (never fp16: p reaches 2^100 before the
// normalisation) for P.V. K9b/K9c: dp = da v^T, ds = p (dp - sum(dp p)) in
// f32, dbias += ds, ds * dh^-0.5 rounded to bf16 before dq = ds k and dk =
// ds^T q, dv = p^T da, all stored bf16; the mask gets no gradient. K9c also
// rounds da, the recomputed LN output and dh to bf16 where JAX does, and
// accumulates every weight gradient in f32 over all rows.
//
// Cross-CTA sums (dbias, the weight and bias gradients, dls, dlb) are
// deterministic: each CTA writes a partial sum of its own and one
// reduce_partials launch adds the partials in a fixed order; no atomics.
// Every sum keeps the first version's terms and order (its row chunks, its
// k16 steps, each thread's walk and the quad sums), so the outputs keep
// its bits where the card's wgmma and mma.sync round a k16 product alike.
//
// K9a, four launches (`geovpr_swin_train_fwd_parts` runs a range of them,
// for timing one by one); the bounds at Swin-B-384 stage 0, B=16 (M =
// 147,456 rows, C 128, H 4; 3.35 TB/s, 989 TFLOP/s):
//   0. ln_stats_kernel (train_gemm.cuh, K9c's LN recompute, here without
//      the row statistics): bf16 LN(x) into the ctx buffer, a warp a row,
//      lane l summing columns l, l + 32, ... (the first version's order of
//      sums, so its bits); bytes, 0.023 ms;
//   1. hopper_gemm_kernel<EPI_QKV2> (hopper_gemm.cuh's persistent TMA +
//      wgmma GEMM): qkv = LN(x) Wqkv + bqkv, and on the q tiles also
//      (acc + b) qscale into qs, both rounded once; bytes, 0.056 ms;
//   2. swin_train_attn_kernel (below): qs, qkv -> ctx, p; bytes (p alone
//      is 170 MB), 0.096 ms;
//   3. hopper_gemm_kernel<EPI_QKV> with qcols 0: ctx Wo + bo -> y; bytes,
//      0.023 ms.
// Their sum, 0.20 ms, is what the split can reach; the fused bound is
// 0.118 ms (x, qkv, ctx, p, y once each).
//
// swin_train_attn_kernel is K4's swin_attn_tma_kernel (its task walk over
// (head pair, window) tasks, its ring of three stages of twelve quarter
// boxes counted on mbarriers and refilled by the group that stores a task,
// its two consumer groups of six warps, three 16-row query tiles a warp)
// with q from the scaled copy and JAX's training numerics: two passes over
// the keys, the row sums first, then p = exp2f(min(s, 100)) (1 / l)
// rounded to bf16, stored, and used for P.V. The scores are recomputed in
// the second pass (a warp's three tiles hold 216 scores a lane: no room to
// keep them; both give the same bits). Each key tile's 48 x 16 p block
// goes through a 1.5 KB staging area of the warp to 16-byte streaming
// stores, whole 32-byte sectors of the (BW, H, N, N) plane; ctx, already
// normalised, is written over the q slot and stored by TMA.
//
// The core backward (K9b, and K9c's launch 3), swin_core_bwd_kernel: one CTA
// of nine warps per (window group, head) walks windows blockIdx.x, blockIdx.x
// + gridDim.x, ... of head blockIdx.y, keeping its warps' rows of dbias in
// registers across them, and writes them as its partial
// dbias_part[blockIdx.x][h] at the end (core_groups(BW, H) groups: the first
// version's partials, and so its sums). Per window, a ring of two stages,
// counted on mbarriers, holds q, k, v (from qkv) and da as one-head quarter
// boxes (64 bytes wide, the 64-byte swizzle) and the 41 KB p plane (one bulk
// copy); thread 0 reloads a stage with the window two on once its outputs are
// stored, so the next window's 78 KB arrive during this window's math. Each
// warp takes 16 query rows: pass 1 sums dp p over the keys, pass 2 forms ds
// tile by tile (dbias += ds; ds_b = bf16(ds scale) to shared memory and, as
// the A operand, dq = ds_b k, k^T by ldmatrix.trans). After a barrier each
// warp takes 16 key rows: dk = ds_b^T q and dv = p^T da by mma.sync m16n8k16
// with both operands from ldmatrix.trans (N = 144 is not a whole number of
// wgmma's 64-row tiles), over the query rows in the first version's 16-row
// order; dq, dk, dv go to box-major tiles (the staging slot, the dead k and v
// slots) and out by TMA. What bounds it: bytes (qkv, da and p read, dqkv
// written: 434 MB, 0.130 ms at stage 0); its four N^2 dh products a window,
// over all windows, take 0.022 ms at the bf16 peak (the recomputed dp adds a
// fifth). One CTA an SM: its 220 KB of shared memory (two stages, the ds
// tile, the dq staging), and the registers, which no layout frees: each
// thread keeps 72 dbias sums across windows (168 registers x 288 threads; a
// second CTA or consumer group would need 96K of the SM's 64K).
//
// K9c's launches (`geovpr_swin_train_bwd_all_parts` runs a range of them,
// for timing one by one): 0 da, 1 dWo, 2 dbo, 3 the core, 4 the LN
// recompute, 5 dWqkv, 6 dbqkv, 7 dh, 8 the LN VJP. Its four products run
// on hopper_gemm.cuh's persistent TMA + wgmma GEMM: da = g Wo^T and dh =
// dqkv Wqkv^T read the (in, out) weights as the K-major B operand and round
// once to bf16; dWo = ctx^T g and dWqkv = h^T dqkv read both operands as
// boxes of rows (A MN-major), split the rows into the first version's
// chunks (train_gemm.cuh's split_rows over its 64 x 64 tiles) whose f32
// partials one reduce_partials launch adds in order. The column sums (dbo,
// dbqkv), the LN recompute and VJP are the first version's. The kernels
// allocate nothing; the caller passes the scratch.

#include "hopper_gemm.cuh"
#include "swin_window.cuh"
#include "train_gemm.cuh"
#include "window_attn.cuh"

namespace {

constexpr float kLog2eT = 1.4426950408889634f;
constexpr float kMaskL2T = -100.f * kLog2eT;
constexpr int TR_W = 12;              // the window side the kernels take
constexpr int TR_NT = 9;              // key / query tiles of 16: N = 144
constexpr int TR_N = TR_NT * 16;
constexpr int TR_PLD = TR_N + 8;      // bf16 row stride of ds in smem

// the quarter (box) of window-order token r: 2 its lower half, 1 its right
__device__ __forceinline__ int tr_quarter(int r) {
  return (r >= TR_N / 2 ? 2 : 0) | (r % TR_W >= TR_W / 2 ? 1 : 0);
}

// ------------------------------------------------------- K9a's attention --
using FT = SwTile<TR_W>;
constexpr int FA_WARPS = FT::kThreads / 32;
constexpr int FA_STG = FT::kR * 16 * 32;  // a warp's p block: 3 x 16 x 16 bf16
// the ring, each group's two bias tables, the tokens' bias positions and
// box-major rows, the warps' p staging, the barriers, align1024's slack
constexpr int FA_SMEM = FT::kStages * FT::kStageBytes +
                        FT::kGroups * 2 * FT::kT * FT::kT * 4 + 2 * TR_N * 4 +
                        FA_WARPS * FA_STG + FT::kStages * 8 + 1024;

// + bias [+ mask] in the exp2 domain, p = exp2f(min(s, 100)), rounding as
// the first version and the plain version
template <bool kMasked>
__device__ __forceinline__ float fa_prob(float s, float bias, bool masked) {
  float v = __fadd_rn(s, bias);
  if (kMasked && masked) v = __fadd_rn(v, kMaskL2T);
  return exp2f(fminf(v, 100.f));
}

// One warp: query rows [r_base, r_base + 48) (window order) of head hh of
// a task against all 144 keys. Pass 1 sums each row's p; pass 2 recomputes
// the scores, stores p = bf16(p (1 / l)) to pw (the head's N x N plane)
// through the warp's staging `stg`, and accumulates P V; ctx, normalised
// already, goes over the same rows and head of the q tile. tab: the head's
// bias table in the exp2 domain; wrap: the quarter bits whose difference
// masks a key (kMasked: wrap != 0).
template <bool kMasked>
__device__ __forceinline__ void fa_attend(uint32_t qs, uint32_t ks,
                                          uint32_t vs, const float* tab,
                                          const int* pos_s, const int* bm_s,
                                          int r_base, int hh, int wrap,
                                          uint32_t stg, bf16* pw, int lane) {
  constexpr int R = FT::kR;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int base = (TR_W - 1) * (FT::kT + 1);
  uint32_t qa[R][2][4];
  int pos[R][2], qd[R][2];  // of this lane's query rows 16 i + g (+ 8)
  float l[R][2];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldmatrix_x4<false>(qa[i][kk],
                         sw_addr<TR_W>(qs, bm_s[r_base + 16 * i + (lane & 15)],
                                       4 * hh + 2 * kk + (lane >> 4)));
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = r_base + 16 * i + g + 8 * hi;
      pos[i][hi] = pos_s[r] + base;
      qd[i][hi] = tr_quarter(r);
      l[i][hi] = 0.f;
    }
  }

  // pass 1: the row sums of p, each lane's keys in the first version's
  // order, then the quad's
#pragma unroll 1
  for (int k0 = 0; k0 < TR_N; k0 += 16) {
    uint32_t kb[2][4];
    int pk[2][2], qk[2][2];  // key k0 + 8 j + 2 t + c
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ldmatrix_x4<false>(kb[j], sw_addr<TR_W>(ks, bm_s[k0 + 8 * j + (lane & 7)],
                                              4 * hh + (lane >> 3)));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t + c;
        pk[j][c] = pos_s[key];
        qk[j][c] = tr_quarter(key);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        mma_bf16(s[j], qa[i][0], kb[j][0], kb[j][1]);
        mma_bf16(s[j], qa[i][1], kb[j][2], kb[j][3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            l[i][hi] += fa_prob<kMasked>(s[j][2 * hi + c],
                                         tab[pos[i][hi] - pk[j][c]],
                                         (qd[i][hi] ^ qk[j][c]) & wrap);
    }
  }
  float inv[R][2];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float li = l[i][hi];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      inv[i][hi] = 1.f / li;
    }

  // pass 2: p normalised, stored, and P V
  float o[R][4][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < TR_N; k0 += 16) {
    uint32_t kb[2][4], vb[2][4];
    int pk[2][2], qk[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ldmatrix_x4<false>(kb[j], sw_addr<TR_W>(ks, bm_s[k0 + 8 * j + (lane & 7)],
                                              4 * hh + (lane >> 3)));
      ldmatrix_x4<true>(vb[j],
                        sw_addr<TR_W>(vs, bm_s[k0 + (lane & 7) + (lane & 8)],
                                      4 * hh + 2 * j + (lane >> 4)));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t + c;
        pk[j][c] = pos_s[key];
        qk[j][c] = tr_quarter(key);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        mma_bf16(s[j], qa[i][0], kb[j][0], kb[j][1]);
        mma_bf16(s[j], qa[i][1], kb[j][2], kb[j][3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            s[j][2 * hi + c] =
                fa_prob<kMasked>(s[j][2 * hi + c], tab[pos[i][hi] - pk[j][c]],
                                 (qd[i][hi] ^ qk[j][c]) & wrap) *
                inv[i][hi];
      // P as the A operand (16 x 16 keys) of P V: pa[2 j + hi] holds row
      // g + 8 hi, keys 8 j + 2 t, + 1
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      // the 16 x 16 block into the staging, its two 16-byte halves of a
      // row swapped on rows 4-7 and 12-15 (no bank conflicts)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = g + 8 * hi;
          st_shared_u32(stg + i * 512 + row * 32 +
                            ((j ^ ((row >> 2) & 1)) << 4) + 4 * t,
                        pa[2 * j + hi]);
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma_bf16(o[i][2 * j], pa, vb[j][0], vb[j][1]);
        mma_bf16(o[i][2 * j + 1], pa, vb[j][2], vb[j][3]);
      }
    }
    __syncwarp();
    // the warp's 48 rows x 16 keys of p: 96 16-byte pieces, two to a row
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = lane >> 1;
      const int c = lane & 1;
      const uint4 v = ld_shared_v4(stg + u * 512 + row * 32 +
                                   ((c ^ ((row >> 2) & 1)) << 4));
      st_global_cs(pw + (size_t)(r_base + 16 * u + row) * TR_N + k0 + 8 * c,
                   v);
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = r_base + 16 * i + g + 8 * hi;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        st_shared_u32(sw_addr<TR_W>(qs, bm_s[r], 4 * hh + jn) + 4 * t,
                      pack_bf16(o[i][jn][2 * hi], o[i][jn][2 * hi + 1]));
    }
}

// Loads task `task`'s q (from the scaled copy), k and v (from qkv) into
// stage `st`, counted on `bar`: twelve two-head quarter boxes.
__device__ __forceinline__ void fa_load_task(unsigned char* st, uint64_t* bar,
                                             const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_kv,
                                             int task, int n_windows, int C,
                                             int S, int shift) {
  const int nw = S / TR_W;
  const int pair = task / n_windows;
  const int win = task % n_windows;
  const int img = win / (nw * nw);
  const int wy = (win / nw) % nw;
  const int wx = win % nw;
  mbar_expect_tx(bar, 12 * FT::kBoxBytes);
  for (int box = 0; box < 4; ++box) {
    const int2 at = sw_box_origin<TR_W>(wx, wy, box, S, shift);
    tma_load_4d(st + box * FT::kSlot, tm_q, bar, 64 * pair, at.x, at.y, img);
    tma_load_4d(st + FT::kTensor + box * FT::kSlot, tm_kv, bar,
                C + 64 * pair, at.x, at.y, img);
    tma_load_4d(st + 2 * FT::kTensor + box * FT::kSlot, tm_kv, bar,
                2 * C + 64 * pair, at.x, at.y, img);
  }
}

// ctx (B*S*S, C) and p (BW, H, N, N) from the scaled q copy qs (B*S*S, C)
// and qkv (B*S*S, 3C): tm_q and tm_ctx map qs and ctx as (C, S, S, B),
// tm_kv qkv as (3C, S, S, B), all in (64, 6, 6, 1) boxes; table ((2w-1)^2,
// H) f32, natural-log domain. The task walk (task = pair * n_windows +
// window; CTA c takes the `chunk` tasks from c * chunk on, its i-th task
// going to consumer group i % 2) and the ring are swin_attn_tma_kernel's.
__global__ void __launch_bounds__(FT::kThreads, 1)
swin_train_attn_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_kv,
                       const __grid_constant__ CUtensorMap tm_ctx,
                       bf16* __restrict__ p_out,
                       const float* __restrict__ table, int C, int H, int S,
                       int shift, int n_windows, int n_tasks, int chunk) {
  constexpr int kTab = 2 * FT::kT * FT::kT;  // floats of a pair's tables
  extern __shared__ unsigned char fa_smem[];
  unsigned char* ring = align1024(fa_smem);
  float* tab_s =
      reinterpret_cast<float*>(ring + FT::kStages * FT::kStageBytes);
  int* pos_s = reinterpret_cast<int*>(tab_s + FT::kGroups * kTab);
  int* bm_s = pos_s + TR_N;
  unsigned char* stg_s = reinterpret_cast<unsigned char*>(bm_s + TR_N);
  uint64_t* full = reinterpret_cast<uint64_t*>(stg_s + FA_WARPS * FA_STG);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int nw = S / TR_W;
  const int first = blockIdx.x * chunk;
  const int count = min(chunk, n_tasks - first);

  // each window-order token's position in the (2w-1)^2 bias grid and its
  // row in the box-major tiles
  for (int r = threadIdx.x; r < TR_N; r += FT::kThreads) {
    pos_s[r] = (r / TR_W) * FT::kT + r % TR_W;
    bm_s[r] = sw_box_major<TR_W>(r);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < FT::kStages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
    for (int i = 0; i < FT::kStages && i < count; ++i)
      fa_load_task(ring + i * FT::kStageBytes, full + i, &tm_q, &tm_kv,
                   first + i, n_windows, C, S, shift);
  }
  __syncthreads();

  // group grp takes the CTA's tasks grp, grp + kGroups, ...; its warp w
  // the query tiles 3 (w % 3) + 0..2 of head w / 3
  const int grp = warp / FT::kGroupWarps;
  const int gw = warp % FT::kGroupWarps;
  const int gtid = threadIdx.x % FT::kGroupThreads;
  const int hh = gw / (FT::kGroupWarps / 2);
  const int r_base = 16 * FT::kR * (gw % (FT::kGroupWarps / 2));
  const uint32_t stg = smem_u32(stg_s + warp * FA_STG);
  float* tab = tab_s + grp * kTab;
  int pair_loaded = -1;
  for (int i = grp; i < count; i += FT::kGroups) {
    const int task = first + i;
    const int s = i % FT::kStages;
    const int pair = task / n_windows;
    const int win = task % n_windows;
    const int img = win / (nw * nw);
    const int wy = (win / nw) % nw;
    const int wx = win % nw;
    if (pair != pair_loaded) {
      // the pair's bias tables, times log2(e); the group's previous task's
      // last barrier has retired every reader of the old ones
      for (int k = gtid; k < kTab; k += FT::kGroupThreads) {
        const int h = 2 * pair + k / (FT::kT * FT::kT);
        tab[k] = h < H ? table[(k % (FT::kT * FT::kT)) * H + h] * kLog2eT
                       : 0.f;
      }
      named_sync(1 + grp, FT::kGroupThreads);
      pair_loaded = pair;
    }
    mbar_wait(full + s, (i / FT::kStages) & 1);
    unsigned char* st = ring + s * FT::kStageBytes;
    const uint32_t qs = smem_u32(st);
    const int wrap =
        shift ? (wy == nw - 1 ? 2 : 0) | (wx == nw - 1 ? 1 : 0) : 0;
    const int h = 2 * pair + hh;
    const float* tab_h = tab + hh * FT::kT * FT::kT;
    bf16* pw = p_out + ((size_t)win * H + h) * TR_N * TR_N;
    if (h >= H) {
      // odd H: the last pair has one head
    } else if (wrap) {
      fa_attend<true>(qs, qs + FT::kTensor, qs + 2 * FT::kTensor, tab_h,
                      pos_s, bm_s, r_base, hh, wrap, stg, pw, lane);
    } else {
      fa_attend<false>(qs, qs + FT::kTensor, qs + 2 * FT::kTensor, tab_h,
                       pos_s, bm_s, r_base, hh, 0, stg, pw, lane);
    }
    fence_proxy_async();
    named_sync(1 + grp, FT::kGroupThreads);
    if (gtid == 0) {
      // ctx by TMA from the q slots; once the stores have read the stage
      // it takes the task kStages on
      for (int box = 0; box < 4; ++box) {
        const int2 to = sw_box_origin<TR_W>(wx, wy, box, S, shift);
        tma_store_4d(&tm_ctx, st + box * FT::kSlot, 64 * pair, to.x, to.y,
                     img);
      }
      bulk_commit();
      bulk_wait_read();
      if (i + FT::kStages < count)
        fa_load_task(st, full + s, &tm_q, &tm_kv, task + FT::kStages,
                     n_windows, C, S, shift);
    }
  }
}

// a bf16 (B*S*S, cols) raster stream as (cols, S, S, B) in quarter boxes of
// `box_cols` columns: 64 (two heads, the 128-byte swizzle) or 32 (one
// head, the 64-byte swizzle)
bool map_quarters(CUtensorMap* m, const bf16* base, int cols, int B, int S,
                  int box_cols) {
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, TR_W / 2, TR_W / 2, 1};
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)S, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)S * cols * 2,
                                 (cuuint64_t)S * S * cols * 2};
  return make_tmap_of(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B,
                      base, 4, dims, strides, box);
}

cudaError_t launch_train_attn(const bf16* qs, const bf16* qkv, bf16* ctx,
                              bf16* p, const float* table, int B, int S,
                              int C, int H, int shift, cudaStream_t s) {
  CUtensorMap tq, tkv, tc;
  if (!map_quarters(&tq, qs, C, B, S, 64) ||
      !map_quarters(&tkv, qkv, 3 * C, B, S, 64) ||
      !map_quarters(&tc, ctx, C, B, S, 64) ||
      (reinterpret_cast<uintptr_t>(p) & 15) != 0)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const int n_windows = B * (S / TR_W) * (S / TR_W);
  const int n_tasks = n_windows * ((H + 1) / 2);
  const int chunk = (n_tasks + sms - 1) / sms;
  swin_train_attn_kernel<<<(n_tasks + chunk - 1) / chunk, FT::kThreads,
                           FA_SMEM, s>>>(tq, tkv, tc, p, table, C, H, S,
                                         shift, n_windows, n_tasks, chunk);
  return cudaGetLastError();
}

// -------------------------------------------------- the core backward ----
constexpr int CB_BOX = (TR_W / 2) * (TR_W / 2) * 64;  // a one-head quarter
constexpr int CB_SLOT = (CB_BOX + 511) / 512 * 512;   // 64-byte swizzle
constexpr int CB_TENSOR = 4 * CB_SLOT;   // q, k, v or da of a window
constexpr int CB_P = TR_N * TR_N * 2;    // the p plane
constexpr int CB_STAGE = 4 * CB_TENSOR + CB_P;
constexpr int CB_STAGES = 2;
constexpr int CB_THREADS = TR_NT * 32;
// the ring, dq's staging tile, ds, the box-major rows, the barriers and
// align1024's slack
constexpr int CB_SMEM = CB_STAGES * CB_STAGE + CB_TENSOR +
                        TR_N * TR_PLD * 2 + TR_N * 4 + CB_STAGES * 8 + 1024;
static_assert(CB_STAGE % 512 == 0, "stage alignment");

// Shared-memory address of chunk c (16 bytes: dims 8 c .. 8 c + 7) of the
// token at box-major row b of a one-head tile at `base`: four 64-byte-wide
// quarter boxes, 16-byte chunk c of row lr at c ^ ((lr / 2) % 4)
__device__ __forceinline__ uint32_t cb_addr(uint32_t base, int b, int c) {
  const int lr = b % (CB_BOX / 64);
  return base + (b / (CB_BOX / 64)) * CB_SLOT + lr * 64 +
         ((c ^ ((lr >> 1) & 3)) << 4);
}

// Loads window w_idx's q, k, v (tm_qkv), da (tm_da) of head h and its p
// plane into stage `st`, counted on `bar`.
__device__ __forceinline__ void cb_load(unsigned char* st, uint64_t* bar,
                                        const CUtensorMap* tm_qkv,
                                        const CUtensorMap* tm_da,
                                        const bf16* p, int w_idx, int h,
                                        int H, int C, int S, int shift) {
  const int nw = S / TR_W;
  const int img = w_idx / (nw * nw);
  const int wy = (w_idx / nw) % nw;
  const int wx = w_idx % nw;
  mbar_expect_tx(bar, 16 * CB_BOX + CB_P);
  for (int box = 0; box < 4; ++box) {
    const int2 src = sw_box_origin<TR_W>(wx, wy, box, S, shift);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      tma_load_4d(st + q * CB_TENSOR + box * CB_SLOT, tm_qkv, bar,
                  q * C + 32 * h, src.x, src.y, img);
    tma_load_4d(st + 3 * CB_TENSOR + box * CB_SLOT, tm_da, bar, 32 * h,
                src.x, src.y, img);
  }
  bulk_load(st + 4 * CB_TENSOR, p + ((size_t)w_idx * H + h) * CB_P / 2, CB_P,
            bar);
}

// tm_qkv, tm_dqkv map qkv and dqkv as (3C, S, S, B), tm_da da as (C, S, S,
// B), all in one-head (32, 6, 6, 1) boxes; p (BW, H, N, N) bf16;
// dbias_part (gridDim.x, H, N, N) f32. Grid (core_groups(BW, H), H).
__global__ void __launch_bounds__(CB_THREADS, 1)
swin_core_bwd_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                     const __grid_constant__ CUtensorMap tm_da,
                     const __grid_constant__ CUtensorMap tm_dqkv,
                     const bf16* __restrict__ p,
                     float* __restrict__ dbias_part, int BW, int C, int H,
                     int S, int shift, float scale) {
  extern __shared__ unsigned char cb_smem[];
  unsigned char* ring = align1024(cb_smem);
  unsigned char* stg = ring + CB_STAGES * CB_STAGE;  // dq's boxes
  bf16* ds_s = reinterpret_cast<bf16*>(stg + CB_TENSOR);
  int* bm_s = reinterpret_cast<int*>(ds_s + TR_N * TR_PLD);
  uint64_t* full = reinterpret_cast<uint64_t*>(bm_s + TR_N);
  const int N = TR_N;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  const int j0 = warp * 16;
  const int nw = S / TR_W;
  const uint32_t stg_u = smem_u32(stg);
  const uint32_t ds_u = smem_u32(ds_s);

  for (int r = tid; r < N; r += CB_THREADS) bm_s[r] = sw_box_major<TR_W>(r);
  if (tid == 0) {
    for (int s = 0; s < CB_STAGES; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
    for (int s = 0; s < CB_STAGES; ++s)
      if (blockIdx.x + s * gridDim.x < BW)
        cb_load(ring + s * CB_STAGE, full + s, &tm_qkv, &tm_da, p,
                blockIdx.x + s * gridDim.x, h, H, C, S, shift);
  }
  __syncthreads();

  float dbias[TR_NT][2][4];
#pragma unroll
  for (int kt = 0; kt < TR_NT; ++kt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dbias[kt][j][e] = 0.f;

  int n = 0;
  for (int w_idx = blockIdx.x; w_idx < BW; w_idx += gridDim.x, ++n) {
    const int s = n % CB_STAGES;
    unsigned char* st = ring + s * CB_STAGE;
    const uint32_t q_u = smem_u32(st);
    const uint32_t k_u = q_u + CB_TENSOR;
    const uint32_t v_u = k_u + CB_TENSOR;
    const uint32_t da_u = v_u + CB_TENSOR;
    const bf16* p_s = reinterpret_cast<const bf16*>(st + 4 * CB_TENSOR);
    mbar_wait(full + s, (n / CB_STAGES) & 1);

    uint32_t dfr[2][4];  // da of rows r0, r1 as the A operand of dp
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldmatrix_x4<false>(dfr[kk], cb_addr(da_u, bm_s[j0 + (lane & 15)],
                                          2 * kk + (lane >> 4)));

    // pass 1: sum_j dp * p of rows r0, r1
    float sub0 = 0.f, sub1 = 0.f;
#pragma unroll
    for (int kt = 0; kt < TR_NT; ++kt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t vb[4];
        ldmatrix_x4<false>(vb, cb_addr(v_u, bm_s[kt * 16 + j * 8 + (lane & 7)],
                                       lane >> 3));
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(dp, dfr[0], vb[0], vb[1]);
        mma_bf16(dp, dfr[1], vb[2], vb[3]);
        const int key = kt * 16 + j * 8 + 2 * t;
        const __nv_bfloat162 pa = *reinterpret_cast<const __nv_bfloat162*>(
            p_s + r0 * N + key);
        const __nv_bfloat162 pb = *reinterpret_cast<const __nv_bfloat162*>(
            p_s + r1 * N + key);
        sub0 += dp[0] * __low2float(pa) + dp[1] * __high2float(pa);
        sub1 += dp[2] * __low2float(pb) + dp[3] * __high2float(pb);
      }
    }
    sub0 += __shfl_xor_sync(0xffffffffu, sub0, 1);
    sub0 += __shfl_xor_sync(0xffffffffu, sub0, 2);
    sub1 += __shfl_xor_sync(0xffffffffu, sub1, 1);
    sub1 += __shfl_xor_sync(0xffffffffu, sub1, 2);

    // pass 2: ds, dbias, ds_b to shared memory, dq = ds_b k
    float dq[4][4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[jn][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < TR_NT; ++kt) {
      uint32_t dsa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t vb[4];
        ldmatrix_x4<false>(vb, cb_addr(v_u, bm_s[kt * 16 + j * 8 + (lane & 7)],
                                       lane >> 3));
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(dp, dfr[0], vb[0], vb[1]);
        mma_bf16(dp, dfr[1], vb[2], vb[3]);
        const int key = kt * 16 + j * 8 + 2 * t;
        const __nv_bfloat162 pa = *reinterpret_cast<const __nv_bfloat162*>(
            p_s + r0 * N + key);
        const __nv_bfloat162 pb = *reinterpret_cast<const __nv_bfloat162*>(
            p_s + r1 * N + key);
        const float pv[4] = {__low2float(pa), __high2float(pa),
                             __low2float(pb), __high2float(pb)};
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[e] = pv[e] * (dp[e] - (e >= 2 ? sub1 : sub0));
          dbias[kt][j][e] += ds[e];
        }
        dsa[2 * j] = pack_bf16(ds[0] * scale, ds[1] * scale);
        dsa[2 * j + 1] = pack_bf16(ds[2] * scale, ds[3] * scale);
        *reinterpret_cast<uint32_t*>(ds_s + r0 * TR_PLD + key) = dsa[2 * j];
        *reinterpret_cast<uint32_t*>(ds_s + r1 * TR_PLD + key) = dsa[2 * j + 1];
      }
      // k^T of the tile's keys by ldmatrix.trans of the row-major k rows
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4<true>(kb, cb_addr(k_u, bm_s[kt * 16 + (lane & 7) + (lane & 8)],
                                      2 * jj + (lane >> 4)));
        mma_bf16(dq[2 * jj], dsa, kb[0], kb[1]);
        mma_bf16(dq[2 * jj + 1], dsa, kb[2], kb[3]);
      }
    }
    // every ds row written; k and v read for the last time
    __syncthreads();
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int b = bm_s[r0 + 8 * hi];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        st_shared_u32(cb_addr(stg_u, b, jn) + 4 * t,
                      pack_bf16(dq[jn][2 * hi], dq[jn][2 * hi + 1]));
    }

    // dk = ds_b^T q and dv = p^T da for key rows j0 .. j0 + 15, over the
    // query rows 16 at a time, both operands by ldmatrix.trans
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[jn][e] = dv[jn][e] = 0.f;
    const int ar = (lane & 7) + ((lane >> 4) << 3);  // A's query row
    const int ac = j0 + ((lane >> 3) & 1) * 8;       // A's key column
#pragma unroll 3
    for (int i0 = 0; i0 < N; i0 += 16) {
      uint32_t a[4], b[4];
      const int br = bm_s[i0 + (lane & 7) + (lane & 8)];
      ldmatrix_x4<true>(a, ds_u + ((i0 + ar) * TR_PLD + ac) * 2);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        ldmatrix_x4<true>(b, cb_addr(q_u, br, 2 * jj + (lane >> 4)));
        mma_bf16(dk[2 * jj], a, b[0], b[1]);
        mma_bf16(dk[2 * jj + 1], a, b[2], b[3]);
      }
      ldmatrix_x4<true>(a, smem_u32(p_s + (i0 + ar) * N + ac));
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        ldmatrix_x4<true>(b, cb_addr(da_u, br, 2 * jj + (lane >> 4)));
        mma_bf16(dv[2 * jj], a, b[0], b[1]);
        mma_bf16(dv[2 * jj + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int b = bm_s[j0 + g + 8 * hi];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        st_shared_u32(cb_addr(k_u, b, jn) + 4 * t,
                      pack_bf16(dk[jn][2 * hi], dk[jn][2 * hi + 1]));
        st_shared_u32(cb_addr(v_u, b, jn) + 4 * t,
                      pack_bf16(dv[jn][2 * hi], dv[jn][2 * hi + 1]));
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      // dq, dk, dv of the head by TMA into dqkv; once the stores have read
      // the stage it takes the window two on
      const int img = w_idx / (nw * nw);
      const int wy = (w_idx / nw) % nw;
      const int wx = w_idx % nw;
      for (int box = 0; box < 4; ++box) {
        const int2 to = sw_box_origin<TR_W>(wx, wy, box, S, shift);
        tma_store_4d(&tm_dqkv, stg + box * CB_SLOT, 32 * h, to.x, to.y, img);
        tma_store_4d(&tm_dqkv, st + CB_TENSOR + box * CB_SLOT, C + 32 * h,
                     to.x, to.y, img);
        tma_store_4d(&tm_dqkv, st + 2 * CB_TENSOR + box * CB_SLOT,
                     2 * C + 32 * h, to.x, to.y, img);
      }
      bulk_commit();
      bulk_wait_read();
      const int next = w_idx + CB_STAGES * gridDim.x;
      if (next < BW)
        cb_load(st, full + s, &tm_qkv, &tm_da, p, next, h, H, C, S, shift);
    }
  }

  float* part = dbias_part + ((size_t)blockIdx.x * H + h) * N * N;
#pragma unroll
  for (int kt = 0; kt < TR_NT; ++kt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = kt * 16 + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(part + (size_t)r0 * N + key) =
          make_float2(dbias[kt][j][0], dbias[kt][j][1]);
      *reinterpret_cast<float2*>(part + (size_t)r1 * N + key) =
          make_float2(dbias[kt][j][2], dbias[kt][j][3]);
    }
}

// ---------------------------------------------------------------- host ----

// What K9's launches take: C = 32 H a multiple of 64 up to 1024 (the
// LayerNorm holds a row in a warp's registers), windows of 12 (N = 144:
// the attention's and the core's tiling), a square stage of whole windows,
// and a shift of 0 or 6, Swin's own (a quarter window is one TMA box).
bool train_shapes_ok(int B, int S, int C, int H, int win, int shift) {
  return B > 0 && H > 0 && C == H * SW_DH && C % 64 == 0 &&
         C <= HG_MAX_DIM && win == TR_W && S > 0 && S % win == 0 &&
         (shift == 0 || 2 * shift == win) &&
         ((long long)B * S * S + HG_BM - 1) / HG_BM <= 65535;
}

// the window groups of the core backward: the first version's partials of
// dbias (about 2 CTAs per SM over all heads)
int core_groups(int BW, int H) { return std::max(1, std::min(BW, cdiv(264, H))); }

// f32 scratch K9b and K9c need (the largest partial-sum buffer of their
// launches)
long long bwd_scratch_floats(int B, int S, int C, int H, int win) {
  const int M = B * S * S;
  const int BW = M / (win * win);
  int s1, c1;
  split_rows(M, cdiv(C, TG_BM) * cdiv(C, TG_BN), &s1, &c1);
  int s3, c3;
  split_rows(M, cdiv(C, TG_BM) * cdiv(3 * C, TG_BN), &s3, &c3);
  int s2, c2;
  split_rows(M, cdiv(3 * C, 128), &s2, &c2);
  long long need = (long long)s1 * C * C;
  need = std::max(need, (long long)s3 * C * 3 * C);
  need = std::max(need, (long long)s2 * 3 * C);
  need = std::max(need, (long long)core_groups(BW, H) * H * TR_N * TR_N);
  need = std::max(need, 2LL * LN_VJP_BLOCKS * LN_VJP_WARPS * C);
  need = std::max(need, 528LL * 3 * C);  // colsum partials
  return need;
}

cudaError_t core_bwd(cudaStream_t st, const bf16* qkv, const bf16* p,
                     const bf16* da, bf16* dqkv, float* part, float* dbias,
                     int B, int S, int C, int H, int win, int shift, float scale) {
  const int BW = B * (S / win) * (S / win);
  const int G = core_groups(BW, H);
  CUtensorMap tq, tda, tdq;
  if (!map_quarters(&tq, qkv, 3 * C, B, S, 32) ||
      !map_quarters(&tda, da, C, B, S, 32) ||
      !map_quarters(&tdq, dqkv, 3 * C, B, S, 32) ||
      (reinterpret_cast<uintptr_t>(p) & 15) != 0)
    return cudaErrorInvalidValue;
  swin_core_bwd_kernel<<<dim3(G, H), CB_THREADS, CB_SMEM, st>>>(
      tq, tda, tdq, p, part, BW, C, H, S, shift, scale);
  cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : reduce(st, part, G, (size_t)H * TR_N * TR_N, dbias);
}

}  // namespace

// Raises the kernels' dynamic shared-memory limits on the current device
// and finds the CUDA driver's tensor-map encoder.
extern "C" int geovpr_swin_train_init(void) {
  cudaError_t e;
  if (tmap_encode_fn() == nullptr) return (int)cudaErrorSymbolNotFound;
  if ((e = allow_gemm_smem<HG_EPI_QKV2>()) != cudaSuccess ||
      (e = allow_gemm_smem<HG_EPI_QKV>()) != cudaSuccess ||
      (e = allow_gemm_smem<HG_EPI_NONE, true>()) != cudaSuccess ||
      (e = allow_gemm_smem<HG_EPI_F32, false, true>()) != cudaSuccess ||
      (e = allow_smem(swin_train_attn_kernel, FA_SMEM)) != cudaSuccess)
    return (int)e;
  return (int)allow_smem(swin_core_bwd_kernel, CB_SMEM);
}

extern "C" long long geovpr_swin_train_scratch_floats(int B, int S, int C, int H,
                                                      int win) {
  return bwd_scratch_floats(B, S, C, H, win);
}

// K9a's launches first..last (0 LayerNorm, 1 QKV GEMM, 2 window attention,
// 3 out projection); returns a cudaError_t as int. x (M, C) bf16 raster
// rows; wqkv (C, 3C) and wo (C, C) bf16 (in, out); ln_scale, ln_bias,
// bqkv, bo f32; table ((2w-1)^2, H) f32; all 16-byte aligned. Outputs: qkv
// (M, 3C) bf16 unscaled, ctx (M, C) bf16 (LN(x) until the attention
// writes ctx), p (BW, H, N, N) bf16, y (M, C) bf16; scratch qs (M, C)
// bf16. qscale = dh^-0.5 log2(e). A launch alone reads what the earlier
// launches of an earlier call left in the buffers.
extern "C" int geovpr_swin_train_fwd_parts(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* table,
    void* qkv, void* qs, void* ctx, void* p, void* y, int B, int S, int C,
    int H, int win, int shift, float eps, float qscale, int first, int last,
    void* stream) {
  if (!train_shapes_ok(B, S, C, H, win, shift) || first < 0 || last > 3 ||
      first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* ctxb = static_cast<bf16*>(ctx);
  CUtensorMap tm;
  cudaError_t e = cudaSuccess;
  for (int k = first; k <= last && e == cudaSuccess; ++k) {
    switch (k) {
      case 0:  // LN(x) into the ctx buffer (K9c's LN recompute, no stats)
        ln_stats_kernel<<<cdiv(M, 8), 256, 0, st>>>(
            static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
            static_cast<const float*>(ln_bias), eps, M, C, ctxb, nullptr);
        e = cudaGetLastError();
        break;
      case 1:  // qkv = LN(x) Wqkv + bqkv, and the scaled q copy
        if (!map_rows(&tm, ctxb, M, C)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_QKV2>(
            tm, static_cast<const bf16*>(wqkv), C, 3 * C,
            HgEpilogue{static_cast<const float*>(bqkv), nullptr, nullptr,
                       qscale, C},
            static_cast<bf16*>(qkv), M, st, 0, static_cast<bf16*>(qs));
        break;
      case 2:  // the window attention: ctx and p
        e = launch_train_attn(static_cast<const bf16*>(qs),
                              static_cast<const bf16*>(qkv), ctxb,
                              static_cast<bf16*>(p),
                              static_cast<const float*>(table), B, S, C, H,
                              shift, st);
        break;
      default:  // y = ctx Wo + bo
        if (!map_rows(&tm, ctxb, M, C)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_QKV>(
            tm, static_cast<const bf16*>(wo), C, C,
            HgEpilogue{static_cast<const float*>(bo), nullptr, nullptr, 1.f,
                       0},
            static_cast<bf16*>(y), M, st);
    }
  }
  return (int)e;
}

// K9a, all four launches.
extern "C" int geovpr_swin_train_fwd(
    const void* x, const void* ln_scale, const void* ln_bias, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* table,
    void* qkv, void* qs, void* ctx, void* p, void* y, int B, int S, int C,
    int H, int win, int shift, float eps, float qscale, void* stream) {
  return geovpr_swin_train_fwd_parts(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                                     table, qkv, qs, ctx, p, y, B, S, C, H,
                                     win, shift, eps, qscale, 0, 3, stream);
}

// K9b. qkv (M, 3C), p (BW, H, N, N), da (M, C) bf16 -> dqkv (M, 3C) bf16,
// dbias (H, N, N) f32; scratch part (at least
// geovpr_swin_train_scratch_floats) f32. scale = dh^-0.5.
extern "C" int geovpr_swin_train_bwd_core(
    const void* qkv, const void* p, const void* da, void* dqkv, void* part,
    void* dbias, int B, int S, int C, int H, int win, int shift, float scale,
    void* stream) {
  if (!train_shapes_ok(B, S, C, H, win, shift)) return (int)cudaErrorInvalidValue;
  return (int)core_bwd(static_cast<cudaStream_t>(stream),
                       static_cast<const bf16*>(qkv), static_cast<const bf16*>(p),
                       static_cast<const bf16*>(da), static_cast<bf16*>(dqkv),
                       static_cast<float*>(part), static_cast<float*>(dbias), B,
                       S, C, H, win, shift, scale);
}

// K9c's launches first..last: 0 da = bf16(g Wo^T); 1 dWo = ctx^T g (and
// its reduce); 2 dbo = sum g; 3 the attention core (and its dbias reduce);
// 4 the LN recompute; 5 dWqkv = h^T dqkv (and its reduce); 6 dbqkv = sum
// dqkv; 7 dh = bf16(dqkv Wqkv^T) into the da buffer; 8 the LN VJP and its
// two reduces. Returns a cudaError_t as int. Inputs: x (M, C), qkv (M, 3C),
// p (BW, H, N, N), ctx (M, C), g (M, C) bf16; wqkv (C, 3C), wo (C, C)
// bf16; ln_scale, ln_bias f32. Outputs: dx (M, C) bf16; dwqkv (C, 3C),
// dbqkv (3C), dwo (C, C), dbo (C), dbias (H, N, N), dls, dlb (C) f32.
// Scratch: da, h (M, C) and dqkv (M, 3C) bf16, stats (M) float2, part f32
// (geovpr_swin_train_scratch_floats). A launch alone reads what the
// earlier launches of an earlier call left in the scratch.
extern "C" int geovpr_swin_train_bwd_all_parts(
    const void* x, const void* qkv, const void* p, const void* ctx,
    const void* g, const void* wqkv, const void* wo, const void* ln_scale,
    const void* ln_bias, void* da, void* dqkv, void* h, void* stats,
    void* part, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
    void* dbias, void* dls, void* dlb, int B, int S, int C, int H, int win,
    int shift, float eps, float scale, int first, int last, void* stream) {
  if (!train_shapes_ok(B, S, C, H, win, shift) || C > 512 || first < 0 ||
      last > 8 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* qkvb = static_cast<const bf16*>(qkv);
  bf16* dab = static_cast<bf16*>(da);
  bf16* dqkvb = static_cast<bf16*>(dqkv);
  bf16* hb = static_cast<bf16*>(h);
  float* pt = static_cast<float*>(part);
  const int parts = LN_VJP_BLOCKS * LN_VJP_WARPS;
  const HgEpilogue ep{nullptr, nullptr, nullptr, 1.f, 0, pt};
  CUtensorMap ta;
  cudaError_t e = cudaSuccess;
  int splits, chunk;
  for (int k = first; k <= last && e == cudaSuccess; ++k) {
    switch (k) {
      case 0:  // da = bf16(g Wo^T), Wo (C, C) read K-major
        if (!map_rows(&ta, gb, M, C)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_NONE, true>(ta, static_cast<const bf16*>(wo),
                                           C, C, ep, dab, M, st);
        break;
      case 1:  // dWo = ctx^T g: partials over chunks of rows, then reduced
        split_rows(M, cdiv(C, TG_BM) * cdiv(C, TG_BN), &splits, &chunk);
        if (!map_tiles64(&ta, static_cast<const bf16*>(ctx), M, C))
          return (int)cudaErrorInvalidValue;
        if ((e = launch_gemm<HG_EPI_F32, false, true>(
                 ta, gb, M, C, ep, nullptr, C, st, chunk)) == cudaSuccess)
          e = reduce(st, pt, splits, (size_t)C * C, static_cast<float*>(dwo));
        break;
      case 2:  // dbo = sum g
        e = colsum(st, gb, M, C, pt, static_cast<float*>(dbo));
        break;
      case 3:  // the attention core: dqkv, dbias
        e = core_bwd(st, qkvb, static_cast<const bf16*>(p), dab, dqkvb, pt,
                     static_cast<float*>(dbias), B, S, C, H, win, shift,
                     scale);
        break;
      case 4:  // the LN recompute
        ln_stats_kernel<<<cdiv(M, 8), 256, 0, st>>>(
            xb, static_cast<const float*>(ln_scale),
            static_cast<const float*>(ln_bias), eps, M, C, hb,
            static_cast<float2*>(stats));
        e = cudaGetLastError();
        break;
      case 5:  // dWqkv = h^T dqkv, as dWo
        split_rows(M, cdiv(C, TG_BM) * cdiv(3 * C, TG_BN), &splits, &chunk);
        if (!map_tiles64(&ta, hb, M, C)) return (int)cudaErrorInvalidValue;
        if ((e = launch_gemm<HG_EPI_F32, false, true>(
                 ta, dqkvb, M, 3 * C, ep, nullptr, C, st, chunk)) ==
            cudaSuccess)
          e = reduce(st, pt, splits, (size_t)C * 3 * C,
                     static_cast<float*>(dwqkv));
        break;
      case 6:  // dbqkv = sum dqkv
        e = colsum(st, dqkvb, M, 3 * C, pt, static_cast<float*>(dbqkv));
        break;
      case 7:  // dh = bf16(dqkv Wqkv^T) into the da buffer, Wqkv (C, 3C)
               // read K-major
        if (!map_rows(&ta, dqkvb, M, 3 * C)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_NONE, true>(ta, static_cast<const bf16*>(wqkv),
                                           3 * C, C, ep, dab, M, st);
        break;
      default:  // the LN VJP -> dx and the partials of dls, dlb
        if ((e = ln_vjp(st, xb, dab, static_cast<const float2*>(stats),
                        static_cast<const float*>(ln_scale), nullptr, M, C,
                        static_cast<bf16*>(dx), pt, pt + (size_t)parts * C)) ==
                cudaSuccess &&
            (e = reduce(st, pt, parts, C, static_cast<float*>(dls))) ==
                cudaSuccess)
          e = reduce(st, pt + (size_t)parts * C, parts, C,
                     static_cast<float*>(dlb));
    }
  }
  return (int)e;
}

// K9c, all its launches (the whole backward).
extern "C" int geovpr_swin_train_bwd_all(
    const void* x, const void* qkv, const void* p, const void* ctx,
    const void* g, const void* wqkv, const void* wo, const void* ln_scale,
    const void* ln_bias, void* da, void* dqkv, void* h, void* stats,
    void* part, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
    void* dbias, void* dls, void* dlb, int B, int S, int C, int H, int win,
    int shift, float eps, float scale, void* stream) {
  return geovpr_swin_train_bwd_all_parts(
      x, qkv, p, ctx, g, wqkv, wo, ln_scale, ln_bias, da, dqkv, h, stats,
      part, dx, dwqkv, dbqkv, dwo, dbo, dbias, dls, dlb, B, S, C, H, win,
      shift, eps, scale, 0, 8, stream);
}
