// K7: the window-attention core for Hopper (sm_90a):
//
//   out[w, h] = softmax(q[w, h] k[w, h]^T dh^-0.5 + bias[h] [+ mask[w]]) v[w, h]
//
// at head dim 32, in two address modes of one kernel (a template
// parameter: how a (window, head, token) becomes a row address, and where
// the bias and the mask come from):
//
// - raster (`geovpr_window_attention_raster`, the window-7 serving path):
//   q, k and v are read straight out of the unfused half's raster qkv, (B,
//   S*S, 3C) bf16 with q | k | v at columns 0, C, 2C and head h at 32 h,
//   and the context is written back in raster order into (B, S*S, C):
//   token (ry, rx) of window (wy, wx) of image b is raster row
//     b*S*S + ((wy*W + ry + shift) mod S) * S + (wx*W + rx + shift) mod S
//   (the formula of swin_attn.cu), so the window partition, the cyclic
//   shift of SW-MSA and their inverses are addressing and no gather or
//   scatter copy exists. The bias comes from the ((2W-1)^2, H)
//   relative-position table, bias[i][j] = table[pos_i - pos_j + base, h]
//   with pos = ry (2W-1) + rx (W <= 12: the head's bias matrix is staged in
//   shared memory); the shift mask is a
//   comparison of region labels (3 * row region + column region in the
//   rolled frame, geovpr_torch/ops/window_attention.py::
//   shifted_window_labels): in the last window row or column of a shifted
//   stage a token's region is whether its window offset is >= W - shift, in
//   every other window all tokens share one region.
// - split (`geovpr_window_attention`, JAX's operands): q, k, v and out are
//   (BW, H, N, 32) bf16, bias (H, N, N) f32, mask (nW, N, N) f32 (0 / -100)
//   or null, window w taking mask w mod nW; bias and mask are read from
//   device memory through the read-only cache, one or two values a score.
//
// Replaces geovpr/ops/pallas_window_attention.py::window_attention_pallas
// (:182, body _kernel, pallas_call :149) in its serving form (_SKIP_MAX).
// Numerics (both modes, bit-equal to the first version): q is bf16 and
// rounded again after the f32 scale, qs = bf16(f32(q) * dh^-0.5 log2(e));
// s = f32(qs k^T) + f32(bias) log2(e) [+ f32(mask) log2(e)], each product
// and each sum rounded (no fused multiply-add), as JAX and the plain
// version round them; in the raster mode a score of two tokens in the same
// region gets no mask term (x + 0 = x), one across regions gets
// __fmul_rn(-100, log2(e)); p = 2^min(s, 100) with no max-shift, so P is
// rounded to bf16 (never fp16) for P V; the f32 row sum divides the
// context, rounded to bf16. Each lane sums its p over the keys in window
// order (16-key tiles, two 8-key halves, two keys each) and the lanes of a
// row by two xor shuffles; P V sums each 16-key tile in one k16 mma.sync,
// tiles in key order: the first version's orders. p is the SFU's ex2,
// which flushes p < 2^-126 to zero where exp2f kept a subnormal: K7 stores
// no p, and a term below 2^-126 moves neither a bf16 p (its smallest
// subnormal is 2^-133, and such a p needs s >= -133 in a masked key) nor
// an f32 row sum that holds the row's own diagonal. Forward only: the JAX
// backward is an XLA recompute, not a kernel.
//
// What bounds it on the H100 (Swin-T-224, B = 64, stages 0 / 1 / 2 / 3:
// BW 4096 / 1024 / 256 / 64 windows of N = 49 tokens, H 3 / 6 / 12 / 24):
// bytes. The raster mode reads qkv once and writes ctx once, 154 / 77 /
// 38.5 / 19.3 MB, 0.046 / 0.023 / 0.0115 / 0.0058 ms at 3.35 TB/s; the
// products are 3.8 / 1.9 / 0.9 / 0.5 GFLOP (0.004 ms at stage 0 at 989
// TFLOP/s); the 29.5 / 14.8 / 7.4 / 3.7 M exp2s take about a sixth of
// the bytes' time at the SFU's 16 a clock an SM (1.98 GHz).
//
// Design. A CTA takes a contiguous run of (head, window) tasks, head-major
// (so that the run keeps one head for all but a few of its tasks), through
// a ring of WA_STAGES = 2 stages, each holding a task's q, k and v: NP =
// pad16(N) rows of 64 bytes each, the 16-byte chunks of row r permuted by
// (r / 2) % 4 so that ldmatrix reads eight consecutive rows without a bank
// conflict. Every thread issues the next task's loads by 16-byte cp.async,
// addressed per token: a window row that the shift wraps costs nothing
// extra, where TMA boxes would need W-wide boxes split at the wrap (and
// 4 x 4 boxes read 64 tokens for 49); the loads of task i + 1 fly while
// task i computes. A warp takes one 16-row query tile of the task (N = 49:
// four warps, the fourth with one live row), so that about five CTAs share
// an SM and the latency of the score -> exp2 -> P V chain is hidden by
// other warps. K and V fragments come by ldmatrix, V by ldmatrix.trans (no
// element-by-element transpose). In the raster mode the head's table
// column rides in the ring beside q, k and v, and each warp keeps its 16
// rows of the head's bias matrix in shared memory, table values times
// log2(e) gathered once a head from each token's place in the (2W-1)^2
// grid, -inf in the columns of the pad keys: a score costs one 8-byte read
// for two keys, one add, the min, the exp2 and the row sum's add, and a pad
// key's p is exp2(-inf) = 0 with no test. Pad rows (N .. NP) of every stage
// are zeroed once and never loaded; a half tile whose keys or query rows
// are all pads computes no score, exp2 or sum (at N = 49: the last query
// tile its first 8 rows, the last key tile its first 8 keys). Each lane
// divides its context by the row sum, rounds once and stores it straight
// to its raster (or split) rows.
//
// Gone from the first version: one CTA per (window, head) with no overlap
// inside it, synchronous 16-byte gathers, the element-by-element v^T
// transpose, the (H, N, N) bias and (nW, N, N) mask read per score in the
// serving path, pad rows and keys doing full work, and the copies around
// the kernel (the roll, the window partition and the head transposes
// before it, their inverses after it). The compute, not the loads, bounds
// this design on the H100 (with either left out of a copy of the kernel,
// the math and stores alone took longer than the loads alone): two query
// tiles a warp in 64-thread CTAs left ten warps an SM and ran slower than
// the first version, and a table lookup a score cost more than the bias
// matrix.

#include <cuda_runtime.h>

#include "hopper.cuh"
#include "window_attn.cuh"

namespace {

constexpr int WA_MAX_N = 256;         // window tokens (16 query tiles)
constexpr int WA_MAX_RASTER_N = 144;  // the raster mode's bias matrix
constexpr int WA_MAX_THREADS = 512;   // a warp a 16-row query tile
constexpr int WA_STAGES = 2;
constexpr int WA_SMEM_LIMIT = 232448;  // a CTA's shared memory on Hopper
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskL2 = -100.f * kLog2e;

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// Floats a row of the raster mode's bias matrix: 8 more than the keys, so
// that the 8-byte reads of a warp's 8 query rows hit distinct banks.
__host__ __device__ inline int wa_bias_ld(int n) { return pad16(n) + 8; }

// Bytes of a ring stage: q | k | v, pad16(n) rows of 64 bytes each, and in
// the raster mode (t2 = (2W-1)^2) the task's head's column of the table.
__host__ __device__ inline int wa_stage_bytes(int n, int t2) {
  return 3 * pad16(n) * 64 + (t2 * 4 + 15) / 16 * 16;
}

// A CTA's shared memory: the ring and, in the raster mode, the head's bias
// matrix (pad16(n) rows of wa_bias_ld(n) floats) and each token's packed
// geometry (wa_token).
__host__ __device__ inline int wa_smem_bytes(int n, int t2) {
  const int np = pad16(n);
  return WA_STAGES * wa_stage_bytes(n, t2) +
         (t2 ? np * wa_bias_ld(n) * 4 + np * 4 : 0);
}

struct WaArgs {
  const bf16* q;       // split: q (BW, H, N, 32); raster: qkv (B, S*S, 3C)
  const bf16* k;       // split only
  const bf16* v;       // split only
  const float* bias;   // split: (H, N, N); raster: table ((2W-1)^2, H)
  const float* mask;   // split: (nW, N, N) or null
  bf16* out;           // split: (BW, H, N, 32); raster: (B, S*S, C)
  int H, N, nW;        // nW: split only
  int W, S, shift, C;  // raster only
  int n_windows;       // BW
  int n_tasks, chunk;  // tasks = H * windows; per CTA
  float qscale;        // dh^-0.5 log2(e)
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Shared-memory address of 16-byte chunk c (dims 8c .. 8c + 7) of row r
// of a 64-byte-row tile at `base`.
__device__ __forceinline__ uint32_t wa_addr(uint32_t base, int r, int c) {
  return base + r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// A window offset's raster row or column: the cyclic shift wraps the last
// window past S back to 0.
__device__ __forceinline__ int wa_wrap(int o, int S) {
  return o >= S ? o - S : o;
}

// A token's geometry in the raster mode, packed: its region bits (bits
// 0-1: 2 row offset >= W - shift, 1 column offset), column and row offset
// in the window (bits 2-5, 6-9) and its place ry (2W-1) + rx in the bias
// grid (from bit 10).
__device__ __forceinline__ int wa_token(int r, int W, int shift) {
  const int ry = r / W;
  const int rx = r - ry * W;
  return (ry * (2 * W - 1) + rx) << 10 | ry << 6 | rx << 2 |
         (ry >= W - shift) << 1 | (rx >= W - shift);
}

// The window and head of a task, stepped task by task (head-major: task =
// h * n_windows + w) without a division.
struct WaTask {
  int w, h;          // window, head
  int img, wy, wx;   // raster: the window's image, row and column
  __device__ void init(const WaArgs& a, int task, int nw) {
    h = task / a.n_windows;
    w = task - h * a.n_windows;
    img = w / (nw * nw);
    wy = (w - img * nw * nw) / nw;
    wx = w - img * nw * nw - wy * nw;
  }
  __device__ void next(const WaArgs& a, int nw) {
    if (++w == a.n_windows) {
      w = img = wy = wx = 0;
      ++h;
    } else if (++wx == nw) {
      wx = 0;
      if (++wy == nw) {
        wy = 0;
        ++img;
      }
    }
  }
};

// Element offset of token r's 32 columns of the task's head: in the raster
// mode (tok: r's wa_token) of the q block of qkv (k at + C, v at + 2C; ctx
// has C columns: `cols`), in the split mode of q (k, v, out alike).
template <bool kRaster>
__device__ __forceinline__ size_t wa_row(const WaArgs& a, const WaTask& tk,
                                         int r, int tok, int cols) {
  if constexpr (kRaster) {
    const int y = wa_wrap(tk.wy * a.W + (tok >> 6 & 15) + a.shift, a.S);
    const int x = wa_wrap(tk.wx * a.W + (tok >> 2 & 15) + a.shift, a.S);
    return ((size_t)(tk.img * a.S + y) * a.S + x) * cols + tk.h * 32;
  } else {
    return (((size_t)tk.w * a.H + tk.h) * a.N + r) * 32;
  }
}

// Issues the task's loads into the stage at `st` (cp.async by every
// thread; the caller commits the group): q, k and v in 16-byte rows and, in
// the raster mode, the head's (2W-1)^2 table entries after them.
template <bool kRaster>
__device__ __forceinline__ void wa_load(const WaArgs& a, uint32_t st,
                                        const WaTask& tk, const int* tok_s) {
  const int tb = pad16(a.N) * 64;  // bytes of a q, k or v tile
  for (int i = threadIdx.x; i < 4 * a.N; i += blockDim.x) {
    const int r = i >> 2;
    const int c = i & 3;
    const size_t off =
        wa_row<kRaster>(a, tk, r, kRaster ? tok_s[r] : 0, 3 * a.C) + c * 8;
    const uint32_t dst = wa_addr(st, r, c);
    if constexpr (kRaster) {
      cp_async16(dst, a.q + off);
      cp_async16(dst + tb, a.q + off + a.C);
      cp_async16(dst + 2 * tb, a.q + off + 2 * a.C);
    } else {
      cp_async16(dst, a.q + off);
      cp_async16(dst + tb, a.k + off);
      cp_async16(dst + 2 * tb, a.v + off);
    }
  }
  if constexpr (kRaster) {
    const int t2 = (2 * a.W - 1) * (2 * a.W - 1);
    for (int i = threadIdx.x; i < t2; i += blockDim.x)
      cp_async4(st + 3 * tb + 4 * i, a.bias + (size_t)i * a.H + tk.h);
  }
}

// One warp: query tile `tile` (16 rows, at least one < N; kHalf: its
// rows 8..15 are all pads) of the task, whose q, k and v are in the stage
// at `st`, against all keys; stores the bf16 context rows < N. Raster
// mode: bias_s the head's bias matrix (times log2(e); -inf in the columns
// of the pad keys, so their p = exp2(-inf) = 0), tok_s each token's
// wa_token, wrap the region bits that matter in this window (0: no mask).
// Split mode: the head's (N, N) bias and the window's (N, N) mask from
// device memory, p = 0 for a key >= N. The key tiles whose 16 keys are all
// < N run with no test; the last, partial one computes its second 8 keys
// only where one of them is < N. Every shared-memory address of a key
// tile is a per-lane base plus 64 k0 (the 16-byte chunks' permutation
// repeats every 8 rows), or plus k0 for the bias matrix.
template <bool kRaster, bool kMasked, bool kHalf>
__device__ __forceinline__ void wa_attend(const WaArgs& a, uint32_t st,
                                          const float* bias_s,
                                          const int* tok_s, const WaTask& tk,
                                          int tile, int wrap, int lane) {
  const int N = a.N;
  const int NP = pad16(N);
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * tile;
  const uint32_t ks = st + NP * 64;
  const uint32_t vs = st + 2 * NP * 64;
  const uint32_t k_lane[2] = {wa_addr(ks, lane & 7, lane >> 3),
                              wa_addr(ks, 8 + (lane & 7), lane >> 3)};
  const uint32_t v_lane[2] = {
      wa_addr(vs, (lane & 7) + (lane & 8), lane >> 4),
      wa_addr(vs, (lane & 7) + (lane & 8), 2 + (lane >> 4))};
  const int ld = wa_bias_ld(N);
  const float* b_lane = bias_s + (r0 + g) * ld + 2 * t;  // + 8 ld hi + key
  const int* t_lane = tok_s + 2 * t;                     // + key
  const float* __restrict__ bias_h = kRaster ? nullptr
                                             : a.bias + (size_t)tk.h * N * N;
  const float* __restrict__ mask_w =
      kRaster || !kMasked ? nullptr : a.mask + (size_t)(tk.w % a.nW) * N * N;
  constexpr int kHi = kHalf ? 1 : 2;  // 8-row halves holding a live row

  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    ldmatrix_x4<false>(qa[kk],
                       wa_addr(st, r0 + (lane & 15), 2 * kk + (lane >> 4)));
    // qs = bf16(f32(q) * qscale), as the first version staged it
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t u = qa[kk][e];  // two bf16, the first in the low half
      qa[kk][e] = pack_bf16(__fmul_rn(__uint_as_float(u << 16), a.qscale),
                            __fmul_rn(__uint_as_float(u & 0xffff0000u),
                                      a.qscale));
    }
  }
  int rq[2];  // raster, masked: this lane's query rows' region bits
  float o[4][4];
  float l[2] = {0.f, 0.f};  // partial row sums (this lane's keys)
#pragma unroll
  for (int hi = 0; hi < 2; ++hi)
    rq[hi] = kRaster && kMasked ? tok_s[r0 + g + 8 * hi] : 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  // one 16-key tile; j1: its second 8 keys hold one < N
  auto step = [&](int k0, bool j1) {
    uint32_t kb[2][4], vb[2][4];
    float s[2][4];  // S (16 x 16) as two 16 x 8 tiles: key k0 + 8 j + 2 t + c
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ldmatrix_x4<true>(vb[j], v_lane[j] + 64 * k0);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if (j == 0 || j1) {
        ldmatrix_x4<false>(kb[j], k_lane[j] + 64 * k0);
        mma_bf16(s[j], qa[0], kb[j][0], kb[j][1]);
        mma_bf16(s[j], qa[1], kb[j][2], kb[j][3]);
      }
    }
    // + bias [+ mask] (exp2 domain), p = exp2(min(s, 100))
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && !j1) continue;  // p stay 0 and add nothing
      const int kc = k0 + 8 * j;    // + 2 t: this lane's keys kc, kc + 1
      int rk[2];
      if constexpr (kRaster && kMasked) {
        rk[0] = t_lane[kc];
        rk[1] = t_lane[kc + 1];
      }
#pragma unroll
      for (int hi = 0; hi < kHi; ++hi) {
        float x[2];
        if constexpr (kRaster) {
          const float2 b =
              *reinterpret_cast<const float2*>(b_lane + 8 * hi * ld + kc);
          x[0] = __fadd_rn(s[j][2 * hi], b.x);
          x[1] = __fadd_rn(s[j][2 * hi + 1], b.y);
          if constexpr (kMasked) {
#pragma unroll
            for (int c = 0; c < 2; ++c)
              x[c] = (rq[hi] ^ rk[c]) & wrap ? __fadd_rn(x[c], kMaskL2)
                                             : x[c];
          }
        } else {
          const int row = min(r0 + g + 8 * hi, N - 1);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = kc + 2 * t + c;
            const int ij = row * N + min(key, N - 1);
            x[c] = __fadd_rn(s[j][2 * hi + c],
                             __fmul_rn(__ldg(bias_h + ij), kLog2e));
            if (kMasked)
              x[c] = __fadd_rn(x[c], __fmul_rn(__ldg(mask_w + ij), kLog2e));
            if (key >= N) x[c] = -INFINITY;
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2_ftz(fminf(x[c], 100.f));
          l[hi] += p;
          s[j][2 * hi + c] = p;
        }
      }
    }
    // P as the A operand (16 x 16 keys) of P V
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            kHalf ? 0u : pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            kHalf ? 0u : pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mma_bf16(o[2 * j], pa, vb[j][0], vb[j][1]);
      mma_bf16(o[2 * j + 1], pa, vb[j][2], vb[j][3]);
    }
  };
  int k0 = 0;
#pragma unroll 1
  for (; k0 + 16 <= N; k0 += 16) step(k0, true);
  if (k0 < N) step(k0, k0 + 8 < N);

#pragma unroll
  for (int hi = 0; hi < kHi; ++hi) {
    float li = l[hi];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = r0 + g + 8 * hi;
    if (r < N) {
      bf16* dst = a.out +
                  wa_row<kRaster>(a, tk, r, kRaster ? tok_s[r] : 0,
                                  kRaster ? a.C : 32) +
                  2 * t;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jn) =
            __floats2bfloat162_rn(o[jn][2 * hi] / li, o[jn][2 * hi + 1] / li);
    }
  }
}

// One warp's tile, dispatched on whether its rows 8..15 hold a row < N.
template <bool kRaster, bool kMasked>
__device__ __forceinline__ void wa_attend_tile(const WaArgs& a, uint32_t st,
                                               const float* bias_s,
                                               const int* tok_s,
                                               const WaTask& tk, int tile,
                                               int wrap, int lane) {
  if (16 * tile + 8 < a.N)
    wa_attend<kRaster, kMasked, false>(a, st, bias_s, tok_s, tk, tile, wrap,
                                       lane);
  else
    wa_attend<kRaster, kMasked, true>(a, st, bias_s, tok_s, tk, tile, wrap,
                                      lane);
}

// Tasks run head-major (task = h * n_windows + window), so that a CTA's
// run of tasks keeps one head, and with it the raster mode's bias matrix,
// for all but its last few tasks at most.
template <bool kRaster>
__global__ void __launch_bounds__(WA_MAX_THREADS)
window_attn_kernel(const WaArgs a) {
  extern __shared__ __align__(128) unsigned char wa_smem[];
  const int N = a.N;
  const int NP = pad16(N);
  const int tb = NP * 64;
  const int T = kRaster ? 2 * a.W - 1 : 0;
  const int stage_bytes = wa_stage_bytes(N, T * T);
  const uint32_t ring = smem_u32(wa_smem);
  float* bias_s = reinterpret_cast<float*>(wa_smem + WA_STAGES * stage_bytes);
  int* tok_s = reinterpret_cast<int*>(bias_s + NP * wa_bias_ld(N));
  const int tid = threadIdx.x;
  const int first = blockIdx.x * a.chunk;
  const int count = min(a.chunk, a.n_tasks - first);
  const int nw = kRaster ? a.S / a.W : 1;

  // pad rows of every q, k and v tile: zero, never loaded
  for (int i = tid; i < WA_STAGES * 3 * (NP - N) * 4; i += blockDim.x) {
    const int c = i & 3;
    const int r = N + (i >> 2) % (NP - N);
    const int tile = (i >> 2) / (NP - N);
    asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};" ::"r"(
                     wa_addr(ring + tile / 3 * stage_bytes + tile % 3 * tb,
                             r, c)),
                 "r"(0)
                 : "memory");
  }
  if constexpr (kRaster) {
    for (int r = tid; r < NP; r += blockDim.x)
      tok_s[r] = r < N ? wa_token(r, a.W, a.shift) : 0;
    __syncthreads();
  }
  WaTask ld, cur;
  ld.init(a, first, nw);
  cur = ld;
  for (int s = 0; s < WA_STAGES - 1; ++s) {
    if (s < count) wa_load<kRaster>(a, ring + s * stage_bytes, ld, tok_s);
    cp_async_commit();
    ld.next(a, nw);
  }

  const int tile = tid >> 5;
  const int lane = tid & 31;
  int h_built = -1;
  for (int i = 0; i < count; ++i) {
    cp_async_wait<WA_STAGES - 2>();
    // every thread's loads of task i have landed; every reader of the stage
    // that task i + WA_STAGES - 1 takes (task i - 1's) is done
    __syncthreads();
    if (i + WA_STAGES - 1 < count)
      wa_load<kRaster>(a, ring + (i + WA_STAGES - 1) % WA_STAGES * stage_bytes,
                       ld, tok_s);
    cp_async_commit();
    ld.next(a, nw);

    const int so = i % WA_STAGES * stage_bytes;
    if constexpr (kRaster) {
      if (cur.h != h_built) {
        // this warp's rows of the head's bias matrix from the table column
        // in the stage: bias[r][k] = table[pos_r - pos_k + base, h]
        // log2(e), -inf for a pad key; only this warp reads them (a pad
        // row's entries stay unwritten: its p and its context are never
        // used)
        const float* tab =
            reinterpret_cast<const float*>(wa_smem + so + 3 * tb);
        const int ld_b = wa_bias_ld(N);
        const int base = (a.W - 1) * (T + 1);
        const int r_end = min(16 * tile + 16, N);  // rows >= N: never read
        __syncwarp();
        for (int k = lane; k < NP; k += 32) {
          const int pk = (tok_s[k] >> 10) - base;
          float* col = bias_s + k;
          for (int r = 16 * tile; r < r_end; ++r)
            col[r * ld_b] = k >= N ? -INFINITY
                                   : __fmul_rn(tab[(tok_s[r] >> 10) - pk],
                                               kLog2e);
        }
        __syncwarp();
        h_built = cur.h;
      }
      const int wrap = a.shift ? (cur.wy == nw - 1) << 1 | (cur.wx == nw - 1)
                               : 0;
      if (wrap)
        wa_attend_tile<true, true>(a, ring + so, bias_s, tok_s, cur, tile,
                                   wrap, lane);
      else
        wa_attend_tile<true, false>(a, ring + so, bias_s, tok_s, cur, tile, 0,
                                    lane);
    } else if (a.mask) {
      wa_attend_tile<false, true>(a, ring + so, nullptr, nullptr, cur, tile,
                                  0, lane);
    } else {
      wa_attend_tile<false, false>(a, ring + so, nullptr, nullptr, cur, tile,
                                   0, lane);
    }
    cur.next(a, nw);
  }
}

template <bool kRaster>
cudaError_t launch_wa(WaArgs a, cudaStream_t s) {
  const int threads = 2 * pad16(a.N);  // a warp a query tile
  const int smem = wa_smem_bytes(a.N, kRaster ? (2 * a.W - 1) * (2 * a.W - 1)
                                              : 0);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, window_attn_kernel<kRaster>, threads, smem)) !=
          cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  a.n_tasks = a.n_windows * a.H;
  a.chunk = (a.n_tasks + sms * per_sm - 1) / (sms * per_sm);
  window_attn_kernel<kRaster><<<(a.n_tasks + a.chunk - 1) / a.chunk, threads,
                                smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Raises both modes' dynamic shared-memory limit to a CTA's maximum on the
// current device; returns a cudaError_t.
extern "C" int geovpr_window_attention_init(void) {
  cudaError_t e = cudaFuncSetAttribute(
      window_attn_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WA_SMEM_LIMIT);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(window_attn_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   WA_SMEM_LIMIT);
}

// K7 on JAX's operands. Returns a cudaError_t as int: 0 when the launch
// was accepted. q, k, v and out (BW, H, N, 32) bf16, contiguous; bias (H,
// N, N) f32; mask (nW, N, N) f32 or null (nW ignored), with BW a multiple
// of nW; 1 <= N <= 256. qscale = dh^-0.5 log2(e) in f32.
extern "C" int geovpr_window_attention(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* mask, void* out, int BW,
                                       int H, int N, int nW, float qscale,
                                       void* stream) {
  if (BW <= 0 || H <= 0 || N <= 0 || N > WA_MAX_N ||
      (long long)BW * H > 0x7fffffff || (mask && (nW <= 0 || BW % nW)))
    return (int)cudaErrorInvalidValue;
  WaArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.N = N;
  a.nW = mask ? nW : 1;
  a.W = 1;
  a.n_windows = BW;
  a.qscale = qscale;
  return (int)launch_wa<false>(a, static_cast<cudaStream_t>(stream));
}

// K7 on the raster qkv of the unfused window-attention half. Returns a
// cudaError_t as int. qkv (B, S*S, 3C) bf16 (q | k | v, head h at columns
// 32 h of each), table ((2W-1)^2, H) f32 (natural-log domain), out (B, S*S,
// C) bf16, all contiguous; C = 32 H; W*W <= 256, S a multiple of W, 0 <=
// shift < W. qscale = dh^-0.5 log2(e) in f32.
extern "C" int geovpr_window_attention_raster(const void* qkv,
                                              const void* table, void* out,
                                              int B, int S, int C, int H,
                                              int W, int shift, float qscale,
                                              void* stream) {
  if (B <= 0 || H <= 0 || C != 32 * H || W <= 0 || W * W > WA_MAX_RASTER_N ||
      S <= 0 || S % W || shift < 0 || shift >= W ||
      (long long)B * (S / W) * (S / W) * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  WaArgs a{};
  a.q = static_cast<const bf16*>(qkv);
  a.bias = static_cast<const float*>(table);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.N = W * W;
  a.nW = 1;
  a.W = W;
  a.S = S;
  a.shift = shift;
  a.C = C;
  a.n_windows = B * (S / W) * (S / W);
  a.qscale = qscale;
  return (int)launch_wa<true>(a, static_cast<cudaStream_t>(stream));
}
