// The window geometry that K4/K5 (swin_attn.cu) and K9 (swin_train.cu)
// share, for Hopper (sm_90a): a window of W x W tokens of the raster
// stream read as its four (W/2) x (W/2) quarters, each one TMA box of a
// 4-d tensor map (columns, x, y, image) at its own raster origin. Swin
// shifts by W/2 or not at all, so the cyclic shift never splits a quarter:
// the wrapped quarters of the last window row and column are boxes at their
// wrapped origin, and two tokens of a wrapped window lie in different
// shift-mask regions iff their quarters differ in a wrapped direction.
// A box lands in shared memory box-major: token r = box * (W/2)^2 + ly *
// (W/2) + lx.

#pragma once

#include "hopper.cuh"

namespace {

// Geometry of the window attentions at window side W (4, 8, 12 or 16: N =
// W^2 a multiple of 16 up to 256), on boxes of two heads (64 bf16 columns,
// 128 bytes, the 128-byte swizzle).
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

// The box-major row of the token at window-order index r = ry W + rx.
template <int W>
__device__ __forceinline__ int sw_box_major(int r) {
  const int ry = r / W, rx = r % W, h = W / 2;
  return ((ry >= h ? 2 : 0) + (rx >= h ? 1 : 0)) * h * h + (ry % h) * h +
         rx % h;
}

}  // namespace
