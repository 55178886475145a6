// The ViT attention half-block's training backward for Hopper (sm_90a), on
// the (B, N, D) token stream of a DINOv2 block, head dim 64, from the
// residuals of the training forward K8a:
//
//   K8a (forward):  K1 (mhsa.cu), whose launches write qkv (post-bias,
//                   unscaled) and ctx to device memory; the training
//                   forward keeps them. The p that the core here recomputes
//                   (vit_attn.cuh) is the one its attention rounds to bf16.
//   K8b (core bwd): dqkv from the saved qkv and da = dL/dctx, with p
//                   recomputed
//   K8c (all bwd):  dy = g gamma, da = dy Wo^T, dgamma (the y = ctx Wo + bo
//                   recompute), dWo, dbo, the core, the LN recompute, dWqkv,
//                   dbqkv, dh = dqkv Wqkv^T, the LN VJP -> dx = g + dx_ln,
//                   dls, dlb
//
// Replaces geovpr/ops/pallas_mhsa.py::_attn_bwd_pallas (_attn_bwd_kernel,
// _attn_bwd_kernel_v3) and _mhsa_bwd_all_pallas (_mhsa_bwd_all_kernel).
//
// Numerics follow JAX's masked bodies (_attn_bwd_kernel,
// _mhsa_bwd_all_kernel): p = exp(s - max) / sum recomputed in f32 from
// s = f32(q k^T) * dh^-0.5 with the keys >= N masked; dp = da v^T, ds =
// p (dp - sum_j dp p) in f32 (a sum, not da . ctx), ds * dh^-0.5 rounded
// to bf16 before dq = ds k and dk = ds^T q, dv = bf16(p)^T da. K8c rounds
// dy = g gamma, da, the LN output and dh to bf16 where JAX rounds them,
// sums dx = g + dx_ln in f32 and every weight gradient in f32 over all
// rows.
//
// Cross-CTA sums (the weight and bias gradients, dgamma, dls, dlb) are
// partials per CTA or chunk that one reduce_partials launch adds in a
// fixed order (train_gemm.cuh); dk and dv sum over all queries inside the
// CTA of their key tile. No atomics, so a training step repeats bit for
// bit.
//
// The core (K8b, and K8c's launch 5) is two launches over a grid of (64-row
// tiles, H, B), each CTA one consumer warpgroup and one producer warp that
// feeds it by TMA (3-d tensor maps, 64 x 64 bf16 boxes with the 128-byte
// swizzle; rows past the tensor's end read as zero) through an mbarrier
// ring, so that loads are in flight while the tensor cores and the ALUs
// work and the shared memory does not grow with N:
//   vit_bwd_dq_kernel: a query tile's q and da stay resident; the key
//     tiles stream three times (k, then k and v twice): pass 1 the rows'
//     max and sum (s = q k^T by wgmma), pass 2 sum_j dp p (dp = da v^T),
//     pass 3 ds, ds_b = bf16(ds * scale) and dq += ds_b k by K1's
//     register-A wgmma with k as the MN-major B operand (no transposed
//     copy), 32 keys a product (m64n32: at 64 the registers of s, dp, dq
//     and ds_b left none for the exponentials in flight, and ptxas
//     spilled). Pass 3 also stages bf16(p) and ds_b of each key tile and
//     stores them by TMA to two bf16 planes P and dS, (B H, N, N).
//   vit_bwd_dkdv_kernel: per key tile, the query tiles' P and dS columns
//     stream with q and da: dv += P^T da and dk += dS^T q by wgmma, the
//     P and dS tiles read as the MN-major A operand. Recomputing s^T,
//     dp^T and p^T here instead would cost a fourth exp and a third
//     quotient a score and two more products; the planes cost 2 x 2 B H
//     N^2 bytes written and read (50 MB at 16 x 257 x 768 x 12) and give
//     the same values: s^T = k q^T sums the same products in the same k16
//     steps as s = q k^T.
// A ring, not a head's k and v resident: it takes any N, and at N = 257
// holds as many CTAs an SM (two stages: the dq half 66 KB, three CTAs an
// SM at its 128 registers; the dk/dv half 66 KB, three). N = 257 ends on a
// one-key (one-query) tile: keys >= N are masked in the softmax, TMA drops
// the rows and keys >= N of every store, and a warp whose 16 rows are all
// >= N skips the softmax (its keys all masked). The wgmma's register A
// operands are formed outside any branch (a write under a divergent
// branch makes the compiler serialize the warpgroup's products). Each
// output element takes its k16 steps in the first port's order (keys in
// order for dq, queries for dk and dv, one wgmma each), every thread
// walks its columns in the first port's order for the statistics (their
// running maxima taken first, so that the exponentials do not wait on one
// another; the same operations) and sum_j dp p, and the quad sums are the
// first port's: where the card's wgmma and mma.sync k16 products round
// alike, dqkv keeps the first port's bits.
//
// K8c's launches (`geovpr_vit_train_bwd_all_parts` runs a range of them,
// for timing one by one): 0 dy, 1 dbo, 2 da, 3 dWo, 4 dgamma, 5 the core,
// 6 the LN recompute, 7 dWqkv, 8 dbqkv, 9 dh, 10 the LN VJP. Its products
// run on hopper_gemm.cuh's persistent TMA + wgmma GEMM, as K9c's: da = dy
// Wo^T and dh = dqkv Wqkv^T read the (in, out) weights as the K-major B
// operand and round once to bf16; dWo = ctx^T dy and dWqkv = h^T dqkv read
// both operands as boxes of rows (A MN-major), split the M = B N rows into
// the first port's chunks (train_gemm.cuh's split_rows; the last chunk
// ends on M's tail of M mod 64 rows, which TMA zero-fills past M) whose f32
// partials one reduce_partials launch adds in order; dgamma recomputes y =
// ctx Wo + bo with the GY epilogue's 64-row partials. dy, the column sums,
// the LN recompute and VJP are the first port's row passes.
//
// What bounds it on the H100, at DINOv2-B/14 training shapes (B = 16,
// N = 257, D = 768, 12 heads; M = 4,112 rows): K8c ~52 GFLOP (GEMMs of
// 18 M D^2 and five N x N x dh products per head) against ~58 MB: 0.052 ms
// at 989 TFLOP/s, bound by operations; K8b ~8.1 GFLOP against ~44 MB (qkv,
// da, dqkv): 0.013 ms at 3.35 TB/s, bytes. The core does seven N x N x dh
// products where the bound counts five (s three times and dp twice in the
// dq half; the dk/dv half's two) and ~45 f32 instructions a score, most of
// them the three exp and two quotients of the dq half's passes (JAX's
// numerics: p recomputed from the row statistics, sum_j dp p as a sum),
// and moves the P and dS planes: its time goes to the ALUs and the wait
// on each product, not to the bytes. The measured
// times, from chip_smoke.py, are in PERF.md beside the card and its power
// limit. The kernels allocate nothing; the caller passes outputs and
// scratch.

#include "hopper_gemm.cuh"
#include "train_gemm.cuh"
#include "vit_attn.cuh"

namespace {

// ------------------------------------------------------------ K8b core ----

constexpr int VB_THREADS = 128 + 32;  // the consumer warpgroup + a producer
constexpr int VB_DQ_STAGES = 2;       // k and v tiles
constexpr int VB_KV_STAGES = 2;       // P, dS, q and da tiles
// q, da, the P and dS staging tiles, the ring, its barriers, align1024's
// slack
constexpr int VB_DQ_SMEM = 4 * VT_TILE + VB_DQ_STAGES * 2 * VT_TILE +
                           (2 * VB_DQ_STAGES + 1) * 8 + 1024;
constexpr int VB_KV_SMEM =
    VB_KV_STAGES * 4 * VT_TILE + 2 * VB_KV_STAGES * 8 + 1024;

// The softmax arithmetic of one 64 x 64 tile of scores s (and dp) in the
// accumulator layout, the first port's expressions walked in its order.
// kFull: all 64 columns (keys) are < N; else those at and past `cols` are
// masked.

// pass 1: the row statistics of rows g (st0) and g + 8 (st1): stat_add
// along each row's walk (8 j + 2 t + c, j then c), its running maxima
// taken first so that the exponentials do not wait on one another
template <bool kFull>
__device__ __forceinline__ void vb_stats(const float (&s)[32], int cols,
                                         int t, float scale, RowStat& st0,
                                         RowStat& st1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    RowStat& st = half ? st1 : st0;
    float v[16], m[17], x[16];
    m[0] = st.m;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[i] = s[4 * (i >> 1) + 2 * half + (i & 1)] * scale;
      const bool in = kFull || 8 * (i >> 1) + 2 * t + (i & 1) < cols;
      m[i + 1] = in && v[i] > m[i] ? v[i] : m[i];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = expf(v[i] > m[i] ? m[i] - v[i] : v[i] - m[i]);
    float l = st.l;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (kFull || 8 * (i >> 1) + 2 * t + (i & 1) < cols)
        l = v[i] > m[i] ? l * x[i] + 1.f : l + x[i];
    st.m = m[16];
    st.l = l;
  }
}

// pass 2: sum_j dp p of rows g (sub0) and g + 8 (sub1), this lane's keys
template <bool kFull>
__device__ __forceinline__ void vb_dp_p(const float (&s)[32],
                                        const float (&dp)[32], int cols, int t,
                                        float scale, const RowStat& st0,
                                        const RowStat& st1, float rl0,
                                        float rl1, float& sub0, float& sub1) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!kFull && 8 * j + 2 * t + (e & 1) >= cols) continue;
      if (e >= 2)
        sub1 += dp[4 * j + e] * vt_prob(s[4 * j + e], scale, st1.m, st1.l, rl1);
      else
        sub0 += dp[4 * j + e] * vt_prob(s[4 * j + e], scale, st0.m, st0.l, rl0);
    }
}

// pass 3: bf16(p) and ds_b = bf16(p (dp - sum_j dp p) scale) of the
// 16-key slice kl of a 32-key half tile (s, dp: m64n32 accumulators; its
// keys from key0 on) as A fragments (rows g / g + 8, keys 2t / 2t + 8: the
// accumulator layout of s); keys at and past `cols` masked
__device__ __forceinline__ void vb_ds(int kl, int key0, const float (&s)[16],
                                      const float (&dp)[16], int cols, int t,
                                      float scale, const RowStat& st0,
                                      const RowStat& st1, float rl0, float rl1,
                                      float sub0, float sub1,
                                      uint32_t (&pa)[4], uint32_t (&dsa)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = 8 * kl + 2 * r;
    const int half = r & 1;
    const int key = key0 + 8 * (r >> 1) + 2 * t;
    float p[2], ds[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      p[c] = key + c < cols
                 ? vt_prob(s[e + c], scale, half ? st1.m : st0.m,
                           half ? st1.l : st0.l, half ? rl1 : rl0)
                 : 0.f;
      ds[c] = p[c] * (dp[e + c] - (half ? sub1 : sub0)) * scale;
    }
    pa[r] = vt_pack(p[0], p[1]);
    dsa[r] = vt_pack(ds[0], ds[1]);
  }
}

// stores an A fragment of slice kc (vb_ds's layout) into its place in a
// 128-byte-swizzled 64 x 64 bf16 tile
__device__ __forceinline__ void vb_stage_frag(unsigned char* tile,
                                              const uint32_t (&a)[4], int kc,
                                              int lr0, int t) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lr = lr0 + 8 * (r & 1);
    const int j = 2 * kc + (r >> 1);
    st_shared_u32(smem_u32(tile + lr * 128 + ((j ^ (lr & 7)) << 4) + 4 * t),
                  a[r]);
  }
}

// dq of one query tile, and its rows of the P and dS planes (grid
// (ceil(N / 64), H, B)): tm_qkv maps qkv as (3D, N, B) and tm_da da as (D,
// N, B) in 64 x 64 x 1 boxes, tm_dqkv dqkv as qkv; tm_p and tm_ds map the
// bf16 planes P = bf16(p) and dS = ds_b, (B H, N, N) with rows padded to a
// multiple of 8, as (N keys, N queries, B H) in 64 x 64 x 1 boxes. scale =
// dh^-0.5.
__global__ void __launch_bounds__(VB_THREADS, 3)
vit_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                  const __grid_constant__ CUtensorMap tm_da,
                  const __grid_constant__ CUtensorMap tm_dqkv,
                  const __grid_constant__ CUtensorMap tm_p,
                  const __grid_constant__ CUtensorMap tm_ds, int N, int D,
                  int H, float scale) {
  extern __shared__ unsigned char vb_smem[];
  unsigned char* q_s = align1024(vb_smem);
  unsigned char* da_s = q_s + VT_TILE;
  unsigned char* p_s = da_s + VT_TILE;   // a key tile's P rows, staged
  unsigned char* ds_s = p_s + VT_TILE;   // and its dS rows
  unsigned char* ring = ds_s + VT_TILE;  // stage s: k, then v
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + VB_DQ_STAGES * 2 * VT_TILE);
  uint64_t* empty = full + VB_DQ_STAGES;
  uint64_t* qd_bar = empty + VB_DQ_STAGES;
  const int q0 = blockIdx.x * VT_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (N + VT_ROWS - 1) / VT_ROWS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < VB_DQ_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    mbar_init(qd_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer: q and da, then the key tiles three times (k alone for
    // pass 1, k and v for passes 2 and 3)
    if (threadIdx.x == 128) {
      mbar_expect_tx(qd_bar, 2 * VT_TILE);
      tma_load_3d(q_s, &tm_qkv, qd_bar, h * VT_DH, q0, b);
      tma_load_3d(da_s, &tm_da, qd_bar, h * VT_DH, q0, b);
      for (int i = 0; i < 3 * tiles; ++i) {
        const int s = i % VB_DQ_STAGES;
        const int k0 = (i % tiles) * VT_ROWS;
        const bool with_v = i >= tiles;
        unsigned char* st = ring + s * 2 * VT_TILE;
        mbar_wait(empty + s, ((i / VB_DQ_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, with_v ? 2 * VT_TILE : VT_TILE);
        tma_load_3d(st, &tm_qkv, full + s, D + h * VT_DH, k0, b);
        if (with_v)
          tma_load_3d(st + VT_TILE, &tm_qkv, full + s, 2 * D + h * VT_DH, k0,
                      b);
      }
    }
    return;
  }

  // the consumer warpgroup: thread 32 w + 4 g + t holds query rows
  // 16 w + g and 16 w + g + 8, keys 8 j + 2 t (+ 1) of each tile
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int t = tid & 3;
  const int lr0 = warp * 16 + ((tid & 31) >> 2);
  // a warp whose 16 rows are all >= N skips the statistics (its rows are
  // never stored)
  const bool live = q0 + 16 * warp < N;
  mbar_wait(qd_bar, 0);
  float s[32], dp[32];
  int step = 0;

  // pass 1: the row statistics, each thread walking its keys in order
  RowStat st0{-INFINITY, 0.f}, st1{-INFINITY, 0.f};
  for (int i = 0; i < tiles; ++i, ++step) {
    const int sg = step % VB_DQ_STAGES;
    const unsigned char* k_t = ring + sg * 2 * VT_TILE;
    mbar_wait(full + sg, (step / VB_DQ_STAGES) & 1);
    vt_product(s, q_s, k_t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (tid == 0) mbar_arrive(empty + sg);
    const int kv = N - i * VT_ROWS;
    if (live && kv >= VT_ROWS)
      vb_stats<true>(s, kv, t, scale, st0, st1);
    else if (live)
      vb_stats<false>(s, kv, t, scale, st0, st1);
  }
  stat_reduce(st0);
  stat_reduce(st1);

  // pass 2: sum_j dp p of rows g, g + 8
  float sub0 = 0.f, sub1 = 0.f;
  const float rl0 = __frcp_rn(st0.l), rl1 = __frcp_rn(st1.l);
  for (int i = 0; i < tiles; ++i, ++step) {
    const int sg = step % VB_DQ_STAGES;
    const unsigned char* k_t = ring + sg * 2 * VT_TILE;
    mbar_wait(full + sg, (step / VB_DQ_STAGES) & 1);
    vt_product(s, q_s, k_t);
    vt_product(dp, da_s, k_t + VT_TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (tid == 0) mbar_arrive(empty + sg);
    const int kv = N - i * VT_ROWS;
    if (live && kv >= VT_ROWS)
      vb_dp_p<true>(s, dp, kv, t, scale, st0, st1, rl0, rl1, sub0, sub1);
    else if (live)
      vb_dp_p<false>(s, dp, kv, t, scale, st0, st1, rl0, rl1, sub0, sub1);
  }
  sub0 = quad_sum(sub0);
  sub1 = quad_sum(sub1);

  // pass 3: ds, ds_b and dq += ds_b k, 16 keys a wgmma, keys in order, s
  // and dp 32 keys a product; bf16(p) and ds_b of each key tile staged and
  // stored by TMA to the P and dS planes (rows and keys >= N dropped) for
  // the dk/dv half. Every warp runs one code path (a dead warp masks all
  // its keys, so that its p is 0, not exp(inf)).
  float dq[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dq[e] = 0.f;
  float s16[16], dp16[16];
  for (int i = 0; i < tiles; ++i, ++step) {
    const int sg = step % VB_DQ_STAGES;
    const unsigned char* k_t = ring + sg * 2 * VT_TILE;
    mbar_wait(full + sg, (step / VB_DQ_STAGES) & 1);
    const int kv = live ? N - i * VT_ROWS : 0;
    uint32_t dsa[4][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      vt_product32(s16, q_s, k_t + h2 * 4096);
      vt_product32(dp16, da_s, k_t + VT_TILE + h2 * 4096);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s16);
      fence_regs(dp16);
      // the last tile's stores have read the staging tiles
      if (h2 == 0 && i > 0) {
        if (tid == 0) bulk_wait_read();
        named_sync(1, 128);
      }
#pragma unroll
      for (int kl = 0; kl < 2; ++kl) {
        const int kc = 2 * h2 + kl;
        uint32_t pa[4];
        vb_ds(kl, 16 * kc, s16, dp16, kv, t, scale, st0, st1, rl0, rl1,
              sub0, sub1, pa, dsa[kc]);
        vb_stage_frag(p_s, pa, kc, lr0, t);
        vb_stage_frag(ds_s, dsa[kc], kc, lr0, t);
      }
      fence_regs(dsa[2 * h2]);
      fence_regs(dsa[2 * h2 + 1]);
      fence_regs(dq);
      wgmma_fence();
      vt_acc(dq, dsa[2 * h2], k_t, 2 * h2);
      vt_acc(dq, dsa[2 * h2 + 1], k_t, 2 * h2 + 1);
      wgmma_commit();
    }
    fence_proxy_async();
    named_sync(1, 128);
    if (tid == 0) {
      tma_store_3d(&tm_p, p_s, i * VT_ROWS, q0, b * H + h);
      tma_store_3d(&tm_ds, ds_s, i * VT_ROWS, q0, b * H + h);
      bulk_commit();
    }
    wgmma_wait<0>();
    fence_regs(dq);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) fence_regs(dsa[kc]);
    if (tid == 0) mbar_arrive(empty + sg);
  }

  // dq over the q tile (no product reads it now), stored by TMA, which
  // drops the rows >= N
  named_sync(1, 128);
  vt_stage(q_s, dq, lr0, t);
  fence_proxy_async();
  named_sync(1, 128);
  if (tid == 0) {
    tma_store_3d(&tm_dqkv, q_s, h * VT_DH, q0, b);
    bulk_commit();
    bulk_wait_read();
  }
}

// dk = dS^T q and dv = P^T da of one key tile (grid (ceil(N / 64), H,
// B)), summed over the query tiles in order, 16 queries a wgmma: the P and
// dS tiles (queries x keys) read as the MN-major A operand, q and da as
// the MN-major B. tm_p, tm_ds, tm_qkv, tm_da and tm_dqkv as
// vit_bwd_dq_kernel's.
__global__ void __launch_bounds__(VB_THREADS, 3)
vit_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_p,
                    const __grid_constant__ CUtensorMap tm_ds,
                    const __grid_constant__ CUtensorMap tm_qkv,
                    const __grid_constant__ CUtensorMap tm_da,
                    const __grid_constant__ CUtensorMap tm_dqkv, int N, int D,
                    int H) {
  extern __shared__ unsigned char vb_smem[];
  unsigned char* ring = align1024(vb_smem);  // stage s: P, dS, q, da
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + VB_KV_STAGES * 4 * VT_TILE);
  uint64_t* empty = full + VB_KV_STAGES;
  const int k0 = blockIdx.x * VT_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (N + VT_ROWS - 1) / VT_ROWS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < VB_KV_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer: each query tile's P and dS rows (this key tile's
    // columns), q and da
    if (threadIdx.x == 128) {
      for (int i = 0; i < tiles; ++i) {
        const int s = i % VB_KV_STAGES;
        unsigned char* st = ring + s * 4 * VT_TILE;
        mbar_wait(empty + s, ((i / VB_KV_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 4 * VT_TILE);
        tma_load_3d(st, &tm_p, full + s, k0, i * VT_ROWS, b * H + h);
        tma_load_3d(st + VT_TILE, &tm_ds, full + s, k0, i * VT_ROWS,
                    b * H + h);
        tma_load_3d(st + 2 * VT_TILE, &tm_qkv, full + s, h * VT_DH,
                    i * VT_ROWS, b);
        tma_load_3d(st + 3 * VT_TILE, &tm_da, full + s, h * VT_DH,
                    i * VT_ROWS, b);
      }
    }
    return;
  }

  // the consumer warpgroup: key rows 16 w + g and 16 w + g + 8
  const int tid = threadIdx.x;
  const int t = tid & 3;
  const int lr0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  float dk[32], dv[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    dk[e] = 0.f;
    dv[e] = 0.f;
  }
  for (int i = 0; i < tiles; ++i) {
    const int sg = i % VB_KV_STAGES;
    const unsigned char* p_t = ring + sg * 4 * VT_TILE;
    const unsigned char* ds_t = p_t + VT_TILE;
    const unsigned char* q_t = p_t + 2 * VT_TILE;
    const unsigned char* da_t = p_t + 3 * VT_TILE;
    mbar_wait(full + sg, (i / VB_KV_STAGES) & 1);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_m64n64<1, 1>(dv, sw128_desc(p_t + kc * 2048, 8192, 1024),
                         sw128_desc(da_t + kc * 2048, 1024, 1024), 1);
      wgmma_m64n64<1, 1>(dk, sw128_desc(ds_t + kc * 2048, 8192, 1024),
                         sw128_desc(q_t + kc * 2048, 1024, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (tid == 0) mbar_arrive(empty + sg);
  }

  // dk and dv over the first stage (every load has been consumed), stored
  // by TMA (rows >= N dropped)
  named_sync(1, 128);
  vt_stage(ring, dk, lr0, t);
  vt_stage(ring + VT_TILE, dv, lr0, t);
  fence_proxy_async();
  named_sync(1, 128);
  if (tid == 0) {
    tma_store_3d(&tm_dqkv, ring, D + h * VT_DH, k0, b);
    tma_store_3d(&tm_dqkv, ring + VT_TILE, 2 * D + h * VT_DH, k0, b);
    bulk_commit();
    bulk_wait_read();
  }
}

// out = bf16(x * mul[col]) in f32 over an (M, C) bf16 matrix
__global__ void scale_cols_kernel(const bf16* __restrict__ x,
                                  const float* __restrict__ mul, size_t n,
                                  int C, bf16* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16(__bfloat162float(x[i]) * mul[i % C]);
}

// ---------------------------------------------------------------- host ----

bool vit_shapes_ok(int B, int N, int D, int H) {
  return B > 0 && N > 0 && H > 0 && B <= 65535 && H <= 65535 &&
         D == H * VT_DH && (long long)B * N <= 0x7fffffff;
}

// the (cols, N, B) view of a (B*N, cols) bf16 matrix in 64 x 64 x 1 boxes
bool vt_map(CUtensorMap* m, const bf16* a, int cols, int N, int B) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)N * cols * 2};
  const cuuint32_t box[3] = {VT_DH, VT_ROWS, 1};
  return make_tmap(m, a, 3, dims, strides, box);
}

// the P and dS planes' row length: N rounded up to 8 (TMA strides are
// multiples of 16 bytes)
long long vit_plane_ld(int N) { return (N + 7) / 8 * 8; }

// bf16 elements of the core's scratch: the P and dS planes
long long vit_core_scratch_elems(int B, int N, int H) {
  return 2LL * B * H * N * vit_plane_ld(N);
}

cudaError_t vit_core_bwd(cudaStream_t st, const bf16* qkv, const bf16* da,
                         bf16* dqkv, bf16* pds, int B, int N, int D, int H,
                         float scale) {
  CUtensorMap tq, td, to, tp, tds;
  const long long ld = vit_plane_ld(N);
  const cuuint64_t pdims[3] = {(cuuint64_t)N, (cuuint64_t)N,
                               (cuuint64_t)B * H};
  const cuuint64_t pstrides[2] = {(cuuint64_t)ld * 2,
                                  (cuuint64_t)N * ld * 2};
  const cuuint32_t pbox[3] = {VT_ROWS, VT_ROWS, 1};
  if (!vt_map(&tq, qkv, 3 * D, N, B) || !vt_map(&td, da, D, N, B) ||
      !vt_map(&to, dqkv, 3 * D, N, B) ||
      !make_tmap(&tp, pds, 3, pdims, pstrides, pbox) ||
      !make_tmap(&tds, pds + (size_t)B * H * N * ld, 3, pdims, pstrides,
                 pbox))
    return cudaErrorInvalidValue;
  const dim3 grid((N + VT_ROWS - 1) / VT_ROWS, H, B);
  vit_bwd_dq_kernel<<<grid, VB_THREADS, VB_DQ_SMEM, st>>>(tq, td, to, tp, tds,
                                                         N, D, H, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  vit_bwd_dkdv_kernel<<<grid, VB_THREADS, VB_KV_SMEM, st>>>(tp, tds, tq, td,
                                                           to, N, D, H);
  return cudaGetLastError();
}

// f32 scratch K8c needs (the largest partial-sum buffer of its launches)
long long vit_bwd_scratch_floats(int M, int D) {
  int s1, c1, s3, c3;
  split_rows(M, cdiv(D, TG_BM) * cdiv(D, TG_BN), &s1, &c1);
  split_rows(M, cdiv(D, TG_BM) * cdiv(3 * D, TG_BN), &s3, &c3);
  long long need = (long long)s1 * D * D;
  need = std::max(need, (long long)s3 * D * 3 * D);
  need = std::max(need, (long long)cdiv(M, 64) * D);
  need = std::max(need, (long long)colsum_parts(M, 3 * D) * 3 * D);
  need = std::max(need, (long long)colsum_parts(M, D) * D);
  need = std::max(need, 2LL * LN_VJP_BLOCKS * LN_VJP_WARPS * D);
  return need;
}

}  // namespace

// Raises the kernels' dynamic shared-memory limits on the current device
// and finds the CUDA driver's tensor-map encoder; returns a cudaError_t as
// int.
extern "C" int geovpr_vit_train_init(void) {
  cudaError_t e;
  if (tmap_encode_fn() == nullptr) return (int)cudaErrorSymbolNotFound;
  if ((e = allow_gemm_smem<HG_EPI_NONE, true>()) != cudaSuccess ||
      (e = allow_gemm_smem<HG_EPI_F32, false, true>()) != cudaSuccess ||
      (e = allow_gemm_smem<HG_EPI_GY>()) != cudaSuccess ||
      (e = allow_smem(vit_bwd_dq_kernel, VB_DQ_SMEM)) != cudaSuccess)
    return (int)e;
  return (int)allow_smem(vit_bwd_dkdv_kernel, VB_KV_SMEM);
}

// Floats of f32 scratch geovpr_vit_train_bwd_all takes as `part`.
extern "C" long long geovpr_vit_train_scratch_floats(int B, int N, int D) {
  return vit_bwd_scratch_floats(B * N, D);
}

// bf16 elements of the core's scratch (geovpr_vit_train_bwd_core's pds).
extern "C" long long geovpr_vit_core_scratch_elems(int B, int N, int H) {
  return vit_core_scratch_elems(B, N, H);
}

// K8b. qkv (B*N, 3D), da (B*N, D) bf16 -> dqkv (B*N, 3D) bf16; scratch pds
// (geovpr_vit_core_scratch_elems bf16), all 16-byte aligned. scale =
// dh^-0.5. geovpr_vit_train_init must have run on the current device.
extern "C" int geovpr_vit_train_bwd_core(const void* qkv, const void* da,
                                         void* dqkv, void* pds, int B, int N,
                                         int D, int H, float scale,
                                         void* stream) {
  if (!vit_shapes_ok(B, N, D, H)) return (int)cudaErrorInvalidValue;
  return (int)vit_core_bwd(static_cast<cudaStream_t>(stream),
                           static_cast<const bf16*>(qkv),
                           static_cast<const bf16*>(da), static_cast<bf16*>(dqkv),
                           static_cast<bf16*>(pds), B, N, D, H, scale);
}

// K8c's launches first..last: 0 dy = bf16(g gamma); 1 dbo = sum g gamma;
// 2 da = bf16(dy Wo^T); 3 dWo = ctx^T dy (and its reduce); 4 dgamma =
// sum g (ctx Wo + bo) (and its reduce); 5 the attention core; 6 the LN
// recompute; 7 dWqkv = h^T dqkv (and its reduce); 8 dbqkv = sum dqkv; 9 dh
// = bf16(dqkv Wqkv^T) into the da buffer; 10 the LN VJP with + g and its
// two reduces. Returns a cudaError_t as int. Inputs: x, ctx, g (B*N, D) and
// qkv (B*N, 3D) bf16; wqkv (D, 3D), wo (D, D) bf16; bo, gamma, ln_scale,
// ln_bias f32. Outputs: dx (B*N, D) bf16; dwqkv (D, 3D), dbqkv (3D), dwo
// (D, D), dbo, dgamma, dls, dlb (D) f32. Scratch: dy, da, h (B*N, D) and
// dqkv (B*N, 3D) bf16, stats (B*N) float2, pds bf16
// (geovpr_vit_core_scratch_elems), part f32
// (geovpr_vit_train_scratch_floats). A launch alone reads what the earlier
// launches of an earlier call left in the scratch. D <= 832 (the LN VJP's
// columns per lane). geovpr_vit_train_init must have run on the current
// device.
extern "C" int geovpr_vit_train_bwd_all_parts(
    const void* x, const void* qkv, const void* ctx, const void* g,
    const void* wqkv, const void* wo, const void* bo, const void* gamma,
    const void* ln_scale, const void* ln_bias, void* dy, void* da, void* dqkv,
    void* h, void* stats, void* pds, void* part, void* dx, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* dgamma, void* dls, void* dlb,
    int B, int N, int D, int H, float eps, float scale, int first, int last,
    void* stream) {
  if (!vit_shapes_ok(B, N, D, H) || D > 832 || first < 0 || last > 10 ||
      first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* ctxb = static_cast<const bf16*>(ctx);
  const bf16* wob = static_cast<const bf16*>(wo);
  bf16* dyb = static_cast<bf16*>(dy);
  bf16* dab = static_cast<bf16*>(da);
  bf16* dqkvb = static_cast<bf16*>(dqkv);
  bf16* hb = static_cast<bf16*>(h);
  float* pt = static_cast<float*>(part);
  const int parts = LN_VJP_BLOCKS * LN_VJP_WARPS;
  const size_t n = (size_t)M * D;
  const HgEpilogue ep{nullptr, nullptr, nullptr, 1.f, 0, pt};
  CUtensorMap ta;
  cudaError_t e = cudaSuccess;
  int S1, c1;
  for (int k = first; k <= last && e == cudaSuccess; ++k) {
    switch (k) {
      case 0:  // dy = bf16(g gamma)
        scale_cols_kernel<<<std::min(cdiv(n, 256), 4096), 256, 0, st>>>(
            gb, static_cast<const float*>(gamma), n, D, dyb);
        e = cudaGetLastError();
        break;
      case 1:  // dbo = sum g gamma in f32
        e = colsum(st, gb, M, D, pt, static_cast<float*>(dbo),
                   static_cast<const float*>(gamma));
        break;
      case 2:  // da = bf16(dy Wo^T), Wo (D, D) read K-major
        if (!map_rows(&ta, dyb, M, D)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_NONE, true>(ta, wob, D, D, ep, dab, M, st);
        break;
      case 3:  // dWo = ctx^T dy: partials over chunks of rows, then reduced
        split_rows(M, cdiv(D, TG_BM) * cdiv(D, TG_BN), &S1, &c1);
        if (!map_tiles64(&ta, ctxb, M, D)) return (int)cudaErrorInvalidValue;
        if ((e = launch_gemm<HG_EPI_F32, false, true>(
                 ta, dyb, M, D, ep, nullptr, D, st, c1)) == cudaSuccess)
          e = reduce(st, pt, S1, (size_t)D * D, static_cast<float*>(dwo));
        break;
      case 4:  // dgamma = sum g (ctx Wo + bo), y recomputed in f32 in 64-row
               // partials, then reduced
        if (!map_rows(&ta, ctxb, M, D)) return (int)cudaErrorInvalidValue;
        if ((e = launch_gemm<HG_EPI_GY>(
                 ta, wob, D, D,
                 HgEpilogue{static_cast<const float*>(bo), nullptr, gb, 1.f, 0,
                            pt},
                 nullptr, M, st)) == cudaSuccess)
          e = reduce(st, pt, cdiv(M, 64), D, static_cast<float*>(dgamma));
        break;
      case 5:  // the attention core: dqkv
        e = vit_core_bwd(st, static_cast<const bf16*>(qkv), dab, dqkvb,
                         static_cast<bf16*>(pds), B, N, D, H, scale);
        break;
      case 6:  // the LN recompute
        ln_stats_kernel<<<cdiv(M, 8), 256, 0, st>>>(
            xb, static_cast<const float*>(ln_scale),
            static_cast<const float*>(ln_bias), eps, M, D, hb,
            static_cast<float2*>(stats));
        e = cudaGetLastError();
        break;
      case 7:  // dWqkv = h^T dqkv, as dWo
        split_rows(M, cdiv(D, TG_BM) * cdiv(3 * D, TG_BN), &S1, &c1);
        if (!map_tiles64(&ta, hb, M, D)) return (int)cudaErrorInvalidValue;
        if ((e = launch_gemm<HG_EPI_F32, false, true>(
                 ta, dqkvb, M, 3 * D, ep, nullptr, D, st, c1)) == cudaSuccess)
          e = reduce(st, pt, S1, (size_t)D * 3 * D,
                     static_cast<float*>(dwqkv));
        break;
      case 8:  // dbqkv = sum dqkv
        e = colsum(st, dqkvb, M, 3 * D, pt, static_cast<float*>(dbqkv));
        break;
      case 9:  // dh = bf16(dqkv Wqkv^T) into the da buffer, Wqkv (D, 3D)
               // read K-major
        if (!map_rows(&ta, dqkvb, M, 3 * D)) return (int)cudaErrorInvalidValue;
        e = launch_gemm<HG_EPI_NONE, true>(ta, static_cast<const bf16*>(wqkv),
                                           3 * D, D, ep, dab, M, st);
        break;
      default:  // the LN VJP with + g, and the partials of dls, dlb
        if ((e = ln_vjp(st, xb, dab, static_cast<const float2*>(stats),
                        static_cast<const float*>(ln_scale), gb, M, D,
                        static_cast<bf16*>(dx), pt, pt + (size_t)parts * D)) ==
                cudaSuccess &&
            (e = reduce(st, pt, parts, D, static_cast<float*>(dls))) ==
                cudaSuccess)
          e = reduce(st, pt + (size_t)parts * D, parts, D,
                     static_cast<float*>(dlb));
    }
  }
  return (int)e;
}

// K8c, all its launches (the whole backward).
extern "C" int geovpr_vit_train_bwd_all(
    const void* x, const void* qkv, const void* ctx, const void* g,
    const void* wqkv, const void* wo, const void* bo, const void* gamma,
    const void* ln_scale, const void* ln_bias, void* dy, void* da, void* dqkv,
    void* h, void* stats, void* pds, void* part, void* dx, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* dgamma, void* dls, void* dlb,
    int B, int N, int D, int H, float eps, float scale, void* stream) {
  return geovpr_vit_train_bwd_all_parts(
      x, qkv, ctx, g, wqkv, wo, bo, gamma, ln_scale, ln_bias, dy, da, dqkv, h,
      stats, pds, part, dx, dwqkv, dbqkv, dwo, dbo, dgamma, dls, dlb, B, N,
      D, H, eps, scale, 0, 10, stream);
}
