// The f32 forms of the ViT attention half-block's training backward for
// Hopper (sm_90a), for a DINOv2 built with compute_dtype="float32", on the
// (B, N, D) token stream, head dim 64, from the residuals of the training
// forward K8a (in f32: K1's f32 launches in f32_serving.cu, whose qkv and
// ctx the training forward keeps):
//
//   K8b.f32 (core bwd): dqkv from the saved qkv and da = dL/dctx, with p
//                       recomputed
//   K8c.f32 (all bwd):  dy = g gamma, dbo, da = dy Wo^T, dWo, dgamma (the
//                       y = ctx Wo + bo recompute), the core, the LN
//                       recompute, dWqkv, dbqkv, dh = dqkv Wqkv^T, the LN
//                       VJP -> dx = g + dx_ln, dls, dlb
//
// Replaces, in f32, geovpr/ops/pallas_mhsa.py::_attn_bwd_pallas (:1166,
// pallas_call :1192; f32 takes the masked body _attn_bwd_kernel) and
// _mhsa_bwd_all_pallas (:1385, pallas_call :1409), whose Pallas bodies
// write x.dtype. The bf16 forms (mhsa_train.cu) are separate kernels;
// nothing here is shared with them.
//
// Numerics, as the masked bodies compute them in f32, with no rounding to
// a narrower type anywhere (JAX's rounding points, dy, da, the LN output
// and dh to x.dtype, are no-ops in f32):
// - s = (q . k) dh^-0.5 with the keys >= N masked; p = exp(s - max) / sum,
//   the two-pass softmax of K1.f32's attention (per-thread running max and
//   sum over the keys, combined across the row's threads, then expf and a
//   correctly rounded division);
// - dp = da v^T; ds = p (dp - sum_j dp p); dq = (ds dh^-0.5) k, dk =
//   (ds dh^-0.5)^T q, dv = p^T da;
// - products on the CUDA cores (FFMA), each output a sequential sum; no
//   TF32 (PERF.md: a single-pass TF32 product misses the f32 bound).
//
// The core (K8b.f32, and K8c.f32's launch 5) is two launches over a grid
// of (64-row tiles, H, B), 256 threads a CTA, 4 x 4 outputs a thread of
// each 64 x 64 product, its operands in shared memory (k-major, float4
// reads):
//   f32_core_dq_kernel: a query tile's q and da stay resident; the key
//     tiles are read three times: pass 1 the rows' max and sum (s), pass 2
//     sum_j dp p (s, dp), pass 3 ds and dq += (ds dh^-0.5) k (s, dp and
//     the product). Pass 3 also writes p and ds dh^-0.5 to two f32 planes
//     P and dS (B H, N, N rounded up to 4).
//   f32_core_dkdv_kernel: per key tile, the query tiles' P and dS columns
//     with q and da: dv += P^T da and dk += dS^T q.
// Recomputing s twice and dp once in the dq half costs three N x N x dh
// products a head; the planes cost 2 x 4 B H N^2 bytes written and read
// (139 MB at large-14, B = 16). Keys >= N are masked in the softmax (their
// k and v rows read as zero); rows >= N read as zero and are not stored.
//
// K8c.f32's launches (`geovpr_vit_f32_bwd_all_parts` runs a range of them,
// for timing one by one): 0 dy, 1 dbo, 2 da, 3 dWo, 4 dgamma, 5 the core,
// 6 the LN recompute, 7 dWqkv, 8 dbqkv, 9 dh, 10 the LN VJP. Its products
// run on f32_gemm.cuh's FFMA GEMM: da = dy Wo^T and dh = dqkv Wqkv^T read
// the (in, out) weights transposed (kTW); dWo = ctx^T dy and dWqkv = h^T
// dqkv read the row-major activations as A^T (kTA), in train_gemm.cuh's
// split_rows chunks of rows (counted over the GEMM's 128 x 128 tiles)
// whose f32 partials one reduce_partials launch adds in order; dgamma
// recomputes y = ctx Wo + bo with the GY epilogue's 128-row partials. dy,
// the column sums, the LN recompute and VJP are row passes in f32. No
// atomics: a training step repeats bit for bit.
//
// The f32 Swin training backward, for a Swin built with
// compute_dtype="float32" (window 12, head dim 32, on the raster stream,
// from the residuals of K9a.f32 in f32_serving.cu: qkv and ctx in raster
// order, the normalised p (BW, H, N, N) in window order):
//
//   K9b.f32 (core bwd): dqkv and dbias from the stored p, no recompute:
//                       dp = da v^T, ds = p (dp - sum_j dp p), dbias = sum
//                       of ds over the windows, dq = (ds dh^-0.5) k, dk =
//                       (ds dh^-0.5)^T q, dv = p^T da
//   K9c.f32 (all bwd):  da = g Wo^T, dWo, dbo, the core, the LN recompute,
//                       dWqkv, dbqkv, dh = dqkv Wqkv^T, the LN VJP -> dx,
//                       dls, dlb (K8c.f32's launches without dy and dgamma:
//                       Swin has no LayerScale, and the residual stays
//                       outside)
//
// Replaces, in f32, pallas_swin_block.py::_swin_attn_bwd_pallas (:1351,
// pallas_call :1369, body _train_bwd_kernel :704) and
// _swin_attn_bwd_all_pallas (:910, pallas_call :934, body
// _train_bwd_all_kernel :783), whose bodies write x.dtype. The core is one
// launch over (window, head) CTAs (f32_swin_core_kernel: the head's q, k,
// v, da rows and its p plane in shared memory, 156 KB; the window's tokens
// addressed in the raster stream through the cyclic shift), writing ds to
// an f32 plane that a column-sum launch and its reduce add over the
// windows in a fixed order (no atomics). K9c.f32's products, column sums
// and LN passes are K8c.f32's.
//
// What bounds it on the H100: operations. At DINOv2-B/14 training shapes
// (B = 16, N = 257, D = 768, 12 heads) K8c.f32 is ~51.8 GFLOP (18 M D^2 of
// products and five N x N x dh products a head), ~0.77 ms at the CUDA
// cores' ~67 TFLOP/s; K9c.f32 at Swin-B-384's stage 0 (B = 16, C = 128, 4
// heads) is 38.7 GFLOP of products and 21.7 of the core, ~0.90 ms, and
// K9b.f32 at stage 3 2.7 GFLOP, 0.041 ms. The measured times, from
// chip_smoke.py, are in PERF.md beside the card and its power limit. The
// kernels allocate nothing; the caller passes outputs and scratch.

#include "f32_gemm.cuh"
#include "train_gemm.cuh"

namespace {

// ------------------------------------------------------------ K8b.f32 ----

constexpr int FC_T = 64;         // rows of a query or key tile
constexpr int FC_DH = 64;        // head dim
constexpr int FC_TILE = FC_T * FC_DH;
constexpr int FC_THREADS = 256;
constexpr int FC_DS_LD = 68;     // row stride of the staged ds^T tile
constexpr int FC_DQ_SMEM = 4 * (5 * FC_TILE + FC_T * FC_DS_LD);
constexpr int FC_KV_SMEM = 4 * (4 * FC_TILE);

struct CoreArgs {
  const float* qkv;  // (B*N, 3D)
  const float* da;   // (B*N, D)
  float* dqkv;       // (B*N, 3D)
  float* P;          // (B*H, N, ld): p
  float* dS;         // (B*H, N, ld): ds * dh^-0.5
  int N, D, H;
  long long ld;      // the planes' row length: N rounded up to 4
  float scale;       // dh^-0.5
};

// the keys past N (the tail tile's padding) are masked out of the softmax
__device__ __forceinline__ bool fc_key_in(int key, int N) { return key < N; }

// rows r0.. r0 + 63 (those < N) of the 64 columns at `col` of a (B*N, ldm)
// matrix of image b into dst transposed, dst[e][r] (rows >= N zero)
__device__ __forceinline__ void fc_load_t(float* dst, const float* src,
                                          long long ldm, int b, int N,
                                          int r0, int col) {
  for (int idx = threadIdx.x; idx < FC_TILE / 4; idx += FC_THREADS) {
    const int r = idx % FC_T, e4 = (idx / FC_T) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < N)
      v = f32_ld4(src + ((long long)b * N + r0 + r) * ldm + col + e4);
    dst[(e4 + 0) * FC_T + r] = v.x;
    dst[(e4 + 1) * FC_T + r] = v.y;
    dst[(e4 + 2) * FC_T + r] = v.z;
    dst[(e4 + 3) * FC_T + r] = v.w;
  }
}

// the same rows into dst as they are, dst[r][e]; `lim` bounds the
// columns (a plane's row length)
__device__ __forceinline__ void fc_load_n(float* dst, const float* src,
                                          long long ldm, long long row0,
                                          int rows, int col, long long lim) {
  for (int idx = threadIdx.x; idx < FC_TILE / 4; idx += FC_THREADS) {
    const int r = idx / (FC_DH / 4), e4 = (idx % (FC_DH / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && col + e4 < lim)
      v = f32_ld4(src + (row0 + r) * ldm + col + e4);
    *reinterpret_cast<float4*>(dst + r * FC_DH + e4) = v;
  }
}

// acc[i][j] += sum_k A[k][4 ty + i] B[k][4 tx + j], k < 64 (A, B k-major
// with row strides lda, ldb)
__device__ __forceinline__ void fc_mma(float (&acc)[4][4], const float* A,
                                       int lda, const float* B, int ldb,
                                       int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < FC_T; ++k) {
    const float4 a4 = f32_ld4(A + k * lda + 4 * ty);
    const float4 b4 = f32_ld4(B + k * ldb + 4 * tx);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void fc_zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// a row's 16 threads (the lanes of one half-warp) combined
__device__ __forceinline__ float fc_row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float fc_row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dq of one query tile (grid (ceil(N / 64), H, B)), and its rows of the P
// and dS planes
__global__ void __launch_bounds__(FC_THREADS, 2)
f32_core_dq_kernel(CoreArgs a) {
  extern __shared__ __align__(16) float fc_smem[];
  float* qT = fc_smem;          // [d][r]
  float* daT = qT + FC_TILE;    // [d][r]
  float* kT = daT + FC_TILE;    // [d][key]
  float* vT = kT + FC_TILE;     // [d][key]
  float* kN = vT + FC_TILE;     // [key][d]
  float* dsT = kN + FC_TILE;    // [key][r], rows of FC_DS_LD
  const int q0 = blockIdx.x * FC_T, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int N = a.N;
  const long long ld3 = 3LL * a.D;
  const int col = h * FC_DH;
  const int tiles = (N + FC_T - 1) / FC_T;
  fc_load_t(qT, a.qkv, ld3, b, N, q0, col);
  fc_load_t(daT, a.da, a.D, b, N, q0, col);

  // pass 1: this thread's running max and sum of its rows 4 ty + i over
  // its keys, then over the row's 16 threads
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float s[4][4], dp[4][4];
  for (int t = 0; t < tiles; ++t) {
    __syncthreads();  // the last tile is read (and q, da are staged)
    fc_load_t(kT, a.qkv, ld3, b, N, t * FC_T, a.D + col);
    __syncthreads();
    fc_zero(s);
    fc_mma(s, qT, FC_T, kT, FC_T, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!fc_key_in(t * FC_T + 4 * tx + j, N)) continue;
        const float v = __fmul_rn(s[i][j], a.scale);
        if (v > m[i]) {
          l[i] = __fmul_rn(l[i], expf(m[i] - v));
          m[i] = v;
        }
        l[i] = __fadd_rn(l[i], expf(v - m[i]));
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float mr = fc_row_max(m[i]);
    const float part =
        m[i] == -INFINITY ? 0.f : __fmul_rn(l[i], expf(m[i] - mr));
    m[i] = mr;
    l[i] = fc_row_sum(part);
  }

  // p of this thread's score (i, j) of key tile t (0 for a masked key)
  auto prob = [&](int t, int i, int j) -> float {
    if (!fc_key_in(t * FC_T + 4 * tx + j, N)) return 0.f;
    return __fdiv_rn(expf(__fmul_rn(s[i][j], a.scale) - m[i]), l[i]);
  };

  // pass 2: sum_j dp p of each row
  float sub[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    __syncthreads();
    fc_load_t(kT, a.qkv, ld3, b, N, t * FC_T, a.D + col);
    fc_load_t(vT, a.qkv, ld3, b, N, t * FC_T, 2 * a.D + col);
    __syncthreads();
    fc_zero(s);
    fc_zero(dp);
    fc_mma(s, qT, FC_T, kT, FC_T, ty, tx);
    fc_mma(dp, daT, FC_T, vT, FC_T, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sub[i] = fmaf(dp[i][j], prob(t, i, j), sub[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sub[i] = fc_row_sum(sub[i]);

  // pass 3: ds, the planes' rows and dq += (ds dh^-0.5) k
  const int bh = b * a.H + h;
  float dq[4][4];
  fc_zero(dq);
  for (int t = 0; t < tiles; ++t) {
    __syncthreads();
    fc_load_t(kT, a.qkv, ld3, b, N, t * FC_T, a.D + col);
    fc_load_t(vT, a.qkv, ld3, b, N, t * FC_T, 2 * a.D + col);
    fc_load_n(kN, a.qkv, ld3, (long long)b * N + t * FC_T, N - t * FC_T,
              a.D + col, ld3);
    __syncthreads();
    fc_zero(s);
    fc_zero(dp);
    fc_mma(s, qT, FC_T, kT, FC_T, ty, tx);
    fc_mma(dp, daT, FC_T, vT, FC_T, ty, tx);
    // each row's p and ds dh^-0.5: staged (ds transposed) for the dq
    // product and stored to the planes
    const int key0 = t * FC_T + 4 * tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float pv[4], dsv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pv[j] = prob(t, i, j);
        dsv[j] = __fmul_rn(__fmul_rn(pv[j], dp[i][j] - sub[i]), a.scale);
        dsT[(4 * tx + j) * FC_DS_LD + 4 * ty + i] = dsv[j];
      }
      const int r = q0 + 4 * ty + i;
      if (r >= N || key0 >= a.ld) continue;
      const long long at = ((long long)bh * N + r) * a.ld + key0;
      *reinterpret_cast<float4*>(a.P + at) =
          make_float4(pv[0], pv[1], pv[2], pv[3]);
      *reinterpret_cast<float4*>(a.dS + at) =
          make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();
    fc_mma(dq, dsT, FC_DS_LD, kN, FC_DH, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r < N)
      *reinterpret_cast<float4*>(a.dqkv + ((long long)b * N + r) * ld3 + col +
                                 4 * tx) =
          make_float4(dq[i][0], dq[i][1], dq[i][2], dq[i][3]);
  }
}

// dk = dS^T q and dv = P^T da of one key tile (grid (ceil(N / 64), H, B)),
// summed over the query tiles in order
__global__ void __launch_bounds__(FC_THREADS, 2)
f32_core_dkdv_kernel(CoreArgs a) {
  extern __shared__ __align__(16) float fc_smem[];
  float* ps = fc_smem;           // [query][key]
  float* dss = ps + FC_TILE;     // [query][key]
  float* qs = dss + FC_TILE;     // [query][d]
  float* das = qs + FC_TILE;     // [query][d]
  const int k0 = blockIdx.x * FC_T, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int N = a.N;
  const long long ld3 = 3LL * a.D;
  const int col = h * FC_DH;
  const long long plane0 = (long long)(b * a.H + h) * N;
  const int tiles = (N + FC_T - 1) / FC_T;
  float dk[4][4], dv[4][4];
  fc_zero(dk);
  fc_zero(dv);
  for (int t = 0; t < tiles; ++t) {
    const int rows = N - t * FC_T;
    __syncthreads();
    fc_load_n(ps, a.P, a.ld, plane0 + t * FC_T, rows, k0, a.ld);
    fc_load_n(dss, a.dS, a.ld, plane0 + t * FC_T, rows, k0, a.ld);
    fc_load_n(qs, a.qkv, ld3, (long long)b * N + t * FC_T, rows, col, ld3);
    fc_load_n(das, a.da, a.D, (long long)b * N + t * FC_T, rows, col, a.D);
    __syncthreads();
    fc_mma(dv, ps, FC_T, das, FC_DH, ty, tx);
    fc_mma(dk, dss, FC_T, qs, FC_DH, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= N) continue;
    float* o = a.dqkv + ((long long)b * N + key) * ld3 + col + 4 * tx;
    *reinterpret_cast<float4*>(o + a.D) =
        make_float4(dk[i][0], dk[i][1], dk[i][2], dk[i][3]);
    *reinterpret_cast<float4*>(o + 2 * a.D) =
        make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
  }
}

// ------------------------------------------------------ K8c.f32 rows ----

// out = x * mul[col] over an (M, C) f32 matrix
__global__ void f32_scale_cols_kernel(const float* __restrict__ x,
                                      const float* __restrict__ mul,
                                      size_t n, int C,
                                      float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __fmul_rn(x[i], mul[i % C]);
}

// part[z][c] = sum over rows [z * rchunk, (z + 1) * rchunk) of x[row][c],
// each term times mul[c] where mul is given
__global__ void f32_colsum_partials_kernel(const float* __restrict__ x,
                                           int M, int C, int rchunk,
                                           float* __restrict__ part,
                                           const float* __restrict__ mul) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int r1 = min(M, (blockIdx.y + 1) * rchunk);
  const float mc = mul ? mul[c] : 1.f;
  float s = 0.f;
  for (int r = blockIdx.y * rchunk; r < r1; ++r) {
    const float v = x[(size_t)r * C + c];
    s = __fadd_rn(s, mul ? __fmul_rn(v, mc) : v);
  }
  part[(size_t)blockIdx.y * C + c] = s;
}

// column sums of an f32 (M, C) matrix into out (C) through part
// (colsum_parts(M, C) * C), each term times mul[c] where mul is given
cudaError_t f32_colsum(cudaStream_t st, const float* x, int M, int C,
                       float* part, float* out, const float* mul = nullptr) {
  int S, chunk;
  split_rows(M, cdiv(C, 128), &S, &chunk);
  f32_colsum_partials_kernel<<<dim3(cdiv(C, 128), S), 128, 0, st>>>(
      x, M, C, chunk, part, mul);
  cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : reduce(st, part, S, C, out);
}

// the LN recompute, one warp a row: two-pass f32 statistics, h = xhat ls +
// lb and each row's (mean, 1/std)
__global__ void f32_ln_stats_kernel(const float* __restrict__ x,
                                    const float* __restrict__ ls,
                                    const float* __restrict__ lb, float eps,
                                    int M, int C, float* __restrict__ h,
                                    float2* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= M) return;
  const float* xr = x + (size_t)row * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += xr[c];
  const float mu = f32_warp_sum(s) / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = xr[c] - mu;
    q = fmaf(d, d, q);
  }
  const float rstd = 1.f / sqrtf(f32_warp_sum(q) / C + eps);
  for (int c = lane; c < C; c += 32)
    h[(size_t)row * C + c] =
        __fadd_rn(__fmul_rn(__fmul_rn(xr[c] - mu, rstd), ls[c]), lb[c]);
  if (lane == 0) stats[row] = make_float2(mu, rstd);
}

// The LN VJP, one warp a row, CPL = C / 32 columns a lane: dx = rstd (dh
// ls - mean(dh ls) - xhat mean(dh ls xhat)), + g with kG (K8c; Swin's K9c
// has no residual inside), and the warp's partial sums of dh xhat (dls)
// and dh (dlb) over its rows at row blockIdx.x * warps + warp of part_ls /
// part_lb.
template <int CPL, bool kG>
__global__ void __launch_bounds__(256)
f32_ln_vjp_kernel(const float* __restrict__ x, const float* __restrict__ dh,
                  const float2* __restrict__ stats,
                  const float* __restrict__ ls, const float* __restrict__ g,
                  int M, float* __restrict__ dx, float* __restrict__ part_ls,
                  float* __restrict__ part_lb) {
  constexpr int C = CPL * 32;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int wid = blockIdx.x * warps + (threadIdx.x >> 5);
  float acc_ls[CPL], acc_lb[CPL], lsv[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    acc_ls[i] = 0.f;
    acc_lb[i] = 0.f;
    lsv[i] = ls[lane + 32 * i];
  }
  for (int row = wid; row < M; row += gridDim.x * warps) {
    const float2 st = stats[row];
    float xh[CPL], dxh[CPL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const size_t o = (size_t)row * C + lane + 32 * i;
      xh[i] = __fmul_rn(x[o] - st.x, st.y);
      const float d = dh[o];
      acc_ls[i] = fmaf(d, xh[i], acc_ls[i]);
      acc_lb[i] += d;
      dxh[i] = __fmul_rn(d, lsv[i]);
      s1 += dxh[i];
      s2 = fmaf(dxh[i], xh[i], s2);
    }
    const float m1 = f32_warp_sum(s1) / C;
    const float m2 = f32_warp_sum(s2) / C;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const size_t o = (size_t)row * C + lane + 32 * i;
      const float v = __fmul_rn(st.y, dxh[i] - m1 - __fmul_rn(xh[i], m2));
      dx[o] = kG ? __fadd_rn(v, g[o]) : v;
    }
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    part_ls[(size_t)wid * C + lane + 32 * i] = acc_ls[i];
    part_lb[(size_t)wid * C + lane + 32 * i] = acc_lb[i];
  }
}

// the LN VJP of every row; g null: no residual (K9c)
cudaError_t f32_ln_vjp(cudaStream_t st, const float* x, const float* dh,
                       const float2* stats, const float* ls, const float* g,
                       int M, int C, float* dx, float* part_ls,
                       float* part_lb) {
  switch (C / 32) {
#define GEOVPR_F32_LN_VJP(cpl)                                              \
  case cpl:                                                                 \
    if (g)                                                                  \
      f32_ln_vjp_kernel<cpl, true>                                          \
          <<<LN_VJP_BLOCKS, LN_VJP_WARPS * 32, 0, st>>>(                    \
              x, dh, stats, ls, g, M, dx, part_ls, part_lb);                \
    else                                                                    \
      f32_ln_vjp_kernel<cpl, false>                                         \
          <<<LN_VJP_BLOCKS, LN_VJP_WARPS * 32, 0, st>>>(                    \
              x, dh, stats, ls, g, M, dx, part_ls, part_lb);                \
    break;
    GEOVPR_F32_LN_VJP(2) GEOVPR_F32_LN_VJP(4) GEOVPR_F32_LN_VJP(6)
    GEOVPR_F32_LN_VJP(8) GEOVPR_F32_LN_VJP(10) GEOVPR_F32_LN_VJP(12)
    GEOVPR_F32_LN_VJP(14) GEOVPR_F32_LN_VJP(16) GEOVPR_F32_LN_VJP(18)
    GEOVPR_F32_LN_VJP(20) GEOVPR_F32_LN_VJP(22) GEOVPR_F32_LN_VJP(24)
    GEOVPR_F32_LN_VJP(26)
#undef GEOVPR_F32_LN_VJP
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}


// ------------------------------------------------------------ K9b.f32 ----

constexpr int SC_N = 144;          // a window's tokens (window 12)
constexpr int SC_DH = 32;          // head dim
constexpr int SC_THREADS = 576;  // 18 warps: 8 query rows a warp
constexpr int SC_VLD = SC_DH + 4;  // v's row stride: float4 rows whose
                                   // quarter-warp reads are conflict-free
constexpr int SC_SMEM =
    4 * (SC_N * SC_N + 3 * SC_N * SC_DH + SC_N * SC_VLD + SC_N);

struct SwinCoreArgs {
  const float* qkv;  // (B*S*S, 3C), raster rows
  const float* p;    // (BW, H, N, N), window order
  const float* da;   // (B*S*S, C), raster rows
  float* dqkv;       // (B*S*S, 3C), raster rows
  float* ds;         // (BW, H, N, N): ds (not scaled), for dbias
  int S, W, shift, C, H;
  float scale;       // dh^-0.5
};

// the raster row of token i of window gw, in the frame rolled by -shift:
// token (ty, tx) of window (wy, wx) is ((Y + shift) mod S, (X + shift) mod
// S), as the forward's raster windows address it
__device__ __forceinline__ int sc_row(const SwinCoreArgs& a, int gw, int i) {
  const int nw = a.S / a.W;
  const int b = gw / (nw * nw), wi = gw - b * nw * nw;
  const int wy = wi / nw, wx = wi - wy * nw;
  const int ty = i / a.W, tx = i - ty * a.W;
  int ry = wy * a.W + ty + a.shift, rx = wx * a.W + tx + a.shift;
  if (ry >= a.S) ry -= a.S;
  if (rx >= a.S) rx -= a.S;
  return (b * a.S + ry) * a.S + rx;
}

__device__ __forceinline__ void sc_outer(float (&acc)[4][4], float4 a4,
                                         float4 b4) {
  const float a[4] = {a4.x, a4.y, a4.z, a4.w};
  const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

__device__ __forceinline__ void sc_store(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// The core backward of one (window, head), grid (BW, H): the head's q, k,
// v and da rows of the window and its p plane in shared memory; dv = p^T
// da; then, a warp a query row, dp = da v^T, ds = p (dp - sum_j dp p)
// (stored to the ds plane, and ds dh^-0.5 over p in shared memory); then
// dq = (ds dh^-0.5) k and dk = (ds dh^-0.5)^T q. Each output a sequential
// sum over its k index, 4 x 4 outputs a thread.
__global__ void __launch_bounds__(SC_THREADS)
f32_swin_core_kernel(SwinCoreArgs a) {
  extern __shared__ __align__(16) float sc_smem[];
  float* P = sc_smem;                  // [N][N]: p, then ds dh^-0.5
  float* qs = P + SC_N * SC_N;         // [N][DH]
  float* ks = qs + SC_N * SC_DH;       // [N][DH]
  float* das = ks + SC_N * SC_DH;      // [N][DH]
  float* vs = das + SC_N * SC_DH;      // [N][VLD]
  int* rows = reinterpret_cast<int*>(vs + SC_N * SC_VLD);
  const int gw = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int C = a.C;
  const long long ld3 = 3LL * C;
  const int col = h * SC_DH;
  const long long plane = ((long long)gw * a.H + h) * SC_N * SC_N;
  for (int i = tid; i < SC_N; i += SC_THREADS) rows[i] = sc_row(a, gw, i);
  __syncthreads();
  for (int idx = tid; idx < SC_N * SC_DH / 4; idx += SC_THREADS) {
    const int i = idx / (SC_DH / 4), c4 = (idx % (SC_DH / 4)) * 4;
    const float* src = a.qkv + (long long)rows[i] * ld3 + col + c4;
    *reinterpret_cast<float4*>(qs + i * SC_DH + c4) = f32_ld4(src);
    *reinterpret_cast<float4*>(ks + i * SC_DH + c4) = f32_ld4(src + C);
    *reinterpret_cast<float4*>(vs + i * SC_VLD + c4) = f32_ld4(src + 2 * C);
    *reinterpret_cast<float4*>(das + i * SC_DH + c4) =
        f32_ld4(a.da + (long long)rows[i] * C + col + c4);
  }
  for (int idx = tid; idx < SC_N * SC_N / 4; idx += SC_THREADS)
    *reinterpret_cast<float4*>(P + 4 * idx) = f32_ld4(a.p + plane + 4 * idx);
  __syncthreads();

  // dv = p^T da: a thread 4 keys x 4 columns, summed over the query rows
  constexpr int kItems = (SC_N / 4) * (SC_DH / 4);
  for (int it = tid; it < kItems; it += SC_THREADS) {
    const int j0 = (it / (SC_DH / 4)) * 4, d0 = (it % (SC_DH / 4)) * 4;
    float acc[4][4] = {};
    for (int i = 0; i < SC_N; ++i)
      sc_outer(acc, f32_ld4(P + i * SC_N + j0), f32_ld4(das + i * SC_DH + d0));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      sc_store(a.dqkv + (long long)rows[j0 + jj] * ld3 + 2 * C + col + d0,
               acc[jj]);
  }
  __syncthreads();

  // a warp a query row: dp, the row's sum of dp p, ds; a lane the keys
  // lane + 32 t
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kT = (SC_N + 31) / 32;
  for (int i = warp; i < SC_N; i += SC_THREADS / 32) {
    float4 dr[SC_DH / 4];
#pragma unroll
    for (int e = 0; e < SC_DH / 4; ++e) dr[e] = f32_ld4(das + i * SC_DH + 4 * e);
    float dp[kT], pr[kT];
    float sub = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int j = lane + 32 * t;
      dp[t] = pr[t] = 0.f;
      if (j >= SC_N) continue;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < SC_DH / 4; ++e) {
        const float4 v4 = f32_ld4(vs + j * SC_VLD + 4 * e);
        d = fmaf(dr[e].x, v4.x, d);
        d = fmaf(dr[e].y, v4.y, d);
        d = fmaf(dr[e].z, v4.z, d);
        d = fmaf(dr[e].w, v4.w, d);
      }
      dp[t] = d;
      pr[t] = P[i * SC_N + j];
      sub = fmaf(d, pr[t], sub);
    }
    sub = f32_warp_sum(sub);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int j = lane + 32 * t;
      if (j >= SC_N) continue;
      const float dsv = __fmul_rn(pr[t], dp[t] - sub);
      a.ds[plane + i * SC_N + j] = dsv;
      P[i * SC_N + j] = __fmul_rn(dsv, a.scale);
    }
  }
  __syncthreads();

  // dq = dsb k (4 query rows x 4 columns) and dk = dsb^T q (4 keys x 4
  // columns), dsb = ds dh^-0.5
  for (int it = tid; it < 2 * kItems; it += SC_THREADS) {
    const bool is_dk = it >= kItems;
    const int w = is_dk ? it - kItems : it;
    const int r0 = (w / (SC_DH / 4)) * 4, d0 = (w % (SC_DH / 4)) * 4;
    float acc[4][4] = {};
    if (is_dk) {
      for (int i = 0; i < SC_N; ++i)
        sc_outer(acc, f32_ld4(P + i * SC_N + r0), f32_ld4(qs + i * SC_DH + d0));
    } else {
      for (int j = 0; j < SC_N; j += 4) {
        float4 ar[4], bk[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ar[r] = f32_ld4(P + (r0 + r) * SC_N + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          bk[jj] = f32_ld4(ks + (j + jj) * SC_DH + d0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float av[4] = {ar[r].x, ar[r].y, ar[r].z, ar[r].w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            acc[r][0] = fmaf(av[jj], bk[jj].x, acc[r][0]);
            acc[r][1] = fmaf(av[jj], bk[jj].y, acc[r][1]);
            acc[r][2] = fmaf(av[jj], bk[jj].z, acc[r][2]);
            acc[r][3] = fmaf(av[jj], bk[jj].w, acc[r][3]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      sc_store(a.dqkv + (long long)rows[r0 + r] * ld3 + (is_dk ? C : 0) + col +
                   d0,
               acc[r]);
  }
}


// ---------------------------------------------------------------- host ----

bool f32_vit_shapes_ok(int B, int N, int D, int H) {
  return B > 0 && N > 0 && H > 0 && B <= 65535 && H <= 65535 &&
         D == H * FC_DH && (long long)B * N <= 0x7fffffff;
}

// the P and dS planes' row length: N rounded up to 4 (float4 stores)
long long f32_plane_ld(int N) { return (N + 3) / 4 * 4; }

long long f32_core_scratch_floats(int B, int N, int H) {
  return 2LL * B * H * N * f32_plane_ld(N);
}

cudaError_t f32_core_bwd(cudaStream_t st, const float* qkv, const float* da,
                         float* dqkv, float* pds, int B, int N, int D, int H,
                         float scale) {
  CoreArgs a{};
  a.qkv = qkv;
  a.da = da;
  a.dqkv = dqkv;
  a.ld = f32_plane_ld(N);
  a.P = pds;
  a.dS = pds + (size_t)B * H * N * a.ld;
  a.N = N;
  a.D = D;
  a.H = H;
  a.scale = scale;
  const dim3 grid((N + FC_T - 1) / FC_T, H, B);
  f32_core_dq_kernel<<<grid, FC_THREADS, FC_DQ_SMEM, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  f32_core_dkdv_kernel<<<grid, FC_THREADS, FC_KV_SMEM, st>>>(a);
  return cudaGetLastError();
}

// the split of a weight gradient's M rows into chunks (split_rows over the
// f32 GEMM's 128 x 128 tiles of its (rows, cols) output)
void f32_wgrad_split(int M, int rows, int cols, int* S, int* chunk) {
  split_rows(M, cdiv(rows, GB_M) * cdiv(cols, GB_N), S, chunk);
}

// f32 scratch K8c.f32 needs (the largest partial-sum buffer of its launches)
long long f32_bwd_scratch_floats(int M, int D) {
  int s1, c1, s3, c3;
  f32_wgrad_split(M, D, D, &s1, &c1);
  f32_wgrad_split(M, D, 3 * D, &s3, &c3);
  long long need = (long long)s1 * D * D;
  need = std::max(need, (long long)s3 * D * 3 * D);
  need = std::max(need, (long long)cdiv(M, GB_M) * D);
  need = std::max(need, (long long)colsum_parts(M, 3 * D) * 3 * D);
  need = std::max(need, (long long)colsum_parts(M, D) * D);
  need = std::max(need, 2LL * LN_VJP_BLOCKS * LN_VJP_WARPS * D);
  return need;
}


// K9 on f32: the window geometry the core takes (window 12, head dim 32)
bool swin_f32_shapes_ok(int B, int S, int C, int H, int win, int shift) {
  return B > 0 && H > 0 && H <= 65535 && C == H * SC_DH && win * win == SC_N &&
         S > 0 && S % win == 0 && shift >= 0 && shift < win &&
         (long long)B * S * S <= 0x7fffffff;
}

// the core's scratch: the ds plane, then the partial sums of its column
// sums over the windows
long long swin_f32_core_floats(int B, int S, int H, int win) {
  const int bw = B * (S / win) * (S / win);
  const int hnn = H * SC_N * SC_N;
  return (long long)bw * hnn + (long long)colsum_parts(bw, hnn) * hnn;
}

// K9b.f32: dqkv and dbias (the ds plane summed over the windows in a fixed
// order: partials, then one reduce)
cudaError_t swin_f32_core_bwd(cudaStream_t st, const float* qkv,
                              const float* p, const float* da, float* dqkv,
                              float* part, float* dbias, int B, int S, int C,
                              int H, int win, int shift, float scale) {
  SwinCoreArgs a{};
  a.qkv = qkv;
  a.p = p;
  a.da = da;
  a.dqkv = dqkv;
  a.ds = part;
  a.S = S;
  a.W = win;
  a.shift = shift;
  a.C = C;
  a.H = H;
  a.scale = scale;
  const int bw = B * (S / win) * (S / win);
  f32_swin_core_kernel<<<dim3(bw, H), SC_THREADS, SC_SMEM, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int hnn = H * SC_N * SC_N;
  return f32_colsum(st, part, bw, hnn, part + (size_t)bw * hnn, dbias);
}

// f32 scratch K9b.f32 and K9c.f32 take as `part`: the core's, or the
// largest partial-sum buffer of K9c's other launches
long long swin_f32_scratch_floats(int B, int S, int C, int H, int win) {
  const int M = B * S * S;
  int s1, c1, s3, c3;
  f32_wgrad_split(M, C, C, &s1, &c1);
  f32_wgrad_split(M, C, 3 * C, &s3, &c3);
  long long need = swin_f32_core_floats(B, S, H, win);
  need = std::max(need, (long long)s1 * C * C);
  need = std::max(need, (long long)s3 * C * 3 * C);
  need = std::max(need, (long long)colsum_parts(M, 3 * C) * 3 * C);
  need = std::max(need, (long long)colsum_parts(M, C) * C);
  need = std::max(need, 2LL * LN_VJP_BLOCKS * LN_VJP_WARPS * C);
  return need;
}

}  // namespace

// Raises the core's dynamic shared-memory limits on the current device;
// returns a cudaError_t as int.
extern "C" int geovpr_f32_train_init(void) {
  cudaError_t e = allow_smem(f32_core_dq_kernel, FC_DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  return (int)allow_smem(f32_core_dkdv_kernel, FC_KV_SMEM);
}

// Floats of f32 scratch geovpr_vit_f32_bwd_all takes as `part`.
extern "C" long long geovpr_vit_f32_scratch_floats(int B, int N, int D) {
  return f32_bwd_scratch_floats(B * N, D);
}

// Floats of the core's scratch (geovpr_vit_f32_bwd_core's pds): the P and
// dS planes.
extern "C" long long geovpr_vit_f32_core_scratch_floats(int B, int N, int H) {
  return f32_core_scratch_floats(B, N, H);
}

// K8b.f32. qkv (B*N, 3D), da (B*N, D) f32 -> dqkv (B*N, 3D) f32; scratch
// pds (geovpr_vit_f32_core_scratch_floats f32), all 16-byte aligned.
// scale = dh^-0.5. geovpr_f32_train_init must have run on the current
// device.
extern "C" int geovpr_vit_f32_bwd_core(const void* qkv, const void* da,
                                       void* dqkv, void* pds, int B, int N,
                                       int D, int H, float scale,
                                       void* stream) {
  if (!f32_vit_shapes_ok(B, N, D, H)) return (int)cudaErrorInvalidValue;
  return (int)f32_core_bwd(static_cast<cudaStream_t>(stream),
                           static_cast<const float*>(qkv),
                           static_cast<const float*>(da),
                           static_cast<float*>(dqkv), static_cast<float*>(pds),
                           B, N, D, H, scale);
}

// K8c.f32's launches first..last: 0 dy = g gamma; 1 dbo = sum g gamma; 2
// da = dy Wo^T; 3 dWo = ctx^T dy (and its reduce); 4 dgamma = sum g (ctx
// Wo + bo) (and its reduce); 5 the attention core; 6 the LN recompute; 7
// dWqkv = h^T dqkv (and its reduce); 8 dbqkv = sum dqkv; 9 dh = dqkv
// Wqkv^T into the da buffer; 10 the LN VJP with + g and its two reduces.
// Returns a cudaError_t as int. The arguments are geovpr_vit_train_bwd_
// all_parts' (mhsa_train.cu), every tensor f32: inputs x, ctx, g (B*N, D),
// qkv (B*N, 3D), wqkv (D, 3D), wo (D, D), bo, gamma, ln_scale, ln_bias;
// outputs dx (B*N, D), dwqkv, dbqkv, dwo, dbo, dgamma, dls, dlb; scratch
// dy, da, h (B*N, D), dqkv (B*N, 3D), stats (B*N) float2, pds
// (geovpr_vit_f32_core_scratch_floats), part
// (geovpr_vit_f32_scratch_floats); all 16-byte aligned. A launch alone
// reads what the earlier launches of an earlier call left in the scratch.
// D <= 832 (the LN VJP's columns per lane). geovpr_f32_train_init must have
// run on the current device.
extern "C" int geovpr_vit_f32_bwd_all_parts(
    const void* x, const void* qkv, const void* ctx, const void* g,
    const void* wqkv, const void* wo, const void* bo, const void* gamma,
    const void* ln_scale, const void* ln_bias, void* dy, void* da, void* dqkv,
    void* h, void* stats, void* pds, void* part, void* dx, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* dgamma, void* dls, void* dlb,
    int B, int N, int D, int H, float eps, float scale, int first, int last,
    void* stream) {
  if (!f32_vit_shapes_ok(B, N, D, H) || D > 832 || first < 0 || last > 10 ||
      first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  const float* ctxf = static_cast<const float*>(ctx);
  const float* wof = static_cast<const float*>(wo);
  float* dyf = static_cast<float*>(dy);
  float* daf = static_cast<float*>(da);
  float* dqkvf = static_cast<float*>(dqkv);
  float* hf = static_cast<float*>(h);
  float* pt = static_cast<float*>(part);
  const int parts = LN_VJP_BLOCKS * LN_VJP_WARPS;
  const size_t n = (size_t)M * D;
  cudaError_t e = cudaSuccess;
  int S1, c1;
  for (int k = first; k <= last && e == cudaSuccess; ++k) {
    switch (k) {
      case 0:  // dy = g gamma
        f32_scale_cols_kernel<<<std::min(cdiv(n, 256), 4096), 256, 0, st>>>(
            gf, static_cast<const float*>(gamma), n, D, dyf);
        e = cudaGetLastError();
        break;
      case 1:  // dbo = sum g gamma
        e = f32_colsum(st, gf, M, D, pt, static_cast<float*>(dbo),
                       static_cast<const float*>(gamma));
        break;
      case 2:  // da = dy Wo^T, Wo (D, D) read transposed
        e = launch_gemm_f32<EPI_NONE, false, true>(dyf, wof, nullptr, nullptr,
                                                   nullptr, daf, M, D, D, st);
        break;
      case 3:  // dWo = ctx^T dy: partials over chunks of rows, then reduced
        f32_wgrad_split(M, D, D, &S1, &c1);
        if ((e = launch_gemm_f32<EPI_NONE, true>(ctxf, dyf, nullptr, nullptr,
                                                 nullptr, pt, D, D, M, st,
                                                 c1)) == cudaSuccess)
          e = reduce(st, pt, S1, (size_t)D * D, static_cast<float*>(dwo));
        break;
      case 4:  // dgamma = sum g (ctx Wo + bo), 128-row partials, reduced
        if ((e = launch_gemm_f32<EPI_GY>(
                 ctxf, wof, static_cast<const float*>(bo), nullptr, gf, pt, M,
                 D, D, st)) == cudaSuccess)
          e = reduce(st, pt, cdiv(M, GB_M), D, static_cast<float*>(dgamma));
        break;
      case 5:  // the attention core: dqkv
        e = f32_core_bwd(st, static_cast<const float*>(qkv), daf, dqkvf,
                         static_cast<float*>(pds), B, N, D, H, scale);
        break;
      case 6:  // the LN recompute
        f32_ln_stats_kernel<<<cdiv(M, 8), 256, 0, st>>>(
            xf, static_cast<const float*>(ln_scale),
            static_cast<const float*>(ln_bias), eps, M, D, hf,
            static_cast<float2*>(stats));
        e = cudaGetLastError();
        break;
      case 7:  // dWqkv = h^T dqkv, as dWo
        f32_wgrad_split(M, D, 3 * D, &S1, &c1);
        if ((e = launch_gemm_f32<EPI_NONE, true>(hf, dqkvf, nullptr, nullptr,
                                                 nullptr, pt, D, 3 * D, M, st,
                                                 c1)) == cudaSuccess)
          e = reduce(st, pt, S1, (size_t)D * 3 * D,
                     static_cast<float*>(dwqkv));
        break;
      case 8:  // dbqkv = sum dqkv
        e = f32_colsum(st, dqkvf, M, 3 * D, pt, static_cast<float*>(dbqkv));
        break;
      case 9:  // dh = dqkv Wqkv^T into the da buffer, Wqkv (D, 3D) read
               // transposed
        e = launch_gemm_f32<EPI_NONE, false, true>(
            dqkvf, static_cast<const float*>(wqkv), nullptr, nullptr, nullptr,
            daf, M, D, 3 * D, st);
        break;
      default:  // the LN VJP with + g, and the partials of dls, dlb
        if ((e = f32_ln_vjp(st, xf, daf, static_cast<const float2*>(stats),
                            static_cast<const float*>(ln_scale), gf, M, D,
                            static_cast<float*>(dx), pt,
                            pt + (size_t)parts * D)) == cudaSuccess &&
            (e = reduce(st, pt, parts, D, static_cast<float*>(dls))) ==
                cudaSuccess)
          e = reduce(st, pt + (size_t)parts * D, parts, D,
                     static_cast<float*>(dlb));
    }
  }
  return (int)e;
}

// K8c.f32, all its launches (the whole backward).
extern "C" int geovpr_vit_f32_bwd_all(
    const void* x, const void* qkv, const void* ctx, const void* g,
    const void* wqkv, const void* wo, const void* bo, const void* gamma,
    const void* ln_scale, const void* ln_bias, void* dy, void* da, void* dqkv,
    void* h, void* stats, void* pds, void* part, void* dx, void* dwqkv,
    void* dbqkv, void* dwo, void* dbo, void* dgamma, void* dls, void* dlb,
    int B, int N, int D, int H, float eps, float scale, void* stream) {
  return geovpr_vit_f32_bwd_all_parts(
      x, qkv, ctx, g, wqkv, wo, bo, gamma, ln_scale, ln_bias, dy, da, dqkv, h,
      stats, pds, part, dx, dwqkv, dbqkv, dwo, dbo, dgamma, dls, dlb, B, N,
      D, H, eps, scale, 0, 10, stream);
}

extern "C" int geovpr_f32_serving_init(void);

// K9's f32 forms: raises the dynamic shared-memory limits of K9a.f32's
// window attention (geovpr_f32_serving_init, f32_serving.cu) and of the
// K9b.f32 core on the current device; returns a cudaError_t as int.
extern "C" int geovpr_f32_swin_train_init(void) {
  const int e = geovpr_f32_serving_init();
  if (e != 0) return e;
  return (int)allow_smem(f32_swin_core_kernel, SC_SMEM);
}

// Floats of f32 scratch geovpr_swin_f32_bwd_core and geovpr_swin_f32_bwd_all
// take as `part`.
extern "C" long long geovpr_swin_f32_scratch_floats(int B, int S, int C,
                                                    int H, int win) {
  return swin_f32_scratch_floats(B, S, C, H, win);
}

// K9b.f32. qkv (M, 3C) and da (M, C) raster rows, p (BW, H, N, N) window
// order, all f32 -> dqkv (M, 3C) raster rows and dbias (H, N, N); scratch
// part (geovpr_swin_f32_scratch_floats). M = B S^2, window 12, C = 32 H;
// all 16-byte aligned. scale = dh^-0.5. geovpr_f32_swin_train_init must
// have run on the current device.
extern "C" int geovpr_swin_f32_bwd_core(
    const void* qkv, const void* p, const void* da, void* dqkv, void* part,
    void* dbias, int B, int S, int C, int H, int win, int shift, float scale,
    void* stream) {
  if (!swin_f32_shapes_ok(B, S, C, H, win, shift))
    return (int)cudaErrorInvalidValue;
  return (int)swin_f32_core_bwd(
      static_cast<cudaStream_t>(stream), static_cast<const float*>(qkv),
      static_cast<const float*>(p), static_cast<const float*>(da),
      static_cast<float*>(dqkv), static_cast<float*>(part),
      static_cast<float*>(dbias), B, S, C, H, win, shift, scale);
}

// K9c.f32's launches first..last: 0 da = g Wo^T; 1 dWo = ctx^T g (and its
// reduce); 2 dbo = sum g; 3 the core (K9b.f32: dqkv, dbias); 4 the LN
// recompute (h, stats); 5 dWqkv = h^T dqkv (and its reduce); 6 dbqkv = sum
// dqkv; 7 dh = dqkv Wqkv^T into the da buffer; 8 the LN VJP -> dx and the
// reduces of dls, dlb. The arguments are geovpr_swin_train_bwd_all_parts'
// (swin_train.cu), every tensor f32: x, ctx, g (M, C) and qkv (M, 3C)
// raster rows, p (BW, H, N, N), wqkv (C, 3C), wo (C, C), ln_scale,
// ln_bias; outputs dx (M, C), dwqkv, dbqkv, dwo, dbo, dbias, dls, dlb;
// scratch da, h (M, C), dqkv (M, 3C), stats (M) float2, part
// (geovpr_swin_f32_scratch_floats); all 16-byte aligned. C <= 512. A
// launch alone reads what the earlier launches of an earlier call left in
// the scratch. geovpr_f32_swin_train_init must have run on the current
// device.
extern "C" int geovpr_swin_f32_bwd_all_parts(
    const void* x, const void* qkv, const void* p, const void* ctx,
    const void* g, const void* wqkv, const void* wo, const void* ln_scale,
    const void* ln_bias, void* da, void* dqkv, void* h, void* stats,
    void* part, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
    void* dbias, void* dls, void* dlb, int B, int S, int C, int H, int win,
    int shift, float eps, float scale, int first, int last, void* stream) {
  if (!swin_f32_shapes_ok(B, S, C, H, win, shift) || C > 512 || first < 0 ||
      last > 8 || first > last)
    return (int)cudaErrorInvalidValue;
  const int M = B * S * S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  float* daf = static_cast<float*>(da);
  float* dqkvf = static_cast<float*>(dqkv);
  float* hf = static_cast<float*>(h);
  float* pt = static_cast<float*>(part);
  const int parts = LN_VJP_BLOCKS * LN_VJP_WARPS;
  cudaError_t e = cudaSuccess;
  int S1, c1;
  for (int k = first; k <= last && e == cudaSuccess; ++k) {
    switch (k) {
      case 0:  // da = g Wo^T, Wo (C, C) read transposed
        e = launch_gemm_f32<EPI_NONE, false, true>(
            gf, static_cast<const float*>(wo), nullptr, nullptr, nullptr, daf,
            M, C, C, st);
        break;
      case 1:  // dWo = ctx^T g: partials over chunks of rows, then reduced
        f32_wgrad_split(M, C, C, &S1, &c1);
        if ((e = launch_gemm_f32<EPI_NONE, true>(
                 static_cast<const float*>(ctx), gf, nullptr, nullptr, nullptr,
                 pt, C, C, M, st, c1)) == cudaSuccess)
          e = reduce(st, pt, S1, (size_t)C * C, static_cast<float*>(dwo));
        break;
      case 2:  // dbo = sum g
        e = f32_colsum(st, gf, M, C, pt, static_cast<float*>(dbo));
        break;
      case 3:  // the attention core: dqkv, dbias
        e = swin_f32_core_bwd(st, static_cast<const float*>(qkv),
                              static_cast<const float*>(p), daf, dqkvf, pt,
                              static_cast<float*>(dbias), B, S, C, H, win,
                              shift, scale);
        break;
      case 4:  // the LN recompute
        f32_ln_stats_kernel<<<cdiv(M, 8), 256, 0, st>>>(
            static_cast<const float*>(x), static_cast<const float*>(ln_scale),
            static_cast<const float*>(ln_bias), eps, M, C, hf,
            static_cast<float2*>(stats));
        e = cudaGetLastError();
        break;
      case 5:  // dWqkv = h^T dqkv, as dWo
        f32_wgrad_split(M, C, 3 * C, &S1, &c1);
        if ((e = launch_gemm_f32<EPI_NONE, true>(hf, dqkvf, nullptr, nullptr,
                                                 nullptr, pt, C, 3 * C, M, st,
                                                 c1)) == cudaSuccess)
          e = reduce(st, pt, S1, (size_t)C * 3 * C,
                     static_cast<float*>(dwqkv));
        break;
      case 6:  // dbqkv = sum dqkv
        e = f32_colsum(st, dqkvf, M, 3 * C, pt, static_cast<float*>(dbqkv));
        break;
      case 7:  // dh = dqkv Wqkv^T into the da buffer
        e = launch_gemm_f32<EPI_NONE, false, true>(
            dqkvf, static_cast<const float*>(wqkv), nullptr, nullptr, nullptr,
            daf, M, C, 3 * C, st);
        break;
      default:  // the LN VJP, and the partials of dls, dlb
        if ((e = f32_ln_vjp(st, static_cast<const float*>(x), daf,
                            static_cast<const float2*>(stats),
                            static_cast<const float*>(ln_scale), nullptr, M,
                            C, static_cast<float*>(dx), pt,
                            pt + (size_t)parts * C)) == cudaSuccess &&
            (e = reduce(st, pt, parts, C, static_cast<float*>(dls))) ==
                cudaSuccess)
          e = reduce(st, pt + (size_t)parts * C, parts, C,
                     static_cast<float*>(dlb));
    }
  }
  return (int)e;
}

// K9c.f32, all its launches (the whole backward).
extern "C" int geovpr_swin_f32_bwd_all(
    const void* x, const void* qkv, const void* p, const void* ctx,
    const void* g, const void* wqkv, const void* wo, const void* ln_scale,
    const void* ln_bias, void* da, void* dqkv, void* h, void* stats,
    void* part, void* dx, void* dwqkv, void* dbqkv, void* dwo, void* dbo,
    void* dbias, void* dls, void* dlb, int B, int S, int C, int H, int win,
    int shift, float eps, float scale, void* stream) {
  return geovpr_swin_f32_bwd_all_parts(
      x, qkv, p, ctx, g, wqkv, wo, ln_scale, ln_bias, da, dqkv, h, stats,
      part, dx, dwqkv, dbqkv, dwo, dbo, dbias, dls, dlb, B, S, C, H, win,
      shift, eps, scale, 0, 8, stream);
}
