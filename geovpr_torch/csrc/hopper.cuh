// Hopper (sm_90a) building blocks of the TMA-fed kernels (hopper_gemm.cuh,
// hopper_gemm_s8.cuh, mhsa.cu, mhsa_int8.cu, swin_attn.cu, patch_merge.cu,
// mlp_int8.cu, swin_train.cu):
// mbarriers, TMA tile loads and stores, bulk copies, warpgroup matrix
// multiplies (wgmma, bf16 and int8) on 128-byte-swizzled shared-memory
// tiles, ldmatrix on the same tiles, and the host's tensor-map encoding.
//
// Every GEMM tile here is 128 bytes (64 bf16, 128 int8) wide in its
// contiguous dimension, written by TMA with CU_TENSOR_MAP_SWIZZLE_128B at a
// 1024-byte-aligned address: row r of the tile sits at r * 128 bytes, its
// 16-byte chunks permuted by r % 8. (K2's and K5's int8 q and k tiles are
// 64 bytes wide, with the 64-byte swizzle, read by ldmatrix: mhsa_int8.cu,
// swin_attn.cu; so are the one-head bf16 tiles of K9's core backward,
// swin_train.cu.) wgmma reads such a tile through a descriptor (PTX ISA,
// "Matrix Descriptor Format"): the start address, the leading and stride
// byte offsets (LBO, SBO) and the 128-byte swizzle mode.
//   K-major operand (K contiguous: A of the forward products, K of q k^T,
//     both operands of the int8 products, the (in, out) weights of the
//     training backward's da and dh): rows are M or N, 8 rows make one
//     core group, SBO = 1024 bytes to the next 8 rows, LBO unused; the
//     k-th 32-byte slice (16 bf16 or 32 int8) starts k * 32 bytes in.
//   MN-major operand (MN contiguous: W of the projections, V of P V, both
//     operands of a weight gradient; the transpose bit set): rows are k,
//     SBO = 1024 bytes to the next 8 k, LBO = the distance between 64-wide
//     MN chunks; the k-th 16-deep slice starts k * 2048 bytes in.
// The tensor map is encoded on the host by cuTensorMapEncodeTiled, reached
// through the runtime's cudaGetDriverEntryPoint, so the library needs no
// link to libcuda; it is passed to the kernel as a __grid_constant__
// parameter.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ device ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte-aligned address at or after p (dynamic shared memory
// is allocated with 1024 bytes of slack for this)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// waits until the barrier's phase of parity `parity` has completed; a
// phase that never completes (a fault in the pipeline) traps after ~2^26
// polls, seconds, instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box of `map` at the given element coordinates (innermost
// first) into shared memory at dst; completion is counted in bytes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A bulk copy of `bytes` (a multiple of 16) contiguous bytes from global
// memory at src (16-byte aligned) into shared memory at dst, completion
// counted in bytes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a 16-byte store that streams past the caches (the data is read again
// only by a later kernel)
__device__ __forceinline__ void st_global_cs(void* dst, uint4 v) {
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// TMA store of the box at the given coordinates from shared memory at src;
// elements out of bounds are not written. Tracked as a bulk group
// (bulk_commit, bulk_wait_read).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// waits until the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// orders this thread's shared-memory writes before a later TMA read of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// barrier `id` (1..15) over the first `count` threads of the CTA
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.b16 [%0], %1;" ::"r"(addr), "h"(v) : "memory");
}
__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// four 8 x 8 bf16 matrices, lanes 8 i .. 8 i + 7 giving the row addresses
// of matrix i; r[i] holds this lane's pair of matrix i (row lane / 4,
// columns 2 (lane % 4), + 1), or with kTrans of its transpose
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
}

// 2^x by the SFU's ex2, flushing a result below 2^-126 to 0 (exp2f keeps
// it as a subnormal: in the attentions' p = 2^min(s, 100), an f32 row sum
// or a bf16 p that a term below 2^-126 would change does not occur)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// descriptor of a 128-byte-swizzled tile (see the header note)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until at most kPending committed groups are still running
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// Orders the compiler's accesses of wgmma accumulators (or register A
// operands) against the asynchronous products: no instruction is emitted.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HP_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HP_D32 HP_D8(0), HP_D8(8), HP_D8(16), HP_D8(24)
#define HP_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"

// d (64 x 64, f32, the m64nNk16 accumulator layout: thread 32 w + 4 g + t
// of the warpgroup holds rows 16 w + g (+ 8) and columns 8 j + 2 t (+ 1) in
// d[4 j + 2 half + c]) = (accumulate ? d : 0) + A (64 x 16 shared tile;
// K-major when kTransA is 0, MN-major when 1) * B (16 x 64; K-major when
// kTransB is 0, MN-major when 1)
template <int kTransB, int kTransA = 0>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_R32
      ", %32, %33, p, 1, 1, %36, %35;\n}\n"
      : HP_D32
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB), "n"(kTransA));
}

// d (64 x 32) as wgmma_m64n64, N = 32 (d[4 j + 2 half + c], j < 4)
template <int kTransB, int kTransA = 0>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %20, %19;\n}\n"
      : HP_D8(0), HP_D8(8)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB), "n"(kTransA));
}

// the same with A (64 x 16) in registers, in the m16n8k16 A-fragment
// layout of each warp's 16 rows (a[0..3]: rows g / g + 8, k 2t / 2t + 8)
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HP_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(kTransB));
}

// d (64 x 128) as wgmma_m64n64, N = 128
template <int kTransB, int kTransA = 0>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, %68, %67;\n}\n"
      : HP_D32, HP_D8(32), HP_D8(40), HP_D8(48), HP_D8(56)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB), "n"(kTransA));
}

#define HP_I8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 128, s32, in wgmma_m64n128's accumulator layout) = (accumulate ?
// d : 0) + A (64 x 32 int8) * B (32 x 128 int8), both K-major shared
// tiles (int8 wgmma takes no transposed operand); exact int32 sums
__device__ __forceinline__ void wgmma_m64n128_s8(int (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p;\n}\n"
      : HP_I8(0), HP_I8(8), HP_I8(16), HP_I8(24), HP_I8(32), HP_I8(40),
        HP_I8(48), HP_I8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef HP_D8
#undef HP_D32
#undef HP_R32
#undef HP_I8

// -------------------------------------------------------------- host ----

typedef CUresult (*TmapEncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver the runtime loaded (looked up
// once); null where that driver has none
inline TmapEncodeFn tmap_encode_fn() {
  static const TmapEncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TmapEncodeFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of `type` and `rank` (<= 5) dims (sizes and byte strides
// innermost first; strides[0] is the stride of dim 1) read or written in
// boxes of box[] elements with the given swizzle (the box's contiguous
// width in bytes at most the swizzle's); elements out of bounds read as
// zero and are not written. False if the encoding is refused (or the base
// is not 16-byte aligned).
inline bool make_tmap_of(CUtensorMap* map, CUtensorMapDataType type,
                         CUtensorMapSwizzle swizzle, const void* base,
                         int rank, const cuuint64_t* dims,
                         const cuuint64_t* strides, const cuuint32_t* box) {
  const TmapEncodeFn enc = tmap_encode_fn();
  if (enc == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0)
    return false;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return enc(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims,
             strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a bf16 tensor map in boxes 64 elements (128 bytes) wide, 128-byte
// swizzle
inline bool make_tmap(CUtensorMap* map, const void* base, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box) {
  return make_tmap_of(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      CU_TENSOR_MAP_SWIZZLE_128B, base, rank, dims, strides,
                      box);
}

}  // namespace
