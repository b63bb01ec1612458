// Hopper (sm_90a) building blocks for hand-written kernels: mbarriers, TMA
// tile loads, wgmma with its shared-memory descriptors and register
// fragments, and the host-side tensor-map encoder. Header-only; a kernel
// source includes it (ops/_build.py hashes it with the source).
//
// Layout conventions used throughout:
//  * every shared tile is bf16 [rows][64], 128 bytes a row, written by TMA
//    with 128-byte swizzle and 1024-byte aligned, so an 8-row group is one
//    1024-byte swizzle atom;
//  * wgmma m64n64k16, fp32 accumulate. The accumulator d[32] of a
//    warpgroup thread (warp w of the group, lane l, g = l / 4,
//    c = 2 * (l % 4)) holds, for n-block j = 0..7,
//        d[4j + 0], d[4j + 1] = D[16w + g][8j + c], D[16w + g][8j + c + 1]
//        d[4j + 2], d[4j + 3] = D[16w + g + 8][8j + c], ... [8j + c + 1]
//    and an A fragment from registers (a[4], bf16 pairs) for k-step kk is
//        a[0] = A[16w + g][c, c+1]        a[1] = A[16w + g + 8][c, c+1]
//        a[2] = A[16w + g][c+8, c+9]      a[3] = A[16w + g + 8][c+8, c+9]
//    (columns relative to 16 kk), so accumulator n-blocks 2kk and 2kk + 1
//    are the A fragment of k-step kk: a score tile feeds the next product
//    from registers.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;               // rows of one TMA box
constexpr int kTileBytes = kTileRows * 128;  // a [64][64] bf16 tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// arrive and announce `bytes` of TMA traffic for the current phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A ring of `Stages` buffers: the stage to use next and its phase parity.
template <int Stages>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == Stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ------------------------------------------------------------ TMA

// One box of a 4-d tensor map into shared memory; coordinates innermost
// first. Completion (the box's bytes, out-of-bounds ones zero-filled) is
// reported to `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A contiguous copy (16-byte aligned, a multiple of 16 bytes) reported to
// `bar` like a TMA box.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------ wgmma

// Descriptor of a 128-byte-swizzled tile whose 8-row groups are 1024
// bytes apart. As a K-major operand (rows = M or N, the 64 columns = K) a
// k-step of 16 advances it by 32 bytes (+2); as an MN-major operand
// (rows = K, the 64 columns = N; wgmma's transpose flag) by 16 rows,
// 2048 bytes (+128). Both offsets (LBO, SBO) are the 1024-byte group
// stride: the MN-major one whose meaning the layout leaves open spans one
// 64-column atom, and N = 64 never steps past it.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>(1024 >> 4) << 16;  // leading byte offset
  d |= static_cast<uint64_t>(1024 >> 4) << 32;  // stride byte offset
  d |= static_cast<uint64_t>(1) << 62;          // 128-byte swizzle
  return d;
}
constexpr uint64_t kKStepK = 32 >> 4;     // K-major: 16 columns
constexpr uint64_t kKStepMN = 2048 >> 4;  // MN-major: 16 rows

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from touching accumulator registers across the
// asynchronous product (issue ... wait).
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_D32_OUT(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (+)= A . B, m64n64k16 bf16: A [64 x 16] and B [16 x 64] from shared
// memory (A K-major; B K-major for TransB = 0, MN-major for 1). scale_d = 0
// overwrites d.
template <int TransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOPPER_D32_OUT(d)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransB));
}

// d (+)= A . B with A from registers (the fragment in the file comment);
// scale_d = 0 overwrites d.
template <int TransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(TransB));
}

#undef HOPPER_D32
#undef HOPPER_D32_OUT

// two bf16 in one register, `lo` (the lower column) in the low half
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(~0u, x, 1));
  return fmaxf(x, __shfl_xor_sync(~0u, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(~0u, x, 1);
  return x + __shfl_xor_sync(~0u, x, 2);
}

// ------------------------------------------------------------ host

// A bf16 [B, S, H, 64] tensor (any batch, seq and head strides in
// elements, multiples of 8; unit stride along the 64) as a 4-d tensor map
// whose box is `rows` sequence positions of one (batch, head): a
// [rows][64] tile, 128-byte swizzled, rows past S zero-filled. Returns a
// CUresult (0 on success).
inline int encode_bhsd(CUtensorMap* map, const void* base, int B, int S, int H,
                       long long stride_b, long long stride_s,
                       long long stride_h, int rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  // cuTensorMapEncodeTiled, fetched through the runtime: the library
  // links no libcuda
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<Encode>(fn)
                                                : nullptr;
  }();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride_h) * 2,
                                 static_cast<cuuint64_t>(stride_s) * 2,
                                 static_cast<cuuint64_t>(stride_b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace hopper
