// Hopper (sm_90a) building blocks for hand-written kernels: mbarriers, TMA
// tile loads, wgmma with its shared-memory descriptors and register
// fragments, what the attention kernels (fused_attention.cu,
// flash_attention.cu, attn128.cu) share of their products and score
// epilogue, and the host-side tensor-map encoders (blockmax.cu's routes
// use the 2-d one). Header-only; a kernel source includes it
// (ops/_build.py hashes it with the source).
//
// Layout conventions used throughout:
//  * a shared tile of the attention kernels and of blockmax_bf16 is bf16
//    [rows][64], 128 bytes a row, written by TMA with 128-byte swizzle and
//    1024-byte aligned, so an 8-row group is one 1024-byte swizzle atom;
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
//    from registers. The wide forms m64n256k16 (wgmma_ss_n256; d[128])
//    and, with A from registers, m64n128k16 (wgmma_rs_n128; d[64]) keep
//    the same layout with j = 0..31 and j = 0..15.
//  * blockmax.cu's fp32-query routes also read 32-column tiles: bf16
//    [rows][32] (64 bytes a row, 64-byte swizzle, desc_sw64), fp32
//    [rows][32] (128-byte swizzle) and int8 [rows][32] (32-byte swizzle),
//    each written by TMA (encode_matrix); its int8-corpus routes under
//    bf16 and int8 queries read int8 [rows][128] tiles, 128 bytes a row
//    as the bf16 [rows][64] ones (wgmma_ss_n256_s8 takes them as both
//    operands).

#pragma once

#include <algorithm>
#include <cmath>
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

// One box of a 3-d tensor map into shared memory, as tma_load_4d.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 2-d tensor map (encode_matrix) into shared memory, as
// tma_load_4d.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// One box of a 4-d tensor map from shared memory to global (the box's
// rows out of bounds are not written), in the issuing thread's bulk
// async-group; tma_store_wait_read() waits until its shared memory has
// been read, tma_store_wait() until it is written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// One box of a 3-d tensor map from shared memory to global, as
// tma_store_4d.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// make this thread's shared-memory writes visible to the async proxy (a
// TMA store that reads them)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Move registers between warpgroups (every thread of a warpgroup runs
// the same one): a producer gives registers back down to N a thread, the
// consumers take up to N; the block is launched with the even share.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wait at named barrier `id` (1-15; 0 is __syncthreads) for `threads`
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// Descriptor of a K-major bf16 tile of 32 columns (64 bytes a row, 8-row
// groups 512 bytes apart, 64-byte swizzle: a row's 16-byte chunk j at
// 16 * (j ^ ((row / 2) % 4))), 512-byte aligned. A k-step of 16 advances
// it by 32 bytes (kKStepK), as in the 128-byte layout; the leading byte
// offset is unused by a swizzled K-major operand.
__device__ __forceinline__ uint64_t desc_sw64(const void* tile) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>(1) << 16;          // leading byte offset
  d |= static_cast<uint64_t>(512 >> 4) << 32;   // stride byte offset
  d |= static_cast<uint64_t>(2) << 62;          // 64-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most `Pending` committed groups are still in flight
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Keep the compiler from touching accumulator registers across the
// asynchronous product (issue ... wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// The same for register A fragments: fenced after the wait that retires
// their product, they stay live (their registers unused by anything else)
// while the product reads them.
template <int P>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[P][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[p][i])::"memory");
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

#define HOPPER_F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_F32(d, i)                                                   \
  HOPPER_F8(d, i), HOPPER_F8(d, i + 8), HOPPER_F8(d, i + 16),              \
      HOPPER_F8(d, i + 24)
#define HOPPER_R8(d, i)                                                    \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),              \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define HOPPER_R32(d, i)                                                   \
  HOPPER_R8(d, i), HOPPER_R8(d, i + 8), HOPPER_R8(d, i + 16),              \
      HOPPER_R8(d, i + 24)
// the 128 accumulator operands %0 .. %127 of an n256 product
#define HOPPER_D128                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// d (+)= A . B, m64n256k16 bf16: A [64 x 16] and B [16 x 256] from shared
// memory, B K-major (its 256 rows one 128-byte-swizzled tile, 8-row groups
// 1024 bytes apart), A K-major for TransA = 0 and MN-major for 1 (a
// [k][64] tile, wgmma's transpose flag, stepped as kKStepMN); scale_d = 0
// overwrites d. One A read serves 256 columns, four times wgmma_ss's.
template <int TransA = 0>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      HOPPER_D128 ", %128, %129, p, 1, 1, %131, 0;\n}\n"
      : HOPPER_F32(d, 0), HOPPER_F32(d, 32), HOPPER_F32(d, 64),
        HOPPER_F32(d, 96)
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransA));
}

// d (+)= A . B, m64n256k32 s8 x s8 -> s32: A [64 x 32] and B [32 x 256]
// int8 from shared memory, both K-major (the integer wgmma takes no
// transpose and no negation). A k-step of 32 int8 is 32 bytes, as a bf16
// k-step of 16 is, so a 128-byte-swizzled [rows][128] int8 tile steps by
// kKStepK and desc_sw128 describes it; the accumulator d[128] has the
// f32 layout of the file comment. The sum is exact in int32 (no
// saturation: |sum| <= 127^2 D stays far below 2^31 for D < 133,000);
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n256_s8(int (&d)[128], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      HOPPER_D128 ", %128, %129, p;\n}\n"
      : HOPPER_R32(d, 0), HOPPER_R32(d, 32), HOPPER_R32(d, 64),
        HOPPER_R32(d, 96)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= A . B, m64n128k16 bf16: A [64 x 16] from registers (the fragment
// in the file comment), B [16 x 128] K-major from shared memory (d[64],
// j = 0..15); scale_d = 0 overwrites d. Registers `a` must not change
// until the product has completed (wgmma_wait).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : HOPPER_F32(d, 0), HOPPER_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef HOPPER_F8
#undef HOPPER_F32
#undef HOPPER_R8
#undef HOPPER_R32
#undef HOPPER_D128

// two bf16 in one register, `lo` (the lower column) in the low half
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

// Two fp32 values (`lo` the lower column) as three packed bf16 pieces:
// p0 = bf16(x), p1 = bf16(x - p0), p2 = bf16(x - p0 - p1), each rounded to
// nearest even; both differences are exact in fp32, and so is the sum
// p0 + p1 + p2 = x for 0 and 2^-100 <= |x| < 2^127 (ops/topk.py's
// split_bf16_pieces, the same arithmetic). Packed as A-fragment registers.
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  p0 = pack_rn(lo, hi);
  const float r_lo = __fsub_rn(lo, __uint_as_float(p0 << 16));
  const float r_hi = __fsub_rn(hi, __uint_as_float(p0 & 0xffff0000u));
  p1 = pack_rn(r_lo, r_hi);
  p2 = pack_rn(__fsub_rn(r_lo, __uint_as_float(p1 << 16)),
               __fsub_rn(r_hi, __uint_as_float(p1 & 0xffff0000u)));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(~0u, x, 1));
  return fmaxf(x, __shfl_xor_sync(~0u, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(~0u, x, 1);
  return x + __shfl_xor_sync(~0u, x, 2);
}

// ------------------------------------------------------------ attention
//
// What the attention kernels share: the block's dynamic shared memory,
// a thread's place in its warpgroup's accumulator, the two products of a
// 64-row tile against a 64-key tile, and the score epilogue's devices.

constexpr int kWgThreads = 128;  // one warpgroup

// the dynamic shared memory, 1024-byte aligned (TMA's 128-byte swizzle
// and the wgmma descriptors assume it); launched with 1 KB of slack
template <typename T>
__device__ __forceinline__ T& aligned_smem() {
  extern __shared__ __align__(128) unsigned char smem_dyn[];
  const uint32_t a = smem_u32(smem_dyn);
  return *reinterpret_cast<T*>(smem_dyn + ((1024 - (a & 1023)) & 1023));
}

// A thread's place in its warpgroup's accumulator (hopper.cuh): rows
// row0 + g and row0 + g + 8 of the warpgroup's 64, columns 8j + c, + 1.
struct Lane {
  int wg, row0, g, c;
  __device__ Lane() {
    const int t = threadIdx.x;
    wg = t / kWgThreads;
    row0 = 16 * ((t % kWgThreads) / 32);
    g = (t % 32) / 4;
    c = 2 * (t % 4);
  }
};

// d = A . B^T over D = 64 (four k-steps): A's 64 rows and B's 64 rows,
// both K-major tiles. Issued only; the caller fences, commits and waits.
__device__ __forceinline__ void issue_abt(float (&d)[32], const bf16* a,
                                          const bf16* b) {
  const uint64_t da = desc_sw128(a), db = desc_sw128(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(d, da + kk * kKStepK,
                        db + kk * kKStepK, kk);
}

// d += A . B with A [64 x 64] as four register fragments and B a [64][64]
// tile read MN-major (its rows are the reduction dimension).
__device__ __forceinline__ void issue_ab(float (&d)[32],
                                         const uint32_t (&a)[4][4],
                                         const bf16* b) {
  const uint64_t db = desc_sw128(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<1>(d, a[kk], db + kk * kKStepMN);
}

__device__ __forceinline__ void wait_products(float (&x)[32]) {
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(x);
}

// s = q . k^T for one 64-key tile, then wait
__device__ __forceinline__ void scores(float (&s)[32], const bf16* q,
                                       const bf16* k) {
  fence_regs(s);
  wgmma_fence();
  issue_abt(s, q, k);
  wait_products(s);
}

// the accumulator as register A fragments, rounded to bf16
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_rn(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// s * scale + bias in one FMA. The host passes only a power-of-two scale
// (1/sqrt(64) = 1/8), for which s * scale is exact, so the FMA rounds
// once where the function rounds twice and gets the same bits.
__device__ __forceinline__ float scaled(float s, float scale, float bias) {
  return __fmaf_rn(s, scale, bias);
}

// scale, bias and the sequence mask on a score tile whose columns are
// keys key0 + 8j + c (+1); `bias` (shared memory, 8-byte aligned) holds
// the tile's 64 keys from key0. Keys >= S get -inf (only the last tile has
// any, so only it pays for the test).
__device__ __forceinline__ void scale_bias(float (&s)[32], const float* bias,
                                           int key0, int S, float scale,
                                           int c) {
  const bool full = key0 + 64 <= S;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + c);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = scaled(s[4 * j + e], scale, (e & 1) ? b.y : b.x);
  }
  if (full) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + 8 * j + c + (e & 1) >= S) s[4 * j + e] = -INFINITY;
}

// exp(s - m) as 2^((s - m) * log2 e) by ex2.approx.ftz: within ~2 ulps of
// the exact value plus (s - m)'s rounding times log2 e (~1e-6 relative at
// p = 1e-9); 0 below 2^-126, where p rounds to no weight. The plain
// ex2.approx (what __expf emits) adds three instructions an exp to keep
// those subnormal results.
__device__ __forceinline__ float exp_shifted(float s, float m) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(y)
      : "f"(__fmul_rn(__fsub_rn(s, m), 1.44269504088896341f)));
  return y;
}

// exp_shifted as a function object (the softmax helpers take the exp)
struct ExpShifted {
  __device__ __forceinline__ float operator()(float s, float m) const {
    return exp_shifted(s, m);
  }
};

// The online softmax of one score tile (its two rows a thread): the exact
// running max m (reduced over the quad), a = exp(m - m'), s = exp(s - m')
// in place, the thread's partial sums l = l * a + rowsum(s) and the
// accumulator acc *= a (flash_fwd_bf16, whose p then carries 24 bits into
// its products, and fused_attention.cu's fp32 forward, with an exact exp).
template <typename Exp = ExpShifted>
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&acc)[32],
                                               Exp exp = Exp()) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float x = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x = fmaxf(x, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
    const float m_new = fmaxf(m[hh], quad_max(x));
    const float a = exp(m[hh], m_new);
    float sum = __fmul_rn(l[hh], a);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hh + e;
        s[i] = exp(s[i], m_new);
        sum = __fadd_rn(sum, s[i]);
        acc[i] = __fmul_rn(acc[i], a);
      }
    m[hh] = m_new;
    l[hh] = sum;
  }
}

// p = e / l correctly rounded, from inv_l = RN(1 / l): q0 = RN(e * inv_l)
// is within an ulp of e / l, r = e - q0 * l is exact in one FMA, and
// RN(q0 + r * inv_l) is the rounded quotient (Markstein). The division
// instruction does the same and adds a range check whose slow path every
// zero numerator (each masked key) took.
__device__ __forceinline__ float divide(float e, float l, float inv_l) {
  const float q0 = __fmul_rn(e, inv_l);
  return __fmaf_rn(__fmaf_rn(-q0, l, e), inv_l, q0);
}

// The end of the online softmax: l sums the quad's partial sums, and
// acc / l is correctly rounded (divide)
__device__ __forceinline__ void online_finish(float (&l)[2],
                                              float (&acc)[32]) {
  float inv_l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = quad_sum(l[hh]);
    inv_l[hh] = __frcp_rn(l[hh]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    acc[i] = divide(acc[i], l[hh], inv_l[hh]);
  }
}

// store a [64 rows][64] fp32 tile in the output's type T (bf16: rounded
// to nearest; fp32 as it is) into rows r0 + row0 + g (+8) < S of one head
// of a contiguous [B, S, H, 64] output (`head` = the head's row 0, rows
// `ld` elements apart)
template <typename T>
__device__ __forceinline__ void store_tile(const float (&o)[32], T* head,
                                           long long ld, int r0, int S,
                                           const Lane& ln) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + ln.row0 + ln.g + 8 * h;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      T* at = head + r * ld + 8 * j + ln.c;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(at) =
            make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      else
        *reinterpret_cast<uint32_t*>(at) =
            pack_rn(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
  }
}

// the [64 rows][64] fp32 tile, rounded to bf16, into a 128-byte-swizzled
// shared [64][64] tile (a TMA box's layout: row r's 16-byte chunk k at
// r * 128 + 16 * (k ^ (r % 8))), each thread's two rows; a warp's 4-byte
// stores then fall on 32 distinct banks
__device__ __forceinline__ void store_tile_swizzled(const float (&o)[32],
                                                    bf16* tile,
                                                    const Lane& ln) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ln.row0 + ln.g + 8 * h;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(base + r * 128 + 16 * (j ^ (r & 7)) +
                                   2 * ln.c) =
          pack_rn(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
  }
}

// ------------------------------------------------------ fp32 as bf16 pieces
//
// The fp32 attention routes (flash_attention.cu's flash_fwd_pieces, the
// forward of both fp32 attentions, and fused_attention.cu's
// fused_bwd_*_pieces): fp32 q, k, v (and dout) as three bf16 pieces each
// (x = x0 + x1 + x2 exactly, split3), every product of the function as the
// six piece products with i + j <= 2 on the bf16 wgmma path: each is exact
// in fp32, and the three dropped ones are below 2^-25 of |a||b|. One
// split_pieces launch (split_pieces.cuh) writes each operand's pieces as
// bf16 [3][B][S][H][64]; the kernels read them as [64][64] TMA tiles
// (load_pieces).

// element strides of a [B, S, H, D] operand (the D stride is 1)
struct Strides {
  long long b, s, h;
};

constexpr int kTileElems = kTileRows * 64;  // a [64][64] tile's elements
constexpr int kPieces = 3;
constexpr int kPieceTileBytes = kPieces * kTileBytes;  // one operand's tile

// The A and B piece of product n = 0..5, smallest first: (2, 0) (1, 1)
// (0, 2), then (1, 0) (0, 1), then (0, 0).
__device__ __forceinline__ constexpr int piece_a(int n) {
  return n == 0 ? 2 : (n == 1 || n == 3) ? 1 : 0;
}
__device__ __forceinline__ constexpr int piece_b(int n) {
  return n == 2 ? 2 : (n == 1 || n == 4) ? 1 : 0;
}

// The tensor cores add each k-step's sum to the fp32 accumulator rounded
// toward zero, so every update of a sum may lose up to an ulp of it. So a
// product takes a fresh accumulator (its first update overwrites d) and
// its 24 updates (6 piece products x 4 k-steps of one 64-deep tile) go
// smallest first: the 20 of the small pieces while d is still ~2^-8 of
// its final size, then the four (0, 0) k-steps, each truncated by at most
// an ulp of the tile's partial sum. A longer product adds its tiles'
// partial sums to a running total rounded to nearest (add_product).

// d = A . B^T over D = 64: `a` and `b` each the three K-major [64][64]
// piece tiles of one operand, one after another. Issued only. With
// Swapped, A's piece is piece_b(n) and B's piece_a(n): the keys pass's
// s^T = k . q^T then adds the rows pass's 16 products of s = q . k^T in
// the same order, so both truncate alike and p is the same in both.
template <bool Swapped = false>
__device__ __forceinline__ void issue_abt_pieces(float (&d)[32], const bf16* a,
                                                 const bf16* b) {
#pragma unroll
  for (int n = 0; n < 6; ++n) {
    const int pa = Swapped ? piece_b(n) : piece_a(n);
    const int pb = Swapped ? piece_a(n) : piece_b(n);
    const uint64_t da = desc_sw128(a + pa * kTileElems);
    const uint64_t db = desc_sw128(b + pb * kTileElems);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0>(d, da + kk * kKStepK, db + kk * kKStepK, n + kk);
  }
}

// d = A . B over 64 keys (or queries): A [64 x 64] as three register
// piece fragments, B's three piece tiles read MN-major. Issued only.
__device__ __forceinline__ void issue_ab_pieces(
    float (&d)[32], const uint32_t (&a)[kPieces][4][4], const bf16* b) {
#pragma unroll
  for (int n = 0; n < 6; ++n) {
    const uint64_t db = desc_sw128(b + piece_b(n) * kTileElems);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(d, a[piece_a(n)][kk], db + kk * kKStepMN, n + kk);
  }
}

// an fp32 accumulator tile as the three pieces of its A fragments
__device__ __forceinline__ void to_a_pieces(uint32_t (&a)[kPieces][4][4],
                                            const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], a[0][kk][r],
             a[1][kk][r], a[2][kk][r]);
}

// part = A . B over one tile (issue_ab_pieces), then total += part rounded
// to nearest. The fragments are fenced after the wait, so their registers
// hold until the product has read them.
__device__ __forceinline__ void add_product(float (&total)[32],
                                            float (&part)[32],
                                            uint32_t (&a)[kPieces][4][4],
                                            const bf16* b) {
  fence_regs(part);
  wgmma_fence();
  issue_ab_pieces(part, a, b);
  wait_products(part);
#pragma unroll
  for (int p = 0; p < kPieces; ++p) fence_regs(a[p]);
#pragma unroll
  for (int i = 0; i < 32; ++i) total[i] = __fadd_rn(total[i], part[i]);
}

// exp(s - m) to within an ulp (expf, as the plain version's exp), for the
// fp32 routes: their p keeps all 24 bits, where exp_shifted's rounding of
// (s - m) * log2 e alone costs ~|s - m| 2^-24 of it
struct ExpExact {
  __device__ __forceinline__ float operator()(float s, float m) const {
    return expf(__fsub_rn(s, m));
  }
};

// Load the `kPieces` piece tiles of rows row0.. of (b, h) from a pieces
// map (piece p of batch row b is batch coordinate p * B + b).
__device__ __forceinline__ void load_pieces(bf16 (*dst)[kTileElems],
                                            const CUtensorMap* map, int h,
                                            int row0, int b, int B,
                                            uint64_t* bar) {
  for (int p = 0; p < kPieces; ++p)
    tma_load_4d(dst[p], map, 0, h, row0, p * B + b, bar);
}

// ------------------------------------------------------------ host

// The attention kernels fold scale and bias into one FMA (`scaled`),
// which keeps the function's two roundings (or its q' = q * scale) only
// for a scale of 2^e; their hosts refuse any other.
inline bool power_of_two(float scale) {
  int e;
  return scale > 0.f && std::frexp(scale, &e) == 0.5f;
}

// cuTensorMapEncodeTiled for a tensor of `type` and `rank` dimensions
// (sizes and box innermost first, byte strides of the outer ones),
// elements out of bounds zero-filled. The function is fetched through the
// runtime: the library links no libcuda. Returns a CUresult (0 on
// success).
inline int encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                        const void* base, cuuint32_t rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
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
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return static_cast<int>(encode(
      map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}


// A bf16 [B, S, H, 64] tensor (any batch, seq and head strides in
// elements, multiples of 8; unit stride along the 64) as a 4-d tensor map
// whose box is `rows` sequence positions of one (batch, head): a
// [rows][64] tile, 128-byte swizzled, rows past S zero-filled. Returns a
// CUresult (0 on success).
inline int encode_bhsd(CUtensorMap* map, const void* base, int B, int S, int H,
                       long long stride_b, long long stride_s,
                       long long stride_h, int rows) {
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride_h) * 2,
                                 static_cast<cuuint64_t>(stride_s) * 2,
                                 static_cast<cuuint64_t>(stride_b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A row-major [rows, cols] matrix of `type` (`elem_bytes` each; rows
// `ld` elements apart, a multiple of 16 bytes; the base 16-byte aligned)
// as a 2-d tensor map whose box is [box_rows][box_cols] with `swizzle`
// (box_cols * elem_bytes no wider than the swizzle span): rows and
// columns out of bounds zero-filled. Returns a CUresult (0 on success).
inline int encode_matrix(CUtensorMap* map, CUtensorMapDataType type,
                         int elem_bytes, const void* base, long long rows,
                         int cols, long long ld, int box_rows, int box_cols,
                         CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  return encode_tiled(map, type, base, 2, dims, strides, box, swizzle);
}

}  // namespace hopper
