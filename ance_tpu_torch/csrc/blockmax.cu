// Block-max inner-product scores for the exact top-k search (phase 1).
//
// Replaces the Pallas kernel ance_tpu/ops/topk.py::_blockmax_kernel.
// For queries [Q, D] and a corpus [N, D] (row-major, contiguous) it writes
//     out[q, b] = max_{r in [b*BS, (b+1)*BS)} <queries[q], corpus[r]>
// as a row-major [Q, N/BS] array, so the caller needs no transpose. The
// full [Q, N] score matrix never reaches device memory: each block keeps
// its 128-row score tile on chip and stores only the per-block maxima (BS x
// fewer bytes than the scores).
//
// Types (query x corpus -> accumulator): f32 x f32, bf16 x bf16, f32 x int8,
// bf16 x int8 -> fp32, and int8 x int8 -> int32. An int8 corpus under a
// float query is widened to the query type as it is loaded (exact: |v| <=
// 127 fits bf16). Padding rows are not special here: the caller masks them.
//
// What bounds it on the H100. At the dev shape (Q = 2048) the product is
// 2*Q*N*D = 3.1 TFLOP per 1M corpus rows against 1.5 GB of bf16 corpus:
// compute bound by a wide margin (3.18 ms at the bf16 peak). At small Q (a
// few queries per call) it is the corpus bytes, ~0.46 ms per 1M x 768 bf16
// rows at 3.35 TB/s. Three kernels, one a route:
//  * bf16 x bf16 (blockmax_bf16: every bf16 index, serve and search). A
//    block is 128 corpus rows x 256 queries: one producer warp keeps TMA
//    loads of 64-deep corpus and query tiles in flight through a ring of
//    four stages, and two consumer warpgroups (64 rows each) run wgmma
//    m64n256k16 with both operands K-major in shared memory, so a
//    warpgroup reads its corpus tile once for 256 queries. The block
//    maximum is taken in registers: with corpus rows as wgmma's M, a
//    warp's 16 accumulator rows are one 16-row block, so a thread maxes
//    its rows g and g + 8 and the warp reduces over g by xor shuffles (a
//    reduce-scatter: each step halves the values a lane keeps), and only
//    [8 or 16 row groups][256 queries] maxima pass through shared memory,
//    to leave as 32-byte runs a query. block_size 1, 2 and 4 (blocks
//    inside a row group) put the whole score tile over the spent ring.
//  * bf16 x int8 and int8 x int8: WMMA (16x16x16 mma.sync fragments; fp32 /
//    int32 accumulation); each of 8 warps owns a 32 x 32 piece of a 128-row
//    x 64-query tile, one stage loaded through registers.
//  * fp32 queries (f32 x f32, f32 x int8), whose products the tensor cores
//    would round (TF32), stay on the CUDA cores: a shared-memory tiled
//    product with an 8x4 register micro-tile per thread.
// For all three the grid is 1-D with the query tile varying fastest, so
// the blocks that share a corpus tile run together and read it from device
// memory about once, while the (small) query matrix stays in L2. Only
// block maxima are written (Q*N/BS values).
// All row and element offsets are 64-bit: at 8.8M x 768 the corpus holds
// 6.8e9 elements, past int32.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hopper.cuh"

namespace {

constexpr int kTileRows = 128;  // corpus rows per block
constexpr int kTileQ = 64;      // queries per block
constexpr int kThreads = 256;   // 8 warps
constexpr int kEpiLd = kTileQ + 4;  // score tile row stride (floats / ints)

template <typename TA>
__device__ __forceinline__ TA max_of(TA a, TA b) { return a > b ? a : b; }

// Shared epilogue: the block's scores sit in shared memory as
// [kTileRows][kEpiLd]; write one max per (BS-row block, query).
template <typename TA>
__device__ __forceinline__ void store_block_maxima(
    const TA* scores, TA* __restrict__ out, int q0, long long row0, int n_q,
    long long n_rows, int block_size) {
  const int blocks_per_tile = kTileRows / block_size;
  const long long n_blocks = n_rows / block_size;
  const long long block0 = row0 / block_size;
  // block index fastest: neighbouring threads store neighbouring outputs
  for (int i = threadIdx.x; i < blocks_per_tile * kTileQ; i += kThreads) {
    const int b = i % blocks_per_tile, n = i / blocks_per_tile;
    const long long gb = block0 + b;
    const int q = q0 + n;
    if (gb >= n_blocks || q >= n_q) continue;
    const TA* col = scores + b * block_size * kEpiLd + n;
    TA m = col[0];
    for (int r = 1; r < block_size; ++r) m = max_of(m, col[r * kEpiLd]);
    out[static_cast<long long>(q) * n_blocks + gb] = m;
  }
}

// ---------------------------------------------------------------- CUDA cores
// fp32 queries: f32 x f32 and f32 x int8.

constexpr int kSimtK = 32;  // depth of one k step
constexpr int kMicroRows = kTileRows / 16;
constexpr int kMicroQ = kTileQ / 16;

// TC: float or int8_t (widened to fp32 as it is loaded; exact)
template <typename TC>
__global__ void __launch_bounds__(kThreads)
blockmax_simt(const float* __restrict__ queries, const TC* __restrict__ corpus,
              float* __restrict__ out, int n_q, long long n_rows, int dim,
              int block_size, long long n_q_tiles) {
  // operand tiles during the product, then the score tile for the epilogue
  constexpr int kStage = kSimtK * (kTileRows + 1) + kSimtK * (kTileQ + 1);
  constexpr int kEpilogue = kTileRows * kEpiLd;
  constexpr int kSmem = kStage > kEpilogue ? kStage : kEpilogue;
  __shared__ float smem[kSmem];
  float* c_tile = smem;                               // [kSimtK][kTileRows + 1]
  float* q_tile = smem + kSimtK * (kTileRows + 1);    // [kSimtK][kTileQ + 1]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long bid = blockIdx.x;
  const int q0 = static_cast<int>(bid % n_q_tiles) * kTileQ;
  const long long row0 = (bid / n_q_tiles) * kTileRows;

  float acc[kMicroRows][kMicroQ];
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i)
#pragma unroll
    for (int j = 0; j < kMicroQ; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < dim; k0 += kSimtK) {
    // neighbouring threads read neighbouring elements of one row
    for (int i = tid; i < kTileRows * kSimtK; i += kThreads) {
      const int r = i / kSimtK, kk = i % kSimtK;
      const long long row = row0 + r;
      const int k = k0 + kk;
      c_tile[kk * (kTileRows + 1) + r] =
          (row < n_rows && k < dim) ? static_cast<float>(corpus[row * dim + k])
                                    : 0.0f;
    }
    for (int i = tid; i < kTileQ * kSimtK; i += kThreads) {
      const int n = i / kSimtK, kk = i % kSimtK;
      const int q = q0 + n;
      const int k = k0 + kk;
      q_tile[kk * (kTileQ + 1) + n] =
          (q < n_q && k < dim) ? queries[static_cast<long long>(q) * dim + k]
                               : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kSimtK; ++kk) {
      float a[kMicroRows], b[kMicroQ];
#pragma unroll
      for (int i = 0; i < kMicroRows; ++i)
        a[i] = c_tile[kk * (kTileRows + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMicroQ; ++j)
        b[j] = q_tile[kk * (kTileQ + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMicroRows; ++i)
#pragma unroll
        for (int j = 0; j < kMicroQ; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

  float* scores = smem;  // [kTileRows][kEpiLd]
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i)
#pragma unroll
    for (int j = 0; j < kMicroQ; ++j)
      scores[(ty + 16 * i) * kEpiLd + tx + 16 * j] = acc[i][j];
  __syncthreads();
  store_block_maxima(scores, out, q0, row0, n_q, n_rows, block_size);
}

// -------------------------------------------------------------- tensor cores
// bf16 x int8 (as bf16) and int8 x int8 on WMMA. Tiles load in
// 8-element chunks, so dim must be a multiple of 8 and both bases 16-byte
// aligned; the launcher refuses other operands.
//
// Shared-memory layout of an operand tile: kWmmaK / 16 slabs, each
// [rows][16] elements (one k16 step), so a WMMA fragment is one contiguous
// run of 16 rows; slabs are padded by 32 bytes so the 8-element stores of
// one row land in distinct banks.

constexpr int kWmmaK = 64;              // depth of one k step
constexpr int kSlabs = kWmmaK / 16;
constexpr int kChunksPerRow = kWmmaK / 8;  // 8-element chunks per tile row

template <typename T>
struct alignas(16) Vec8 {
  T v[8];
};

template <typename T>
__device__ __forceinline__ Vec8<T> load8(const T* p) {  // p: 8*sizeof(T)-aligned
  Vec8<T> out;
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(&out) = *reinterpret_cast<const uint4*>(p);
  } else {
    static_assert(sizeof(T) == 1, "load8 takes bf16 or int8");
    *reinterpret_cast<uint2*>(&out) = *reinterpret_cast<const uint2*>(p);
  }
  return out;
}

template <typename TE>
struct ToElem;

template <>
struct ToElem<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 of(__nv_bfloat16 x) {
    return x;
  }
  static __device__ __forceinline__ __nv_bfloat16 of(int8_t x) {
    return __float2bfloat16(static_cast<float>(x));  // exact
  }
};

template <>
struct ToElem<signed char> {
  static __device__ __forceinline__ signed char of(int8_t x) { return x; }
};

template <typename TE>
__host__ __device__ constexpr int slab_stride(int rows) {  // elements between slabs
  return rows * 16 + 32 / static_cast<int>(sizeof(TE));
}

// Copy rows [row0, row0 + rows) x columns [k0, k0 + kWmmaK) of src [n, dim]
// into the slab layout, converting to TE; out-of-range rows and columns
// are zero (they add nothing to the products).
template <typename TE, typename TSrc>
__device__ __forceinline__ void load_tile(TE* dst, const TSrc* __restrict__ src,
                                          long long row0, long long n_valid,
                                          int rows, int k0, int dim) {
  const int stride = slab_stride<TE>(rows);
  for (int c = threadIdx.x; c < rows * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow, j = c % kChunksPerRow;
    const long long row = row0 + r;
    const int k = k0 + j * 8;
    Vec8<TE> e;
    if (row < n_valid && k < dim) {  // dim % 8 == 0: the chunk is whole
      const Vec8<TSrc> s = load8(src + row * dim + k);
#pragma unroll
      for (int i = 0; i < 8; ++i) e.v[i] = ToElem<TE>::of(s.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) e.v[i] = ToElem<TE>::of(int8_t(0));
    }
    TE* d = dst + (j / 2) * stride + r * 16 + (j % 2) * 8;
    if constexpr (sizeof(TE) == 2) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(&e);
    } else {
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(&e);
    }
  }
}

template <typename TQ, typename TC, typename TE, typename TA>
__global__ void __launch_bounds__(kThreads)
blockmax_wmma(const TQ* __restrict__ queries, const TC* __restrict__ corpus,
              TA* __restrict__ out, int n_q, long long n_rows, int dim,
              int block_size, long long n_q_tiles) {
  namespace wmma = nvcuda::wmma;
  constexpr int kCStride = slab_stride<TE>(kTileRows);
  constexpr int kQStride = slab_stride<TE>(kTileQ);
  constexpr int kStageBytes = (kSlabs * kCStride + kSlabs * kQStride) *
                              static_cast<int>(sizeof(TE));
  constexpr int kEpiBytes = kTileRows * kEpiLd * static_cast<int>(sizeof(TA));
  constexpr int kBytes = kStageBytes > kEpiBytes ? kStageBytes : kEpiBytes;
  __shared__ __align__(128) unsigned char smem[kBytes];
  TE* c_tile = reinterpret_cast<TE*>(smem);
  TE* q_tile = c_tile + kSlabs * kCStride;

  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32;  // this warp's 32 corpus rows
  const int wq = (warp % 2) * 32;  // and 32 queries
  const long long bid = blockIdx.x;
  const int q0 = static_cast<int>(bid % n_q_tiles) * kTileQ;
  const long long row0 = (bid / n_q_tiles) * kTileRows;

  wmma::fragment<wmma::accumulator, 16, 16, 16, TA> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], TA(0));

  for (int k0 = 0; k0 < dim; k0 += kWmmaK) {
    load_tile(c_tile, corpus, row0, n_rows, kTileRows, k0, dim);
    load_tile(q_tile, queries, q0, n_q, kTileQ, k0, dim);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, TE, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, TE, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], c_tile + s * kCStride + (wr + 16 * i) * 16,
                               16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], q_tile + s * kQStride + (wq + 16 * j) * 16,
                               16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  TA* scores = reinterpret_cast<TA*>(smem);  // [kTileRows][kEpiLd]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(scores + (wr + 16 * i) * kEpiLd + wq + 16 * j,
                              acc[i][j], kEpiLd, wmma::mem_row_major);
  __syncthreads();
  store_block_maxima(scores, out, q0, row0, n_q, n_rows, block_size);
}

// ------------------------------------------------ bf16 x bf16, wgmma + TMA

using hopper::bf16;

constexpr int kBf16Q = 256;       // queries per block: wgmma's N
constexpr int kBf16Stages = 4;    // ring of 64-deep k steps
constexpr int kConsumerWarps = 8;  // two warpgroups of 64 corpus rows (M)
constexpr int kBf16Consumers = 32 * kConsumerWarps;
constexpr int kBf16Threads = kBf16Consumers + 32;  // + the producer warp
constexpr int kMaximaLd = kBf16Q + 4;  // floats a row of the maxima tile
constexpr int kBf16StageBytes = (kTileRows + kBf16Q) * 64 * 2;

struct alignas(1024) Bf16Smem {
  bf16 c[kBf16Stages][kTileRows * 64];  // corpus rows x 64 columns
  bf16 q[kBf16Stages][kBf16Q * 64];     // queries x 64 columns
  // the maximum of each 16-row group (8 for block_size 8) for each query
  float maxima[kTileRows / 8][kMaximaLd];
  uint64_t full[kBf16Stages], empty[kBf16Stages];
  // block_size 1, 2 and 4: every row's score for each query, laid over the
  // ring once its last product has been read
  __device__ float (*rows())[kMaximaLd] {
    return reinterpret_cast<float (*)[kMaximaLd]>(c);
  }
};
static_assert(offsetof(Bf16Smem, maxima) >=
                  sizeof(float) * kTileRows * kMaximaLd,
              "the row scores overrun the ring");
constexpr int kSmemSlack = 1024;  // aligned_smem's rounding
constexpr int kBf16SmemBytes = static_cast<int>(sizeof(Bf16Smem)) + kSmemSlack;
static_assert(kBf16SmemBytes <= 232448, "more than a block's shared memory");

// Over the 8 lanes g of one c (lane bits 2-4), the maximum of each of the
// 64 columns whose values this thread holds at acc[4j + Off + e] (column
// 8j + c + e, j = 0..31, e = 0, 1), as a reduce-scatter: at each of three
// xor shuffles (16, 8, 4: g's bits 2, 1, 0) a lane keeps the half of its
// columns whose j has that bit equal to its own and takes the partner's
// values of that half. Afterwards lane g holds the maximum of column
// 8(8i + g) + c + e = 64i + 8g + c + e at acc[32i + Off + e], i = 0..3:
// 56 shuffles where an all-reduce of 64 values takes 192.
template <int Off>
__device__ __forceinline__ void lane_max_scatter(float (&acc)[128], int g) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int jbit = 4 >> s, lanes = 16 >> s;
    const bool up = g & jbit;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j & (8 - jbit)) continue;  // a reduced bit or the step's bit set
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& lo = acc[4 * j + Off + e];
        const float hi = acc[4 * (j + jbit) + Off + e];
        const float send = up ? lo : hi;
        const float keep = up ? hi : lo;
        lo = fmaxf(keep, __shfl_xor_sync(~0u, send, lanes));
      }
    }
  }
}

// One block: rows [row0, row0 + 128) of the corpus against queries
// [q0, q0 + 256). Warp 8 is the producer; warps 0-7 are two consumer
// warpgroups, warpgroup wg owning corpus rows 64 wg .. 64 wg + 63.
__global__ void __launch_bounds__(kBf16Threads, 1)
    blockmax_bf16(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mc,
                  float* __restrict__ out, int n_q, long long n_rows, int dim,
                  int block_size, long long n_q_tiles) {
  Bf16Smem& sm = hopper::aligned_smem<Bf16Smem>();
  const long long bid = blockIdx.x;
  const int q0 = static_cast<int>(bid % n_q_tiles) * kBf16Q;
  const long long row0 = (bid / n_q_tiles) * kTileRows;
  const int n_k = (dim + 63) / 64;  // columns past dim are zero-filled
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBf16Stages; ++i) {
      hopper::mbar_init(&sm.full[i], 1);
      hopper::mbar_init(&sm.empty[i], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / 32 == kConsumerWarps) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      hopper::Ring<kBf16Stages> r;
      for (int t = 0; t < n_k; ++t, r.next()) {
        hopper::mbar_wait(&sm.empty[r.stage], r.phase ^ 1);
        hopper::mbar_expect_tx(&sm.full[r.stage], kBf16StageBytes);
        hopper::tma_load_2d(sm.c[r.stage], &mc, 64 * t,
                            static_cast<int>(row0), &sm.full[r.stage]);
        hopper::tma_load_2d(sm.q[r.stage], &mq, 64 * t, q0,
                            &sm.full[r.stage]);
      }
    }
    return;
  }

  const hopper::Lane ln;
  const int warp = threadIdx.x / 32;  // the row group 16 warp .. + 15
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  hopper::Ring<kBf16Stages> r;
  for (int t = 0; t < n_k; ++t, r.next()) {
    hopper::mbar_wait(&sm.full[r.stage], r.phase);
    const uint64_t da = hopper::desc_sw128(sm.c[r.stage] + ln.wg * 64 * 64);
    const uint64_t db = hopper::desc_sw128(sm.q[r.stage]);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_ss_n256(acc, da + kk * hopper::kKStepK,
                            db + kk * hopper::kKStepK, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();  // the other warpgroup's products fill the gap
    hopper::fence_regs(acc);
    if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&sm.empty[r.stage]);
  }

  // acc[4j + 2h + e] = score of corpus row 16 warp + g + 8h and query
  // 8j + c + e. A row of `tile` holds, for each query, the maximum of a
  // 16-row group (block_size >= 16) or of an 8-row group (8), taken in
  // registers, or one row's score (1, 2, 4); a block is `per` of its rows.
  float (*tile)[kMaximaLd] = sm.maxima;
  int per = 1;
  if (block_size >= 16) {  // rows g and g + 8 share a block
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[4 * j + e] = fmaxf(acc[4 * j + e], acc[4 * j + 2 + e]);
    lane_max_scatter<0>(acc, ln.g);
    float* row = tile[warp];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float2*>(row + 64 * i + 8 * ln.g + ln.c) =
          make_float2(acc[32 * i], acc[32 * i + 1]);
    per = block_size / 16;
  } else if (block_size == 8) {  // rows g and rows g + 8 are two blocks
    lane_max_scatter<0>(acc, ln.g);
    lane_max_scatter<2>(acc, ln.g);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = tile[2 * warp + h];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float2*>(row + 64 * i + 8 * ln.g + ln.c) =
            make_float2(acc[32 * i + 2 * h], acc[32 * i + 2 * h + 1]);
    }
  } else {  // blocks within a row group: the whole score tile, over the ring
    hopper::named_barrier(1, kBf16Consumers);  // every product has read it
    tile = sm.rows();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = tile[16 * warp + ln.g + 8 * h];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + ln.c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    per = block_size;
  }
  hopper::named_barrier(1, kBf16Consumers);

  // block b of the tile is rows b * per .. + per - 1 of `tile`; block index
  // fastest, so a query's maxima leave as one run (32 bytes at block_size
  // 16)
  const int blocks_per_tile = kTileRows / block_size;
  const long long n_blocks = n_rows / block_size;
  const long long block0 = row0 / block_size;
  for (int i = threadIdx.x; i < blocks_per_tile * kBf16Q;
       i += kBf16Consumers) {
    const int b = i % blocks_per_tile, n = i / blocks_per_tile;
    const long long gb = block0 + b;
    const int q = q0 + n;
    if (gb >= n_blocks || q >= n_q) continue;
    float m = tile[b * per][n];
    for (int k = 1; k < per; ++k) m = fmaxf(m, tile[b * per + k][n]);
    out[static_cast<long long>(q) * n_blocks + gb] = m;
  }
}

struct Grid {
  long long n_q_tiles, blocks;
};

Grid grid_for(int n_q, long long n_rows) {
  const long long n_q_tiles = (n_q + kTileQ - 1) / kTileQ;
  return {n_q_tiles, n_q_tiles * ((n_rows + kTileRows - 1) / kTileRows)};
}

template <typename TC>
int launch_simt(const void* q, const void* c, void* out, int n_q,
                long long n_rows, int dim, int block_size,
                cudaStream_t stream) {
  const Grid g = grid_for(n_q, n_rows);
  if (g.blocks == 0) return 0;
  if (g.blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  blockmax_simt<TC><<<static_cast<unsigned>(g.blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const TC*>(c),
      static_cast<float*>(out), n_q, n_rows, dim, block_size, g.n_q_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, typename TE, typename TA>
int launch_wmma(const void* q, const void* c, void* out, int n_q,
                long long n_rows, int dim, int block_size,
                cudaStream_t stream) {
  const Grid g = grid_for(n_q, n_rows);
  if (g.blocks == 0) return 0;
  if (g.blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  blockmax_wmma<TQ, TC, TE, TA><<<static_cast<unsigned>(g.blocks), kThreads,
                                  0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(c),
      static_cast<TA*>(out), n_q, n_rows, dim, block_size, g.n_q_tiles);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Refuses (cudaErrorInvalidValue) what the tensor maps cannot describe:
// dim % 8 != 0, a base not 16-byte aligned, a failed encode, more rows
// than a TMA coordinate holds; never hands the call to another kernel.
int launch_bf16(const void* q, const void* c, void* out, int n_q,
                long long n_rows, int dim, int block_size,
                cudaStream_t stream) {
  if (dim % 8 != 0 || !aligned16(q) || !aligned16(c) || n_rows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_q_tiles = (n_q + kBf16Q - 1) / kBf16Q;
  const long long blocks = n_q_tiles * ((n_rows + kTileRows - 1) / kTileRows);
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mc;
  if (hopper::encode_rows(&mq, q, n_q, dim, kBf16Q) != 0 ||
      hopper::encode_rows(&mc, c, n_rows, dim, kTileRows) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      blockmax_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBf16SmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  blockmax_bf16<<<static_cast<unsigned>(blocks), kBf16Threads, kBf16SmemBytes,
                  stream>>>(mq, mc, static_cast<float*>(out), n_q, n_rows,
                            dim, block_size, n_q_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16, 2 = int8. Returns a cudaError_t
// (0 on success; cudaErrorInvalidValue for operands the kernels do not
// take); the launch is asynchronous on `stream`.
extern "C" int blockmax_scores_launch(int q_type, int c_type, const void* q,
                                      const void* c, void* out, int n_q,
                                      long long n_rows, int dim,
                                      int block_size, void* stream) {
  if (block_size <= 0 || kTileRows % block_size != 0 || n_q < 0 ||
      n_rows < 0 || dim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == 0 && c_type == 0)
    return launch_simt<float>(q, c, out, n_q, n_rows, dim, block_size, s);
  if (q_type == 0 && c_type == 2)
    return launch_simt<int8_t>(q, c, out, n_q, n_rows, dim, block_size, s);
  if (q_type == 1 && c_type == 1)
    return launch_bf16(q, c, out, n_q, n_rows, dim, block_size, s);
  if (dim % 8 != 0 || !aligned16(q) || !aligned16(c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_type == 1 && c_type == 2)
    return launch_wmma<__nv_bfloat16, int8_t, __nv_bfloat16, float>(
        q, c, out, n_q, n_rows, dim, block_size, s);
  if (q_type == 2 && c_type == 2)
    return launch_wmma<int8_t, int8_t, signed char, int>(
        q, c, out, n_q, n_rows, dim, block_size, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory blockmax_bf16 is launched with, in bytes
// (ptxas's report counts only static shared memory).
extern "C" void blockmax_bf16_smem(int* bytes) { bytes[0] = kBf16SmemBytes; }
