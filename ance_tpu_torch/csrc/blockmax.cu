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
// compute bound by a wide margin (3.18 ms at the bf16 peak, 1.59 at the
// int8 peak). At small Q (a few queries per call) it is the corpus bytes,
// ~0.46 ms per 1M x 768 bf16 rows at 3.35 TB/s. Seven kernels, one a
// route:
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
//  * int8 x int8 -> int32 (blockmax_int8: topk_blockmax's phase1_dtype
//    int8 over an int8 corpus). blockmax_bf16's block, ring and epilogue
//    on int8 operands and int32 scores, with wgmma m64n256k32 s8 x s8 ->
//    s32 (both operands K-major: the integer wgmma has no transpose). A
//    stage is 128 columns deep: an int8 row of 128 is one 128-byte
//    swizzle span, as a bf16 row of 64 is, so a stage holds the same
//    48 KB (four k32 steps, each advancing the descriptors by 32 bytes)
//    and four stages fill the same 192 KB; at D = 768 that is six stages,
//    four in flight. The sum is exact in int32, so one running
//    accumulator serves the whole of D (no truncation, unlike fp32).
//  * fp32 queries (f32 x f32, f32 x int8: blockmax_pieces_f32 and
//    blockmax_pieces_int8). The tensor cores take no exact fp32 product
//    (TF32 keeps 10 bits), so each fp32 operand is split into three bf16
//    pieces, x = x0 + x1 + x2 exactly (x0 = bf16(x), x1 = bf16(x - x0),
//    x2 = bf16(x - x0 - x1)), and the piece products run on wgmma, each
//    exact in fp32. f32 x f32 sums the six with i + j <= 2 (q0c0 + q0c1 +
//    q1c0 + q0c2 + q1c1 + q2c0; the dropped three are below 2^-25 of
//    |q||c|); f32 x int8 the three q_i c (an int8 code is exact in bf16).
//    The query pieces [3, Q, D] come split (ops/topk.py); the corpus, the
//    operand read from device memory, is split in registers as it is read,
//    never stored twice: a consumer warpgroup reads its 64 rows of the
//    TMA-loaded fp32 (or int8) tile into wgmma A fragments, splits (or
//    widens) them, and issues m64n128k16 with A from registers against the
//    query pieces in shared memory, the next fragments split while the
//    last products run. The tensor cores' fp32 accumulation truncates, so
//    a long sum drifts toward zero by up to an ulp of itself an update:
//    each 32-column stage sums into a fresh accumulator, added to a
//    running total with one round-to-nearest add a stage, which takes two
//    accumulators a thread and so a tile of 128 queries (not 256). Stages
//    are 32 deep (an fp32 row of 32 is one 128-byte swizzle span; the
//    pieces' 64-byte rows take the 64-byte swizzle), five in the ring; the
//    epilogue is blockmax_bf16's at 128 queries, a block walks tiles
//    (persistent, below), and the producer is a whole warpgroup that
//    gives its registers to the consumers (setmaxnreg). At Q = 2048 x 1M x 768 the six products
//    bound it at 19.1 ms (6 x 3.18), the three of int8 at 9.5 ms.
//  * bf16 x int8 -> fp32 (blockmax_bf16_int8: phase1_dtype bf16 over an
//    int8 corpus). The pieces kernel with one query piece, the bf16 query
//    itself: the int8 tile arrives by TMA (half a bf16 tile's bytes), is
//    widened into A fragments in registers (exact) and multiplied against
//    the bf16 query tile, a third of blockmax_pieces_int8's products
//    (bound 3.18 ms at the bf16 peak). Its fp32 sums truncate as the
//    pieces routes' do, so it keeps their fresh accumulator a stage, but
//    with one product a k-step a 32-column stage would be mostly its
//    fixed work (barriers, waits, the add to the total): its stages are
//    128 columns deep (an int8 row of 128 is one 128-byte span; the
//    query's 128 columns two 128-byte-swizzled [128][64] tiles), eight
//    k-steps into one fresh accumulator, four stages in the ring
//    (PieceStage). Two accumulators a thread keep its tiles at 128
//    queries, twice blockmax_bf16's count, so a tile's fixed work weighs
//    twice: the pieces kernels are persistent (one block an SM walks its
//    tiles, and its producer fills the next tile's ring during the last
//    one's epilogue): at Q = 2048 on an H100, 7.91 -> 7.01 ms, and 3-6%
//    off the fp32-query routes (experiments/blockmax_variants.py).
//  * fp32 queries where a tensor map cannot describe an operand (D % 4 !=
//    0, or D % 16 != 0 under an int8 corpus; a base not 16-byte aligned):
//    blockmax_simt, on the CUDA cores, a shared-memory tiled product with
//    an 8x4 register micro-tile per thread. ops/topk.py chooses it by
//    shape before any launch.
//  * bf16 or int8 queries over an int8 corpus that no tensor map describes
//    (D % 16 != 0, D % 8 == 0): blockmax_wmma (16x16x16 mma.sync fragments;
//    fp32 / int32 accumulation), each of 8 warps owning a 32 x 32 piece of
//    a 128-row x 64-query tile, one stage loaded through registers; its
//    own entry point, blockmax_wmma_launch.
// For all of them the tiles are numbered with the query tile varying
// fastest (a block a tile, or for the pieces kernels one block an SM
// taking every gridDim-th tile), so the tiles that share a corpus tile
// run together and read it from device memory about once, while the
// (small) query matrix stays in L2. Only
// block maxima are written (Q*N/BS values).
// All row and element offsets are 64-bit: at 8.8M x 768 the corpus holds
// 6.8e9 elements, past int32.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <type_traits>

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
// fp32 queries (f32 x f32 and f32 x int8) whose corpus no tensor map
// describes; every other fp32-query shape takes blockmax_pieces_*.

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
// bf16 x int8 (as bf16) and int8 x int8 on WMMA, for D % 16 != 0 (the
// wgmma routes take every other shape). Tiles load in
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

// -------------------------- bf16 x bf16 and int8 x int8, wgmma + TMA

using hopper::bf16;

constexpr int kBf16Q = 256;       // queries per block: wgmma's N
constexpr int kBf16Stages = 4;    // ring of 128-byte-deep k steps
constexpr int kConsumerWarps = 8;  // two warpgroups of 64 corpus rows (M)
constexpr int kBf16Consumers = 32 * kConsumerWarps;
constexpr int kBf16Threads = kBf16Consumers + 32;  // + the producer warp
constexpr int kMaximaLd = kBf16Q + 4;  // values a row of the maxima tile
constexpr int kWideRowBytes = 128;     // a stage row: one 128-byte span
constexpr int kBf16StageBytes = (kTileRows + kBf16Q) * kWideRowBytes;

// The ring and the epilogue of the n256 routes, for operands of type TE
// (bf16: a stage is 64 columns; int8: 128) and block maxima of type TA
// (fp32; int32 for int8 x int8). A stage row is 128 bytes either way.
template <typename TE, typename TA>
struct alignas(1024) WideSmem {
  static constexpr int kCols = kWideRowBytes / static_cast<int>(sizeof(TE));
  TE c[kBf16Stages][kTileRows * kCols];  // corpus rows x one stage
  TE q[kBf16Stages][kBf16Q * kCols];     // queries x one stage
  // the maximum of each 16-row group (8 for block_size 8) for each query
  TA maxima[kTileRows / 8][kMaximaLd];
  uint64_t full[kBf16Stages], empty[kBf16Stages];
  // block_size 1, 2 and 4: every row's score for each query, laid over the
  // ring once its last product has been read
  __device__ TA (*rows())[kMaximaLd] {
    return reinterpret_cast<TA (*)[kMaximaLd]>(c);
  }
};
using Bf16Smem = WideSmem<bf16, float>;
using Int8Smem = WideSmem<int8_t, int>;
static_assert(sizeof(Bf16Smem) == sizeof(Int8Smem), "one layout in bytes");
static_assert(offsetof(Bf16Smem, maxima) >=
                  sizeof(float) * kTileRows * kMaximaLd,
              "the row scores overrun the ring");
constexpr int kSmemSlack = 1024;  // aligned_smem's rounding
constexpr int kBf16SmemBytes = static_cast<int>(sizeof(Bf16Smem)) + kSmemSlack;
static_assert(kBf16SmemBytes <= 232448, "more than a block's shared memory");

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

// Over the 8 lanes g of one c (lane bits 2-4), the maximum of each of the
// NQ / 4 columns whose values this thread holds at acc[4j + Off + e]
// (column 8j + c + e, j = 0..NQ/8 - 1, e = 0, 1), as a reduce-scatter: at
// each of three xor shuffles (16, 8, 4: g's bits 2, 1, 0) a lane keeps the
// half of its columns whose j has that bit equal to its own and takes the
// partner's values of that half. Afterwards lane g holds the maximum of
// column 8(8i + g) + c + e = 64i + 8g + c + e at acc[32i + Off + e],
// i = 0..NQ/64 - 1: at NQ = 256, 56 shuffles where an all-reduce of 64
// values takes 192.
template <int Off, int NQ, typename T>
__device__ __forceinline__ void lane_max_scatter(T (&acc)[NQ / 2], int g) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int jbit = 4 >> s, lanes = 16 >> s;
    const bool up = g & jbit;
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
      if (j & (8 - jbit)) continue;  // a reduced bit or the step's bit set
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        T& lo = acc[4 * j + Off + e];
        const T hi = acc[4 * (j + jbit) + Off + e];
        const T send = up ? lo : hi;
        const T keep = up ? hi : lo;
        lo = vmax(keep, __shfl_xor_sync(~0u, send, lanes));
      }
    }
  }
}

// The epilogue of the wgmma routes, for a block of 128 corpus rows
// (two warpgroups' acc, the layout of hopper.cuh, j = 0..NQ/8 - 1) x NQ
// queries (256 for blockmax_bf16 and blockmax_int8, 128 for the pieces
// kernels), on fp32 or (int8 x int8) int32 scores:
// acc[4j + 2h + e] = score of corpus row 16 warp + g + 8h and query
// 8j + c + e. A row of `tile` (NQ + 4 values) holds, for each query, the
// maximum of a 16-row group (block_size >= 16) or of an 8-row group (8),
// taken in registers, or one row's score (1, 2, 4: the whole score tile,
// laid over the spent ring `rows`); a block is `per` of its rows. The
// caller has waited for every product; `rows` is read by no product any
// more once the consumers pass the first barrier.
template <int NQ, typename T>
__device__ __forceinline__ void block_maxima(
    T (&acc)[NQ / 2], T (*maxima)[NQ + 4], T (*rows)[NQ + 4],
    const hopper::Lane& ln, int warp, T* __restrict__ out, int q0,
    long long row0, int n_q, long long n_rows, int block_size) {
  using T2 = std::conditional_t<std::is_same_v<T, float>, float2, int2>;
  T (*tile)[NQ + 4] = maxima;
  int per = 1;
  if (block_size >= 16) {  // rows g and g + 8 share a block
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[4 * j + e] = vmax(acc[4 * j + e], acc[4 * j + 2 + e]);
    lane_max_scatter<0, NQ>(acc, ln.g);
    T* row = tile[warp];
#pragma unroll
    for (int i = 0; i < NQ / 64; ++i)
      *reinterpret_cast<T2*>(row + 64 * i + 8 * ln.g + ln.c) =
          T2{acc[32 * i], acc[32 * i + 1]};
    per = block_size / 16;
  } else if (block_size == 8) {  // rows g and rows g + 8 are two blocks
    lane_max_scatter<0, NQ>(acc, ln.g);
    lane_max_scatter<2, NQ>(acc, ln.g);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* row = tile[2 * warp + h];
#pragma unroll
      for (int i = 0; i < NQ / 64; ++i)
        *reinterpret_cast<T2*>(row + 64 * i + 8 * ln.g + ln.c) =
            T2{acc[32 * i + 2 * h], acc[32 * i + 2 * h + 1]};
    }
  } else {  // blocks within a row group: the whole score tile, over the ring
    hopper::named_barrier(1, kBf16Consumers);  // every product has read it
    tile = rows;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* row = tile[16 * warp + ln.g + 8 * h];
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
        *reinterpret_cast<T2*>(row + 8 * j + ln.c) =
            T2{acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
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
  for (int i = threadIdx.x; i < blocks_per_tile * NQ; i += kBf16Consumers) {
    const int b = i % blocks_per_tile, n = i / blocks_per_tile;
    const long long gb = block0 + b;
    const int q = q0 + n;
    if (gb >= n_blocks || q >= n_q) continue;
    T m = tile[b * per][n];
    for (int k = 1; k < per; ++k) m = vmax(m, tile[b * per + k][n]);
    out[static_cast<long long>(q) * n_blocks + gb] = m;
  }
}

// One block: rows [row0, row0 + 128) of the corpus against queries
// [q0, q0 + 256). Warp 8 is the producer; warps 0-7 are two consumer
// warpgroups, warpgroup wg owning corpus rows 64 wg .. 64 wg + 63. A stage
// is 128 bytes of every row: four k-steps, of 16 bf16 columns
// (m64n256k16) or of 32 int8 columns (m64n256k32).
template <typename TE, typename TA>
__device__ __forceinline__ void wide_block(const CUtensorMap& mq,
                                           const CUtensorMap& mc,
                                           TA* __restrict__ out, int n_q,
                                           long long n_rows, int dim,
                                           int block_size,
                                           long long n_q_tiles) {
  using Smem = WideSmem<TE, TA>;
  constexpr int kCols = Smem::kCols;
  Smem& sm = hopper::aligned_smem<Smem>();
  const long long bid = blockIdx.x;
  const int q0 = static_cast<int>(bid % n_q_tiles) * kBf16Q;
  const long long row0 = (bid / n_q_tiles) * kTileRows;
  const int n_k = (dim + kCols - 1) / kCols;  // columns past dim: zero
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
        hopper::tma_load_2d(sm.c[r.stage], &mc, kCols * t,
                            static_cast<int>(row0), &sm.full[r.stage]);
        hopper::tma_load_2d(sm.q[r.stage], &mq, kCols * t, q0,
                            &sm.full[r.stage]);
      }
    }
    return;
  }

  const hopper::Lane ln;
  const int warp = threadIdx.x / 32;  // the row group 16 warp .. + 15
  TA acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = TA(0);
  hopper::Ring<kBf16Stages> r;
  for (int t = 0; t < n_k; ++t, r.next()) {
    hopper::mbar_wait(&sm.full[r.stage], r.phase);
    const uint64_t da = hopper::desc_sw128(sm.c[r.stage] + ln.wg * 64 * kCols);
    const uint64_t db = hopper::desc_sw128(sm.q[r.stage]);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (sizeof(TE) == 2)
        hopper::wgmma_ss_n256(acc, da + kk * hopper::kKStepK,
                              db + kk * hopper::kKStepK, 1);
      else
        hopper::wgmma_ss_n256_s8(acc, da + kk * hopper::kKStepK,
                                 db + kk * hopper::kKStepK, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();  // the other warpgroup's products fill the gap
    hopper::fence_regs(acc);
    if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&sm.empty[r.stage]);
  }

  block_maxima<kBf16Q>(acc, sm.maxima, sm.rows(), ln, warp, out, q0, row0,
                       n_q, n_rows, block_size);
}

__global__ void __launch_bounds__(kBf16Threads, 1)
    blockmax_bf16(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mc,
                  float* __restrict__ out, int n_q, long long n_rows, int dim,
                  int block_size, long long n_q_tiles) {
  wide_block<bf16, float>(mq, mc, out, n_q, n_rows, dim, block_size,
                          n_q_tiles);
}

__global__ void __launch_bounds__(kBf16Threads, 1)
    blockmax_int8(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mc,
                  int* __restrict__ out, int n_q, long long n_rows, int dim,
                  int block_size, long long n_q_tiles) {
  wide_block<int8_t, int>(mq, mc, out, n_q, n_rows, dim, block_size,
                          n_q_tiles);
}

// ---------------- fp32 and bf16 queries: bf16 pieces on wgmma + TMA

constexpr int kPieceQ = 128;     // queries per block: wgmma's N
// two consumer warpgroups and a producer warpgroup (one thread of it
// issues the loads), which gives its registers to the consumers: 232 a
// consumer thread holds the two 64-float accumulators, its A fragments
// (three pieces' two k-steps, 24; one piece's eight, 32) and the split's
// temporaries without spilling
constexpr int kPieceThreads = kBf16Consumers + hopper::kWgThreads;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kConsumerRegs * kBf16Consumers +
                      kProducerRegs * hopper::kWgThreads <= 65536,
              "more registers than an SM holds");

// What a corpus element type brings to the routes: its pieces in
// registers and its tensor-map type.
template <typename TC>
struct CorpusTile;

template <>
struct CorpusTile<float> {
  static constexpr int kPieces = 3;  // c0, c1, c2
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <>
struct CorpusTile<int8_t> {
  static constexpr int kPieces = 1;  // the code itself, exact in bf16
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

constexpr CUtensorMapSwizzle swizzle_for(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A ring stage of the pieces routes, QP query pieces over a TC corpus:
//  * fp32 queries (QP = 3): 32 columns deep, so that an fp32 corpus row
//    is one 128-byte swizzle span (an int8 row 32 bytes); each query
//    piece one [128][32] bf16 tile (64-byte rows, 64-byte swizzle); five
//    stages. Six or three products a k-step keep a stage's two k-steps
//    busy.
//  * bf16 queries over int8 (QP = 1): one product a k-step, so the
//    stage's fixed work (the barriers, the wait for its products, the
//    add of its accumulator to the total) is spread over 128 columns,
//    eight k-steps: an int8 row of 128 is one 128-byte span, and the
//    query's 128 columns are two [128][64] bf16 tiles (128-byte rows,
//    128-byte swizzle); four stages, 192 KB.
// The corpus tile is [128][kK] with the TMA swizzle of its row width:
// the 16-byte chunk j of row r at chunk j ^ (r / (128 / row bytes) %
// (row bytes / 16)).
template <typename TC, int QP>
struct PieceStage {
  static_assert(QP == 3 || (QP == 1 && sizeof(TC) == 1),
                "three query pieces, or bf16 queries over int8");
  static constexpr int kK = QP == 3 ? 32 : 128;  // columns a stage
  static constexpr int kSteps = kK / 16;         // wgmma k-steps a stage
  static constexpr int kStages = QP == 3 ? 5 : 4;
  // A-fragment buffers a consumer cycles through: k-step kk's fragments
  // are loaded once k-step kk - kBuffers's products are done, so up to
  // kBuffers - 1 k-steps' products stay in flight. One piece's fragments
  // are 4 registers, so QP = 1 loads a whole stage's (32 registers) and
  // waits once a stage (at Q = 2048 on an H100 7.01 ms, against 7.36 with
  // four buffers and 7.47 with two: experiments/blockmax_variants.py);
  // three pieces' are 12, and two k-steps' fill what the split leaves
  static constexpr int kBuffers = QP == 3 ? 2 : 8;
  static constexpr int kQTiles = QP == 3 ? 3 : kK / 64;  // bf16 tiles
  static constexpr int kQCols = QP == 3 ? kK : 64;       // columns a tile
  static constexpr CUtensorMapSwizzle kQSwizzle = swizzle_for(2 * kQCols);
  static constexpr int kRowBytes = kK * static_cast<int>(sizeof(TC));
  static constexpr CUtensorMapSwizzle kSwizzle = swizzle_for(kRowBytes);
  static_assert(kRowBytes == 32 || kRowBytes == 64 || kRowBytes == 128,
                "a corpus row is one swizzle span");
  static constexpr int kStageBytes =
      kQTiles * kPieceQ * kQCols * 2 + kTileRows * kRowBytes;
  // the byte of row r, column k (0 .. kK - 1) of the corpus tile
  static __device__ __forceinline__ int offset(int r, int k) {
    constexpr int kEsize = static_cast<int>(sizeof(TC));
    const int at = k * kEsize;
    const int swz = (r / (128 / kRowBytes)) % (kRowBytes / 16);
    return r * kRowBytes + (((at >> 4) ^ swz) << 4) + (at & 15);
  }
  // the descriptor of k-step kk of query piece p: the piece's tile, or
  // for QP = 1 the half of the stage that holds the k-step
  static __device__ __forceinline__ uint64_t q_desc(
      const bf16 (*q)[kPieceQ * kQCols], int p, int kk) {
    if constexpr (QP == 3)
      return hopper::desc_sw64(q[p]) + kk * hopper::kKStepK;
    else
      return hopper::desc_sw128(q[kk / 4]) + (kk % 4) * hopper::kKStepK;
  }
};

template <typename TC, int QP>
struct alignas(1024) PieceSmem {
  using Stage = PieceStage<TC, QP>;
  static constexpr int kStages = Stage::kStages;
  bf16 q[kStages][Stage::kQTiles][kPieceQ * Stage::kQCols];
  TC c[kStages][kTileRows * Stage::kK];  // corpus rows x a stage's columns
  float maxima[kTileRows / 8][kPieceQ + 4];
  uint64_t full[kStages], empty[kStages];
  uint64_t tile_free;  // block_size 1, 2, 4: a tile's row scores are read
  // block_size 1, 2, 4: laid over the query tiles and the corpus tiles
  __device__ float (*rows())[kPieceQ + 4] {
    return reinterpret_cast<float (*)[kPieceQ + 4]>(q);
  }
};
template <typename TC, int QP>
constexpr int kPieceSmemBytes =
    static_cast<int>(sizeof(PieceSmem<TC, QP>)) + kSmemSlack;
template <typename TC, int QP>
constexpr bool piece_smem_fits() {
  using Smem = PieceSmem<TC, QP>;
  return offsetof(Smem, maxima) >= sizeof(float) * kTileRows * (kPieceQ + 4) &&
         kPieceSmemBytes<TC, QP> <= 232448;
}
static_assert(piece_smem_fits<float, 3>() && piece_smem_fits<int8_t, 3>() &&
                  piece_smem_fits<int8_t, 1>(),
              "the row scores overrun the ring, or more than a block's "
              "shared memory");

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A fragments (hopper.cuh) of k-step kk (columns 16 kk .. + 15) of the
// warp's 16 rows `row` .. + 15 of the stage's corpus tile, as pieces:
// a[p][0] = rows row + g, columns c, c + 1; a[p][1] = row + g + 8;
// a[p][2], a[p][3] = the same rows, columns c + 8, c + 9. A warp's 8-byte
// fp32 loads fall on 32 distinct banks in two wavefronts (the swizzle
// spreads its 8 rows over the 8 chunks), its 2-byte int8 loads on
// distinct words or two lanes' one word.
template <typename TC, int QP>
__device__ __forceinline__ void load_pieces(
    uint32_t (&a)[CorpusTile<TC>::kPieces][4], const TC* tile, int row,
    const hopper::Lane& ln, int kk) {
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row + ln.g + 8 * (i & 1);
    const int k = 16 * kk + ln.c + 8 * (i >> 1);
    const int at = PieceStage<TC, QP>::offset(r, k);
    if constexpr (sizeof(TC) == 4) {
      const float2 v = *reinterpret_cast<const float2*>(base + at);
      hopper::split3(v.x, v.y, a[0][i], a[1][i], a[2][i]);
    } else {
      const char2 v = *reinterpret_cast<const char2*>(base + at);
      a[0][i] = bits(__floats2bfloat162_rn(static_cast<float>(v.x),
                                           static_cast<float>(v.y)));
    }
  }
}

// The piece products of k-step kk, accumulated into d: with q (the
// stage's QP query pieces) as B, q0c0, q0c1, q1c0, q0c2, q1c1, q2c0 for
// an fp32 corpus (A = c0, c1, c2), q0c, q1c, q2c for int8 (A = c), and
// for bf16 queries (one piece, the query itself) over int8 q0c. The
// stage's first product (kk = 0) overwrites d.
template <typename TC, int QP>
__device__ __forceinline__ void issue_pieces(
    float (&d)[64], const uint32_t (&a)[CorpusTile<TC>::kPieces][4],
    const bf16 (*q)[kPieceQ * PieceStage<TC, QP>::kQCols], int kk) {
  uint64_t db[QP];
#pragma unroll
  for (int p = 0; p < QP; ++p) db[p] = PieceStage<TC, QP>::q_desc(q, p, kk);
  if constexpr (QP == 1) {
    hopper::wgmma_rs_n128(d, a[0], db[0], kk);
  } else if constexpr (sizeof(TC) == 4) {
    hopper::wgmma_rs_n128(d, a[0], db[0], kk);
    hopper::wgmma_rs_n128(d, a[1], db[0]);
    hopper::wgmma_rs_n128(d, a[0], db[1]);
    hopper::wgmma_rs_n128(d, a[2], db[0]);
    hopper::wgmma_rs_n128(d, a[1], db[1]);
    hopper::wgmma_rs_n128(d, a[0], db[2]);
  } else {
    hopper::wgmma_rs_n128(d, a[0], db[0], kk);
    hopper::wgmma_rs_n128(d, a[0], db[1]);
    hopper::wgmma_rs_n128(d, a[0], db[2]);
  }
}

// A persistent block (one an SM): tiles blockIdx.x, + gridDim.x, ... of
// the grid of 128-row x 128-query tiles, query tile fastest, a tile rows
// [row0, row0 + 128) of the corpus against queries [q0, q0 + 128). One
// thread of warpgroup 2 is the producer (per stage: the corpus tile and
// the query tiles, rows p * n_q + q0 of the [QP n_q, D] pieces, or for
// QP = 1 the two column halves of the bf16 queries); it walks on into the
// next tile's stages while the consumers take a tile's block maxima, so a
// tile's ring fill overlaps the last one's epilogue (except at block_size
// 1, 2 and 4, whose row scores lie over the ring: there it waits for the
// epilogue, tile_free). Warps 0-7 are two consumer warpgroups of 64
// corpus rows. The tensor cores' fp32 accumulation truncates each
// product's sum (toward zero, not to nearest), so an update of a large
// running sum loses up to an ulp of it: over D = 768 (288 updates) that
// drifts by ~4e-3 at scores ~700. So a stage's products go to a fresh
// accumulator `part` (its first product overwrites it), small as one
// stage's sum, and `total` takes it with one round-to-nearest add a
// stage. Per k-step a consumer fences that k-step's fragments and issues
// their products, then (once the products that last read the next
// buffer are done) splits the next k-step's fragments into it while the
// products run; after the stage's last issue it waits for the products
// that read buffer 0, splits the next stage's k-step 0, waits for the
// stage's products, frees the stage and adds `part` to `total`. The other
// warpgroup's products keep the tensor cores busy across the waits.
template <typename TC, int QP>
__device__ __forceinline__ void pieces_block(const CUtensorMap& mq,
                                             const CUtensorMap& mc,
                                             float* __restrict__ out, int n_q,
                                             long long n_rows, int dim,
                                             int block_size,
                                             long long n_q_tiles,
                                             long long n_tiles) {
  using Smem = PieceSmem<TC, QP>;
  using Stage = PieceStage<TC, QP>;
  constexpr int P = CorpusTile<TC>::kPieces;
  constexpr int kStages = Smem::kStages;
  constexpr int kK = Stage::kK;
  constexpr int kBuffers = Stage::kBuffers;
  static_assert(Stage::kSteps % kBuffers == 0,
                "a stage's k-steps cycle through whole buffers");
  Smem& sm = hopper::aligned_smem<Smem>();
  const int n_k = (dim + kK - 1) / kK;  // columns past dim: zero
  const bool rows_over_ring = block_size < 8;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&sm.full[i], 1);
      hopper::mbar_init(&sm.empty[i], kConsumerWarps);
    }
    hopper::mbar_init(&sm.tile_free, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kBf16Consumers) {  // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kBf16Consumers) {
      hopper::Ring<kStages> r;
      uint32_t free_phase = 0;
      for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        if (rows_over_ring && tile != blockIdx.x) {
          hopper::mbar_wait(&sm.tile_free, free_phase);
          free_phase ^= 1;
        }
        const int q0 = static_cast<int>(tile % n_q_tiles) * kPieceQ;
        const int row0 = static_cast<int>((tile / n_q_tiles) * kTileRows);
        for (int t = 0; t < n_k; ++t, r.next()) {
          hopper::mbar_wait(&sm.empty[r.stage], r.phase ^ 1);
          hopper::mbar_expect_tx(&sm.full[r.stage], Stage::kStageBytes);
          hopper::tma_load_2d(sm.c[r.stage], &mc, kK * t, row0,
                              &sm.full[r.stage]);
          for (int i = 0; i < Stage::kQTiles; ++i) {
            if constexpr (QP == 3)  // piece i
              hopper::tma_load_2d(sm.q[r.stage][i], &mq, kK * t,
                                  i * n_q + q0, &sm.full[r.stage]);
            else  // column half i
              hopper::tma_load_2d(sm.q[r.stage][i], &mq,
                                  kK * t + Stage::kQCols * i, q0,
                                  &sm.full[r.stage]);
          }
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const hopper::Lane ln;
  const int warp = threadIdx.x / 32;  // corpus rows 16 warp .. + 15
  float total[64], part[64];
  uint32_t a[kBuffers][P][4];  // k-step kk's fragments in a[kk % kBuffers]
  hopper::Ring<kStages> r;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int q0 = static_cast<int>(tile % n_q_tiles) * kPieceQ;
    const long long row0 = (tile / n_q_tiles) * kTileRows;
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = part[i] = 0.f;
    hopper::mbar_wait(&sm.full[r.stage], r.phase);
    load_pieces<TC, QP>(a[0], sm.c[r.stage], 16 * warp, ln, 0);
    for (int t = 0; t < n_k; ++t, r.next()) {
      hopper::fence_regs(part);
#pragma unroll
      for (int kk = 0; kk < Stage::kSteps; ++kk) {
        hopper::fence_regs(a[kk % kBuffers]);
        hopper::wgmma_fence();
        issue_pieces<TC, QP>(part, a[kk % kBuffers], sm.q[r.stage], kk);
        hopper::wgmma_commit();
        if (kk + 1 < Stage::kSteps) {
          const int next = (kk + 1) % kBuffers;
          if (kk + 1 >= kBuffers) {
            // k-step kk + 1 - kBuffers's products, the last to read the
            // buffer, are done: at most the kBuffers - 1 after it in flight
            hopper::wgmma_wait<kBuffers - 1>();
            hopper::fence_regs(a[next]);
          }
          load_pieces<TC, QP>(a[next], sm.c[r.stage], 16 * warp, ln,
                              kk + 1);
        }
      }
      // k-step kSteps - kBuffers's products, the last to read a[0], are
      // done
      hopper::wgmma_wait<kBuffers - 1>();
      hopper::fence_regs(a[0]);
      if (t + 1 < n_k) {
        const bool wrap = r.stage + 1 == kStages;
        const int next = wrap ? 0 : r.stage + 1;
        hopper::mbar_wait(&sm.full[next], wrap ? r.phase ^ 1 : r.phase);
        load_pieces<TC, QP>(a[0], sm.c[next], 16 * warp, ln, 0);
      }
      hopper::wgmma_wait_all();  // the stage's products are done
#pragma unroll
      for (int b = 1; b < kBuffers; ++b) hopper::fence_regs(a[b]);
      hopper::fence_regs(part);
      if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&sm.empty[r.stage]);
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] = __fadd_rn(total[i], part[i]);
    }

    block_maxima<kPieceQ>(total, sm.maxima, sm.rows(), ln, warp, out, q0,
                          row0, n_q, n_rows, block_size);
    // every consumer has read the tile's maxima (or row scores) before
    // the next tile writes them, or the producer the ring under them
    hopper::named_barrier(1, kBf16Consumers);
    if (rows_over_ring && threadIdx.x == 0) hopper::mbar_arrive(&sm.tile_free);
  }
}

__global__ void __launch_bounds__(kPieceThreads, 1)
    blockmax_pieces_f32(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mc,
                        float* __restrict__ out, int n_q, long long n_rows,
                        int dim, int block_size, long long n_q_tiles,
                        long long n_tiles) {
  pieces_block<float, 3>(mq, mc, out, n_q, n_rows, dim, block_size,
                         n_q_tiles, n_tiles);
}

__global__ void __launch_bounds__(kPieceThreads, 1)
    blockmax_pieces_int8(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mc,
                         float* __restrict__ out, int n_q, long long n_rows,
                         int dim, int block_size, long long n_q_tiles,
                         long long n_tiles) {
  pieces_block<int8_t, 3>(mq, mc, out, n_q, n_rows, dim, block_size,
                          n_q_tiles, n_tiles);
}

// bf16 queries x int8 corpus: the pieces kernel with the queries as their
// own one piece (a third of blockmax_pieces_int8's products)
__global__ void __launch_bounds__(kPieceThreads, 1)
    blockmax_bf16_int8(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mc,
                       float* __restrict__ out, int n_q, long long n_rows,
                       int dim, int block_size, long long n_q_tiles,
                       long long n_tiles) {
  pieces_block<int8_t, 1>(mq, mc, out, n_q, n_rows, dim, block_size,
                          n_q_tiles, n_tiles);
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

// blockmax_bf16 (TE = bf16) and blockmax_int8 (TE = int8). Refuses
// (cudaErrorInvalidValue) what the tensor maps cannot describe: rows not a
// multiple of 16 bytes (dim % 8 != 0 for bf16, dim % 16 != 0 for int8), a
// base not 16-byte aligned, a failed encode, more rows than a TMA
// coordinate holds; never hands the call to another kernel.
template <typename TE>
int launch_wide(const void* q, const void* c, void* out, int n_q,
                long long n_rows, int dim, int block_size,
                cudaStream_t stream) {
  constexpr bool kInt8 = sizeof(TE) == 1;
  using TA = std::conditional_t<kInt8, int, float>;
  constexpr int kCols = WideSmem<TE, TA>::kCols;
  constexpr CUtensorMapDataType kType =
      kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if ((dim * sizeof(TE)) % 16 != 0 || !aligned16(q) || !aligned16(c) ||
      n_rows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_q_tiles = (n_q + kBf16Q - 1) / kBf16Q;
  const long long blocks = n_q_tiles * ((n_rows + kTileRows - 1) / kTileRows);
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mc;
  const int esize = static_cast<int>(sizeof(TE));
  if (hopper::encode_matrix(&mq, kType, esize, q, n_q, dim, dim, kBf16Q,
                            kCols, CU_TENSOR_MAP_SWIZZLE_128B) != 0 ||
      hopper::encode_matrix(&mc, kType, esize, c, n_rows, dim, dim, kTileRows,
                            kCols, CU_TENSOR_MAP_SWIZZLE_128B) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = [] {
    if constexpr (kInt8) return blockmax_int8;
    else return blockmax_bf16;
  }();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBf16SmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kBf16Threads, kBf16SmemBytes,
           stream>>>(mq, mc, static_cast<TA*>(out), n_q, n_rows, dim,
                     block_size, n_q_tiles);
  return static_cast<int>(cudaGetLastError());
}

// The query pieces' row length: D rounded up to 8 bf16 (16 bytes, a
// tensor map's row stride), zero past D.
int pieces_ld(int dim) { return (dim + 7) / 8 * 8; }

// fp32 queries as three bf16 pieces `q` [3, n_q, pieces_ld(dim)] against
// an fp32 or int8 corpus (QP = 3), or bf16 queries `q` [n_q, dim] against
// an int8 corpus (QP = 1). Refuses (cudaErrorInvalidValue) what a tensor
// map cannot describe: a corpus row not a multiple of 16 bytes (D % 4 for
// fp32, D % 16 for int8), a base not 16-byte aligned, more rows than a
// TMA coordinate holds, a failed encode; never hands the call to another
// kernel (ops/topk.py sends those shapes to blockmax_simt or, for bf16
// queries, blockmax_wmma before any launch).
template <typename TC, int QP>
int launch_pieces(const void* q, const void* c, void* out, int n_q,
                  long long n_rows, int dim, int block_size,
                  cudaStream_t stream) {
  if ((dim * sizeof(TC)) % 16 != 0 || !aligned16(q) || !aligned16(c) ||
      n_rows > INT_MAX || static_cast<long long>(QP) * n_q > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_q_tiles = (n_q + kPieceQ - 1) / kPieceQ;
  const long long n_tiles = n_q_tiles * ((n_rows + kTileRows - 1) / kTileRows);
  if (n_tiles == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = n_tiles < sms ? n_tiles : sms;  // one an SM
  using Stage = PieceStage<TC, QP>;
  CUtensorMap mq, mc;
  if (hopper::encode_matrix(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q,
                            static_cast<long long>(QP) * n_q, dim,
                            pieces_ld(dim), kPieceQ, Stage::kQCols,
                            Stage::kQSwizzle) != 0 ||
      hopper::encode_matrix(&mc, CorpusTile<TC>::kType,
                            static_cast<int>(sizeof(TC)), c,
                            n_rows, dim, dim, kTileRows, Stage::kK,
                            Stage::kSwizzle) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = QP == 1             ? blockmax_bf16_int8
                : sizeof(TC) == 4 ? blockmax_pieces_f32
                                  : blockmax_pieces_int8;
  constexpr int kBytes = kPieceSmemBytes<TC, QP>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kPieceThreads, kBytes, stream>>>(
      mq, mc, static_cast<float*>(out), n_q, n_rows, dim, block_size,
      n_q_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

bool valid_call(int n_q, long long n_rows, int dim, int block_size) {
  return block_size > 0 && kTileRows % block_size == 0 && n_q >= 0 &&
         n_rows >= 0 && dim > 0;
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16, 2 = int8, and for queries 3 =
// float32 given as its three bf16 pieces [3, Q, D rounded up to 8] (ops/
// topk.py's split_bf16_pieces). Each pair has one kernel: f32 pieces x f32
// or int8 -> blockmax_pieces_*, float32 x f32 or int8 -> blockmax_simt,
// bf16 x bf16 -> blockmax_bf16, bf16 x int8 -> blockmax_bf16_int8, int8 x
// int8 -> blockmax_int8 (blockmax_wmma has its own entry below). Returns
// a cudaError_t (0 on success; cudaErrorInvalidValue for operands the
// pair's kernel does not take, and for any other pair); the launch is
// asynchronous on `stream`.
extern "C" int blockmax_scores_launch(int q_type, int c_type, const void* q,
                                      const void* c, void* out, int n_q,
                                      long long n_rows, int dim,
                                      int block_size, void* stream) {
  if (!valid_call(n_q, n_rows, dim, block_size))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == 3 && c_type == 0)
    return launch_pieces<float, 3>(q, c, out, n_q, n_rows, dim, block_size,
                                   s);
  if (q_type == 3 && c_type == 2)
    return launch_pieces<int8_t, 3>(q, c, out, n_q, n_rows, dim, block_size,
                                    s);
  if (q_type == 0 && c_type == 0)
    return launch_simt<float>(q, c, out, n_q, n_rows, dim, block_size, s);
  if (q_type == 0 && c_type == 2)
    return launch_simt<int8_t>(q, c, out, n_q, n_rows, dim, block_size, s);
  if (q_type == 1 && c_type == 1)
    return launch_wide<bf16>(q, c, out, n_q, n_rows, dim, block_size, s);
  if (q_type == 1 && c_type == 2)
    return launch_pieces<int8_t, 1>(q, c, out, n_q, n_rows, dim, block_size,
                                    s);
  if (q_type == 2 && c_type == 2)
    return launch_wide<int8_t>(q, c, out, n_q, n_rows, dim, block_size, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// blockmax_wmma, for bf16 x int8 (1, 2) and int8 x int8 (2, 2) operands
// that no tensor map describes (ops/topk.py: D % 16 != 0). Refuses
// (cudaErrorInvalidValue) dim % 8 != 0, a base not 16-byte aligned and
// any other pair.
extern "C" int blockmax_wmma_launch(int q_type, int c_type, const void* q,
                                    const void* c, void* out, int n_q,
                                    long long n_rows, int dim,
                                    int block_size, void* stream) {
  if (!valid_call(n_q, n_rows, dim, block_size) || dim % 8 != 0 ||
      !aligned16(q) || !aligned16(c))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == 1 && c_type == 2)
    return launch_wmma<__nv_bfloat16, int8_t, __nv_bfloat16, float>(
        q, c, out, n_q, n_rows, dim, block_size, s);
  if (q_type == 2 && c_type == 2)
    return launch_wmma<int8_t, int8_t, signed char, int>(
        q, c, out, n_q, n_rows, dim, block_size, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory blockmax_bf16, blockmax_pieces_f32,
// blockmax_pieces_int8, blockmax_int8 and blockmax_bf16_int8 are launched
// with, in bytes, in that order (ptxas's report counts only static shared
// memory).
extern "C" void blockmax_bf16_smem(int* bytes) {
  bytes[0] = kBf16SmemBytes;
  bytes[1] = kPieceSmemBytes<float, 3>;
  bytes[2] = kPieceSmemBytes<int8_t, 3>;
  bytes[3] = kBf16SmemBytes;
  bytes[4] = kPieceSmemBytes<int8_t, 1>;
}
