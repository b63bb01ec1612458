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
// rows at 3.35 TB/s. Four kernels, one a route:
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
//    accumulators a thread and so a block of 128 queries (not 256). Stages
//    are 32 deep (an fp32 row of 32 is one 128-byte swizzle span; the
//    pieces' 64-byte rows take the 64-byte swizzle), five in the ring; the
//    grid and the epilogue are blockmax_bf16's at 128 queries, and the
//    producer is a whole warpgroup that gives its registers to the
//    consumers (setmaxnreg). At Q = 2048 x 1M x 768 the six products
//    bound it at 19.1 ms (6 x 3.18), the three of int8 at 9.5 ms.
//  * fp32 queries where a tensor map cannot describe an operand (D % 4 !=
//    0, or D % 16 != 0 under an int8 corpus; a base not 16-byte aligned):
//    blockmax_simt, on the CUDA cores, a shared-memory tiled product with
//    an 8x4 register micro-tile per thread. ops/topk.py chooses it by
//    shape before any launch.
// For all of them the grid is 1-D with the query tile varying fastest, so
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
// NQ / 4 columns whose values this thread holds at acc[4j + Off + e]
// (column 8j + c + e, j = 0..NQ/8 - 1, e = 0, 1), as a reduce-scatter: at
// each of three xor shuffles (16, 8, 4: g's bits 2, 1, 0) a lane keeps the
// half of its columns whose j has that bit equal to its own and takes the
// partner's values of that half. Afterwards lane g holds the maximum of
// column 8(8i + g) + c + e = 64i + 8g + c + e at acc[32i + Off + e],
// i = 0..NQ/64 - 1: at NQ = 256, 56 shuffles where an all-reduce of 64
// values takes 192.
template <int Off, int NQ>
__device__ __forceinline__ void lane_max_scatter(float (&acc)[NQ / 2], int g) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int jbit = 4 >> s, lanes = 16 >> s;
    const bool up = g & jbit;
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
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

// The epilogue of the wgmma routes, for a block of 128 corpus rows
// (two warpgroups' acc, the layout of hopper.cuh, j = 0..NQ/8 - 1) x NQ
// queries (256 for blockmax_bf16, 128 for the pieces kernels):
// acc[4j + 2h + e] = score of corpus row 16 warp + g + 8h and query
// 8j + c + e. A row of `tile` (NQ + 4 floats) holds, for each query, the
// maximum of a 16-row group (block_size >= 16) or of an 8-row group (8),
// taken in registers, or one row's score (1, 2, 4: the whole score tile,
// laid over the spent ring `rows`); a block is `per` of its rows. The
// caller has waited for every product; `rows` is read by no product any
// more once the consumers pass the first barrier.
template <int NQ>
__device__ __forceinline__ void block_maxima(
    float (&acc)[NQ / 2], float (*maxima)[NQ + 4], float (*rows)[NQ + 4],
    const hopper::Lane& ln, int warp, float* __restrict__ out, int q0,
    long long row0, int n_q, long long n_rows, int block_size) {
  float (*tile)[NQ + 4] = maxima;
  int per = 1;
  if (block_size >= 16) {  // rows g and g + 8 share a block
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[4 * j + e] = fmaxf(acc[4 * j + e], acc[4 * j + 2 + e]);
    lane_max_scatter<0, NQ>(acc, ln.g);
    float* row = tile[warp];
#pragma unroll
    for (int i = 0; i < NQ / 64; ++i)
      *reinterpret_cast<float2*>(row + 64 * i + 8 * ln.g + ln.c) =
          make_float2(acc[32 * i], acc[32 * i + 1]);
    per = block_size / 16;
  } else if (block_size == 8) {  // rows g and rows g + 8 are two blocks
    lane_max_scatter<0, NQ>(acc, ln.g);
    lane_max_scatter<2, NQ>(acc, ln.g);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = tile[2 * warp + h];
#pragma unroll
      for (int i = 0; i < NQ / 64; ++i)
        *reinterpret_cast<float2*>(row + 64 * i + 8 * ln.g + ln.c) =
            make_float2(acc[32 * i + 2 * h], acc[32 * i + 2 * h + 1]);
    }
  } else {  // blocks within a row group: the whole score tile, over the ring
    hopper::named_barrier(1, kBf16Consumers);  // every product has read it
    tile = rows;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = tile[16 * warp + ln.g + 8 * h];
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
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
  for (int i = threadIdx.x; i < blocks_per_tile * NQ; i += kBf16Consumers) {
    const int b = i % blocks_per_tile, n = i / blocks_per_tile;
    const long long gb = block0 + b;
    const int q = q0 + n;
    if (gb >= n_blocks || q >= n_q) continue;
    float m = tile[b * per][n];
    for (int k = 1; k < per; ++k) m = fmaxf(m, tile[b * per + k][n]);
    out[static_cast<long long>(q) * n_blocks + gb] = m;
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

  block_maxima<kBf16Q>(acc, sm.maxima, sm.rows(), ln, warp, out, q0, row0,
                       n_q, n_rows, block_size);
}

// -------------------------------- fp32 queries: bf16 pieces on wgmma + TMA

constexpr int kPieceK = 32;      // depth of a ring stage
constexpr int kPieceStages = 5;
constexpr int kPieceQ = 128;     // queries per block: wgmma's N
// two consumer warpgroups and a producer warpgroup (one thread of it
// issues the loads), which gives its registers to the consumers: 232 a
// consumer thread holds the two 64-float accumulators, two k-steps of A
// fragments (24) and the split's temporaries without spilling
constexpr int kPieceThreads = kBf16Consumers + hopper::kWgThreads;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kConsumerRegs * kBf16Consumers +
                      kProducerRegs * hopper::kWgThreads <= 65536,
              "more registers than an SM holds");
constexpr int kQPieceBytes = kPieceQ * kPieceK * 2;  // one query piece a stage

// What a corpus element type brings to the route: its pieces in registers,
// the swizzle of its [128][32] tile (an fp32 row of 32 is 128 bytes, an
// int8 row 32) and the byte of row r, column k (0..31) of that tile.
template <typename TC>
struct CorpusTile;

template <>
struct CorpusTile<float> {
  static constexpr int kPieces = 3;  // c0, c1, c2
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  // 128-byte swizzle: 16-byte chunk k / 4 of row r at chunk (k / 4) ^ (r % 8)
  static __device__ __forceinline__ int offset(int r, int k) {
    return r * 128 + (((k >> 2) ^ (r & 7)) << 4) + ((k & 3) << 2);
  }
};

template <>
struct CorpusTile<int8_t> {
  static constexpr int kPieces = 1;  // the code itself, exact in bf16
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_32B;
  // 32-byte swizzle: 16-byte chunk k / 16 of row r at (k / 16) ^ (r / 4 % 2)
  static __device__ __forceinline__ int offset(int r, int k) {
    return r * 32 + (((k >> 4) ^ ((r >> 2) & 1)) << 4) + (k & 15);
  }
};

template <typename TC>
struct alignas(1024) PieceSmem {
  bf16 q[kPieceStages][3][kPieceQ * kPieceK];  // 3 query pieces x 128 x 32
  TC c[kPieceStages][kTileRows * kPieceK];     // corpus rows x 32 columns
  float maxima[kTileRows / 8][kPieceQ + 4];
  uint64_t full[kPieceStages], empty[kPieceStages];
  static constexpr int kStageBytes =
      3 * kQPieceBytes + kTileRows * kPieceK * static_cast<int>(sizeof(TC));
  __device__ float (*rows())[kPieceQ + 4] {  // block_size 1, 2, 4
    return reinterpret_cast<float (*)[kPieceQ + 4]>(q);
  }
};
static_assert(sizeof(PieceSmem<int8_t>::q) >=
                  sizeof(float) * kTileRows * (kPieceQ + 4),
              "the row scores overrun the query pieces");
template <typename TC>
constexpr int kPieceSmemBytes =
    static_cast<int>(sizeof(PieceSmem<TC>)) + kSmemSlack;
static_assert(kPieceSmemBytes<float> <= 232448,
              "more than a block's shared memory");

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A fragments (hopper.cuh) of k-step kk (columns 16 kk .. + 15) of the
// warp's 16 rows `row` .. + 15 of the stage's corpus tile, as pieces:
// a[p][0] = rows row + g, columns c, c + 1; a[p][1] = row + g + 8;
// a[p][2], a[p][3] = the same rows, columns c + 8, c + 9. A warp's 8-byte
// fp32 loads fall on 32 distinct banks in two wavefronts (the swizzle
// spreads its 8 rows over the 8 chunks), its 2-byte int8 loads on
// distinct words.
template <typename TC>
__device__ __forceinline__ void load_pieces(
    uint32_t (&a)[CorpusTile<TC>::kPieces][4], const TC* tile, int row,
    const hopper::Lane& ln, int kk) {
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row + ln.g + 8 * (i & 1);
    const int k = 16 * kk + ln.c + 8 * (i >> 1);
    const int at = CorpusTile<TC>::offset(r, k);
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
// stage's three query pieces) as B, q0c0, q0c1, q1c0, q0c2, q1c1, q2c0 for
// an fp32 corpus (A = c0, c1, c2), q0c, q1c, q2c for int8 (A = c). The
// stage's first product (kk = 0) overwrites d.
template <typename TC>
__device__ __forceinline__ void issue_pieces(
    float (&d)[64], const uint32_t (&a)[CorpusTile<TC>::kPieces][4],
    const bf16 (*q)[kPieceQ * kPieceK], int kk) {
  uint64_t db[3];
#pragma unroll
  for (int p = 0; p < 3; ++p)
    db[p] = hopper::desc_sw64(q[p]) + kk * hopper::kKStepK;
  if constexpr (sizeof(TC) == 4) {
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

// One block: rows [row0, row0 + 128) of the corpus against queries
// [q0, q0 + 128): one thread of warpgroup 2 the producer (per 32-column
// stage: the corpus tile and the three query-piece tiles, rows
// p * n_q + q0 of the [3 n_q, D] pieces), warps 0-7 two consumer
// warpgroups of 64 corpus rows. The tensor cores' fp32 accumulation
// truncates each product's sum (toward zero, not to nearest), so an update
// of a large running sum loses up to an ulp of it: over D = 768 (288
// updates) that drifts by ~4e-3 at scores ~700. So a stage's products go
// to a fresh accumulator `part` (its first product overwrites it), small
// as 32 columns' sum, and `total` takes it with one round-to-nearest add
// a stage. Per stage a consumer fences the k-step 0 fragments and issues
// their products, splits k-step 1's fragments while they run and issues
// those, waits until only those are in flight (so k-step 0's fragments
// are free) and splits the next stage's k-step 0 into them, then waits for
// the stage's products, frees the stage and adds `part` to `total`. The
// other warpgroup's products keep the tensor cores busy across the wait.
template <typename TC>
__device__ __forceinline__ void pieces_block(const CUtensorMap& mq,
                                             const CUtensorMap& mc,
                                             float* __restrict__ out, int n_q,
                                             long long n_rows, int dim,
                                             int block_size,
                                             long long n_q_tiles) {
  using Smem = PieceSmem<TC>;
  constexpr int P = CorpusTile<TC>::kPieces;
  Smem& sm = hopper::aligned_smem<Smem>();
  const long long bid = blockIdx.x;
  const int q0 = static_cast<int>(bid % n_q_tiles) * kPieceQ;
  const long long row0 = (bid / n_q_tiles) * kTileRows;
  const int n_k = (dim + kPieceK - 1) / kPieceK;  // columns past dim: zero
  if (threadIdx.x == 0) {
    for (int i = 0; i < kPieceStages; ++i) {
      hopper::mbar_init(&sm.full[i], 1);
      hopper::mbar_init(&sm.empty[i], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kBf16Consumers) {  // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kBf16Consumers) {
      hopper::Ring<kPieceStages> r;
      for (int t = 0; t < n_k; ++t, r.next()) {
        hopper::mbar_wait(&sm.empty[r.stage], r.phase ^ 1);
        hopper::mbar_expect_tx(&sm.full[r.stage], Smem::kStageBytes);
        hopper::tma_load_2d(sm.c[r.stage], &mc, kPieceK * t,
                            static_cast<int>(row0), &sm.full[r.stage]);
        for (int p = 0; p < 3; ++p)
          hopper::tma_load_2d(sm.q[r.stage][p], &mq, kPieceK * t,
                              p * n_q + q0, &sm.full[r.stage]);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const hopper::Lane ln;
  const int warp = threadIdx.x / 32;  // corpus rows 16 warp .. + 15
  float total[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = part[i] = 0.f;
  uint32_t a[2][P][4];  // the fragments of k-steps 0 and 1 of a stage
  hopper::Ring<kPieceStages> r;
  hopper::mbar_wait(&sm.full[0], 0);
  load_pieces<TC>(a[0], sm.c[0], 16 * warp, ln, 0);
  for (int t = 0; t < n_k; ++t, r.next()) {
    hopper::fence_regs(a[0]);
    hopper::fence_regs(part);
    hopper::wgmma_fence();
    issue_pieces<TC>(part, a[0], sm.q[r.stage], 0);
    hopper::wgmma_commit();
    load_pieces<TC>(a[1], sm.c[r.stage], 16 * warp, ln, 1);
    hopper::fence_regs(a[1]);
    hopper::wgmma_fence();
    issue_pieces<TC>(part, a[1], sm.q[r.stage], 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // k-step 0's products are done
    hopper::fence_regs(a[0]);
    if (t + 1 < n_k) {
      const bool wrap = r.stage + 1 == kPieceStages;
      const int next = wrap ? 0 : r.stage + 1;
      hopper::mbar_wait(&sm.full[next], wrap ? r.phase ^ 1 : r.phase);
      load_pieces<TC>(a[0], sm.c[next], 16 * warp, ln, 0);
    }
    hopper::wgmma_wait_all();  // the stage's products are done
    hopper::fence_regs(a[1]);
    hopper::fence_regs(part);
    if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&sm.empty[r.stage]);
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = __fadd_rn(total[i], part[i]);
  }

  block_maxima<kPieceQ>(total, sm.maxima, sm.rows(), ln, warp, out, q0,
                        row0, n_q, n_rows, block_size);
}

__global__ void __launch_bounds__(kPieceThreads, 1)
    blockmax_pieces_f32(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mc,
                        float* __restrict__ out, int n_q, long long n_rows,
                        int dim, int block_size, long long n_q_tiles) {
  pieces_block<float>(mq, mc, out, n_q, n_rows, dim, block_size, n_q_tiles);
}

__global__ void __launch_bounds__(kPieceThreads, 1)
    blockmax_pieces_int8(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mc,
                         float* __restrict__ out, int n_q, long long n_rows,
                         int dim, int block_size, long long n_q_tiles) {
  pieces_block<int8_t>(mq, mc, out, n_q, n_rows, dim, block_size, n_q_tiles);
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
  if (hopper::encode_matrix(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, n_q,
                            dim, dim, kBf16Q, 64,
                            CU_TENSOR_MAP_SWIZZLE_128B) != 0 ||
      hopper::encode_matrix(&mc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, c,
                            n_rows, dim, dim, kTileRows, 64,
                            CU_TENSOR_MAP_SWIZZLE_128B) != 0)
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

// The query pieces' row length: D rounded up to 8 bf16 (16 bytes, a
// tensor map's row stride), zero past D.
int pieces_ld(int dim) { return (dim + 7) / 8 * 8; }

// fp32 queries as three bf16 pieces `q` [3, n_q, pieces_ld(dim)] against
// an fp32 or int8 corpus. Refuses (cudaErrorInvalidValue) what a tensor
// map cannot describe: a corpus row not a multiple of 16 bytes (D % 4 for
// fp32, D % 16 for int8), a base not 16-byte aligned, more rows than a
// TMA coordinate holds, a failed encode; never hands the call to another
// kernel (ops/topk.py sends those shapes to blockmax_simt before any
// launch).
template <typename TC>
int launch_pieces(const void* q, const void* c, void* out, int n_q,
                  long long n_rows, int dim, int block_size,
                  cudaStream_t stream) {
  if ((dim * sizeof(TC)) % 16 != 0 || !aligned16(q) || !aligned16(c) ||
      n_rows > INT_MAX || 3LL * n_q > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_q_tiles = (n_q + kPieceQ - 1) / kPieceQ;
  const long long blocks = n_q_tiles * ((n_rows + kTileRows - 1) / kTileRows);
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mc;
  if (hopper::encode_matrix(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q,
                            3LL * n_q, dim, pieces_ld(dim), kPieceQ, kPieceK,
                            CU_TENSOR_MAP_SWIZZLE_64B) != 0 ||
      hopper::encode_matrix(&mc, CorpusTile<TC>::kType,
                            static_cast<int>(sizeof(TC)), c,
                            n_rows, dim, dim, kTileRows, kPieceK,
                            CorpusTile<TC>::kSwizzle) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sizeof(TC) == 4 ? blockmax_pieces_f32 : blockmax_pieces_int8;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPieceSmemBytes<TC>);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kPieceThreads, kPieceSmemBytes<TC>,
           stream>>>(mq, mc, static_cast<float*>(out), n_q, n_rows, dim,
                     block_size, n_q_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16, 2 = int8, and for queries 3 =
// float32 given as its three bf16 pieces [3, Q, D rounded up to 8] (ops/
// topk.py's split_bf16_pieces). Each pair has one kernel: f32 pieces x f32
// or int8 -> blockmax_pieces_*, float32 x f32 or int8 -> blockmax_simt,
// bf16 x bf16 -> blockmax_bf16, bf16 x int8 and int8 x int8 ->
// blockmax_wmma. Returns a cudaError_t (0 on success;
// cudaErrorInvalidValue for operands the pair's kernel does not take, and
// for any other pair); the launch is asynchronous on `stream`.
extern "C" int blockmax_scores_launch(int q_type, int c_type, const void* q,
                                      const void* c, void* out, int n_q,
                                      long long n_rows, int dim,
                                      int block_size, void* stream) {
  if (block_size <= 0 || kTileRows % block_size != 0 || n_q < 0 ||
      n_rows < 0 || dim <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == 3 && c_type == 0)
    return launch_pieces<float>(q, c, out, n_q, n_rows, dim, block_size, s);
  if (q_type == 3 && c_type == 2)
    return launch_pieces<int8_t>(q, c, out, n_q, n_rows, dim, block_size, s);
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

// The dynamic shared memory blockmax_bf16, blockmax_pieces_f32 and
// blockmax_pieces_int8 are launched with, in bytes, in that order
// (ptxas's report counts only static shared memory).
extern "C" void blockmax_bf16_smem(int* bytes) {
  bytes[0] = kBf16SmemBytes;
  bytes[1] = kPieceSmemBytes<float>;
  bytes[2] = kPieceSmemBytes<int8_t>;
}
