// Kernel #7: the routed experts' grouped products of DeepSeek-V2's MoE
// layer (ops/grouped_gemm.py, ops/moe.py). Replaces no TPU kernel: the JAX
// package has no mixture of experts. The (token, expert) pairs are sorted
// by expert; each projection is one launch over every expert's rows:
//
//  * grouped_swiglu_kernel: h[r] = silu(x[rows[r]] . W_gate[e]^T) *
//    (x[rows[r]] . W_up[e]^T) for pair r of expert e, the gate and up sums
//    in fp32 and the SwiGLU formed from them before the one rounding to
//    bf16;
//  * grouped_down_kernel: y[r] = p[r] * (h[r] . W_down[e]^T), scaled by
//    the pair's gate weight in fp32 before the rounding.
//
// The schedule is on the device, so nothing is read back to the host. The
// tiles are (row-tile slot, column tile) pairs, column tiles fastest; the
// slots bound the 128-row tiles any routing can need
// (ops/grouped_gemm.py::schedule), and a tile finds its expert and rows
// from the per-expert tile and pair offsets (a binary search over E + 1
// ints); an expert with no rows has no tiles. The kernels are persistent:
// one block a multiprocessor takes tiles blockIdx.x, + gridDim.x, ... until
// a slot past the last tile. So the blocks that run together share a few
// tiles of rows and walk one expert's weights, which stay in L2 while that
// expert's row tiles pass, and a block's next tile loads while it stores
// the one before.
//
// A block is a 128-row x 256-column tile on wgmma m64n256k16 (bf16, fp32
// accumulation): two consumer warpgroups of 64 rows each and a producer
// warpgroup that gives its registers to them (setmaxnreg). A stage is 64
// reduction columns (128 bytes a row, 128-byte swizzle) of the A rows and
// the 256 B rows, in a four-stage ring of mbarriers; the consumers keep one
// product in flight (wgmma wait 1) and free a stage once its product has
// completed. B, the expert's weight rows, comes by TMA: for the SwiGLU the
// ring's 256 rows are 128 rows of W_gate then the same 128 of W_up, so one
// n256 product gives both sums of 128 output columns side by side. A of the
// down product (h, whose rows are the sorted pairs) comes by TMA too; A of
// the SwiGLU is x's rows gathered through the pairs' token index, which no
// tensor map describes, so the producer warpgroup copies them with cp.async
// into the 128-byte-swizzled layout a TMA box would have (row r's 16-byte
// chunk k at r * 128 + 16 * (k ^ (r % 8))), a thread one chunk of 8 rows,
// each thread's copies of a stage arriving on the stage's barrier as they
// land (cp.async.mbarrier.arrive), the consumers fencing them to the async
// proxy before their products. Rows past the expert's end and columns
// past K are zeros (TMA's out-of-bounds fill, cp.async's zero source size);
// the epilogue writes only the expert's rows and the columns below N.
//
// Operands: bf16, contiguous, 16-byte-aligned bases, N and K multiples of 8
// (TMA's 16-byte row strides; the epilogue's bf16 pairs).

#include "hopper.cuh"

namespace {

using hopper::bf16;

constexpr int kRows = 128;          // pair rows a block: two warpgroups' 64
constexpr int kCols = 256;          // B rows a stage: wgmma's N
constexpr int kHalf = kCols / 2;    // the SwiGLU's output columns a block
constexpr int kK = 64;              // reduction columns a stage: 128 bytes
constexpr int kStages = 4;
constexpr int kChunks = kK / 8;     // 16-byte chunks of a stage's row
constexpr int kConsumers = 2 * hopper::kWgThreads;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + hopper::kWgThreads;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kConsumerRegs * kConsumers +
                      kProducerRegs * hopper::kWgThreads <= 65536,
              "more registers than an SM holds");
constexpr uint32_t kABytes = kRows * kK * 2;
constexpr uint32_t kBBytes = kCols * kK * 2;
// rows a producer thread gathers: the warpgroup's 128 threads cover a
// stage's kRows x kChunks chunks, a thread one chunk column
constexpr int kGatherRows = kRows * kChunks / hopper::kWgThreads;

struct Smem {
  bf16 a[kStages][kRows * kK];  // each 1024-byte aligned
  bf16 b[kStages][kCols * kK];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  int src_row[kRows];  // the SwiGLU's token a tile row, -1 past the expert
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // + aligned_smem's slack

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
// an arrival on `bar` once every cp.async this thread has issued so far
// has completed (the barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hopper::smem_u32(bar))
               : "memory");
}

// The block's expert and its rows [row0, row1) of the sorted pairs; false
// for a slot past the last tile.
struct Tile {
  int e, row0, row1;
};
__device__ __forceinline__ bool find_tile(const int* __restrict__ pair_off,
                                          const int* __restrict__ tile_off,
                                          int E, int slot, Tile& tile) {
  int lo = 0, hi = E;  // the largest e in [0, E] with tile_off[e] <= slot
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (__ldg(tile_off + mid) <= slot)
      lo = mid;
    else
      hi = mid - 1;
  }
  if (lo == E) return false;
  tile.e = lo;
  tile.row0 = __ldg(pair_off + lo) + (slot - __ldg(tile_off + lo)) * kRows;
  tile.row1 = __ldg(pair_off + lo + 1);
  return true;
}

// The producer warpgroup's loads for each of the block's tiles, stages
// 0 .. n_k - 1 a tile, into the ring `r` that runs on across tiles (so the
// next tile's first stages load while the consumers store this one's). B:
// the expert's weight rows from `mb0` (and, for the SwiGLU, the same rows
// of `mb1` in the stage's second half); A: the tile's rows of `ma` (the
// down product) or its gathered rows of x (the SwiGLU, `kGather`).
template <bool kGather>
__device__ __forceinline__ void produce(Smem& sm, const CUtensorMap& ma,
                                        const CUtensorMap& mb0,
                                        const CUtensorMap& mb1,
                                        const int* __restrict__ pair_off,
                                        const int* __restrict__ tile_off,
                                        int E, int N, int K, int n_col,
                                        int col_width,
                                        const bf16* __restrict__ x,
                                        const int* __restrict__ rows) {
  const int i = threadIdx.x - kConsumers;
  const int n_k = (K + kK - 1) / kK;
  hopper::Ring<kStages> r;
  if constexpr (!kGather) {
    if (i != 0) return;
    Tile tile;
    for (int t = blockIdx.x; find_tile(pair_off, tile_off, E, t / n_col, tile);
         t += gridDim.x) {
      const int b_row0 = tile.e * N + (t % n_col) * col_width;
      for (int k = 0; k < n_k; ++k, r.next()) {
        hopper::mbar_wait(&sm.empty[r.stage], r.phase ^ 1);
        hopper::mbar_expect_tx(&sm.full[r.stage], kABytes + kBBytes);
        hopper::tma_load_2d(sm.a[r.stage], &ma, kK * k, tile.row0,
                            &sm.full[r.stage]);
        hopper::tma_load_2d(sm.b[r.stage], &mb0, kK * k, b_row0,
                            &sm.full[r.stage]);
      }
    }
  } else {
    // a thread's chunk column and first row of each stage
    const int chunk = i % kChunks, r0 = i / kChunks;
    constexpr int kRowStep = hopper::kWgThreads / kChunks;
    Tile tile;
    for (int t = blockIdx.x; find_tile(pair_off, tile_off, E, t / n_col, tile);
         t += gridDim.x) {
      const int b_row0 = tile.e * N + (t % n_col) * col_width;
      // the tile's tokens, once every copy of the tile before is issued
      hopper::named_barrier(1, hopper::kWgThreads);
      const int row = tile.row0 + i;
      sm.src_row[i] = row < tile.row1 ? __ldg(rows + row) : -1;
      hopper::named_barrier(1, hopper::kWgThreads);
      for (int k = 0; k < n_k; ++k, r.next()) {
        hopper::mbar_wait(&sm.empty[r.stage], r.phase ^ 1);
        if (i == 0) {
          hopper::mbar_expect_tx(&sm.full[r.stage], kBBytes);
          hopper::tma_load_2d(sm.b[r.stage], &mb0, kK * k, b_row0,
                              &sm.full[r.stage]);
          hopper::tma_load_2d(sm.b[r.stage] + kHalf * kK, &mb1, kK * k,
                              b_row0, &sm.full[r.stage]);
        }
        const int col = kK * k + 8 * chunk;
        bf16* a = sm.a[r.stage];
#pragma unroll
        for (int m = 0; m < kGatherRows; ++m) {
          const int rr = r0 + kRowStep * m;
          const int src = sm.src_row[rr];
          const bool ok = src >= 0 && col < K;
          cp_async_16(a + rr * kK + 8 * (chunk ^ (rr % 8)),
                      x + (ok ? static_cast<long long>(src) * K + col : 0),
                      ok);
        }
        // arrives once this thread's copies so far have landed
        cp_async_arrive(&sm.full[r.stage]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // none left behind
  }
}

// A consumer warpgroup's products over one tile's n_k stages of the ring
// `r`: acc = A's 64 rows of the warpgroup . B's 256 rows^T, one product in
// flight; every stage is freed by the time it returns.
template <bool kGather>
__device__ __forceinline__ void consume(Smem& sm, float (&acc)[128], int n_k,
                                        const hopper::Lane& ln,
                                        hopper::Ring<kStages>& r) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int k = 0; k < n_k; ++k, r.next()) {
    hopper::mbar_wait(&sm.full[r.stage], r.phase);
    // the gathered rows were written by cp.async (the generic proxy); the
    // products read them through the async proxy
    if constexpr (kGather) hopper::fence_async_smem();
    const uint64_t da = hopper::desc_sw128(sm.a[r.stage] + ln.wg * 64 * kK);
    const uint64_t db = hopper::desc_sw128(sm.b[r.stage]);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_ss_n256(acc, da + kk * hopper::kKStepK,
                            db + kk * hopper::kKStepK, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the stage before has been read
    hopper::fence_regs(acc);
    if (prev >= 0 && threadIdx.x % 32 == 0)
      hopper::mbar_arrive(&sm.empty[prev]);
    prev = r.stage;
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  if (prev >= 0 && threadIdx.x % 32 == 0) hopper::mbar_arrive(&sm.empty[prev]);
}

// The ring's barriers: `full_arrivals` a stage's load, a consumer warp's
// arrival each on `empty`.
__device__ __forceinline__ void init_ring(Smem& sm, uint32_t full_arrivals) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&sm.full[i], full_arrivals);
      hopper::mbar_init(&sm.empty[i], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// Persistent: block b takes tiles b, b + gridDim.x, ... of the (row-tile
// slot, column tile) order, column tiles fastest, until a slot past the
// last tile.
__global__ void __launch_bounds__(kThreads, 1)
    grouped_swiglu_kernel(const __grid_constant__ CUtensorMap mg,
                          const __grid_constant__ CUtensorMap mu,
                          const bf16* __restrict__ x,
                          const int* __restrict__ rows, bf16* __restrict__ h,
                          const int* __restrict__ pair_off,
                          const int* __restrict__ tile_off, int E, int N,
                          int K, int n_col) {
  Smem& sm = hopper::aligned_smem<Smem>();
  // each producer thread arrives once a stage, its first thread also with
  // the TMA bytes
  init_ring(sm, hopper::kWgThreads + 1);
  if (threadIdx.x >= kConsumers) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    produce<true>(sm, mg, mg, mu, pair_off, tile_off, E, N, K, n_col, kHalf,
                  x, rows);
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const hopper::Lane ln;
  const int n_k = (K + kK - 1) / kK;
  hopper::Ring<kStages> r;
  Tile tile;
  float acc[128];
  for (int t = blockIdx.x; find_tile(pair_off, tile_off, E, t / n_col, tile);
       t += gridDim.x) {
    const int n0 = (t % n_col) * kHalf;
    consume<true>(sm, acc, n_k, ln, r);
    // columns 8j + c (+1) of n-blocks j < 16 are the gate's sums, of
    // j + 16 the up projection's, for the same output column
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = tile.row0 + ln.wg * 64 + ln.row0 + ln.g + 8 * half;
      if (row >= tile.row1) continue;
      bf16* out = h + static_cast<long long>(row) * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + ln.c;
        if (col >= N) continue;
        const float g0 = acc[4 * j + 2 * half];
        const float g1 = acc[4 * j + 2 * half + 1];
        const float u0 = acc[4 * (j + 16) + 2 * half];
        const float u1 = acc[4 * (j + 16) + 2 * half + 1];
        // silu by the fast exp and division (a few fp32 ulps, far below
        // the bf16 rounding that follows): the epilogue holds the tensor
        // cores idle, and expf's cost showed (2.29 against 2.18 ms a
        // launch at the cell's shapes on an H100)
        *reinterpret_cast<uint32_t*>(out + col) = hopper::pack_rn(
            __fdividef(g0, 1.f + __expf(-g0)) * u0,
            __fdividef(g1, 1.f + __expf(-g1)) * u1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    grouped_down_kernel(const __grid_constant__ CUtensorMap mh,
                        const __grid_constant__ CUtensorMap mw,
                        const float* __restrict__ p, bf16* __restrict__ y,
                        const int* __restrict__ pair_off,
                        const int* __restrict__ tile_off, int E, int N, int K,
                        int n_col) {
  Smem& sm = hopper::aligned_smem<Smem>();
  init_ring(sm, 1);
  if (threadIdx.x >= kConsumers) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    produce<false>(sm, mh, mw, mw, pair_off, tile_off, E, N, K, n_col, kCols,
                   nullptr, nullptr);
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const hopper::Lane ln;
  const int n_k = (K + kK - 1) / kK;
  hopper::Ring<kStages> r;
  Tile tile;
  float acc[128];
  for (int t = blockIdx.x; find_tile(pair_off, tile_off, E, t / n_col, tile);
       t += gridDim.x) {
    const int n0 = (t % n_col) * kCols;
    consume<false>(sm, acc, n_k, ln, r);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = tile.row0 + ln.wg * 64 + ln.row0 + ln.g + 8 * half;
      if (row >= tile.row1) continue;
      const float w = __ldg(p + row);
      bf16* out = y + static_cast<long long>(row) * N;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = n0 + 8 * j + ln.c;
        if (col >= N) continue;
        *reinterpret_cast<uint32_t*>(out + col) =
            hopper::pack_rn(w * acc[4 * j + 2 * half],
                            w * acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

constexpr int kMaxSlots = 65535;  // ops/grouped_gemm.py::MAX_SLOTS (int tiles)

bool takes(int P, int E, int N, int K, int slots) {
  return P >= 0 && E > 0 && N > 0 && K > 0 && N % 8 == 0 && K % 8 == 0 &&
         slots >= 0 && slots <= kMaxSlots;
}

// A row-major bf16 [rows, K] matrix as a tensor map of [box_rows][64]
// boxes, 128-byte swizzled. Returns a CUresult.
int encode_rows(CUtensorMap* map, const void* base, long long rows, int K,
                int box_rows) {
  return hopper::encode_matrix(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base,
                               rows, K, K, box_rows, kK,
                               CU_TENSOR_MAP_SWIZZLE_128B);
}

// Allow the kernel its shared memory; `blocks` = one a multiprocessor, at
// most `tiles`.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, long long tiles, int& blocks) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  blocks = static_cast<int>(tiles < sms ? tiles : sms);
  return err;
}

}  // namespace

// h [P, N] = the SwiGLU of each sorted pair (file comment). x [T, K];
// rows [P] int32 (the pairs' tokens); w_gate, w_up [E, N, K]; pair_off,
// tile_off [E + 1] int32 (ops/grouped_gemm.py::schedule); slots the grid's
// row-tile slots. Rows of h past pair_off[E] are not written. Returns a
// cudaError_t, 0 on success (cudaErrorInvalidValue for what it does not
// take); asynchronous on `stream`.
extern "C" int grouped_swiglu_launch(const void* x, const int* rows,
                                     const void* w_gate, const void* w_up,
                                     void* h, const int* pair_off,
                                     const int* tile_off, int P, int E, int N,
                                     int K, int slots, void* stream) {
  if (!takes(P, E, N, K, slots)) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || slots == 0) return 0;
  CUtensorMap mg, mu;
  const long long w_rows = static_cast<long long>(E) * N;
  if (encode_rows(&mg, w_gate, w_rows, K, kHalf) != 0 ||
      encode_rows(&mu, w_up, w_rows, K, kHalf) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_col = (N + kHalf - 1) / kHalf;
  int blocks = 0;
  const cudaError_t err = prepare(
      grouped_swiglu_kernel, static_cast<long long>(n_col) * slots, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_swiglu_kernel<<<blocks, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      mg, mu, static_cast<const bf16*>(x), rows, static_cast<bf16*>(h),
      pair_off, tile_off, E, N, K, n_col);
  return static_cast<int>(cudaGetLastError());
}

// y [P, N] = p[r] * (h[r] . W_down[e]^T) for each sorted pair r of expert e.
// h [P, K]; w_down [E, N, K]; p [P] fp32; the rest as
// grouped_swiglu_launch.
extern "C" int grouped_down_launch(const void* h, const void* w_down,
                                   const float* p, void* y,
                                   const int* pair_off, const int* tile_off,
                                   int P, int E, int N, int K, int slots,
                                   void* stream) {
  if (!takes(P, E, N, K, slots)) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0 || slots == 0) return 0;
  CUtensorMap mh, mw;
  if (encode_rows(&mh, h, P, K, kRows) != 0 ||
      encode_rows(&mw, w_down, static_cast<long long>(E) * N, K, kCols) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_col = (N + kCols - 1) / kCols;
  int blocks = 0;
  const cudaError_t err = prepare(
      grouped_down_kernel, static_cast<long long>(n_col) * slots, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_down_kernel<<<blocks, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      mh, mw, p, static_cast<bf16*>(y), pair_off, tile_off, E, N, K, n_col);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory each wgmma kernel is launched with, in bytes:
// [0] grouped_swiglu_kernel, [1] grouped_down_kernel.
extern "C" void grouped_gemm_bf16_smem(int* bytes) {
  bytes[0] = bytes[1] = kSmemBytes;
}
