// Seq-128 attention in the projection layout, and the whole attention
// sub-block: the two kernels of the seq-128 experiment.
//
// attn128 (kernel #5). Replaces docs/perf_attn128_r3.py::_kernel128 (via
// fused128). q, k, v and out are [B, S, H] bf16, contiguous, as the Q / K /
// V projections write them, H = heads * 64, head h the columns
// [64h, 64h + 64); bias is fp32 [B, S] (0 keep, -1e9 drop). For each
// (b, h) it writes
//     s   = fp32(q_h . k_h^T) * (1/8) + bias        (two roundings, no FMA)
//     p   = exp(s - rowmax(s)) / rowsum(...)        (exact max and sum)
//     out = bf16(fp32(bf16(p) . v_h))
// which is attn128.py::fused128_reference step for step. A fully masked
// row sees s == -1e9 on every key (the fp32 ulp of 1e9 is 64) and comes out
// as the mean of v, as in the JAX function.
//
// What bounds it on the H100. A head at S = 128 is 4*S*S*64 = 4.2 MFLOP
// against 3*S*64*2 = 48 KB of q, k and v: ~85 FLOP a byte, under the bf16
// ridge (~295), so the least time is the bytes: q, k, v read once, out
// written once (4 * B*S*H*2 = 100.7 MB at B = 128, 0.030 ms at 3.35 TB/s;
// the products are 6.4 GFLOP, ~7 us, and the exps 25 M MUFU operations,
// ~7 us). The TPU kernel's point was to read the projection layout without
// the [B, S, H, D] -> [B*H, S, D] transposes; this kernel keeps that and is
// otherwise its own design, specialised to S <= 128 and built to keep HBM
// streaming (wgmma + TMA, hopper.cuh):
//  * persistent blocks, one an SM, the (b, h) heads dealt to them
//    round-robin, so the blocks running at once read neighbouring heads
//    of the same [B, S, H] rows. A producer warp
//    loads a head's q, k and v as three TMA boxes of [128][64] (a 4-d
//    tensor map over the [B, S, heads, 64] view of [B, S, H], 128-byte
//    swizzle, rows past S zero-filled) and its bias row into a ring of
//    kRing stages guarded by full / empty mbarriers, so the next heads'
//    loads are in flight while this one computes;
//  * two consumer warpgroups own 64 query rows each. q . k^T is wgmma
//    m64n64k16 from shared memory into the whole 64 x 128 fp32 score row
//    in registers (two 64-key halves; one where S <= 64), so the softmax is
//    one pass with the exact max; p . v is wgmma with p as the register A
//    fragment and v read MN-major (the transpose flag); the context goes
//    back through shared memory (over q, done with by then) as a TMA
//    store of the warpgroup's 64 rows (rows past S are not written);
//  * the epilogue as the fused kernel's: scale and bias in one FMA (exact:
//    the scale is 1/8), exp as one ex2.approx.ftz, 1/l once a row and
//    Markstein's two FMAs for the correctly rounded p = e / l, the mask
//    tested only in a ragged half.
//
// attn_block (kernel #6). Replaces docs/perf_attn128_r3.py::_block_kernel
// (via fused_block). x is [B, S, H] bf16 and wq, wk, wv, wo [H, H] bf16
// (x . W, no biases). It computes, as fused_block_reference does,
//     q, k, v = bf16(fp32(x . W))
//     ctx     = attn128(q, k, v) per head, each head's context in bf16
//     out     = bf16(fp32(ctx . wo))
// The TPU kernel holds all four [768, 768] weights (4.7 MB) and a group of
// x rows (384 KB at G = 2) in VMEM; a Hopper block has 227 KB of shared
// memory and holds neither. The work is 83.7 GFLOP at B = 128 (the four
// projections 77.3 of it): bound by the bf16 tensor-core rate, 0.085 ms
// at 989 TFLOP/s. So the projections are wgmma m64n256k16 products fed by
// a TMA ring (blockmax_bf16's mainloop), in two launches:
//  1. qkv_attend: a block owns two batch rows (256 rows of x, each batch
//     row's S rows at 128-row offsets, rows past S zero-filled) and one
//     head h: each weight tile serves two batch rows, half the L2 traffic
//     of the weights a block of one row read (each block reads its weight
//     columns, 295 KB, and its x rows, 393 KB, from L2). Three warpgroups
//     each project onto one of wq, wk, wv: out^T = W_h^T . x^T, the
//     weight's [64 k][64 n] tile as wgmma's A (MN-major, the transpose
//     flag), x's [256 rows][64 k] tile as B (K-major), so one m64n256k16
//     covers the head's 64 columns of all 256 rows, 128 fp32 accumulators
//     a thread (twelve warps: 168 registers a thread). The first thread
//     keeps 64-deep x and weight tiles in flight by TMA through a ring of
//     kProjStages (128-byte swizzle). q, k and v are rounded to bf16 into
//     shared memory, transposed back to [rows][64] over the spent ring;
//     they never reach device memory, the fusion's reason for being.
//     attn128's attention (attend_head) then runs on them, a 64-query tile
//     at a time, and the context leaves by one TMA store.
//  2. out_proj: the same mainloop and block over out = ctx . wo, a block
//     owning two batch rows and 192 output columns (64 a warpgroup), the
//     result stored by TMA.
// The output projection needs every head of a row, so it cannot finish in
// a block that owns one head without summing heads across blocks (fp32
// atomics, a result that changes from run to run); the split keeps the
// result deterministic at the cost of writing and reading ctx once
// (2 * 25 MB at B = 128). Every product of the TPU kernel's body runs
// here on the tensor cores; none goes to a library.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                // head dim
constexpr int kMaxS = 128;            // the longest sequence

using hopper::quad_max;
using hopper::quad_sum;

// ---- kernel #5: persistent, TMA ring, wgmma

using hopper::Lane;
using hopper::Ring;

constexpr int kConsumerWgs = 2;  // 64 query rows each
constexpr int kConsumerWarps = 4 * kConsumerWgs;
constexpr int k5Threads = kConsumerWgs * hopper::kWgThreads + 32;  // + producer
constexpr int kRing = 3;                     // heads in flight a block
constexpr int k5BlocksPerSm = 1;
constexpr int kBox = kMaxS * kD;             // a head's [128][64] TMA box
constexpr uint32_t kBoxBytes = kBox * 2;

struct alignas(1024) HeadSmem {
  bf16 q[kRing][kBox], k[kRing][kBox], v[kRing][kBox];
  float bias[kRing][kMaxS];  // keys >= S: 0 (masked in the epilogue)
  uint64_t full[kRing], empty[kRing];
};
constexpr int kSmemSlack = 1024;  // aligned_smem's rounding
constexpr int kHeadSmemBytes = static_cast<int>(sizeof(HeadSmem)) + kSmemSlack;

// One warpgroup's 64 query rows (the shared tile q) against the head's
// keys, in KT 64-key halves (k, v: [128][64] boxes): the whole score row
// in registers, its exact max and sum, p = e / l rounded to bf16 into
// p . v; the context, rounded to bf16, written over q (a TMA box's
// layout) once q . k^T is done with it.
template <int KT>
__device__ __forceinline__ void attend_head(bf16* q, const bf16* k,
                                            const bf16* v, const float* bias,
                                            int S, float scale,
                                            const Lane& ln) {
  float s[KT][32];
#pragma unroll
  for (int t = 0; t < KT; ++t) hopper::fence_regs(s[t]);
  hopper::wgmma_fence();
#pragma unroll
  for (int t = 0; t < KT; ++t) hopper::issue_abt(s[t], q, k + t * 64 * kD);
  hopper::wgmma_commit();
  hopper::wgmma_wait_all();
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    hopper::fence_regs(s[t]);
    hopper::scale_bias(s[t], bias + 64 * t, 64 * t, S, scale, ln.c);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      m[h] = fmaxf(m[h], s[t][i]);
    }
  }
  float l[2] = {0.f, 0.f}, inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = quad_max(m[h]);
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      s[t][i] = hopper::exp_shifted(s[t][i], m[h]);
      l[h] = __fadd_rn(l[h], s[t][i]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv_l[h] = __frcp_rn(l[h]);
  }
  uint32_t a[KT][4][4];
#pragma unroll
  for (int t = 0; t < KT; ++t) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      s[t][i] = hopper::divide(s[t][i], l[h], inv_l[h]);
    }
    hopper::to_a(a[t], s[t]);
  }
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  hopper::fence_regs(o);
  hopper::wgmma_fence();
#pragma unroll
  for (int t = 0; t < KT; ++t) hopper::issue_ab(o, a[t], v + t * 64 * kD);
  hopper::wait_products(o);
  hopper::store_tile_swizzled(o, q, ln);
}

// One block an SM: its ring of three heads is 147 KB of shared memory,
// and two blocks would cap a thread at 112 registers (it takes 158: the
// score row alone is 64).
__global__ void __launch_bounds__(k5Threads, k5BlocksPerSm)
    attn128_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mo,
                   const float* __restrict__ bias, int S, int H, float scale,
                   int n_heads) {
  HeadSmem& sm = hopper::aligned_smem<HeadSmem>();
  const int heads = H / kD;
  // the block's heads, dealt round-robin (block i takes heads i,
  // i + grid, ...): the blocks running at once read neighbouring heads of
  // the same rows, which kept HBM busier than a contiguous run a block
  const int first = blockIdx.x;
  const int last = n_heads;
  const int step = gridDim.x;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      hopper::mbar_init(&sm.full[i], 32);  // every producer lane arrives
      hopper::mbar_init(&sm.empty[i], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / 32 == kConsumerWarps) {  // the producer warp
    const int lane = threadIdx.x % 32;
    Ring<kRing> r;
    for (int w = first; w < last; w += step, r.next()) {
      const int b = w / heads, h = w % heads;
      hopper::mbar_wait(&sm.empty[r.stage], r.phase ^ 1);
      // the bias row by the warp's plain stores, each lane's released by
      // its own arrive
      for (int i = lane; i < kMaxS; i += 32)
        sm.bias[r.stage][i] =
            i < S ? bias[static_cast<long long>(b) * S + i] : 0.f;
      if (lane == 0) {
        hopper::mbar_expect_tx(&sm.full[r.stage], 3 * kBoxBytes);
        hopper::tma_load_4d(sm.q[r.stage], &mq, 0, h, 0, b, &sm.full[r.stage]);
        hopper::tma_load_4d(sm.k[r.stage], &mk, 0, h, 0, b, &sm.full[r.stage]);
        hopper::tma_load_4d(sm.v[r.stage], &mv, 0, h, 0, b, &sm.full[r.stage]);
      } else {
        hopper::mbar_arrive(&sm.full[r.stage]);
      }
    }
    return;
  }

  const Lane ln;
  const int q0 = 64 * ln.wg;  // the warpgroup's query rows
  const bool arrives = threadIdx.x % 32 == 0;
  // the warpgroup's first thread stores its context tile by TMA and
  // releases the stage only once the store has read it
  const bool stores = threadIdx.x % hopper::kWgThreads == 0;
  Ring<kRing> r;
  for (int w = first; w < last; w += step, r.next()) {
    const int b = w / heads, h = w % heads;
    hopper::mbar_wait(&sm.full[r.stage], r.phase);
    if (q0 < S) {
      bf16* qt = sm.q[r.stage] + q0 * kD;
      if (S > 64)
        attend_head<2>(qt, sm.k[r.stage], sm.v[r.stage], sm.bias[r.stage], S,
                       scale, ln);
      else
        attend_head<1>(qt, sm.k[r.stage], sm.v[r.stage], sm.bias[r.stage], S,
                       scale, ln);
      hopper::fence_async_smem();
      hopper::named_barrier(1 + ln.wg, hopper::kWgThreads);
      if (stores) {  // rows past S are not written
        hopper::tma_store_4d(&mo, qt, 0, h, q0, b);
        hopper::tma_store_wait_read();
      }
    }
    if (arrives) hopper::mbar_arrive(&sm.empty[r.stage]);
  }
  if (stores) hopper::tma_store_wait();
}


// ---- kernel #6: two batch rows a block, wgmma + TMA ring, two launches

constexpr int kBlockBatch = 2;                 // batch rows a block
constexpr int kRows = kBlockBatch * kMaxS;     // x rows a block: wgmma's N
constexpr int kProjWgs = 3;                    // one a weight tile
// Twelve warps, three to a register sub-partition: 168 registers a
// thread, room for a 64 x 256 tile's 128 accumulators (a fourth,
// producer, warpgroup would cap every thread at 128, which ptxas compiles
// the whole kernel to, setmaxnreg or not), so the first thread issues the
// TMA loads between its own products.
constexpr int kProjThreads = kProjWgs * hopper::kWgThreads;
constexpr int kProjStages = 3;                 // ring of 64-deep k steps
constexpr int kProjCols = kProjWgs * kD;       // out_proj's columns a block
constexpr uint32_t kXBytes = kRows * kD * 2;         // an x stage, 32 KB
constexpr uint32_t kWBytes = hopper::kTileBytes;     // a weight tile, 8 KB
constexpr uint32_t kStageBytes = kXBytes + kProjWgs * kWBytes;

struct alignas(1024) ProjSmem {
  // the ring's x tiles; after the mainloop, warpgroup w's product in bf16
  // [kRows][64] over x[w] (q, k, v in qkv_attend; then the context over q)
  bf16 x[kProjStages][kRows * kD];
  bf16 w[kProjStages][kProjWgs][kD * kD];  // [64 k][64 n] weight tiles
  float bias[kBlockBatch][kMaxS];          // keys >= S: 0 (masked)
  uint64_t full[kProjStages], empty[kProjStages];
};
static_assert(kProjStages == kProjWgs, "each product lands on one x stage");
constexpr int kProjSmemBytes = static_cast<int>(sizeof(ProjSmem)) + kSmemSlack;
static_assert(kProjSmemBytes <= 232448, "more than a block's shared memory");

// What a block's loads read: x's (or ctx's) two batch rows from b0, and
// three weight tiles, weight i's columns col[i]..
struct ProjOperands {
  const CUtensorMap* x;
  const CUtensorMap* w[kProjWgs];
  int col[kProjWgs];
  int b0;
};

// stage t's tiles (x columns 64 t.., weight rows 64 t..) into ring stage
// `stage`, by one thread
__device__ __forceinline__ void load_stage(ProjSmem& sm, int stage, int t,
                                           const ProjOperands& op) {
  hopper::mbar_expect_tx(&sm.full[stage], kStageBytes);
  hopper::tma_load_3d(sm.x[stage], op.x, 64 * t, 0, op.b0, &sm.full[stage]);
  for (int i = 0; i < kProjWgs; ++i)
    hopper::tma_load_2d(sm.w[stage][i], op.w[i], op.col[i], 64 * t,
                        &sm.full[stage]);
}

// The mainloop both launches share: warpgroup wg's 64 output columns of
// the block's 256 rows, acc = (W tile)^T . (x tile)^T over the H / 64
// stages (hopper.cuh's accumulator layout: acc[4j + e] is column
// 16 warp + g + 8 (e / 2) of row 8j + c + e % 2), then every warpgroup's
// product lands in bf16 on x[wg] as [row][column], 128-byte swizzled (a
// TMA box's layout), once every warpgroup is past the ring. Thread 0
// fills the ring: kProjStages stages ahead, then each stage again once
// every warp has released it.
__device__ __forceinline__ void project(ProjSmem& sm, int n_k,
                                        const ProjOperands& op,
                                        const hopper::Lane& ln) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kProjStages; ++i) {
      hopper::mbar_init(&sm.full[i], 1);
      hopper::mbar_init(&sm.empty[i], kProjThreads / 32);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const bool loads = threadIdx.x == 0;
  if (loads)
    for (int t = 0; t < kProjStages && t < n_k; ++t) load_stage(sm, t, t, op);
  float acc[128];
  hopper::Ring<kProjStages> r;
  for (int t = 0; t < n_k; ++t, r.next()) {
    hopper::mbar_wait(&sm.full[r.stage], r.phase);
    const uint64_t da = hopper::desc_sw128(sm.w[r.stage][ln.wg]);
    const uint64_t db = hopper::desc_sw128(sm.x[r.stage]);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_ss_n256<1>(acc, da + kk * hopper::kKStepMN,
                               db + kk * hopper::kKStepK, t > 0 || kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();  // the other warpgroups' products fill the gap
    hopper::fence_regs(acc);
    if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&sm.empty[r.stage]);
    if (loads && t + kProjStages < n_k) {
      hopper::mbar_wait(&sm.empty[r.stage], r.phase);
      load_stage(sm, r.stage, t + kProjStages, op);
    }
    __syncwarp();  // warp 0 converged again for the next wgmma
  }
  hopper::named_barrier(1, kProjThreads);  // the ring is spent
  unsigned char* tile = reinterpret_cast<unsigned char*>(sm.x[ln.wg]);
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * j + ln.c + (e & 1);
      const int col = ln.row0 + ln.g + 8 * (e >> 1);
      *reinterpret_cast<uint16_t*>(tile + row * 128 +
                                   16 * ((col >> 3) ^ (row & 7)) +
                                   2 * (col & 7)) =
          __bfloat16_as_ushort(__float2bfloat16_rn(acc[4 * j + e]));
    }
  hopper::fence_async_smem();  // wgmma and TMA stores read these tiles
}

// attn_block launch 1: batch rows b0, b0 + 1 and head h (blocks of one
// pair of rows adjacent, so x comes from L2). Each warpgroup projects onto
// one of wq, wk, wv; then query tiles i = wg, wg + 3 of the four (batch
// row i / 2, rows 64 (i % 2)..) attend to their batch row's keys, and the
// context ([2][128][64] over q) leaves by one TMA store (rows past S and
// batch rows past B are not written).
__global__ void __launch_bounds__(kProjThreads, 1)
    qkv_attend_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mwq,
                      const __grid_constant__ CUtensorMap mwk,
                      const __grid_constant__ CUtensorMap mwv,
                      const __grid_constant__ CUtensorMap mctx,
                      const float* __restrict__ bias, int B, int S, int H,
                      float scale) {
  ProjSmem& sm = hopper::aligned_smem<ProjSmem>();
  const int heads = H / kD;
  const int b0 = kBlockBatch * (blockIdx.x / heads), h = blockIdx.x % heads;
  for (int i = threadIdx.x; i < kBlockBatch * kMaxS; i += kProjThreads) {
    const int b = b0 + i / kMaxS, key = i % kMaxS;
    sm.bias[i / kMaxS][key] =
        b < B && key < S ? bias[static_cast<long long>(b) * S + key] : 0.f;
  }
  const ProjOperands op{&mx, {&mwq, &mwk, &mwv}, {h * kD, h * kD, h * kD},
                        b0};
  const hopper::Lane ln;
  project(sm, H / 64, op, ln);  // its __syncthreads covers the bias too
  hopper::named_barrier(1, kProjThreads);  // q, k and v are in place
  for (int i = ln.wg; i < 2 * kBlockBatch; i += kProjWgs) {
    const int g = i / 2, q0 = 64 * (i % 2);
    if (b0 + g >= B || q0 >= S) continue;
    bf16* qt = sm.x[0] + (g * kMaxS + q0) * kD;
    const bf16* kt = sm.x[1] + g * kMaxS * kD;
    const bf16* vt = sm.x[2] + g * kMaxS * kD;
    if (S > 64)
      attend_head<2>(qt, kt, vt, sm.bias[g], S, scale, ln);
    else
      attend_head<1>(qt, kt, vt, sm.bias[g], S, scale, ln);
  }
  hopper::fence_async_smem();
  hopper::named_barrier(1, kProjThreads);  // every context tile is in
  if (threadIdx.x == 0) {
    hopper::tma_store_3d(&mctx, sm.x[0], h * kD, 0, b0);
    hopper::tma_store_wait();
  }
}

// attn_block launch 2: batch rows b0, b0 + 1 and output columns
// [192 j, 192 j + 192), 64 a warpgroup: out = bf16(ctx . wo), each
// warpgroup's [2][128][64] stored by TMA (columns past H, rows past S and
// batch rows past B are not written).
__global__ void __launch_bounds__(kProjThreads, 1)
    out_proj_kernel(const __grid_constant__ CUtensorMap mctx,
                    const __grid_constant__ CUtensorMap mwo,
                    const __grid_constant__ CUtensorMap mout, int H) {
  ProjSmem& sm = hopper::aligned_smem<ProjSmem>();
  const int col_groups = (H + kProjCols - 1) / kProjCols;
  const int b0 = kBlockBatch * (blockIdx.x / col_groups);
  const int col0 = kProjCols * (blockIdx.x % col_groups);
  const ProjOperands op{&mctx, {&mwo, &mwo, &mwo},
                        {col0, col0 + kD, col0 + 2 * kD}, b0};
  const hopper::Lane ln;
  project(sm, H / 64, op, ln);
  const int col = col0 + kD * ln.wg;
  hopper::named_barrier(2 + ln.wg, hopper::kWgThreads);  // its tile is in
  if (threadIdx.x % hopper::kWgThreads == 0 && col < H) {
    hopper::tma_store_3d(&mout, sm.x[ln.wg], col, 0, b0);
    hopper::tma_store_wait();
  }
}

// A contiguous [B, S, H] bf16 tensor as a 3-d tensor map whose box is
// [kBlockBatch][kMaxS][64]: two batch rows' 128 rows (rows past S and
// batch rows past B zero-filled on load, not written on store) of 64
// columns, 128-byte swizzled. Returns a CUresult (0 on success).
int encode_bsh(CUtensorMap* map, const void* base, int B, int S, int H) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(H) * 2,
                                 static_cast<cuuint64_t>(S) * H * 2};
  const cuuint32_t box[3] = {kD, kMaxS, kBlockBatch};
  return hopper::encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 3,
                              dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A [H, H] bf16 weight (x . W: rows the input features) as a 2-d tensor
// map of [64][64] tiles, 128-byte swizzled. Returns a CUresult.
int encode_weight(CUtensorMap* map, const void* w, int H) {
  return hopper::encode_matrix(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, H,
                               H, H, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
}
bool takes(int B, int S, int H) {
  return B >= 0 && S >= 1 && S <= kMaxS && H > 0 && H % kD == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Kernel #5. q, k, v, out: contiguous [B, S, H] bf16 with 16-byte-aligned
// base addresses (the TMA boxes; the wrapper checks), 1 <= S <= 128, H a
// multiple of 64; bias fp32 [B, S]; a power-of-two scale (1/sqrt(64) is).
// Returns a cudaError_t, 0 on success (cudaErrorInvalidValue for what it
// does not take); asynchronous on `stream`.
extern "C" int attn128_launch(const void* q, const void* k, const void* v,
                              const float* bias, void* out, int B, int S,
                              int H, float scale, void* stream) {
  if (!takes(B, S, H) || !hopper::power_of_two(scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_heads = static_cast<long long>(B) * (H / kD);
  if (n_heads == 0) return 0;
  if (n_heads > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = allow_smem(attn128_kernel, kHeadSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // q, k, v and out as [B, S, heads, 64] with strides (S * H, H, 64): a
  // load box is a head's 128 rows, a store box a warpgroup's 64
  CUtensorMap maps[4];
  const void* operands[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i)
    if (hopper::encode_bhsd(&maps[i], operands[i], B, S, H / kD,
                            static_cast<long long>(S) * H, H, kD,
                            i < 3 ? kMaxS : hopper::kTileRows) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = static_cast<long long>(sms) * k5BlocksPerSm;
  const int blocks = static_cast<int>(n_heads < slots ? n_heads : slots);
  attn128_kernel<<<blocks, k5Threads, kHeadSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], bias, S, H, scale,
      static_cast<int>(n_heads));
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory each wgmma kernel is launched with, in bytes:
// [0] attn128_kernel (#5), [1] qkv_attend_kernel and [2] out_proj_kernel
// (#6) (ptxas's report counts only static shared memory).
extern "C" void attn128_bf16_smem(int* bytes) {
  bytes[0] = kHeadSmemBytes;
  bytes[1] = bytes[2] = kProjSmemBytes;
}

// Kernel #6: x, ctx (scratch) and out contiguous [B, S, H] bf16; wq, wk,
// wv, wo contiguous [H, H] bf16 (x . W); every base 16-byte aligned (TMA);
// bias fp32 [B, S]; limits as attn128_launch. Two kernels on `stream`,
// qkv_attend then out_proj.
extern "C" int attn_block_launch(const void* x, const void* wq,
                                 const void* wk, const void* wv,
                                 const void* wo, const float* bias, void* ctx,
                                 void* out, int B, int S, int H, float scale,
                                 void* stream) {
  if (!takes(B, S, H) || !hopper::power_of_two(scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = (static_cast<long long>(B) + kBlockBatch - 1) /
                          kBlockBatch;
  const long long attend_blocks = pairs * (H / kD);
  const long long proj_blocks = pairs * ((H + kProjCols - 1) / kProjCols);
  if (pairs == 0) return 0;
  if (attend_blocks > 0x7fffffffLL || proj_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mctx, mout, mw[4];
  const void* weights[4] = {wq, wk, wv, wo};
  bool ok = encode_bsh(&mx, x, B, S, H) == 0 &&
            encode_bsh(&mctx, ctx, B, S, H) == 0 &&
            encode_bsh(&mout, out, B, S, H) == 0;
  for (int i = 0; i < 4 && ok; ++i)
    ok = encode_weight(&mw[i], weights[i], H) == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(qkv_attend_kernel, kProjSmemBytes);
  if (err == cudaSuccess) err = allow_smem(out_proj_kernel, kProjSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  qkv_attend_kernel<<<static_cast<unsigned>(attend_blocks), kProjThreads,
                      kProjSmemBytes, s>>>(mx, mw[0], mw[1], mw[2], mctx, bias,
                                           B, S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  out_proj_kernel<<<static_cast<unsigned>(proj_blocks), kProjThreads,
                    kProjSmemBytes, s>>>(mctx, mw[3], mout, H);
  return static_cast<int>(cudaGetLastError());
}
