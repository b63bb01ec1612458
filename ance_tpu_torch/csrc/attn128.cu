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
// memory and holds neither. So this is two launches, each streaming
// 64-deep tiles of x and of the weights through a cp.async double buffer:
//  1. qkv_attend: a block owns one (b, h): it projects the b's S rows of x
//     onto the head's 64 columns of wq, wk and wv (three 128 x 64 fp32
//     accumulators in registers, 12 tiles of 64), rounds q, k and v to bf16
//     into shared memory, and runs attn128's attention on them. Only ctx
//     ([B, S, H] bf16) reaches device memory; q, k and v never do.
//  2. out_proj: a block owns 128 rows x 64 columns of out = ctx . wo.
// The output projection needs every head of a row, so it cannot finish in
// a block that owns one head without summing heads across blocks (fp32
// atomics, a result that changes from run to run); the split keeps the
// result deterministic at the cost of writing and reading ctx once
// (2 * 25 MB at B = 128). Every product of the TPU kernel's body runs
// here on the tensor cores; none goes to a library. The work is 83.7 GFLOP
// at B = 128 (the projections are 96%): bound by the bf16 tensor-core
// rate, 0.085 ms at 989 TFLOP/s. wgmma, TMA and tuning are later work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                // head dim
constexpr int kMaxS = 128;            // the longest sequence
constexpr int kWarps = kMaxS / 16;    // one warp per 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = kD + 8;           // bf16 shared rows: 144 B, 16-B aligned;
                                      // fragment loads hit 32 distinct banks
constexpr int kKeyTiles = kMaxS / 8;  // 8-key accumulator tiles of a row
constexpr int kDimTiles = kD / 8;     // 8-column accumulator tiles of a head
constexpr int kChunk = 64;            // reduction depth of a staged tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// two bf16 in one register, `lo` in the low half (the lower index)
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a . b for one 16 x 8 x 16 tile (bf16 in, fp32 accumulate). The PTX
// ISA fixes the fragment layouts; with g = lane / 4 and c = 2 * (lane % 4):
//   a[0] = A[g][c..c+1]    a[1] = A[g+8][c..c+1]
//   a[2] = A[g][c+8..c+9]  a[3] = A[g+8][c+8..c+9]
//   b0   = B[c..c+1][g]    b1   = B[c+8..c+9][g]
//   d[0..1] = D[g][c..c+1] d[2..3] = D[g+8][c..c+1]
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment: rows [r0, r0 + 16) x columns [c0, c0 + 16) of a row-major
// shared tile with row pitch ld
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t,
                                       int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = t + (r0 + (lane >> 2)) * ld + c0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment of B = T^T (T row-major [n][k], e.g. K[key][d]): n from n0,
// k from k0; each register is two neighbours of one row of T
__device__ __forceinline__ void load_bt(uint32_t& b0, uint32_t& b1,
                                        const bf16* t, int ld, int n0,
                                        int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = t + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B fragment of a row-major B [k][n] (V[key][d], W[in][out]): k from k0,
// n from n0; each register is two rows of one column
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* t, int ld, int k0,
                                       int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = t + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b0 = pack(p[0], p[ld]);
  b1 = pack(p[8 * ld], p[9 * ld]);
}

using hopper::pack_rn;
using hopper::quad_max;
using hopper::quad_sum;

// Kernel #6's attention (mma.sync m16n8k16): one warp's 16 query rows
// [16w, 16w + 16) of a head staged in shared memory (Qs, Ks, Vs:
// [kMaxS][kLd], rows past S zero) against keys [0, S), the function of
// the file comment with the division instruction and expf; the warp's
// rows of the context stored in bf16 at out + row * ld_out.
__device__ __forceinline__ void attend_rows(const bf16* Qs, const bf16* Ks,
                                            const bf16* Vs, const float* bias,
                                            int S, float scale, bf16* out,
                                            long long ld_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3);
  const int r0 = warp * 16;
  if (r0 >= S) return;
  const int key_tiles = (S + 15) / 16;  // 16-key tiles that hold a valid key

  // 1. s = q . k^T: 16 rows x up to 128 keys in registers
  float s[kKeyTiles][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < kD; kd += 16) {
    uint32_t a[4];
    load_a(a, Qs, kLd, r0, kd);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      if (j < 2 * key_tiles) {
        uint32_t b0, b1;
        load_bt(b0, b1, Ks, kLd, j * 8, kd);
        mma(s[j], a, b0, b1);
      }
    }
  }

  // 2. scale, bias (keys past S weigh nothing), exact max and sum over the
  //    row: this thread holds rows g (e = 0, 1) and g + 8 (e = 2, 3)
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + c + (e & 1);
      s[j][e] = key < S ? __fadd_rn(__fmul_rn(s[j][e], scale), bias[key])
                        : -INFINITY;
    }
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    s[j][0] = expf(s[j][0] - m0);
    s[j][1] = expf(s[j][1] - m0);
    s[j][2] = expf(s[j][2] - m1);
    s[j][3] = expf(s[j][3] - m1);
    l0 += s[j][0] + s[j][1];
    l1 += s[j][2] + s[j][3];
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // 3. out = bf16(p / l) . v: the score tiles 2t and 2t + 1 are the A
  //    fragment of key tile t
  float o[kDimTiles][4];
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int t = 0; t < kKeyTiles / 2; ++t) {
    if (t < key_tiles) {
      uint32_t a[4];
      a[0] = pack_rn(__fdiv_rn(s[2 * t][0], l0), __fdiv_rn(s[2 * t][1], l0));
      a[1] = pack_rn(__fdiv_rn(s[2 * t][2], l1), __fdiv_rn(s[2 * t][3], l1));
      a[2] = pack_rn(__fdiv_rn(s[2 * t + 1][0], l0),
                     __fdiv_rn(s[2 * t + 1][1], l0));
      a[3] = pack_rn(__fdiv_rn(s[2 * t + 1][2], l1),
                     __fdiv_rn(s[2 * t + 1][3], l1));
#pragma unroll
      for (int n = 0; n < kDimTiles; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, Vs, kLd, t * 16, n * 8);
        mma(o[n], a, b0, b1);
      }
    }
  }

  // 4. store the rows that exist, bf16
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) {
    if (r0 + g < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (r0 + g) * ld_out + n * 8 + c) =
          __floats2bfloat162_rn(o[n][0], o[n][1]);
    if (r0 + g + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (r0 + g + 8) * ld_out + n * 8 +
                                         c) =
          __floats2bfloat162_rn(o[n][2], o[n][3]);
  }
}

template <int NW>
struct Weights {
  const bf16* p[NW];
};

// x tiles in a projection's staging buffer: kMaxS rows of kChunk (+ pad)
constexpr int kLdX = kChunk + 8;
template <int NW>
__host__ __device__ constexpr long long proj_stage() {  // elements a stage
  return static_cast<long long>(kMaxS) * kLdX +
         static_cast<long long>(NW) * kChunk * kLd;
}
template <int NW>
__host__ __device__ constexpr long long proj_smem() {
  return 2 * proj_stage<NW>() * 2;
}

// acc[m] = x[rows 16w..16w+16, :K] . W_m[:K, col0..col0+64) for this warp
// w and each of the NW weights; x row-major with row stride ldx, rows
// >= n_rows read as zeros; W_m row-major [K][ldw]. 64-deep tiles of x (all
// kMaxS rows) and of each W_m stream through a cp.async double buffer at
// `stage` (proj_smem<NW>() bytes). K must be a multiple of kChunk.
template <int NW>
__device__ __forceinline__ void project(float (&acc)[NW][kDimTiles][4],
                                        const bf16* x, long long ldx,
                                        int n_rows, int K, Weights<NW> w,
                                        long long ldw, int col0,
                                        bf16* stage) {
  const int r0 = (threadIdx.x >> 5) * 16;
#pragma unroll
  for (int m = 0; m < NW; ++m)
#pragma unroll
    for (int n = 0; n < kDimTiles; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

  auto load = [&](int buf, int k0) {
    bf16* X = stage + buf * proj_stage<NW>();
    for (int i = threadIdx.x; i < kMaxS * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), ch = i % (kChunk / 8);
      const bool valid = r < n_rows;
      cp_async16(X + r * kLdX + ch * 8, valid ? x + r * ldx + k0 + ch * 8 : x,
                 valid);
    }
#pragma unroll
    for (int m = 0; m < NW; ++m) {
      bf16* W = X + kMaxS * kLdX + m * kChunk * kLd;
      for (int i = threadIdx.x; i < kChunk * (kD / 8); i += kThreads) {
        const int r = i / (kD / 8), ch = i % (kD / 8);
        cp_async16(W + r * kLd + ch * 8, w.p[m] + (k0 + r) * ldw + col0 + ch * 8,
                   true);
      }
    }
  };

  const int n_chunks = K / kChunk;
  load(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_chunks; ++t) {
    if (t + 1 < n_chunks) load((t + 1) & 1, (t + 1) * kChunk);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const bf16* X = stage + (t & 1) * proj_stage<NW>();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      uint32_t a[4];
      load_a(a, X, kLdX, r0, kk);
#pragma unroll
      for (int m = 0; m < NW; ++m) {
        const bf16* W = X + kMaxS * kLdX + m * kChunk * kLd;
#pragma unroll
        for (int n = 0; n < kDimTiles; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, W, kLd, kk, n * 8);
          mma(acc[m][n], a, b0, b1);
        }
      }
    }
    __syncthreads();  // this buffer is refilled at t + 2
  }
}

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

// attn_block launch 1: a block owns one (b, h)
__global__ void __launch_bounds__(kThreads)
    qkv_attend_kernel(const bf16* __restrict__ x, Weights<3> w,
                      const float* __restrict__ bias, bf16* __restrict__ ctx,
                      int S, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  const int heads = H / kD;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const long long row0 = static_cast<long long>(b) * S;

  float acc[3][kDimTiles][4];
  project<3>(acc, x + row0 * H, H, S, H, w, H, h * kD, stage);

  // q, k, v in bf16 into shared memory (over the staging buffers, which
  // the last __syncthreads of project() has released); rows past S are 0
  bf16* Qs = stage;
  bf16* qkv[3] = {Qs, Qs + kMaxS * kLd, Qs + 2 * kMaxS * kLd};
  const int lane = threadIdx.x & 31, g = lane >> 2, c = 2 * (lane & 3);
  const int r0 = (threadIdx.x >> 5) * 16;
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int n = 0; n < kDimTiles; ++n) {
      *reinterpret_cast<uint32_t*>(qkv[m] + (r0 + g) * kLd + n * 8 + c) =
          pack_rn(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<uint32_t*>(qkv[m] + (r0 + g + 8) * kLd + n * 8 + c) =
          pack_rn(acc[m][n][2], acc[m][n][3]);
    }
  __syncthreads();
  attend_rows(qkv[0], qkv[1], qkv[2], bias + row0, S, scale,
              ctx + row0 * H + h * kD, H);
}

// attn_block launch 2: a block owns rows [128 i, 128 i + 128) x columns
// [64 j, 64 j + 64) of out = bf16(ctx . wo)
__global__ void __launch_bounds__(kThreads)
    out_proj_kernel(const bf16* __restrict__ ctx, Weights<1> wo,
                    bf16* __restrict__ out, long long M, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);
  const int col_tiles = H / kD;
  const long long row0 = static_cast<long long>(blockIdx.x / col_tiles) * kMaxS;
  const int col0 = (blockIdx.x % col_tiles) * kD;
  const long long left = M - row0;
  const int n_rows = left < kMaxS ? static_cast<int>(left) : kMaxS;

  float acc[1][kDimTiles][4];
  project<1>(acc, ctx + row0 * H, H, n_rows, H, wo, H, col0, stage);

  const int lane = threadIdx.x & 31, g = lane >> 2, c = 2 * (lane & 3);
  const int r0 = (threadIdx.x >> 5) * 16;
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) {
    if (r0 + g < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r0 + g) * H + col0 +
                                         n * 8 + c) =
          __floats2bfloat162_rn(acc[0][n][0], acc[0][n][1]);
    if (r0 + g + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r0 + g + 8) * H + col0 +
                                         n * 8 + c) =
          __floats2bfloat162_rn(acc[0][n][2], acc[0][n][3]);
  }
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

// The dynamic shared memory kernel #5 is launched with, in bytes (ptxas's
// report counts only static shared memory).
extern "C" void attn128_bf16_smem(int* bytes) { bytes[0] = kHeadSmemBytes; }

// Kernel #6: x, ctx (scratch) and out contiguous [B, S, H] bf16; wq, wk,
// wv, wo contiguous [H, H] bf16 (x . W); bias fp32 [B, S]; limits as
// attn128_launch. Two kernels on `stream`, qkv_attend then out_proj.
extern "C" int attn_block_launch(const void* x, const void* wq,
                                 const void* wk, const void* wv,
                                 const void* wo, const float* bias, void* ctx,
                                 void* out, int B, int S, int H, float scale,
                                 void* stream) {
  if (!takes(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * S;
  const long long attend_blocks = static_cast<long long>(B) * (H / kD);
  const long long proj_blocks = (M + kMaxS - 1) / kMaxS * (H / kD);
  if (M == 0) return 0;
  if (attend_blocks > 0x7fffffffLL || proj_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(qkv_attend_kernel, proj_smem<3>());
  if (err == cudaSuccess) err = allow_smem(out_proj_kernel, proj_smem<1>());
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Weights<3> w{{static_cast<const bf16*>(wq),
                      static_cast<const bf16*>(wk),
                      static_cast<const bf16*>(wv)}};
  qkv_attend_kernel<<<static_cast<unsigned>(attend_blocks), kThreads,
                      proj_smem<3>(), s>>>(static_cast<const bf16*>(x), w,
                                           bias, static_cast<bf16*>(ctx), S,
                                           H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Weights<1> w_o{{static_cast<const bf16*>(wo)}};
  out_proj_kernel<<<static_cast<unsigned>(proj_blocks), kThreads,
                    proj_smem<1>(), s>>>(static_cast<const bf16*>(ctx), w_o,
                                         static_cast<bf16*>(out), M, H);
  return static_cast<int>(cudaGetLastError());
}
