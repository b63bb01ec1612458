// Blocked flash attention forward (online softmax over key tiles).
//
// Replaces the Pallas kernel ance_tpu/ops/flash_attention.py::_flash_kernel
// (via _flash_forward). For q, k, v laid out [B, S, H, D] (any batch, seq
// and head strides, unit stride along D; float32 or bfloat16) and an fp32
// key bias [B, S] (0 keep, -1e9 drop) it writes out [B, S, H, D]
// contiguous, computing in fp32 throughout, as the JAX kernel does:
//     q' = fp32(q) * (1/sqrt(D))
//     for each key tile:  s = q' . fp32(k) + bias
//                         m' = max(m, rowmax(s));  p = exp(s - m')
//                         a = exp(m - m');  l = l*a + rowsum(p)
//                         acc = acc*a + p . fp32(v)
//     out = acc / l, rounded to the input type.
// p stays fp32 into the PV product (unlike the fused kernel, which rounds
// it to the input type first): that is what makes it another function.
// The JAX kernel's 256 x 256 blocks and its rule that S be a multiple of
// them are TPU tiling; here a tile is 64 queries x 64 keys and the ragged
// edge is masked (keys at or beyond S get -inf, rows beyond S are not
// stored).
//
// Its job is long sequences, where the fused kernel's whole score row no
// longer fits shared memory: per (b, h) it reads q, k, v once per query
// tile and keeps only a score tile and the running max / sum / accumulator
// on chip, so memory is O(S), not O(S^2).
//
// bf16 inputs (flash_fwd_bf16: wgmma + TMA, hopper.cuh). The function's
// products run on the bf16 tensor cores with no loss:
//  * q . k: the scale 1/8 is a power of two, so q' = q / 8 is exact in
//    bf16 and each product q'_d k_d = (q_d k_d) / 8 is exact in fp32;
//    s = fma(q . k, 1/8, bias) with q . k from bf16 wgmma (fp32
//    accumulate) is the function's s, its sum taken in another order;
//  * p . v: p (fp32, 24 bits) is exactly p1 + p2 + p3 with p1 = bf16(p),
//    p2 = bf16(p - p1), p3 = bf16(p - p1 - p2) (each remainder exact; the
//    last piece fits bf16's 8 bits, down to bf16's subnormals, below
//    which a piece under 2^-133 is lost), so p . v is three bf16 wgmma
//    into one fp32 accumulator, the smallest piece first. Two pieces would
//    be another function (p to 16 bits).
// The least time is then the operations: 2*S*S*64 (q . k) + 3*2*S*S*64
// (p . v) a head at the bf16 rate, 0.208 ms at B = 8, S = 2048, H = 12.
// A block is a producer warp and two consumer warpgroups of 64 query rows;
// the producer streams 64-key K and V tiles (and the tile's bias, by the
// warp's own stores) through a ring of kStages guarded by full / empty
// mbarriers, straight from the strided views (128-byte swizzle, rows past
// S zero-filled). Each tile: s = q . k^T by wgmma from shared memory, the
// scale-and-bias FMA, the online max and a rescaled running sum (the exp
// one ex2.approx.ftz), acc *= a, the three pieces of p as register A
// fragments into wgmma against v read MN-major; at the end out = acc / l
// (1/l once a row and Markstein's two FMAs: the correctly rounded
// quotient). What it waits on is the CUDA-core epilogue (max, exp, sum,
// the split and its packing, ~13 instructions a score), which overlaps the
// tensor cores only across the two warpgroups.
//
// float32 inputs (flash_fwd_pieces: wgmma on exact bf16 pieces). TF32
// stays off, so an fp32 product must keep every bit: one split_pieces
// launch (split_pieces.cuh) writes three bf16 pieces of q, k and v, each
// element exactly x0 + x1 + x2 (hopper::split3), and every product of the
// function is the six piece products with i + j <= 2 on wgmma, each exact
// in fp32 (the dropped three are below 2^-25 of |a||b|). For fp32 operands
// the fused attention's forward is this same function (q / 8 is exact, p
// stays fp32 in both), so this one kernel is the fp32 forward of both:
// ops/fused_attention.py launches it for the fused route too. A block is
// 128 query rows of one (b, h), two consumer warpgroups and a producer
// warpgroup that gives its registers to them (setmaxnreg); the producer
// streams the K | V piece tiles through a TMA ring of kPieceStages and,
// as flash_fwd_bf16's does, each tile's 64 bias values by stage, so S has
// no cap. Each 64-key tile: s = the six
// piece products smallest first into a fresh accumulator, the scale-and-
// bias FMA and the online softmax with expf (ExpExact: p keeps 24 bits),
// p split into three A fragments in registers, p . v as six piece products
// into a fresh partial added to the running total rounded to nearest,
// because the tensor cores' fp32 accumulation truncates; out = total / l.
// Its least time is the piece products, 6 x 4*S*S*64 a head at the bf16
// rate (0.625 ms at B = 8, S = 2048, H = 12), where the fp32 rate would
// take 1.538 ms; the split moves 10 bytes an element.
//
// float32 operands the split's 16-byte loads cannot read (strides not a
// multiple of 4 elements, or a base off 16-byte alignment) take
// flash_fwd_f32 on the CUDA cores: 64 queries a block through shared
// memory. ops/flash_attention.py's flash_kernel_for names the route
// before any launch.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "split_pieces.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps; tx = tid % 16, ty = tid / 16
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // query rows per block and keys per tile

using hopper::Strides;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Rows [row0, row0 + kTile) of one head into shared memory [kTile][D + 1]
// times `mul` (exact for mul == 1); rows >= S become zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* head,
                                          long long ld_src, int row0, int S,
                                          float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        row0 + r < S ? __fmul_rn(head[(row0 + r) * ld_src + d], mul) : 0.f;
  }
}

template <int D>
constexpr int smem_bytes() {
  // Q, K, V [kTile][D + 1] | p [kTile][kTile + 1] | m, l, alpha [kTile]
  return 4 * (3 * kTile * (D + 1) + kTile * (kTile + 1) + 3 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  float* __restrict__ out, int S, int H, Strides st,
                  float scale, int n_qtiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kLd = D + 1;     // odd: column reads hit distinct banks
  constexpr int kLdP = kTile + 1;
  constexpr int kCols = D / 16;  // output columns per thread
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kTile * kLd;
  float* Vs = Ks + kTile * kLd;
  float* Ps = Vs + kTile * kLd;
  float* m_row = Ps + kTile * kLdP;
  float* l_row = m_row + kTile;
  float* a_row = l_row + kTile;

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kTile;
  const int b = bh / H, h = bh % H;
  const long long head = b * st.b + h * st.h;
  const float* bias_b = bias + static_cast<long long>(b) * S;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D>(Qs, q + head, st.s, q0, S, scale);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    m_row[r] = -INFINITY;
    l_row[r] = 0.f;
  }
  float acc[4][kCols] = {};  // rows ty + 16 i, columns tx + 16 c

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous tile's K, V and p are consumed
    load_tile<D>(Ks, k + head, st.s, k0, S, 1.f);
    load_tile<D>(Vs, v + head, st.s, k0, S, 1.f);
    __syncthreads();

    // s = q' . k + bias for rows ty + 16 i, keys tx + 16 j
    float s[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float kv[4], qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const float bj = key < S ? bias_b[key] : -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = __fadd_rn(s[i][j], bj);
    }
    __syncthreads();

    // online statistics, one warp per row: p = exp(s - m'), l, alpha
    for (int r = warp; r < kTile; r += kWarps) {
      float* row = Ps + r * kLdP;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_prev = m_row[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_row[r] = __fadd_rn(__fmul_rn(l_row[r], alpha), sum);
        m_row[r] = m_new;
        a_row[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v
    float pv[4][kCols] = {};
    for (int j = 0; j < kTile; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[j * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * kLdP + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) pv[i][c] = fmaf(p, vv[c], pv[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_row[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], alpha), pv[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float l = l_row[r];
    float* o = out + ((static_cast<long long>(b) * S + q0 + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[tx + 16 * c] = __fdiv_rn(acc[i][c], l);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v,
               const float* bias, void* out, int B, int S, int H, Strides st,
               float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (S + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(B) * H * n_qtiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_f32<D><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(out), S, H, st,
      scale, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bf16, wgmma

using hopper::kTileBytes;  // one [64][64] bf16 tile
using hopper::Lane;
using hopper::Ring;

constexpr int kConsumerWgs = 2;
constexpr int kConsumerWarps = 4 * kConsumerWgs;
constexpr int kBf16Threads = kConsumerWgs * hopper::kWgThreads + 32;
constexpr int kBlockRows = kConsumerWgs * 64;  // query rows a block owns
constexpr int kStages = 4;
constexpr int kTileElems = 64 * 64;

struct alignas(1024) FlashSmem {
  bf16 q[kConsumerWgs][kTileElems];
  bf16 kv[kStages][2][kTileElems];  // K | V
  float bias[kStages][64];          // the tile's keys; >= S: 0 (masked)
  uint64_t full[kStages], empty[kStages], q_full;
};
constexpr int kSmemSlack = 1024;  // aligned_smem's rounding
constexpr int kFlashSmemBytes =
    static_cast<int>(sizeof(FlashSmem)) + kSmemSlack;

// Two blocks an SM: four consumer warpgroups, so one's epilogue overlaps
// another's products. That caps a thread at 96 registers (the three
// pieces of p alone are 48) where one block an SM took 162, and it ran
// faster on the card all the same.
__global__ void __launch_bounds__(kBf16Threads, 2)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int S, int H, float scale, int n_blocks) {
  FlashSmem& sm = hopper::aligned_smem<FlashSmem>();
  const int bh = blockIdx.x / n_blocks;
  const int q0 = (blockIdx.x % n_blocks) * kBlockRows;
  const int b = bh / H, h = bh % H;
  const int n_kt = (S + 63) / 64;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&sm.full[i], 32);  // every producer lane arrives
      hopper::mbar_init(&sm.empty[i], kConsumerWarps);
    }
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / 32 == kConsumerWarps) {  // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      hopper::mbar_expect_tx(&sm.q_full, kConsumerWgs * kTileBytes);
      for (int w = 0; w < kConsumerWgs; ++w)
        hopper::tma_load_4d(sm.q[w], &mq, 0, h, q0 + 64 * w, b, &sm.q_full);
    }
    const float* bias_b = bias + static_cast<long long>(b) * S;
    Ring<kStages> r;
    for (int t = 0; t < n_kt; ++t, r.next()) {
      hopper::mbar_wait(&sm.empty[r.stage], r.phase ^ 1);
      // the tile's bias by the warp's plain stores, each lane's released by
      // its own arrive
      for (int i = lane; i < 64; i += 32) {
        const int key = 64 * t + i;
        sm.bias[r.stage][i] = key < S ? bias_b[key] : 0.f;
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(&sm.full[r.stage], 2 * kTileBytes);
        hopper::tma_load_4d(sm.kv[r.stage][0], &mk, 0, h, 64 * t, b,
                            &sm.full[r.stage]);
        hopper::tma_load_4d(sm.kv[r.stage][1], &mv, 0, h, 64 * t, b,
                            &sm.full[r.stage]);
      } else {
        hopper::mbar_arrive(&sm.full[r.stage]);
      }
    }
    return;
  }

  const Lane ln;
  const bool arrives = threadIdx.x % 32 == 0;
  const bf16* qt = sm.q[ln.wg];
  hopper::mbar_wait(&sm.q_full, 0);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // the thread's partial sums, quad-reduced last
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  Ring<kStages> r;
  for (int t = 0; t < n_kt; ++t, r.next()) {
    hopper::mbar_wait(&sm.full[r.stage], r.phase);
    float s[32];
    hopper::scores(s, qt, sm.kv[r.stage][0]);
    hopper::scale_bias(s, sm.bias[r.stage], 64 * t, S, scale, ln.c);
    // online statistics: the exact running max (reduced over the quad),
    // a = exp(m - m'), p = exp(s - m'), the thread's partial sums
    hopper::online_softmax(s, m, l, acc);
    // p . v as three bf16 products; a piece's registers stay untouched
    // until the wait that covers its product
    uint32_t p1[4][4], p2[4][4], p3[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        hopper::split3(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1], p1[kk][q],
                       p2[kk][q], p3[kk][q]);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    hopper::issue_ab(acc, p3, sm.kv[r.stage][1]);
    hopper::issue_ab(acc, p2, sm.kv[r.stage][1]);
    hopper::issue_ab(acc, p1, sm.kv[r.stage][1]);
    hopper::wait_products(acc);
    if (arrives) hopper::mbar_arrive(&sm.empty[r.stage]);
  }
  hopper::online_finish(l, acc);
  hopper::store_tile(acc, out + (static_cast<long long>(b) * S * H + h) * 64,
                     static_cast<long long>(H) * 64, q0 + 64 * ln.wg, S, ln);
}

int launch_bf16(const void* q, const void* k, const void* v,
                const float* bias, void* out, int B, int S, int H, Strides st,
                float scale, cudaStream_t stream) {
  if (!hopper::power_of_two(scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (S + kBlockRows - 1) / kBlockRows;
  const long long blocks = static_cast<long long>(B) * H * n_blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const void* operands[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (hopper::encode_bhsd(&maps[i], operands[i], B, S, H, st.b, st.s, st.h,
                            hopper::kTileRows) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFlashSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16<<<static_cast<unsigned>(blocks), kBf16Threads,
                   kFlashSmemBytes, stream>>>(maps[0], maps[1], maps[2], bias,
                                              static_cast<bf16*>(out), S, H,
                                              scale, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ fp32, bf16 pieces

using hopper::kPieces;
using hopper::kPieceTileBytes;

constexpr int kPieceStages = 3;  // the K | V piece ring
constexpr int kConsumerThreads = kConsumerWgs * hopper::kWgThreads;
constexpr int kPieceThreads = kConsumerThreads + hopper::kWgThreads;
// a consumer's registers: three pieces of a fragment beside a fresh
// accumulator and a running total (nine warps would cap them at 168)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kConsumerRegs * kConsumerThreads +
                      kProducerRegs * hopper::kWgThreads <= 65536,
              "more registers than an SM holds");

struct alignas(1024) FlashPiecesSmem {
  bf16 q[kConsumerWgs][kPieces][kTileElems];
  bf16 kv[kPieceStages][2][kPieces][kTileElems];  // K | V pieces
  float bias[kPieceStages][64];  // the tile's keys; >= S: 0 (masked)
  uint64_t full[kPieceStages], empty[kPieceStages], q_full;
};
constexpr int kFlashPiecesSmemBytes =
    static_cast<int>(sizeof(FlashPiecesSmem)) + kSmemSlack;
static_assert(kFlashPiecesSmemBytes <= 232448,
              "more than a block's shared memory");

// 128 query rows of one (b, h) of the fp32 function on the operands'
// pieces: warps 0-7 are two consumer warpgroups of 64 rows, warps 8-11
// the producer warpgroup, whose first warp loads the tiles and the bias.
__global__ void __launch_bounds__(kPieceThreads, 1)
    flash_fwd_pieces(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int B, int S, int H, float scale, int n_blocks) {
  FlashPiecesSmem& sm = hopper::aligned_smem<FlashPiecesSmem>();
  const int bh = blockIdx.x / n_blocks;
  const int q0 = (blockIdx.x % n_blocks) * kBlockRows;
  const int b = bh / H, h = bh % H;
  const int n_kt = (S + 63) / 64;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kPieceStages; ++i) {
      hopper::mbar_init(&sm.full[i], 32);  // every loading lane arrives
      hopper::mbar_init(&sm.empty[i], kConsumerWarps);
    }
    hopper::mbar_init(&sm.q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 != kConsumerWarps) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      hopper::mbar_expect_tx(&sm.q_full, kConsumerWgs * kPieceTileBytes);
      for (int w = 0; w < kConsumerWgs; ++w)
        hopper::load_pieces(sm.q[w], &mq, h, q0 + 64 * w, b, B, &sm.q_full);
    }
    const float* bias_b = bias + static_cast<long long>(b) * S;
    Ring<kPieceStages> r;
    for (int t = 0; t < n_kt; ++t, r.next()) {
      hopper::mbar_wait(&sm.empty[r.stage], r.phase ^ 1);
      // the tile's bias by the warp's plain stores, each lane's released by
      // its own arrive
      for (int i = lane; i < 64; i += 32) {
        const int key = 64 * t + i;
        sm.bias[r.stage][i] = key < S ? bias_b[key] : 0.f;
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(&sm.full[r.stage], 2 * kPieceTileBytes);
        hopper::load_pieces(sm.kv[r.stage][0], &mk, h, 64 * t, b, B,
                            &sm.full[r.stage]);
        hopper::load_pieces(sm.kv[r.stage][1], &mv, h, 64 * t, b, B,
                            &sm.full[r.stage]);
      } else {
        hopper::mbar_arrive(&sm.full[r.stage]);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const Lane ln;
  const bool arrives = threadIdx.x % 32 == 0;
  const bf16* qt = sm.q[ln.wg][0];
  hopper::mbar_wait(&sm.q_full, 0);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // the thread's partial sums, quad-reduced last
  float total[32], s[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) total[i] = 0.f;
  Ring<kPieceStages> r;
  for (int t = 0; t < n_kt; ++t, r.next()) {
    hopper::mbar_wait(&sm.full[r.stage], r.phase);
    hopper::fence_regs(s);
    hopper::wgmma_fence();
    hopper::issue_abt_pieces(s, qt, sm.kv[r.stage][0][0]);
    hopper::wait_products(s);
    hopper::scale_bias(s, sm.bias[r.stage], 64 * t, S, scale, ln.c);
    hopper::online_softmax(s, m, l, total, hopper::ExpExact());
    uint32_t pa[kPieces][4][4];
    hopper::to_a_pieces(pa, s);
    hopper::add_product(total, part, pa, sm.kv[r.stage][1][0]);
    if (arrives) hopper::mbar_arrive(&sm.empty[r.stage]);
  }
  hopper::online_finish(l, total);
  hopper::store_tile(total, out + (static_cast<long long>(b) * S * H + h) * 64,
                     static_cast<long long>(H) * 64, q0 + 64 * ln.wg, S, ln);
}

int launch_pieces(const void* q, const void* k, const void* v,
                  const float* bias, void* out, bf16* pieces, int B, int S,
                  int H, Strides st, float scale, cudaStream_t stream) {
  if (!hopper::power_of_two(scale) || pieces == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (S + kBlockRows - 1) / kBlockRows;
  const long long blocks = static_cast<long long>(B) * H * n_blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL || 3LL * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ops[3] = {q, k, v};
  const Strides sts[3] = {st, st, st};
  CUtensorMap maps[3];
  int err = hopper::split_operands(ops, sts, pieces, B, S, H, stream);
  for (int i = 0; i < 3 && err == 0; ++i)
    err = hopper::pieces_map(&maps[i], pieces, i, B, S, H);
  if (err == 0)
    err = static_cast<int>(cudaFuncSetAttribute(
        flash_fwd_pieces, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kFlashPiecesSmemBytes));
  if (err != 0) return err;
  flash_fwd_pieces<<<static_cast<unsigned>(blocks), kPieceThreads,
                     kFlashPiecesSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], bias, static_cast<float*>(out), B, S, H,
      scale, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel codes: 0 = float32 on the CUDA cores (flash_fwd_f32), 1 =
// bfloat16 (flash_fwd_bf16), 2 = float32 as bf16 pieces (split_pieces,
// then flash_fwd_pieces; `pieces` is bf16 scratch of 9 * B * S * H * 64
// elements, three pieces of each operand). D must be 64. q, k and v share
// one set of strides (elements; unit stride along D); the bf16 and pieces
// routes need 16-byte-aligned rows and base addresses (TMA boxes, the
// split's 16-byte loads; ops/flash_attention.py's flash_kernel_for chooses
// the code, and the launch refuses, never re-routes, operands its kernel
// cannot take) and a power-of-two scale (1/sqrt(64) is). Returns a
// cudaError_t, 0 on success (cudaErrorInvalidValue for what the kernel
// does not take); the launch is asynchronous on `stream`.
extern "C" int flash_attention_launch(int code, const void* q, const void* k,
                                      const void* v, const float* bias,
                                      void* out, void* pieces, int B, int S,
                                      int H, int D, long long stride_b,
                                      long long stride_s, long long stride_h,
                                      float scale, void* stream) {
  if (D != 64 || B < 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{stride_b, stride_s, stride_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code == 0)
    return launch_f32<64>(q, k, v, bias, out, B, S, H, st, scale, s);
  if (code == 1)
    return launch_bf16(q, k, v, bias, out, B, S, H, st, scale, s);
  if (code == 2)
    return launch_pieces(q, k, v, bias, out, static_cast<bf16*>(pieces), B,
                         S, H, st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory each wgmma kernel is launched with, in bytes:
// [0] flash_fwd_bf16, [1] flash_fwd_pieces (ptxas's report counts only
// static shared memory).
extern "C" void flash_attention_bf16_smem(int* bytes) {
  bytes[0] = kFlashSmemBytes;
  bytes[1] = kFlashPiecesSmemBytes;
}
