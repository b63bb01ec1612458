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
// written once (4 * B*S*H*2 = 100.7 MB at B = 128, 0.030 ms at 3.35 TB/s).
// The TPU kernel's point was to read the projection layout without the
// [B, S, H, D] -> [B*H, S, D] transposes; this kernel keeps that and is
// otherwise its own design, specialised to S <= 128:
//  * a block owns one (b, h); its 8 warps own 16 query rows each. The
//    head's 64 columns of q, k and v are 128-byte row segments of
//    [B, S, H], copied into shared memory with cp.async (16 bytes a
//    thread, rows past S zero-filled);
//  * q.k^T and p.v run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//    fp32 accumulate). A warp's 16 x 128 score rows never leave its
//    registers: 16 accumulator tiles of 16 x 8, whose documented fragment
//    layout gives each thread two rows, reduced over the 4 threads of a
//    quad with shuffles for the exact max and sum. The accumulator layout
//    of q.k^T is the A-operand layout of p.v, so p goes from registers
//    straight into the second product.
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
constexpr long long kHeadSmem = 3LL * kMaxS * kLd * 2;  // Q | K | V

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// two bf16 in one register, `lo` in the low half (the lower index)
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
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

// Start copying rows [0, rows) of a head's 64 columns (row r at
// src + r * ld_src) into a shared [rows][kLd] tile; rows >= S become zeros.
__device__ __forceinline__ void copy_head_async(bf16* dst, const bf16* src,
                                                long long ld_src, int rows,
                                                int S) {
  for (int i = threadIdx.x; i < rows * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), ch = i % (kD / 8);
    const bool valid = r < S;
    cp_async16(dst + r * kLd + ch * 8, valid ? src + r * ld_src + ch * 8 : src,
               valid);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(~0u, x, 1));
  return fmaxf(x, __shfl_xor_sync(~0u, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(~0u, x, 1);
  return x + __shfl_xor_sync(~0u, x, 2);
}

// One warp's 16 query rows [16w, 16w + 16) of a head staged in shared
// memory (Qs, Ks, Vs: [kMaxS][kLd], rows past S zero) against keys
// [0, S): the attention of the file comment, the warp's rows of the
// context stored in bf16 at out + row * ld_out.
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

__global__ void __launch_bounds__(kThreads)
    attn128_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   bf16* __restrict__ out, int S, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kMaxS * kLd;
  bf16* Vs = Ks + kMaxS * kLd;
  const int heads = H / kD;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const long long base = static_cast<long long>(b) * S * H + h * kD;
  const int rows = (S + 15) / 16 * 16;
  copy_head_async(Qs, q + base, H, rows, S);
  copy_head_async(Ks, k + base, H, rows, S);
  copy_head_async(Vs, v + base, H, rows, S);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  attend_rows(Qs, Ks, Vs, bias + static_cast<long long>(b) * S, S, scale,
              out + base, H);
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
// rows (the wrapper checks), 1 <= S <= 128, H a multiple of 64; bias fp32
// [B, S]. Returns a cudaError_t, 0 on success (cudaErrorInvalidValue for
// shapes it does not take); asynchronous on `stream`.
extern "C" int attn128_launch(const void* q, const void* k, const void* v,
                              const float* bias, void* out, int B, int S,
                              int H, float scale, void* stream) {
  if (!takes(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(B) * (H / kD);
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(attn128_kernel, kHeadSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn128_kernel<<<static_cast<unsigned>(blocks), kThreads, kHeadSmem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<bf16*>(out), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

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
