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
// What bounds it on the H100. Its job is long sequences, where the fused
// kernel's whole score row no longer fits shared memory: per (b, h) it
// reads q, k, v once per 64-query tile and keeps only a 64 x 64 score tile
// and the running max / sum / accumulator on chip, so memory is O(S), not
// O(S^2). The products are fp32 on the CUDA cores, because fp32 k, v and p
// are part of the function (tensor cores would round them to TF32 or
// bf16): at S = 2048 a head is 4*S*S*D = 1.07 GFLOP, and the fp32 rate
// (67 TFLOP/s peak) is the bound. A 3xTF32 or bf16-split product on the
// tensor cores is later work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps; tx = tid % 16, ty = tid / 16
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // query rows per block and keys per tile

struct Strides {
  long long b, s, h;  // elements; the D stride is 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Rows [row0, row0 + kTile) of one head into shared memory [kTile][D + 1]
// as fp32, times `mul` (exact for mul == 1); rows >= S become zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* head,
                                          long long ld_src, int row0, int S,
                                          float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        row0 + r < S ? __fmul_rn(to_f32(head[(row0 + r) * ld_src + d]), mul)
                     : 0.f;
  }
}

template <int D>
constexpr int smem_bytes() {
  // Q, K, V [kTile][D + 1] | p [kTile][kTile + 1] | m, l, alpha [kTile]
  return 4 * (3 * kTile * (D + 1) + kTile * (kTile + 1) + 3 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ bias,
              T* __restrict__ out, int S, int H, Strides st, float scale,
              int n_qtiles) {
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

  load_tile<T, D>(Qs, q + head, st.s, q0, S, scale);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    m_row[r] = -INFINITY;
    l_row[r] = 0.f;
  }
  float acc[4][kCols] = {};  // rows ty + 16 i, columns tx + 16 c

  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // the previous tile's K, V and p are consumed
    load_tile<T, D>(Ks, k + head, st.s, k0, S, 1.f);
    load_tile<T, D>(Vs, v + head, st.s, k0, S, 1.f);
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
    T* o = out + ((static_cast<long long>(b) * S + q0 + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store(o + tx + 16 * c, __fdiv_rn(acc[i][c], l));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int B, int S, int H, Strides st, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (S + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(B) * H * n_qtiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd<T, D><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), S, H, st, scale,
      n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D must be 64. q, k and v share one set
// of strides (elements; unit stride along D). Returns a cudaError_t, 0 on
// success (cudaErrorInvalidValue for what the kernel does not take); the
// launch is asynchronous on `stream`.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, const float* bias,
                                      void* out, int B, int S, int H, int D,
                                      long long stride_b, long long stride_s,
                                      long long stride_h, float scale,
                                      void* stream) {
  if (D != 64 || B < 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{stride_b, stride_s, stride_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, 64>(q, k, v, bias, out, B, S, H, st, scale, s);
  if (dtype == 1)
    return launch<bf16, 64>(q, k, v, bias, out, B, S, H, st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
