// The split of the fp32 attention routes (fused_attention.cu's backward
// on pieces, flash_attention.cu's flash_fwd_pieces): one split_pieces
// launch writes the three bf16 pieces of each fp32 operand (hopper::split3,
// x = x0 + x1 + x2 exactly) as bf16 [3][B][S][H][64] (split_operands), and
// the kernels read them back as [64][64] TMA tiles (pieces_map,
// hopper::load_pieces). A header of its own, not part of hopper.cuh, so
// that the sources that never split (blockmax.cu, attn128.cu) build no
// copy of the kernel.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace hopper {

// Up to four fp32 operands [B, S, H, 64] (each its strides; 16-byte-
// aligned rows and base) and their pieces [3][B][S][H][64] (bf16,
// contiguous). Four slots for every caller: indexed by blockIdx.y, three
// put the arguments on each thread's stack (120 bytes; the split ran at
// half its rate on an H100), four stay in the parameter space.
constexpr int kSplitSlots = 4;
struct SplitArgs {
  const float* x[kSplitSlots];
  bf16* out[kSplitSlots];
  Strides st[kSplitSlots];
};

// Each operand (blockIdx.y) as its three bf16 pieces: one 16-byte load
// and three 8-byte stores a thread a step.
__global__ void __launch_bounds__(256)
    split_pieces(const SplitArgs args, int S, int H, long long n4) {
  const float* x = args.x[blockIdx.y];
  uint2* out = reinterpret_cast<uint2*>(args.out[blockIdx.y]);
  const Strides st = args.st[blockIdx.y];
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int d = 4 * static_cast<int>(i % 16);
    long long row = i / 16;  // (b * S + s) * H + h
    const int h = static_cast<int>(row % H);
    row /= H;
    const int s = static_cast<int>(row % S);
    const long long b = row / S;
    const float4 v = *reinterpret_cast<const float4*>(x + b * st.b +
                                                      s * st.s + h * st.h + d);
    uint2 p0, p1, p2;
    split3(v.x, v.y, p0.x, p1.x, p2.x);
    split3(v.z, v.w, p0.y, p1.y, p2.y);
    out[i] = p0;
    out[i + n4] = p1;
    out[i + 2 * n4] = p2;
  }
}

// ------------------------------------------------------------ host

// what split_pieces' float4 loads read: a 16-byte-aligned base and
// strides of whole 16-byte chunks
inline bool chunked(const void* p, const Strides& st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 &&
         st.s % 4 == 0 && st.h % 4 == 0;
}

// Split N fp32 operands [B, S, H, 64] into their pieces, operand i at
// pieces + i * 3 * B * S * H * 64, in one launch on `stream`. Returns a
// cudaError_t (cudaErrorInvalidValue for an operand split_pieces cannot
// read).
template <int N>
int split_operands(const void* const (&ops)[N], const Strides (&st)[N],
                   bf16* pieces, int B, int S, int H, cudaStream_t stream) {
  static_assert(N <= kSplitSlots, "more operands than split_pieces takes");
  SplitArgs args{};
  const long long n = static_cast<long long>(B) * S * H * 64;
  for (int i = 0; i < N; ++i) {
    if (!chunked(ops[i], st[i])) return static_cast<int>(cudaErrorInvalidValue);
    args.x[i] = static_cast<const float*>(ops[i]);
    args.out[i] = pieces + i * kPieces * n;
    args.st[i] = st[i];
  }
  const long long n4 = n / 4;
  const long long blocks = std::min<long long>((n4 + 255) / 256, 4096);
  split_pieces<<<dim3(static_cast<unsigned>(blocks), N), 256, 0,
                 stream>>>(args, S, H, n4);
  return static_cast<int>(cudaGetLastError());
}

// operand i's pieces [3][B][S][H][64] as one tensor map of [64][64] tiles
// (batch coordinate p * B + b: piece p of batch row b). Returns a
// cudaError_t.
inline int pieces_map(CUtensorMap* map, const bf16* pieces, int i, int B,
                      int S, int H) {
  const long long n = static_cast<long long>(B) * S * H * 64;
  return encode_bhsd(map, pieces + i * kPieces * n, kPieces * B, S, H,
                     static_cast<long long>(S) * H * 64,
                     static_cast<long long>(H) * 64, 64, kTileRows) == 0
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
