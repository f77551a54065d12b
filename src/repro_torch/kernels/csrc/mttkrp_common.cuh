// What the port's CUDA sources share: the MTTKRP body's block shape
// (mttkrp_cluster.cuh), the cp.async helpers, the rank padding, the pass
// that adds split partials in a fixed order, and the error strings.
//
// Layout of an MTTKRP block: BI lanes x WARPS warps.  Lane = target row i of
// the tile, warp = a slice of the step's contracted indices.  Every lane
// keeps its own (1, CP) accumulator row in registers; the warps' rows are
// summed at the end in a fixed order (warp 0 + 1 + ... + 7), so a result
// never depends on scheduling and no atomics are needed.
//
// CP is a column block's width padded to one of 4, 8, 12, 16, 24, 32, 48,
// 64 (a template parameter: the accumulator lives in registers, so it must
// be a compile-time size; a multiple of 4 for the float4 reads).  A rank
// above 64 is cut into column blocks of at most 64 (col_blocks,
// block_cols).  Padded columns hold zeros in shared memory and are never
// stored.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mttkrp {

constexpr int BI = 32;               // target rows per block, one per lane
constexpr int WARPS = 8;             // warps per block
constexpr int THREADS = BI * WARPS;  // 256

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// Asynchronous 4-byte global -> shared copy (zero-fill when !valid; src must
// still be a mapped address), grouped with commit / wait_group.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out[z * n + e] = sum_{k < splits} ws[(z * splits + k) * n + e], summed in
// split order: the second pass of the split reduction, one slab z after the
// other (deterministic; no atomics anywhere).  n = I * C elements per slab.
__global__ void sum_splits_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                  int64_t n, int splits, int64_t total) {
  const int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= total) return;
  const int64_t z = g / n;
  const float* __restrict__ w = ws + z * splits * n + (g - z * n);
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += w[k * n];
  out[g] = s;
}

inline void launch_sum_splits(const float* ws, float* out, int64_t n, int splits, int slabs,
                              cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * slabs;
  const int64_t blocks = (total + threads - 1) / threads;
  sum_splits_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(ws, out, n, splits,
                                                                           total);
}

// The widest column block: the largest padded rank.
constexpr int MAX_BLOCK_COLS = 64;

// Column blocks of rank c: ceil(c / 64) near-equal blocks (one for c <= 64).
inline int col_blocks(int c) {
  return static_cast<int>((static_cast<int64_t>(c) + MAX_BLOCK_COLS - 1) / MAX_BLOCK_COLS);
}

// Columns of each block of rank c but the last, which holds the rest (at
// least one: cw <= 64 and c > 64 (nb - 1)).
inline int block_cols(int c) {
  const int64_t nb = col_blocks(c);
  return static_cast<int>((static_cast<int64_t>(c) + nb - 1) / nb);
}

// A block's width padded to what the register accumulator needs; 0 above 64.
inline int padded_rank(int c) {
  static const int kPadded[] = {4, 8, 12, 16, 24, 32, 48, 64};
  for (int cp : kPadded) {
    if (c <= cp) return cp;
  }
  return 0;
}

}  // namespace mttkrp

extern "C" const char* mttkrp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
