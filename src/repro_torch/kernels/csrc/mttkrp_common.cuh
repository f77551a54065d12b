// Tile machinery of the two MTTKRP kernels (fused_mttkrp.cu,
// matrix_free.cu): one thread block owns BI rows of the target mode of one
// slab (blockIdx.z; a single tensor is one slab).  The fused kernel streams
// that slab's tensor through shared memory in BI x BR tiles (issue_tile,
// mac_tile, reduce_and_store); the matrix-free kernel, whose stages hold
// whole q extents, shares the block shape, the cp.async helpers, the rank
// padding and the split-sum pass.
//
// Layout of a block: BI lanes x WARPS warps.  Lane = target row i of the
// tile, warp = a slice of RPW reduction indices of the tile.  Every lane keeps
// its own (1, CP) accumulator row in registers; the warps' rows are summed at
// the end in a fixed order (warp 0 + 1 + ... + 7), so a result never depends
// on scheduling and no atomics are needed.
//
// CP is the rank padded to one of 4, 8, 12, 16, 24, 32, 48, 64 (a template
// parameter: the accumulator lives in registers, so it must be a
// compile-time size; a multiple of 4 for the float4 reads).  Padded rank
// columns hold zeros in shared memory and are never stored.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mttkrp {

constexpr int BI = 32;                              // target rows per block, one per lane
constexpr int WARPS = 8;                            // warps per block
constexpr int THREADS = BI * WARPS;                 // 256
constexpr int BR = 64;                              // reduction indices per tile
constexpr int RPW = BR / WARPS;                     // reduction indices per warp per tile
constexpr int PER_THREAD = BI * BR / THREADS;       // tile elements each thread loads

constexpr int STAGES = 3;                           // tensor tiles in flight per block

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

// Tile element (i, r) lies at base + i * si + r * sr; rows i >= ni and
// columns r >= nr are outside the tensor and read as 0.  I_CONTIG says which
// axis is contiguous (si == 1 when true, sr == 1 when false): neighbouring
// threads load neighbouring addresses either way.
template <bool I_CONTIG>
__device__ __forceinline__ void tile_coords(int k, int& i, int& r) {
  const int t = threadIdx.x;
  if (I_CONTIG) {
    i = t % BI;
    r = t / BI + k * (THREADS / BI);
  } else {
    r = t % BR;
    i = t / BR + k * (THREADS / BR);
  }
}

// Starts the asynchronous copy of one tile into ts[r][i].  The +1 pad keeps
// the copies (32 consecutive r, or 32 consecutive i) and the compute loop's
// reads (32 consecutive i) free of bank conflicts.  `base` is the tile's
// origin, inside the tensor; masked elements are zero-filled.
template <bool I_CONTIG>
__device__ __forceinline__ void issue_tile(float (*ts)[BI + 1], const float* __restrict__ base,
                                           int64_t si, int64_t sr, int ni, int nr) {
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    int i, r;
    tile_coords<I_CONTIG>(k, i, r);
    const bool valid = i < ni && r < nr;
    cp_async_f32(&ts[r][i], valid ? base + i * si + r * sr : base, valid);
  }
}

// acc[c] += sum over this warp's r of ts[r][lane] * w[r][c]  (ordinary fp32
// FMA; w is broadcast to the whole warp, read as float4).
template <int CP>
__device__ __forceinline__ void mac_tile(float (&acc)[CP], const float (*ts)[BI + 1],
                                         const float (*w)[CP]) {
  const int lane = threadIdx.x % BI;
  const int warp = threadIdx.x / BI;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp * RPW + rr;
    const float t = ts[r][lane];
#pragma unroll
    for (int c = 0; c < CP; c += 4) {
      const float4 k = *reinterpret_cast<const float4*>(&w[r][c]);
      acc[c] = fmaf(t, k.x, acc[c]);
      acc[c + 1] = fmaf(t, k.y, acc[c + 1]);
      acc[c + 2] = fmaf(t, k.z, acc[c + 2]);
      acc[c + 3] = fmaf(t, k.w, acc[c + 3]);
    }
  }
}

// Sums the warps' accumulators in the fixed order 0, 1, ..., WARPS-1 and
// writes rows [i0, i0 + BI) of one split's partial, out[i * C + c], c < C.
template <int CP>
__device__ __forceinline__ void reduce_and_store(float (&acc)[CP], float* red,
                                                 float* __restrict__ out, int64_t i0,
                                                 int64_t rows, int C) {
  const int lane = threadIdx.x % BI;
  const int warp = threadIdx.x / BI;
  for (int src = 1; src < WARPS; ++src) {
    __syncthreads();
    if (warp == src) {
#pragma unroll
      for (int c = 0; c < CP; ++c) red[c * BI + lane] = acc[c];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int c = 0; c < CP; ++c) acc[c] += red[c * BI + lane];
    }
  }
  const int64_t i = i0 + lane;
  if (warp == 0 && i < rows) {
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      if (c < C) out[i * C + c] = acc[c];
    }
  }
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

// Rank padded to what the register accumulator needs; 0 when unsupported.
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
