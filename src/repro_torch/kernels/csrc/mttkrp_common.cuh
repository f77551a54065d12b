// What the port's CUDA sources share: the MTTKRP body's block shape
// (mttkrp_cluster.cuh), the element types, the cp.async helpers, the rank
// padding, the pass that adds split partials in a fixed order, and the
// error strings.
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mttkrp {

constexpr int BI = 32;               // target rows per block, one per lane
constexpr int WARPS = 8;             // warps per block
constexpr int THREADS = BI * WARPS;  // 256

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// The element types the kernels read: float, bf16, fp16 and double, each
// read from HBM at its own width.  Every sum is taken in fp32 (the
// reference's kernels accumulate into a float32 output whatever they read),
// so a double is rounded to float where it is used; bf16 and fp16 convert
// to float exactly.  Per type: the elements in a 16-byte unit, the
// conversion to float (of a value, and of the bits of a 16-bit one), the
// type a product of two elements is taken in (`Wide`: float, exact for two
// 16-bit values; double for doubles) and that product rounded as the
// reference rounds `a * b` in T (`round`: to T, then widened to `Wide`
// again; to float for doubles, where the reference casts the product to
// its float32 sum), and the product stored as T (`store`).
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kUnit = 4;
  using Wide = float;
  __device__ static __forceinline__ float to_float(float v) { return v; }
  __device__ static __forceinline__ float round(float p) { return p; }
  __device__ static __forceinline__ float store(float p) { return p; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kUnit = 8;
  using Wide = float;
  __device__ static __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __forceinline__ float bits_to_float(unsigned b) {
    return __uint_as_float(b << 16);
  }
  __device__ static __forceinline__ float round(float p) {
    return __bfloat162float(__float2bfloat16_rn(p));
  }
  __device__ static __forceinline__ __nv_bfloat16 store(float p) { return __float2bfloat16_rn(p); }
};

template <>
struct Elem<__half> {
  static constexpr int kUnit = 8;
  using Wide = float;
  __device__ static __forceinline__ float to_float(__half v) { return __half2float(v); }
  __device__ static __forceinline__ float bits_to_float(unsigned b) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  }
  __device__ static __forceinline__ float round(float p) {
    return __half2float(__float2half_rn(p));
  }
  __device__ static __forceinline__ __half store(float p) { return __float2half_rn(p); }
};

template <>
struct Elem<double> {
  static constexpr int kUnit = 2;
  using Wide = double;
  __device__ static __forceinline__ float to_float(double v) { return __double2float_rn(v); }
  __device__ static __forceinline__ float round(double p) { return __double2float_rn(p); }
  __device__ static __forceinline__ double store(double p) { return p; }
};

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  return Elem<T>::to_float(v);
}

// An element as the type its products are taken in (exact).
template <typename T>
__device__ __forceinline__ typename Elem<T>::Wide widen(T v) {
  if constexpr (sizeof(T) == 8) {
    return v;
  } else {
    return Elem<T>::to_float(v);
  }
}

// Asynchronous 4-byte global -> shared copy (zero-fill when !valid; src must
// still be a mapped address), grouped with commit / wait_group.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
// The same for 8 bytes (a double).
__device__ __forceinline__ void cp_async_8(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}
// And 16 bytes (a unit), bypassing L1.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
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
