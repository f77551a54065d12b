// Multi-TTV for Hopper (sm_90a), fp32 -- the second step of the 2-step
// MTTKRP (paper Alg. 4):
//
//     M[i, c] = sum_l T[l, i, c] * W[l, c]            (unbatched)
//     M[s, i, c] = sum_l T[s, l, i, c] * W[s, l, c]   (batched, slab s)
//
// Replaces the Pallas TPU kernels src/repro/kernels/multi_ttv.py::
// multi_ttv_kernel (body _kernel) and multi_ttv_batched_kernel (body
// _kernel_batched).  The TPU kernel walks an ordered grid (I blocks, L) and
// accumulates o[i-block, :] += T[l, i-block, :] * W[l, :] into a revisited
// output block.  Here the L walk is a loop inside each thread:
//   * one thread owns one output row i and keeps its C sums in registers
//     (CP, the rank padded as in mttkrp_common.cuh);
//   * a block is `threads` consecutive rows (the wrapper's block_i, clamped
//     to the rows there are); a warp reads T[l, i..i+31, :], 32 * C
//     contiguous floats, and W[l, :] is one address for the whole block, a
//     broadcast through the read-only cache;
//   * L is split over gridDim.y (split_reduction in the wrapper) so that a
//     short I still fills the card; each split writes an (I, C) partial and
//     launch_sum_splits adds the splits in a fixed order.  The l loop runs in
//     ascending order: no atomics, bitwise repeatable results.
//   * Batched, the slab is blockIdx.z and every slab reads only its own T and
//     W and writes only its own partials (as fused_mttkrp.cu).
// Bound: HBM bytes.  T is read once (4 |T| bytes) for 2 |T| FLOPs, 0.5 FLOP
// a byte, far below the card's 20 FLOP/byte fp32 ridge.  At the shapes the
// fMRI tensor gives (T up to 200 x 200 x 10, 1.6 MB) a call moves about
// 0.5 us of HBM traffic, so launch latency, not bandwidth, sets its time.
// Ragged I and L are masked, nothing is padded.
#include "mttkrp_common.cuh"

namespace mttkrp {

template <int CP, bool BATCHED>
__global__ void multi_ttv_kernel(const float* __restrict__ t, const float* __restrict__ w,
                                 float* __restrict__ ws, int64_t L, int64_t I, int C,
                                 int64_t l_per_split) {
  const int64_t z = BATCHED ? static_cast<int64_t>(blockIdx.z) : 0;
  t += z * L * I * C;
  w += z * L * C;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t l0 = static_cast<int64_t>(blockIdx.y) * l_per_split;
  const int64_t l1 = imin(L, l0 + l_per_split);
  if (i >= I) return;
  float acc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] = 0.0f;
  for (int64_t l = l0; l < l1; ++l) {
    const float* __restrict__ trow = t + (l * I + i) * C;
    const float* __restrict__ wrow = w + l * C;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      if (c < C) acc[c] = fmaf(trow[c], __ldg(wrow + c), acc[c]);
    }
  }
  float* __restrict__ out = ws + ((z * gridDim.y + blockIdx.y) * I + i) * C;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    if (c < C) out[c] = acc[c];
  }
}

template <bool BATCHED>
bool dispatch(int cp, dim3 grid, int threads, const float* t, const float* w, float* ws,
              int64_t L, int64_t I, int C, int64_t lps, cudaStream_t s) {
  switch (cp) {
#define MTTKRP_CASE(CP)                                                        \
  case CP:                                                                     \
    multi_ttv_kernel<CP, BATCHED><<<grid, threads, 0, s>>>(t, w, ws, L, I, C, lps); \
    return true;
    MTTKRP_CASE(4) MTTKRP_CASE(8) MTTKRP_CASE(12) MTTKRP_CASE(16)
    MTTKRP_CASE(24) MTTKRP_CASE(32) MTTKRP_CASE(48) MTTKRP_CASE(64)
#undef MTTKRP_CASE
  }
  return false;
}

int run(const float* t, const float* w, float* ws, float* out, bool batched, int slabs,
        int64_t L, int64_t I, int C, int threads, int64_t l_per_split, int splits,
        cudaStream_t s) {
  const int cp = padded_rank(C);
  if (cp == 0 || C < 1 || L < 1 || I < 1 || slabs < 1 || slabs > 65535 ||
      (!batched && slabs != 1) || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      splits < 1 || splits > 65535 || l_per_split < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(static_cast<unsigned>((I + threads - 1) / threads), static_cast<unsigned>(splits),
            static_cast<unsigned>(slabs));
  const bool ok = batched ? dispatch<true>(cp, grid, threads, t, w, ws, L, I, C, l_per_split, s)
                          : dispatch<false>(cp, grid, threads, t, w, ws, L, I, C, l_per_split, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_sum_splits(ws, out, I * C, splits, slabs, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mttkrp

// t: contiguous (L, I, c); w: (L, c); ws: (splits, I, c) scratch; out: (I, c).
// `threads` rows per block (a multiple of 32, at most 1024); split k covers
// l in [k * l_per_split, (k+1) * l_per_split).  Returns cudaGetLastError()
// after both launches (0 on success).
extern "C" int multi_ttv_f32(const float* t, const float* w, float* ws, float* out, int64_t L,
                             int64_t I, int c, int threads, int64_t l_per_split, int splits,
                             void* stream) {
  return mttkrp::run(t, w, ws, out, false, 1, L, I, c, threads, l_per_split, splits,
                     static_cast<cudaStream_t>(stream));
}

// The same for `slabs` stacked problems: t: contiguous (slabs, L, I, c);
// w: (slabs, L, c); ws: (slabs, splits, I, c); out: (slabs, I, c).
extern "C" int multi_ttv_batched_f32(const float* t, const float* w, float* ws, float* out,
                                     int slabs, int64_t L, int64_t I, int c, int threads,
                                     int64_t l_per_split, int splits, void* stream) {
  return mttkrp::run(t, w, ws, out, true, slabs, L, I, c, threads, l_per_split, splits,
                     static_cast<cudaStream_t>(stream));
}
