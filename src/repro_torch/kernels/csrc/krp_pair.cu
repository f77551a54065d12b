// Khatri-Rao product of two matrices for Hopper (sm_90a), fp32 (paper Alg. 1,
// parallel variant):
//
//     K[ja * JB + jb, c] = A[ja, c] * B[jb, c]        (A's index slow)
//
// Replaces the Pallas TPU kernel src/repro/kernels/krp_kernel.py::krp_pair
// (body _kernel).  As there, the grid is (JA, JB tiles): block (ja, tile)
// owns the block_b output rows ja * JB + [jb0, jb0 + block_b), which are
// contiguous, and writes A[ja, :] * B[jb0 + r, :] for each of them -- one
// Hadamard multiply per output element, the flop count of Alg. 1's reuse
// scheme.  A[ja, :] is the same C floats for the whole block (a broadcast
// through the read-only cache); B's tile rows are contiguous too, so the
// block reads B[jb0 * C + e] and writes K[(ja * JB + jb0) * C + e] for
// e < nb * C with neighbouring threads on neighbouring addresses.
// Bound: HBM bytes, and nearly all of them are the output: K is JA * JB * C
// floats written once against (JA + JB) * C read, with one multiply per
// written float.  Ragged JB is masked (nb < block_b on the last tile), not
// padded, so the wrapper never slices a padded product.
#include "mttkrp_common.cuh"

namespace mttkrp {

constexpr int KRP_THREADS = 256;

__global__ void __launch_bounds__(KRP_THREADS)
    krp_pair_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int64_t jb, int C, int block_b) {
  const int64_t ja = blockIdx.x;
  const int64_t jb0 = static_cast<int64_t>(blockIdx.y) * block_b;
  const int64_t n = imin(block_b, jb - jb0) * C;  // elements of this tile
  const float* __restrict__ arow = a + ja * C;
  const float* __restrict__ bt = b + jb0 * C;
  float* __restrict__ ot = out + (ja * jb + jb0) * C;
  for (int64_t e = threadIdx.x; e < n; e += KRP_THREADS) {
    ot[e] = __ldg(arow + e % C) * __ldg(bt + e);
  }
}

}  // namespace mttkrp

// a: contiguous (ja, c); b: contiguous (jb, c); out: (ja * jb, c).  Grid
// (ja, ceil(jb / block_b)).  Returns cudaGetLastError() after the launch.
extern "C" int krp_pair_f32(const float* a, const float* b, float* out, int64_t ja, int64_t jb,
                            int c, int block_b, void* stream) {
  if (ja < 1 || ja > 2147483647 || jb < 1 || c < 1 || block_b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (jb + block_b - 1) / block_b;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(ja), static_cast<unsigned>(tiles));
  mttkrp::krp_pair_kernel<<<grid, mttkrp::KRP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, jb, c, block_b);
  return static_cast<int>(cudaGetLastError());
}
