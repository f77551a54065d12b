// Khatri-Rao product of two matrices for Hopper (sm_90a), in float, bf16, fp16
// or double (paper Alg. 1, parallel variant):
//
//     K[ja * JB + jb, c] = A[ja, c] * B[jb, c]        (A's index slow)
//
// Replaces the Pallas TPU kernel src/repro/kernels/krp_kernel.py::krp_pair
// (body _kernel).  As there, the grid is (JA, JB tiles): block (ja, tile)
// owns the block_b output rows ja * JB + [jb0, jb0 + block_b), which are
// contiguous, and writes A[ja, :] * B[jb0 + r, :] for each of them -- one
// Hadamard multiply per output element, the flop count of Alg. 1's reuse
// scheme.  A[ja, :] is the same C elements for the whole block (a broadcast
// through the read-only cache); B's tile rows are contiguous too, so the
// block reads B[jb0 * C + e] and writes K[(ja * JB + jb0) * C + e] for
// e < nb * C with neighbouring threads on neighbouring addresses.
// Bound: HBM bytes, and nearly all of them are the output: K is JA * JB * C
// elements written once against (JA + JB) * C read, with one multiply per
// written element.  Ragged JB is masked (nb < block_b on the last tile), not
// padded, so the wrapper never slices a padded product.  In a 16-bit type or
// double the product is taken in fp32 (fp64 for double) and rounded once to
// the operands' type, the type of K: for 16-bit values that is bitwise
// a * b in that type, as the reference forms it (the product of two 16-bit
// values is exact in fp32).
#include "mttkrp_common.cuh"

namespace mttkrp {

constexpr int KRP_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(KRP_THREADS)
    krp_pair_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                    int64_t jb, int C, int block_b) {
  const int64_t ja = blockIdx.x;
  const int64_t jb0 = static_cast<int64_t>(blockIdx.y) * block_b;
  const int64_t n = imin(block_b, jb - jb0) * C;  // elements of this tile
  const T* __restrict__ arow = a + ja * C;
  const T* __restrict__ bt = b + jb0 * C;
  T* __restrict__ ot = out + (ja * jb + jb0) * C;
  for (int64_t e = threadIdx.x; e < n; e += KRP_THREADS) {
    ot[e] = Elem<T>::store(widen(__ldg(arow + e % C)) * widen(__ldg(bt + e)));
  }
}

template <typename T>
int run_krp(const T* a, const T* b, T* out, int64_t ja, int64_t jb, int c, int block_b,
            cudaStream_t s) {
  if (ja < 1 || ja > 2147483647 || jb < 1 || c < 1 || block_b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (jb + block_b - 1) / block_b;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(ja), static_cast<unsigned>(tiles));
  krp_pair_kernel<<<grid, KRP_THREADS, 0, s>>>(a, b, out, jb, c, block_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mttkrp

// a: contiguous (ja, c); b: contiguous (jb, c); out: (ja * jb, c), all of one
// type.  Grid (ja, ceil(jb / block_b)).  Returns cudaGetLastError() after the
// launch.
#define KRP_PAIR_ENTRY(T, SUFFIX)                                                            \
  extern "C" int krp_pair_##SUFFIX(const T* a, const T* b, T* out, int64_t ja, int64_t jb,   \
                                   int c, int block_b, void* stream) {                       \
    return mttkrp::run_krp(a, b, out, ja, jb, c, block_b, static_cast<cudaStream_t>(stream)); \
  }

KRP_PAIR_ENTRY(float, f32)
KRP_PAIR_ENTRY(__nv_bfloat16, bf16)
KRP_PAIR_ENTRY(__half, f16)
KRP_PAIR_ENTRY(double, f64)
