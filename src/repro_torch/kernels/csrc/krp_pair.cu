// Khatri-Rao product of two matrices for Hopper (sm_90a), in float, bf16, fp16
// or double (paper Alg. 1, parallel variant):
//
//     K[ja * JB + jb, c] = A[ja, c] * B[jb, c]        (A's index slow)
//
// Replaces the Pallas TPU kernel src/repro/kernels/krp_kernel.py::krp_pair
// (body _kernel), which holds A's row in VMEM while a (block_b, C) tile of B
// sweeps under it.
//
// Bound: HBM bytes, nearly all of them the output.  K is JA * JB * C elements
// written once against (JA + JB) * C read, with one multiply per written
// element, so the kernel must spend only a few instructions an element.  The
// design:
//
// - Flat positions.  Row ja of K is B (JB * C contiguous elements, the row
//   span S) scaled column-wise by A[ja, :]; the rows of g consecutive ja are
//   one contiguous span of g * S elements.  Position q < g * S of such a span
//   is row r = q / S of the step, B element p = q % S and column p % C.
// - A block owns a fixed tile of THREADS * per_thread * VEC positions of the
//   span and walks down A's row groups (a grid-stride loop over groups, the
//   tile fixed).  Each thread works out its positions' row, B element and
//   column once, before the walk (32-bit arithmetic unless the span passes
//   2^31 elements), loads its B elements once (16-byte loads) into registers
//   widened to the product's type, and keeps each element's offset into A's
//   row group.  A step then reads the group's A values through the read-only
//   cache (g * C elements, the same few lines for the whole block),
//   multiplies and stores: no division and no 64-bit index arithmetic an
//   element.  B's tile is read from memory once per block, not once per ja
//   row: Alg. 1's reuse, the cached operand held while the other index moves.
// - Stores of 16 bytes (4 floats, 8 halves or bf16, 2 doubles) with the
//   streaming hint (st.global.cs): the output, 94 MB at the fMRI KRP's last
//   fold at rank 10, exceeds the 50 MB L2 and is written once.  A span whose
//   row is not a whole number of 16-byte units, or a B or K pointer off a
//   16-byte line, takes the same kernel at VEC = 1 (one element a store,
//   coalesced across the warp).  A is read an element at a time on either
//   path, so its alignment does not matter.
// - g, the tile and the grid come from the shape alone
//   (repro_torch.kernels.krp_kernel.launch_shape): g = the most rows whose
//   span fits one full tile (2048 elements: KRP_HELD a thread), at least
//   1; a span longer than a tile is cut into tiles of near-equal thread
//   loads.  The grid is one-dimensional, tiles x walkers <= 132 SMs x 4
//   resident blocks, so any JA, JB and C launch once (no 65535-tile limit).
//   Masked: positions past the span in the last tile, rows past JA in the
//   last group.
//
// Each product is taken in fp32 (fp64 for double) and rounded once to the
// operands' type, the type of K: for 16-bit values that is bitwise a * b in
// that type, as the reference forms it (the product of two 16-bit values is
// exact in fp32).  Every element is independent, so the result never depends
// on the geometry.
#include <cstring>

#include "mttkrp_common.cuh"

namespace mttkrp {

constexpr int KRP_THREADS = 256;
constexpr int KRP_BLOCKS_PER_SM = 4;  // residency the register budget is held to (<= 64)
// Elements of B a thread holds in registers (widened to the product's type),
// with as many A offsets and, a step, as many A values in flight: 8 keeps
// them within the 64 registers of four resident blocks, with no spills.
constexpr int KRP_HELD = 8;

// The unsigned type of BYTES bytes that one load or store moves.
template <int BYTES>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<8> {
  using type = unsigned long long;
};
template <>
struct Raw<16> {
  using type = uint4;
};

__device__ __forceinline__ int krp_clamp(int64_t x) {
  return static_cast<int>(x < 0 ? 0 : (x > 0x7fffffff ? 0x7fffffff : x));
}

// Row r, B element p and column c0 of span position q (q < span).
template <typename I>
__device__ __forceinline__ void krp_locate(I q, I row_len, I c, int64_t& r, int64_t& p, int& c0) {
  const I rr = q / row_len;
  const I pp = q - rr * row_len;
  r = static_cast<int64_t>(rr);
  p = static_cast<int64_t>(pp);
  c0 = static_cast<int>(pp % c);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(KRP_THREADS, KRP_BLOCKS_PER_SM)
    krp_pair_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                    int64_t ja, int64_t row_len, int c, int per_thread, int rows, int tiles,
                    int walkers) {
  constexpr int K = KRP_HELD / VEC;  // vectors a thread may hold
  constexpr int STRIDE = KRP_THREADS * VEC;
  using W = typename Elem<T>::Wide;
  using R = typename Raw<sizeof(T) * VEC>::type;
  const int64_t span = rows * row_len;
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const int walker = static_cast<int>(blockIdx.x / tiles);
  const int64_t first = static_cast<int64_t>(tile) * KRP_THREADS * per_thread * VEC +
                        static_cast<int64_t>(threadIdx.x) * VEC;  // this thread's first position

  W bw[K][VEC];
  int aoff[K][VEC];  // offset of each element's A value from its row group's first
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t q = first + k * STRIDE;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      bw[k][v] = W(0);
      aoff[k][v] = 0;
    }
    if (k < per_thread && q < span) {
      int64_t r, p;
      int cc;
      if (span <= 0x7fffffff) {
        krp_locate<unsigned>(static_cast<unsigned>(q), static_cast<unsigned>(row_len),
                             static_cast<unsigned>(c), r, p, cc);
      } else {
        krp_locate<int64_t>(q, row_len, c, r, p, cc);
      }
      const R raw = __ldg(reinterpret_cast<const R*>(b + p));
      T e[VEC];
      memcpy(e, &raw, sizeof(raw));
      const int base = static_cast<int>(r) * c;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        bw[k][v] = widen(e[v]);
        aoff[k][v] = base + cc;
        if (++cc == c) cc = 0;
      }
    }
  }

  // The walk: groups walker, walker + walkers, ...; A's and K's pointers
  // advance by a fixed stride.  Positions left to this thread in a group
  // from its first on: the span's, or fewer in the last group if it is short.
  const int64_t groups = (ja + rows - 1) / rows;
  const int64_t full = ja / rows;  // groups with all their rows
  const int whole = krp_clamp(span - first);
  const T* __restrict__ as = a + walker * static_cast<int64_t>(rows) * c;
  T* __restrict__ os = out + walker * span + first;
  const int64_t a_step = walkers * static_cast<int64_t>(rows) * c;
  const int64_t o_step = walkers * span;
  for (int64_t grp = walker; grp < groups; grp += walkers, as += a_step, os += o_step) {
    const int left = grp < full ? whole : krp_clamp((ja - grp * rows) * row_len - first);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < per_thread && k * STRIDE < left) {
        T e[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          e[v] = Elem<T>::store(widen(__ldg(as + aoff[k][v])) * bw[k][v]);
        }
        R raw;
        memcpy(&raw, e, sizeof(raw));
        __stcs(reinterpret_cast<R*>(os + k * STRIDE), raw);
      }
    }
  }
}

template <typename T>
int run_krp(const T* a, const T* b, T* out, int64_t ja, int64_t jb, int c, int vec,
            int per_thread, int rows, int tiles, int blocks, cudaStream_t s) {
  constexpr int unit = Elem<T>::kUnit;
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (ja < 1 || jb < 1 || c < 1 || rows < 1 || tiles < 1 || blocks < tiles || blocks % tiles) {
    return invalid;
  }
  if ((vec != 1 && vec != unit) || per_thread < 1 || per_thread > KRP_HELD / vec) {
    return invalid;
  }
  if (jb > INT64_MAX / c) return invalid;
  const int64_t row_len = jb * c;
  // A's offsets within a row group are 32-bit; the span must not overflow.
  if (static_cast<int64_t>(rows) * c > 0x7fffffff || rows > INT64_MAX / row_len) return invalid;
  // The tiles must cover the span, or outputs would go unwritten.
  if (static_cast<int64_t>(tiles) * KRP_THREADS * per_thread * vec < rows * row_len) {
    return invalid;
  }
  if (vec > 1) {
    const auto misaligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16; };
    if (row_len % vec || misaligned(b) || misaligned(out)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  const int walkers = blocks / tiles;
  if (vec == 1) {
    krp_pair_kernel<T, 1><<<blocks, KRP_THREADS, 0, s>>>(a, b, out, ja, row_len, c, per_thread,
                                                         rows, tiles, walkers);
  } else {
    krp_pair_kernel<T, unit><<<blocks, KRP_THREADS, 0, s>>>(a, b, out, ja, row_len, c,
                                                            per_thread, rows, tiles, walkers);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mttkrp

// a: contiguous (ja, c); b: contiguous (jb, c); out: (ja * jb, c), all of one
// type.  vec (1 or the type's 16-byte unit), per_thread, rows (g), tiles and
// blocks: krp_kernel.launch_shape.  Returns cudaGetLastError() after the
// launch, or an error code, launching nothing, for a geometry that does not
// cover the output or a 16-byte path off a 16-byte line.
#define KRP_PAIR_ENTRY(T, SUFFIX)                                                              \
  extern "C" int krp_pair_##SUFFIX(const T* a, const T* b, T* out, int64_t ja, int64_t jb,     \
                                   int c, int vec, int per_thread, int rows, int tiles,        \
                                   int blocks, void* stream) {                                 \
    return mttkrp::run_krp(a, b, out, ja, jb, c, vec, per_thread, rows, tiles, blocks,         \
                           static_cast<cudaStream_t>(stream));                                 \
  }

KRP_PAIR_ENTRY(float, f32)
KRP_PAIR_ENTRY(__nv_bfloat16, bf16)
KRP_PAIR_ENTRY(__half, f16)
KRP_PAIR_ENTRY(double, f64)
