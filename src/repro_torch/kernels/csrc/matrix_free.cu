// Matrix-free MTTKRP for Hopper (sm_90a), fp32, any mode of an order-3..6
// tensor in its natural row-major layout:
//
//     M[i, c] = sum over every non-target index of x[...] * prod_k U_k[i_k, c]
//
// Replaces the Pallas TPU kernels src/repro/kernels/matrix_free.py::
// matrix_free_kernel and matrix_free_batched_kernel (fold: _fold_tile).  The
// batched form folds each slab z of a stack of S tensors against that slab's
// own factors: the slab is a grid axis (blockIdx.z), each block offsets x,
// every factor and its workspace by the slab's strides, and slabs never share
// a block, a partial or a sum -- a slab's result depends only on its own data
// and on S (through the split count).  Nothing is padded (the reference pads
// S to its block_batch).  As in the TPU kernels, nothing of KRP shape
// exists anywhere -- no full KRP, no partial KRP, no KRP tile: the tensor is
// folded one non-target mode at a time.  The innermost non-target mode q
// (the highest mode id other than the target) is contracted first, as a
// matrix product of the streamed tensor tile with U_q's rows; the result is
// then scaled by the product of the remaining ("outer") factor rows of the
// current outer multi-index o and added to the output row.  That is the same
// fold as _fold_tile, one (outer index, q tile) pair per step.
//
// Bound at the main path's shapes (fMRI tensor 225 x 59 x 200 x 200, C = 10):
// HBM bytes.  Each call must read the 2.12 GB tensor once, about 0.63 ms at
// 3.35 TB/s, against about 0.16 ms for its 2 |x| C fp32 FLOPs at 67 TFLOP/s.
// The design streams x once at full width:
//   * x is read exactly once, in BI x BR tiles (BI target rows x BR indices of
//     mode q), coalesced along x's contiguous axis (mode q, or the target mode
//     when it is the last one), streamed with cp.async through a ring of
//     STAGES shared-memory tiles, STAGES - 1 steps ahead.  Steps run
//     q-tile outer and outer index inner, so U_q's tile is loaded once per
//     pass and the outer index advances as an odometer.  The kernel
//     computes its own offsets from x's shape, so no view or copy is needed.
//   * The outer multi-index range is split over gridDim.y so that enough
//     blocks are in flight on 132 SMs even for a short target mode.  Each
//     split writes an (I, C) partial to a workspace and a second kernel sums
//     the splits in a fixed order: no atomics, bitwise repeatable results.
//     Batched, the split count is sized from S x row blocks.
// Accumulation is ordinary fp32 FMA (no TF32), as Precision.HIGHEST asks.
#include "mttkrp_common.cuh"

namespace mttkrp {

constexpr int MAX_ORDER = 6;

struct MFArgs {
  const float* x;
  const float* u[MAX_ORDER];  // factor of each mode, (ext[k], C); u[n] unused
  int64_t ext[MAX_ORDER];
  int64_t stride[MAX_ORDER];
  int order, n, q;
  int n_outer;
  int outer[MAX_ORDER];  // outer modes, ascending (row-major decode order)
  int C;
  int64_t o_per_split;
};

constexpr int MAX_OUTER = MAX_ORDER - 2;

// Outer multi-index o (the outer modes enumerated row-major) and its offset
// in x (from `base`, the start of the block's slab), advanced one step at a
// time without division.
struct Odometer {
  int64_t idx[MAX_OUTER];
  int64_t off;

  __device__ __forceinline__ void reset(const MFArgs& p, int64_t o, int64_t base) {
    off = base;
#pragma unroll
    for (int k = MAX_OUTER - 1; k >= 0; --k) {
      if (k < p.n_outer) {
        const int m = p.outer[k];
        idx[k] = o % p.ext[m];
        o /= p.ext[m];
        off += idx[k] * p.stride[m];
      }
    }
  }

  __device__ __forceinline__ void step(const MFArgs& p) {
#pragma unroll
    for (int k = MAX_OUTER - 1; k >= 0; --k) {
      if (k < p.n_outer) {
        const int m = p.outer[k];
        off += p.stride[m];
        if (++idx[k] < p.ext[m]) break;
        off -= p.ext[m] * p.stride[m];
        idx[k] = 0;
      }
    }
  }
};

// The body of both kernels below.  BATCHED reads the slab from blockIdx.z;
// unbatched it is compiled without any slab arithmetic (z is the constant 0).
template <bool I_CONTIG, int CP, bool BATCHED>
__device__ __forceinline__ void matrix_free_body(const MFArgs& p, float* __restrict__ ws) {
  constexpr int KPT = BR * CP / THREADS;  // factor-tile entries loaded per thread
  const int64_t rows = p.ext[p.n];
  const int64_t si = p.stride[p.n];
  const int64_t sq = p.stride[p.q];
  const int64_t eq = p.ext[p.q];
  const int C = p.C;
  // Slab z: x, every factor and the workspace are offset by their slab
  // strides (folded into the odometer's tensor offset and U_q's pointer).
  const int64_t z = BATCHED ? static_cast<int64_t>(blockIdx.z) : 0;
  const int64_t x_base = z * p.stride[0] * p.ext[0];
  const float* __restrict__ uq = p.u[p.q] + z * eq * C;

  int64_t o_total = 1;
  for (int k = 0; k < p.n_outer; ++k) o_total *= p.ext[p.outer[k]];

  __shared__ float ts[STAGES][BR][BI + 1];  // ring of tensor tiles; reused by the final reduction
  __shared__ __align__(16) float us[BR][CP];
  __shared__ float wo[CP];

  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * BI;
  const int ni = static_cast<int>(imin(BI, rows - i0));
  const int64_t o0 = static_cast<int64_t>(blockIdx.y) * p.o_per_split;
  const int64_t n_o = imin(o_total, o0 + p.o_per_split) - o0;
  const int64_t n_jt = (eq + BR - 1) / BR;
  const int64_t total = n_o > 0 ? n_o * n_jt : 0;

  float acc[CP], part[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] = 0.0f;
  float ureg[KPT];        // U_q rows of the next step (this thread's entries)
  float wraw[MAX_OUTER];  // outer factor entries U_m[o_m, threadIdx.x] of the next step

  // Steps run q-tile outer, outer index o inner: the U_q tile is loaded once
  // per pass over the split's o range.  Tensor tiles stream through a ring of
  // STAGES shared-memory buffers with cp.async, STAGES - 1 steps ahead; the
  // factor rows are loaded one step ahead.  Positions advance as counters and
  // odometers: no division in the loop.
  Odometer io;  // outer index of the next tile to issue
  int64_t io_n = 0, ij = 0;
  io.reset(p, o0, x_base);
  int issue_stage = 0;
  auto issue = [&]() {
    const int nr = static_cast<int>(imin(BR, eq - ij * BR));
    issue_tile<I_CONTIG>(ts[issue_stage], p.x + io.off + ij * BR * sq + i0 * si, si, sq, ni, nr);
    if (++io_n == n_o) {
      io_n = 0;
      ++ij;
      io.reset(p, o0, x_base);
    } else {
      io.step(p);
    }
    issue_stage = issue_stage + 1 == STAGES ? 0 : issue_stage + 1;
  };
  Odometer co;  // outer index of the step wraw/ureg hold
  int64_t co_n = 0, cj = 0;
  co.reset(p, o0, 0);
  auto load_factors = [&](bool new_j) {
    if (threadIdx.x < CP) {
#pragma unroll
      for (int k = 0; k < MAX_OUTER; ++k) {
        wraw[k] = (k < p.n_outer && static_cast<int>(threadIdx.x) < C)
                      ? __ldg(p.u[p.outer[k]] + (z * p.ext[p.outer[k]] + co.idx[k]) * C +
                              threadIdx.x)
                      : 1.0f;
      }
    }
    if (new_j) {
#pragma unroll
      for (int k = 0; k < KPT; ++k) {
        const int e = threadIdx.x + k * THREADS;
        const int64_t j = cj * BR + e / CP;
        ureg[k] = (e % CP < C && j < eq) ? __ldg(uq + j * C + e % CP) : 0.0f;
      }
    }
  };

  int64_t issued = 0;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (issued < total) { issue(); ++issued; }
    cp_async_commit();
  }
  bool new_j = true;
  if (total > 0) load_factors(true);
  int stage = 0;
  for (int64_t it = 0; it < total; ++it) {
    if (issued < total) { issue(); ++issued; }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this thread's copies of step `it` have landed
    if (new_j) {
#pragma unroll
      for (int k = 0; k < KPT; ++k) {
        const int e = threadIdx.x + k * THREADS;
        us[e / CP][e % CP] = ureg[k];
      }
    }
    if (threadIdx.x < CP) {  // product of the outer modes' rows at this o
      float w = static_cast<int>(threadIdx.x) < C ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_OUTER; ++k) w *= wraw[k];
      wo[threadIdx.x] = w;
    }
    __syncthreads();  // every thread's copies, U_q rows and weights visible
    if (it + 1 < total) {
      new_j = false;
      if (++co_n == n_o) {
        co_n = 0;
        ++cj;
        co.reset(p, o0, 0);
        new_j = true;
      } else {
        co.step(p);
      }
      load_factors(new_j);
    }
#pragma unroll
    for (int c = 0; c < CP; ++c) part[c] = 0.0f;
    mac_tile<CP>(part, ts[stage], us);  // contract mode q: part = x_tile . U_q tile
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[c] = fmaf(wo[c], part[c], acc[c]);  // fold outer rows
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    __syncthreads();  // ts[stage], us and wo free for reuse
  }
  cp_async_wait<0>();
  const int64_t split = z * gridDim.y + blockIdx.y;
  reduce_and_store<CP>(acc, &ts[0][0][0], ws + split * rows * C, i0, rows, C);
}

// The unbatched kernel keeps the launch bounds (and so the register
// allocation) it had before the batched entry existed: at rank <= 12 ptxas
// fits it in 128 registers, two blocks per SM.  The batched kernel's slab
// arithmetic would push it past 128 under the same bounds (one block per SM,
// about 1.4x slower), so at rank <= 12 it asks for two blocks per SM.
template <bool I_CONTIG, int CP>
__global__ void __launch_bounds__(THREADS) matrix_free_kernel(MFArgs p, float* __restrict__ ws) {
  matrix_free_body<I_CONTIG, CP, false>(p, ws);
}

template <bool I_CONTIG, int CP>
__global__ void __launch_bounds__(THREADS, CP <= 12 ? 2 : 1)
    matrix_free_batched_kernel(MFArgs p, float* __restrict__ ws) {
  matrix_free_body<I_CONTIG, CP, true>(p, ws);
}

template <int CP, bool BATCHED>
void launch(const MFArgs& p, int slabs, int splits, float* ws, cudaStream_t s) {
  const int64_t rows = p.ext[p.n];
  dim3 grid(static_cast<unsigned>((rows + BI - 1) / BI), static_cast<unsigned>(splits),
            static_cast<unsigned>(slabs));
  const bool i_contig = p.n == p.order - 1;
  if (BATCHED) {
    if (i_contig) {
      matrix_free_batched_kernel<true, CP><<<grid, THREADS, 0, s>>>(p, ws);
    } else {
      matrix_free_batched_kernel<false, CP><<<grid, THREADS, 0, s>>>(p, ws);
    }
  } else if (i_contig) {
    matrix_free_kernel<true, CP><<<grid, THREADS, 0, s>>>(p, ws);
  } else {
    matrix_free_kernel<false, CP><<<grid, THREADS, 0, s>>>(p, ws);
  }
}

// Both launches for `slabs` stacked problems; cudaGetLastError() after them.
int run(const float* x, const void* const* factors, const int64_t* shape, int order, int n,
        int c, bool batched, int slabs, int64_t o_per_split, int splits, float* ws, float* out,
        cudaStream_t s) {
  const int cp = padded_rank(c);
  if (cp == 0 || c < 1 || order < 3 || order > MAX_ORDER || n < 0 || n >= order ||
      slabs < 1 || slabs > 65535 || (!batched && slabs != 1) || splits < 1 || splits > 65535 ||
      o_per_split < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MFArgs p{};
  p.x = x;
  p.order = order;
  p.n = n;
  p.C = c;
  p.o_per_split = o_per_split;
  int64_t stride = 1;
  for (int k = order - 1; k >= 0; --k) {
    p.ext[k] = shape[k];
    p.stride[k] = stride;
    stride *= shape[k];
    p.u[k] = static_cast<const float*>(factors[k]);
  }
  p.q = (n == order - 1) ? order - 2 : order - 1;
  p.n_outer = 0;
  for (int k = 0; k < order; ++k) {
    if (k != n && k != p.q) p.outer[p.n_outer++] = k;
  }
  switch (cp) {
#define MTTKRP_CASE(CP) \
  case CP:                                                  \
    if (batched) {                                          \
      launch<CP, true>(p, slabs, splits, ws, s);            \
    } else {                                                \
      launch<CP, false>(p, slabs, splits, ws, s);           \
    }                                                       \
    break;
    MTTKRP_CASE(4) MTTKRP_CASE(8) MTTKRP_CASE(12) MTTKRP_CASE(16)
    MTTKRP_CASE(24) MTTKRP_CASE(32) MTTKRP_CASE(48) MTTKRP_CASE(64)
#undef MTTKRP_CASE
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_sum_splits(ws, out, shape[n] * c, splits, slabs, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mttkrp

// x: contiguous, shape[0..order); factors: host array of `order` device
// pointers to the (shape[k], c) factors (entry n unused); ws: (splits, I, c)
// scratch; out: (I, c).  Split s covers outer indices
// [s * o_per_split, (s+1) * o_per_split).  Returns cudaGetLastError() after
// both launches (0 on success).
extern "C" int matrix_free_mttkrp_f32(const float* x, const void* const* factors,
                                      const int64_t* shape, int order, int n, int c,
                                      int64_t o_per_split, int splits, float* ws, float* out,
                                      void* stream) {
  return mttkrp::run(x, factors, shape, order, n, c, false, 1, o_per_split, splits, ws, out,
                     static_cast<cudaStream_t>(stream));
}

// The same for `slabs` stacked problems: x: contiguous (slabs, shape[0..order));
// factors: device pointers to the (slabs, shape[k], c) factors; ws:
// (slabs, splits, I, c) scratch; out: (slabs, I, c).  `shape` is one slab's.
extern "C" int matrix_free_mttkrp_batched_f32(const float* x, const void* const* factors,
                                              const int64_t* shape, int order, int n, int c,
                                              int slabs, int64_t o_per_split, int splits,
                                              float* ws, float* out, void* stream) {
  return mttkrp::run(x, factors, shape, order, n, c, true, slabs, o_per_split, splits, ws,
                     out, static_cast<cudaStream_t>(stream));
}
