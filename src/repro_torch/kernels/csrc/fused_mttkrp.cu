// Fused bilinear MTTKRP for Hopper (sm_90a), fp32:
//
//     M[i, c] = sum_{a, b} T[...] * A[a, c] * B[b, c]
//
// with T a contiguous 3-D view of the tensor whose i-axis sits at POS:
// POS 0 -> T[i, a, b], POS 1 -> T[a, i, b], POS 2 -> T[a, b, i].
//
// Replaces the Pallas TPU kernels src/repro/kernels/fused_mttkrp.py::
// fused_mttkrp_bilinear (body _kernel) and fused_mttkrp_bilinear_batched
// (body _kernel_batched).  The batched form computes the same per slab s of
// a stack of S tensors, M[s, i, c] with T[s], A[s], B[s]: the slab is a grid
// axis (blockIdx.z), each block offsets T, A, B and its workspace by the
// slab's strides, and slabs never share a block, a partial or a sum -- a
// slab's result depends only on its own data and on S (through the split
// count).  The reference pads S to its block_batch; here nothing is padded.
// As in the TPU kernels, the KRP tile
// A[a, :] * B[b-tile, :] is formed on chip (here: in shared memory, ks below)
// and consumed at once; the L*R x C KRP never exists in global memory.
//
// Bound at the main path's shapes (fMRI tensor 225 x 59 x 200 x 200, C = 10):
// HBM bytes.  Each call must read the 2.12 GB tensor once, about 0.63 ms at
// 3.35 TB/s, against about 0.16 ms for its 2 |T| C fp32 FLOPs at 67 TFLOP/s.
// The design therefore aims at streaming T once at full width:
//   * T is read exactly once, in BI x BR tiles, coalesced along its contiguous
//     axis (b for POS 0/1, i for POS 2 -- the TPU kernel's in-VMEM transpose
//     becomes a load with swapped strides), streamed with cp.async through a
//     ring of STAGES shared-memory tiles, STAGES - 1 steps ahead.
//   * The loop runs b-tile outer, a inner; the A and B rows of the next step
//     are loaded before the current step's arithmetic, so no dependent load
//     sits on the critical path.
//   * The a-reduction is split over gridDim.y so that enough blocks are in
//     flight on 132 SMs even when the target mode is short (59 rows: 2 blocks
//     along i).  Each split writes an (I, C) partial to a workspace and a
//     second kernel sums the splits in a fixed order: no atomics, bitwise
//     repeatable results.
//   * Ragged edges are masked in the kernel, so the tensor is never padded or
//     copied.
// Batched, the bound is the same per byte: a serving batch of 8 fMRI subjects
// (8 x 225 x 200 x 200, 288 MB) must be read once per call, about 0.086 ms.
// The split count is sized from S x row blocks, so a batch gets fewer splits
// than a single tensor of the same size.
// Accumulation is ordinary fp32 FMA (no TF32), as Precision.HIGHEST asks.
#include "mttkrp_common.cuh"

namespace mttkrp {

// BATCHED instances read the slab from blockIdx.z; the unbatched ones are
// compiled without any slab arithmetic (z is the constant 0), so adding the
// batched entry leaves the unbatched kernel's code as it was.
template <int POS, int CP, bool BATCHED>
__global__ void __launch_bounds__(THREADS)
    fused_bilinear_kernel(const float* __restrict__ t, const float* __restrict__ A,
                          const float* __restrict__ B, float* __restrict__ ws,
                          int64_t d0, int64_t d1, int64_t d2, int C,
                          int64_t a_per_split) {
  constexpr bool I_CONTIG = (POS == 2);
  constexpr int KPT = BR * CP / THREADS;  // KRP-tile entries built per thread
  int64_t rows, da, db, si, sa, sb;
  if (POS == 0) {
    rows = d0; da = d1; db = d2; si = d1 * d2; sa = d2; sb = 1;
  } else if (POS == 1) {
    da = d0; rows = d1; db = d2; si = d2; sa = d1 * d2; sb = 1;
  } else {
    da = d0; db = d1; rows = d2; si = 1; sa = d1 * d2; sb = d2;
  }

  __shared__ float ts[STAGES][BR][BI + 1];  // ring of tensor tiles; reused by the final reduction
  __shared__ __align__(16) float ks[BR][CP];

  const int64_t z = BATCHED ? static_cast<int64_t>(blockIdx.z) : 0;  // slab: operands offset
  t += z * d0 * d1 * d2;
  A += z * da * C;
  B += z * db * C;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * BI;
  const int ni = static_cast<int>(imin(BI, rows - i0));
  const int64_t a0 = static_cast<int64_t>(blockIdx.y) * a_per_split;
  const int64_t n_a = imin(da, a0 + a_per_split) - a0;
  const int64_t n_bt = (db + BR - 1) / BR;
  const int64_t total = n_a > 0 ? n_a * n_bt : 0;

  float acc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] = 0.0f;
  float areg[KPT];  // A[a, c] for this thread's KRP-tile entries of the next step
  float breg[KPT];  // this thread's entries of the current B tile

  // Steps run b-tile outer, a inner (B rows stay in registers for a pass over
  // the split's a range).  Tensor tiles stream through a ring of STAGES
  // shared-memory buffers with cp.async, STAGES - 1 steps ahead; A and B rows
  // are loaded one step ahead.  No division in the loop: positions advance as
  // counters.
  int64_t ia = 0, ib = 0;  // (a, b-tile) of the next tile to issue
  int issue_stage = 0;
  auto issue = [&]() {
    const int nr = static_cast<int>(imin(BR, db - ib * BR));
    issue_tile<I_CONTIG>(ts[issue_stage], t + (a0 + ia) * sa + ib * BR * sb + i0 * si, si, sb,
                         ni, nr);
    if (++ia == n_a) { ia = 0; ++ib; }
    issue_stage = issue_stage + 1 == STAGES ? 0 : issue_stage + 1;
  };
  int64_t pa = 0, pb = 0;  // (a, b-tile) of the step areg/breg hold
  auto load_ab = [&](bool new_b) {
#pragma unroll
    for (int k = 0; k < KPT; ++k) {  // entry e = threadIdx.x + k * THREADS
      const int c = (threadIdx.x + k * THREADS) % CP;
      areg[k] = c < C ? __ldg(A + (a0 + pa) * C + c) : 0.0f;
      if (new_b) {
        const int64_t b = pb * BR + (threadIdx.x + k * THREADS) / CP;
        breg[k] = (c < C && b < db) ? __ldg(B + b * C + c) : 0.0f;
      }
    }
  };

  int64_t issued = 0;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (issued < total) { issue(); ++issued; }
    cp_async_commit();
  }
  if (total > 0) load_ab(true);
  int stage = 0;
  for (int64_t it = 0; it < total; ++it) {
    if (issued < total) { issue(); ++issued; }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this thread's copies of step `it` have landed
    // the KRP tile, formed on chip: ks[r][c] = A[a, c] * B[b0 + r, c]
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int e = threadIdx.x + k * THREADS;
      ks[e / CP][e % CP] = areg[k] * breg[k];
    }
    __syncthreads();  // every thread's copies and KRP entries visible
    if (it + 1 < total) {
      bool new_b = false;
      if (++pa == n_a) { pa = 0; ++pb; new_b = true; }
      load_ab(new_b);
    }
    mac_tile<CP>(acc, ts[stage], ks);
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    __syncthreads();  // ts[stage] and ks free for reuse
  }
  cp_async_wait<0>();
  const int64_t split = z * gridDim.y + blockIdx.y;  // this slab's split
  reduce_and_store<CP>(acc, &ts[0][0][0], ws + split * rows * C, i0, rows, C);
}

template <int POS, int CP, bool BATCHED>
void launch(const float* t, const float* a, const float* b, float* ws, int slabs, int64_t d0,
            int64_t d1, int64_t d2, int c, int64_t a_per_split, int splits,
            cudaStream_t stream) {
  const int64_t rows = POS == 0 ? d0 : (POS == 1 ? d1 : d2);
  dim3 grid(static_cast<unsigned>((rows + BI - 1) / BI), static_cast<unsigned>(splits),
            static_cast<unsigned>(slabs));
  fused_bilinear_kernel<POS, CP, BATCHED>
      <<<grid, THREADS, 0, stream>>>(t, a, b, ws, d0, d1, d2, c, a_per_split);
}

template <int POS, bool BATCHED>
bool dispatch_rank(int cp, const float* t, const float* a, const float* b, float* ws,
                   int slabs, int64_t d0, int64_t d1, int64_t d2, int c, int64_t aps,
                   int splits, cudaStream_t s) {
  switch (cp) {
#define MTTKRP_CASE(CP)                                                          \
  case CP:                                                                       \
    launch<POS, CP, BATCHED>(t, a, b, ws, slabs, d0, d1, d2, c, aps, splits, s); \
    return true;
    MTTKRP_CASE(4) MTTKRP_CASE(8) MTTKRP_CASE(12) MTTKRP_CASE(16)
    MTTKRP_CASE(24) MTTKRP_CASE(32) MTTKRP_CASE(48) MTTKRP_CASE(64)
#undef MTTKRP_CASE
  }
  return false;
}

// Both launches for `slabs` stacked problems; cudaGetLastError() after them.
template <bool BATCHED>
bool dispatch_pos(int pos, int cp, const float* t, const float* a, const float* b, float* ws,
                  int slabs, int64_t d0, int64_t d1, int64_t d2, int c, int64_t aps,
                  int splits, cudaStream_t s) {
  switch (pos) {
    case 0: return dispatch_rank<0, BATCHED>(cp, t, a, b, ws, slabs, d0, d1, d2, c, aps, splits, s);
    case 1: return dispatch_rank<1, BATCHED>(cp, t, a, b, ws, slabs, d0, d1, d2, c, aps, splits, s);
    case 2: return dispatch_rank<2, BATCHED>(cp, t, a, b, ws, slabs, d0, d1, d2, c, aps, splits, s);
  }
  return false;
}

int run(const float* t, const float* a, const float* b, float* ws, float* out, int pos,
        bool batched, int slabs, int64_t d0, int64_t d1, int64_t d2, int c,
        int64_t a_per_split, int splits, cudaStream_t s) {
  const int cp = padded_rank(c);
  if (cp == 0 || c < 1 || slabs < 1 || slabs > 65535 || (!batched && slabs != 1) ||
      splits < 1 || splits > 65535 || a_per_split < 1 || pos < 0 || pos > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool ok = batched ? dispatch_pos<true>(pos, cp, t, a, b, ws, slabs, d0, d1, d2, c,
                                               a_per_split, splits, s)
                          : dispatch_pos<false>(pos, cp, t, a, b, ws, slabs, d0, d1, d2, c,
                                                a_per_split, splits, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = pos == 0 ? d0 : (pos == 1 ? d1 : d2);
  launch_sum_splits(ws, out, rows * c, splits, slabs, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mttkrp

// t: contiguous (d0, d1, d2) view; a: (da, c); b: (db, c); ws: (splits, I, c)
// scratch; out: (I, c).  Split s covers a in [s * a_per_split, (s+1) * a_per_split).
// Returns cudaGetLastError() after both launches (0 on success).
extern "C" int fused_mttkrp_bilinear_f32(const float* t, const float* a, const float* b,
                                         float* ws, float* out, int pos, int64_t d0,
                                         int64_t d1, int64_t d2, int c,
                                         int64_t a_per_split, int splits, void* stream) {
  return mttkrp::run(t, a, b, ws, out, pos, false, 1, d0, d1, d2, c, a_per_split, splits,
                     static_cast<cudaStream_t>(stream));
}

// The same for `slabs` stacked problems: t: contiguous (slabs, d0, d1, d2);
// a: (slabs, da, c); b: (slabs, db, c); ws: (slabs, splits, I, c) scratch;
// out: (slabs, I, c).  Every slab uses the same split of its a range.
extern "C" int fused_mttkrp_bilinear_batched_f32(const float* t, const float* a,
                                                 const float* b, float* ws, float* out,
                                                 int pos, int slabs, int64_t d0, int64_t d1,
                                                 int64_t d2, int c, int64_t a_per_split,
                                                 int splits, void* stream) {
  return mttkrp::run(t, a, b, ws, out, pos, true, slabs, d0, d1, d2, c, a_per_split, splits,
                     static_cast<cudaStream_t>(stream));
}
