// Fused bilinear MTTKRP for Hopper (sm_90a), fp32 (the entries of the other
// element types, on the same body, are in mttkrp_entries.cuh):
//
//     M[i, c] = sum_{a, b} T[...] * A[a, c] * B[b, c]
//
// with T a contiguous 3-D view of the tensor whose i-axis sits at pos:
// pos 0 -> T[i, a, b], pos 1 -> T[a, i, b], pos 2 -> T[a, b, i].  A and B
// are the two partial KRPs of the other modes (kernels/ops.py:
// bilinear_operands); the full KRP never exists.
//
// Replaces the Pallas TPU kernels src/repro/kernels/fused_mttkrp.py::
// fused_mttkrp_bilinear (:182, body _kernel) and
// fused_mttkrp_bilinear_batched (:111, body _kernel_batched).  The batched
// form computes the same per slab s of a stack of S views, M[s] from T[s],
// A[s], B[s]; slabs never share a block, a partial or a sum.
//
// Bound: HBM bytes.  A call must read T once: the fMRI tensor 225 x 59 x
// 200 x 200 (the unbatched entry's main path, C = 10) is 2.12 GB, 0.634 ms
// at 3.35 TB/s, against 0.16 ms for its 2 |T| C fp32 FLOPs at 67 TFLOP/s;
// the serving batch 8 x 225 x 200 x 200 (the batched entry's) is 288 MB,
// 0.086 ms.  The factors and the output add under 1%.
//
// The bilinear form is the order-3 matrix-free fold of the view T at mode
// n = pos, with A in the one outer slot and B in the contracted slot: the
// fold contracts the highest mode other than pos first, which is always
// B's axis (2 for pos 0 and 1, 1 for pos 2), then scales the result by A's
// row of the step's outer index.  So both entries launch the port's one
// Hopper MTTKRP body, matrix_free_cluster_kernel (mttkrp_cluster.cuh; its
// design notes are at the top of matrix_free.cu): whole-q stages in a
// cp.async ring with one barrier a step, 16-byte copies, U_q (here B)
// staged in shared memory once a chunk, the split summed on chip through
// distributed shared memory, parts cut over the flat range of (B chunk, a)
// steps.  The TPU kernel forms each KRP tile A[a, :] * B[b-tile, :] on
// chip; the fold computes the same sum without any KRP tile -- it contracts
// T's b axis against B, then scales by A[a, :] once a step.  At the fleet's
// views the launches are those of the batched matrix-free entry on the same
// 3-way stack, bit for bit; at the fMRI tensor's modes 0 and 2 they are the
// unbatched matrix-free entry's.  The view's operands of the fold are
// bilinear_fold (mttkrp_cluster.cuh).
#include "mttkrp_cluster.cuh"

// t: contiguous (d0, d1, d2) view; a: (da, c); b: (db, c); out: (I, c);
// any rank c >= 1.  The grid is (ceil(I / 32) x col_blocks(c), groups *
// splits) in clusters of (1, splits, 1)
// (matrix_free.py: unbatched_launch_shape of the view at mode pos): splits
// in {1, 2, 4, 8}, groups * splits at most the steps of a row block
// (chunks of b x rows of A) and 65535.  With groups > 1 the clusters write
// (groups, I, c) partials to ws and a second kernel sums them in group
// order (ws unused, and may be null, with one group).  A stage holds
// q_chunk (a multiple of 4) rows of B; vec != 0 copies 16 bytes (d2 a
// multiple of 4 and t 16-byte aligned).  Returns cudaGetLastError() after
// the launches (0 on success); a geometry it cannot run returns
// cudaErrorInvalidValue.
extern "C" int fused_mttkrp_bilinear_f32(const float* t, const float* a, const float* b,
                                         float* ws, float* out, int pos, int64_t d0, int64_t d1,
                                         int64_t d2, int c, int groups, int splits,
                                         int64_t q_chunk, int vec, void* stream) {
  using namespace mttkrp;
  int64_t shape[3];
  const void* factors[3];
  if (!bilinear_fold(pos, a, b, d0, d1, d2, shape, factors)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run_unbatched(t, factors, shape, 3, pos, c, groups, splits, q_chunk, vec, ws, out,
                       static_cast<cudaStream_t>(stream));
}

// The same for `slabs` stacked problems, in one launch: t: contiguous
// (slabs, d0, d1, d2); a: (slabs, da, c); b: (slabs, db, c); out: (slabs,
// I, c).  The grid is (ceil(I / 32) x col_blocks(c), splits, slabs) in
// clusters of (1, splits, 1) (matrix_free.py: launch_shape of the view at
// mode pos);
// q_chunk and vec as above.
extern "C" int fused_mttkrp_bilinear_batched_f32(const float* t, const float* a,
                                                 const float* b, float* out, int pos, int slabs,
                                                 int64_t d0, int64_t d1, int64_t d2, int c,
                                                 int splits, int64_t q_chunk, int vec,
                                                 void* stream) {
  using namespace mttkrp;
  int64_t shape[3];
  const void* factors[3];
  if (!bilinear_fold(pos, a, b, d0, d1, d2, shape, factors)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run_cluster(t, factors, shape, 3, pos, c, slabs, 1, splits, q_chunk, vec, out,
                     static_cast<cudaStream_t>(stream));
}
