// Matrix-free MTTKRP for Hopper (sm_90a), fp32, any mode of an order-3..6
// tensor in its natural row-major layout (the entries of the other element
// types, on the same body, are in mttkrp_entries.cuh):
//
//     M[i, c] = sum over every non-target index of x[...] * prod_k U_k[i_k, c]
//
// Replaces the Pallas TPU kernels src/repro/kernels/matrix_free.py::
// matrix_free_kernel and matrix_free_batched_kernel (fold: _fold_tile).  The
// batched form folds each slab z of a stack of S tensors against that slab's
// own factors: the slab is a grid axis (blockIdx.z), each block offsets x and
// every factor by the slab's strides, and slabs never share a block, a
// partial or a sum -- a slab's result depends only on its own data and on S
// (through the split count).  Nothing is padded (the reference pads S to its
// block_batch).  As in the TPU kernels, nothing of KRP shape exists anywhere
// -- no full KRP, no partial KRP, no KRP tile: the tensor is folded one
// non-target mode at a time.  The innermost non-target mode q (the highest
// mode id other than the target) is contracted first, as a matrix product of
// the streamed tensor tile with U_q's rows; the result is then scaled by the
// product of the remaining ("outer") factor rows of the current outer
// multi-index o and added to the output row.  That is the same fold as
// _fold_tile, one (outer index, q chunk) pair per step.
//
// Bound: HBM bytes.  Each call must read x once: the fMRI tensor 225 x 59 x
// 200 x 200 (the unbatched entry's main path, C = 10) is 2.12 GB, 0.634 ms at
// 3.35 TB/s, against 0.16 ms for its 2 |x| C fp32 FLOPs at 67 TFLOP/s; the
// serving batch 8 x 225 x 200 x 200 (the batched entry's) is 288 MB, 86 us,
// against 25 us of FLOPs.  Both entries launch one kernel body,
// matrix_free_cluster_kernel (mttkrp_cluster.cuh, shared with the two fused
// bilinear entries of fused_mttkrp.cu), which streams x once at full width:
//   * Grid (row blocks x column blocks, groups x splits, S), cluster (1,
//     splits, 1); one column block up to rank 64, ceil(C / 64) above it
//     (mttkrp_cluster.cuh).  A CTA owns BI rows of the target mode and the
//     columns of its block, of one slab, and one of groups x splits
//     balanced parts of the nq x O steps (q chunk outer, outer index inner),
//     part p = blockIdx.y covering steps [S p / P, S (p + 1) / P); with one
//     chunk (nq = 1) that is [O p / P, O (p + 1) / P) of the outer range.
//     The wrapper (matrix_free.py: launch_shape,
//     unbatched_launch_shape) picks splits in {1, 2, 4, 8} and groups from
//     the shape alone, to fill the card's CTA slots in the fewest whole
//     waves.  The batched entry runs one group (its slabs fill the card);
//     the unbatched one runs as many groups as one wave holds (2-8 row
//     blocks of one tensor fill far fewer slots than 264).
//   * Whole q extents.  A stage holds BI rows x q_chunk indices of q, the
//     whole extent where it fits (200 at the fMRI shapes, 25.6 KB), else
//     the largest equal chunk that fits; U_q's chunk is loaded into shared
//     memory at a part's first step and at each chunk start (once per CTA
//     when q fits; a part's steps touch few chunks when it does not).  A
//     ring of STAGES such tiles streams with cp.async, STAGES - 1 steps
//     ahead, one barrier a step; each stage also carries its step's outer
//     factor rows (cp.async, 4 bytes), so a thread forms the step's weights
//     from shared memory.
//   * 16-byte copies (cp.async.cg, zero-fill) where the contiguous axis'
//     extent is a multiple of 4 and x is 16-byte aligned (`vec`; the C
//     entries refuse vec on a misaligned x), else 4-byte ones.  Rows past the
//     tensor are not copied (their lanes' sums are never stored); indices of
//     q past the tensor are zero-filled, and U_q's rows there are zeros.
//   * Layouts without bank conflicts.  With the target mode not last
//     (!I_CONTIG, q contiguous), a tile is [row][j] with a row stride of
//     4 mod 32 floats: lane = row reads 4 consecutive j as a float4, and the
//     8 lanes of a quarter warp hit 8 distinct 16-byte bank groups.  With
//     the target mode last (I_CONTIG), a tile is [j][row]: lane = row reads
//     one float per j, 32 consecutive words.  Warp w takes the quads of j
//     w, w + 8, ...; U_q's 4 rows of a quad are broadcast as float4.
//   * The split is summed on chip, in a fixed order.  After its last step a
//     CTA sums its warps' (BI, C) accumulators into shared memory (each of
//     BI x CP sums in warp order), then cluster rank 0 adds ranks 1.. in
//     rank order through distributed shared memory (map_shared_rank) and
//     writes its group's sum; a second cluster.sync() keeps every rank's
//     shared memory alive while rank 0 reads it.  With one group that is the
//     output.  With more (unbatched only), each group writes an (I, C)
//     partial to a workspace and sum_splits_kernel adds the groups in group
//     order: under 0.3 MB at the fMRI shapes, a few us.  No atomics:
//     bitwise repeatable.
// Accumulation is ordinary fp32 FMA (no TF32), as Precision.HIGHEST asks.
// A ragged last row block (mode 0's 225 rows end in one block of 1 row)
// runs every step of its range, with 1/32 of a full block's copies, in the
// same wave.
#include "mttkrp_cluster.cuh"

// x: contiguous, shape[0..order); factors: host array of `order` device
// pointers to the (shape[k], c) factors (entry n unused); out: (I, c); any
// rank c >= 1.  The grid is (ceil(I / 32) x col_blocks(c), groups * splits)
// in clusters of (1, splits, 1):
// splits in {1, 2, 4, 8}, groups * splits at most the steps of a row block
// (chunks of q x outer indices) and 65535.  With groups > 1 the clusters
// write (groups, I, c) partials to ws and a second kernel sums them in
// group order (ws unused, and may be null, with one group).  q_chunk and vec as for the batched
// entry below.  Returns cudaGetLastError() after the launches (0 on
// success); a geometry it cannot run returns cudaErrorInvalidValue.
extern "C" int matrix_free_mttkrp_f32(const float* x, const void* const* factors,
                                      const int64_t* shape, int order, int n, int c, int groups,
                                      int splits, int64_t q_chunk, int vec, float* ws, float* out,
                                      void* stream) {
  return mttkrp::run_unbatched(x, factors, shape, order, n, c, groups, splits, q_chunk, vec, ws,
                               out, static_cast<cudaStream_t>(stream));
}

// The same for `slabs` stacked problems, in one launch: x: contiguous
// (slabs, shape[0..order)); factors: device pointers to the (slabs,
// shape[k], c) factors; out: (slabs, I, c).  `shape` is one slab's.  The
// grid is (ceil(I / 32) x col_blocks(c), splits, slabs) in clusters of (1,
// splits, 1), splits in {1, 2, 4, 8} and at most the steps of a row block;
// a stage holds q_chunk (a multiple of 4) indices of the contracted mode;
// vec != 0 copies 16 bytes (the last mode's extent a multiple of 4 and x
// 16-byte aligned).  A geometry it cannot run returns cudaErrorInvalidValue.
extern "C" int matrix_free_mttkrp_batched_f32(const float* x, const void* const* factors,
                                              const int64_t* shape, int order, int n, int c,
                                              int slabs, int splits, int64_t q_chunk, int vec,
                                              float* out, void* stream) {
  return mttkrp::run_cluster(x, factors, shape, order, n, c, slabs, 1, splits, q_chunk, vec, out,
                             static_cast<cudaStream_t>(stream));
}

// The kernel's occupancy at rank c (the padded width of its column blocks),
// target mode last or not, a stage of q_chunk indices and clusters of
// `splits`: CTAs an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and clusters the card holds (cudaOccupancyMaxActiveClusters).  Launches
// nothing.
extern "C" int matrix_free_occupancy_f32(int c, int i_contig, int64_t q_chunk, int splits,
                                         int* blocks_per_sm, int* clusters) {
  return mttkrp::occupancy<float>(c, i_contig, q_chunk, splits, blocks_per_sm, clusters);
}
