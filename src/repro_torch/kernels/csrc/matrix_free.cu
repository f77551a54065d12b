// Matrix-free MTTKRP for Hopper (sm_90a), fp32, any mode of an order-3..6
// tensor in its natural row-major layout:
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
// matrix_free_cluster_kernel, which streams x once at full width:
//   * Grid (row blocks, groups x splits, S), cluster (1, splits, 1).  A CTA
//     owns BI rows of the target mode of one slab and one of groups x splits
//     balanced parts of the outer range, part p = blockIdx.y covering
//     [O p / P, O (p + 1) / P).  The wrapper (matrix_free.py: launch_shape,
//     unbatched_launch_shape) picks splits in {1, 2, 4, 8} and groups from
//     the shape alone, to fill the card's CTA slots in the fewest whole
//     waves.  The batched entry runs one group (its slabs fill the card);
//     the unbatched one runs as many groups as one wave holds (2-8 row
//     blocks of one tensor fill far fewer slots than 264).
//   * Whole q extents.  A stage holds BI rows x q_chunk indices of q, the
//     whole extent where it fits (200 at the fMRI shapes, 25.6 KB), else
//     the largest equal chunk that fits; steps run q chunk outer, outer index
//     inner, and U_q's chunk is loaded into shared memory once per chunk
//     (once per CTA when q fits).  A ring of STAGES such tiles streams with
//     cp.async, STAGES - 1 steps ahead, one barrier a step; each stage also
//     carries its step's outer factor rows (cp.async, 4 bytes), so a thread
//     forms the step's weights from shared memory.
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
#include <cooperative_groups.h>

#include "mttkrp_common.cuh"

namespace mttkrp {

namespace cg = cooperative_groups;

constexpr int MAX_ORDER = 6;
constexpr int MAX_OUTER = MAX_ORDER - 2;
constexpr int MFC_STAGES = 3;
constexpr int MFC_BLOCK_SMEM = 232448;  // most dynamic shared memory a CTA may use
constexpr int64_t MAX_GRID_Y = 65535;

struct MFArgs {
  const float* x;
  const float* u[MAX_ORDER];  // factor of each mode, (ext[k], C); u[n] unused
  int64_t ext[MAX_ORDER];
  int64_t stride[MAX_ORDER];
  int order, n, q;
  int n_outer;
  int outer[MAX_ORDER];  // outer modes, ascending (row-major decode order)
  int C;
};

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

// Mode bookkeeping of one (slab's) tensor: extents, row-major strides, the
// factor pointers, the contracted mode q and the outer modes.
void fill_modes(MFArgs& p, const float* x, const void* const* factors, const int64_t* shape,
                int order, int n, int c) {
  p.x = x;
  p.order = order;
  p.n = n;
  p.C = c;
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
}

struct MFCArgs {
  MFArgs p;  // one slab's modes and the factors' bases
  float* out;  // (S, groups, I, C): the output with one group, else the workspace
  int64_t o_total;  // outer multi-indices of a (slab, row block)
  int qc;           // indices of q a stage holds (a multiple of 4)
  int qs;           // floats between tile rows (!I_CONTIG)
  int64_t nq;       // chunks of q
  int vec;          // 16-byte copies
};

// Row stride of a !I_CONTIG tile: >= qc and 4 mod 32 floats.
inline int mfc_row_stride(int qc) { return qc + (36 - qc % 32) % 32; }

// Dynamic shared memory of one CTA (matrix_free.py: cluster_smem).
inline int64_t mfc_smem_bytes(int64_t qc, int cp, bool i_contig) {
  const int64_t qs = i_contig ? qc : mfc_row_stride(static_cast<int>(qc));
  const int64_t main = MFC_STAGES * BI * qs + MFC_STAGES * MAX_OUTER * cp + qc * cp;
  const int64_t red = static_cast<int64_t>(WARPS) * cp * BI;
  return 4 * (main > red ? main : red);
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// part[c] += sum over the quad's 4 indices j of t_j * U_q[j, c] (u: the
// quad's first row of the U_q chunk, rows CP floats apart).
template <int CP>
__device__ __forceinline__ void mfc_mac_quad(float (&part)[CP], float t0, float t1, float t2,
                                             float t3, const float* u) {
#pragma unroll
  for (int c = 0; c < CP; c += 4) {
    const float4 u0 = *reinterpret_cast<const float4*>(u + c);
    const float4 u1 = *reinterpret_cast<const float4*>(u + CP + c);
    const float4 u2 = *reinterpret_cast<const float4*>(u + 2 * CP + c);
    const float4 u3 = *reinterpret_cast<const float4*>(u + 3 * CP + c);
    part[c] = fmaf(t3, u3.x, fmaf(t2, u2.x, fmaf(t1, u1.x, fmaf(t0, u0.x, part[c]))));
    part[c + 1] = fmaf(t3, u3.y, fmaf(t2, u2.y, fmaf(t1, u1.y, fmaf(t0, u0.y, part[c + 1]))));
    part[c + 2] = fmaf(t3, u3.z, fmaf(t2, u2.z, fmaf(t1, u1.z, fmaf(t0, u0.z, part[c + 2]))));
    part[c + 3] = fmaf(t3, u3.w, fmaf(t2, u2.w, fmaf(t1, u1.w, fmaf(t0, u0.w, part[c + 3]))));
  }
}

// Two CTAs an SM up to rank 32 (the bounds cap the registers at 128 a
// thread; the wrapper sizes shared memory to let two in), one above
// (matrix_free.py: residency).
template <bool I_CONTIG, int CP>
__global__ void __launch_bounds__(THREADS, CP <= 32 ? 2 : 1)
    matrix_free_cluster_kernel(MFCArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const MFArgs& p = a.p;
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % BI;
  const int warp = threadIdx.x / BI;
  const int64_t rows = p.ext[p.n];
  const int64_t si = p.stride[p.n];
  const int64_t sq = p.stride[p.q];
  const int64_t eq = p.ext[p.q];
  const int C = p.C;
  const int qc = a.qc;
  const int nquad = qc / 4;
  const int64_t z = blockIdx.z;
  const float* __restrict__ xs = p.x + z * p.stride[0] * p.ext[0];  // this slab
  const float* __restrict__ uq = p.u[p.q] + z * eq * C;
  const int stage_floats = I_CONTIG ? qc * BI : BI * a.qs;
  float* ring = smem;                                   // [STAGES][tile]
  float* wring = ring + MFC_STAGES * stage_floats;      // [STAGES][MAX_OUTER][CP]
  float* us = wring + MFC_STAGES * MAX_OUTER * CP;      // [qc][CP]

  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * BI;
  const int ni = static_cast<int>(imin(BI, rows - i0));
  // Part blockIdx.y = group * splits + rank of the groups x splits parts.
  const int64_t part = blockIdx.y, parts = gridDim.y;
  const int64_t o_lo = a.o_total * part / parts;
  const int64_t n_o = a.o_total * (part + 1) / parts - o_lo;
  const int64_t total = n_o * a.nq;

  // This thread's first copy of a tile and its stride, as (row, unit)
  // counters: a unit is 4 floats (vec) or 1 along the contiguous axis.
  const int width = a.vec ? 4 : 1;
  const int upr = I_CONTIG ? BI / width : qc / width;  // units a tile row
  const int c_first = threadIdx.x / upr, u_first = threadIdx.x % upr;
  const int c_step = THREADS / upr, u_step = THREADS % upr;

  Odometer io;  // outer index of the next step to issue (offset within the slab)
  int64_t io_n = 0, ich = 0;
  io.reset(p, o_lo, 0);
  auto issue = [&](int stage) {
    const int64_t jc0 = ich * qc;
    const float* __restrict__ tb = xs + io.off + i0 * si + jc0 * sq;  // the tile's origin
    float* dst = ring + stage * stage_floats;
    int r = c_first, u = u_first;  // I_CONTIG: (j, row unit); else (row, j unit)
    const int n_r = I_CONTIG ? qc : ni;
    for (; r < n_r; r += c_step, u += u_step) {
      if (u >= upr) {
        u -= upr;
        ++r;
        if (r >= n_r) break;
      }
      const int i = I_CONTIG ? u * width : r;  // tile row
      const int j = I_CONTIG ? r : u * width;  // index of q within the chunk
      if (I_CONTIG && i >= ni) continue;       // past the tensor's rows: never stored
      const bool valid = jc0 + j < eq;
      const float* src = valid ? tb + i * si + j * sq : xs;
      float* d = I_CONTIG ? dst + j * BI + i : dst + i * a.qs + j;
      if (a.vec) {
        cp_async_16(d, src, valid);
      } else {
        cp_async_f32(d, src, valid);
      }
    }
    if (static_cast<int>(threadIdx.x) < p.n_outer * CP) {  // the step's outer factor rows
      const int k = threadIdx.x / CP, c = threadIdx.x % CP;
      const int m = p.outer[k];
      const bool valid = c < C;
      const float* src = p.u[m] + (z * p.ext[m] + io.idx[k]) * C + c;
      cp_async_f32(wring + (stage * MAX_OUTER + k) * CP + c, valid ? src : p.u[m], valid);
    }
    if (++io_n == n_o) {
      io_n = 0;
      ++ich;
      io.reset(p, o_lo, 0);
    } else {
      io.step(p);
    }
  };

  int64_t issued = 0;
  int istage = 0;
  for (int st = 0; st < MFC_STAGES - 1; ++st) {
    if (issued < total) {
      issue(istage);
      ++issued;
      istage = istage + 1 == MFC_STAGES ? 0 : istage + 1;
    }
    cp_async_commit();
  }

  float acc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] = 0.0f;
  int64_t co_n = 0, cch = 0;  // the computed step: position in the outer range, q chunk
  int cstage = 0;
  for (int64_t it = 0; it < total; ++it) {
    cp_async_wait<MFC_STAGES - 2>();  // this thread's copies of step `it` have landed
    __syncthreads();  // everyone's copies visible; step it - 1 read by every thread
    if (issued < total) {
      issue(istage);  // into step it - 1's stage
      ++issued;
      istage = istage + 1 == MFC_STAGES ? 0 : istage + 1;
    }
    cp_async_commit();
    if (co_n == 0) {  // the first step of a q chunk: its rows of U_q
      const int64_t jc0 = cch * qc;
      for (int e = threadIdx.x; e < qc * CP; e += THREADS) {
        const int c = e % CP;
        const int64_t j = jc0 + e / CP;
        us[e] = (c < C && j < eq) ? __ldg(uq + j * C + c) : 0.0f;
      }
      __syncthreads();
    }
    const float* ts = ring + cstage * stage_floats;
    float part[CP];
#pragma unroll
    for (int c = 0; c < CP; ++c) part[c] = 0.0f;
    if (I_CONTIG) {
      for (int qd = warp; qd < nquad; qd += WARPS) {
        const float* tq = ts + 4 * qd * BI + lane;
        mfc_mac_quad<CP>(part, tq[0], tq[BI], tq[2 * BI], tq[3 * BI], us + 4 * qd * CP);
      }
    } else {
      const float* trow = ts + lane * a.qs;
      for (int qd = warp; qd < nquad; qd += WARPS) {
        const float4 t = *reinterpret_cast<const float4*>(trow + 4 * qd);
        mfc_mac_quad<CP>(part, t.x, t.y, t.z, t.w, us + 4 * qd * CP);
      }
    }
    // fold the outer rows: acc += (prod_k U_k[o_k, :]) * part
    const float* w = wring + cstage * MAX_OUTER * CP;
#pragma unroll
    for (int c = 0; c < CP; c += 4) {
      float4 wc = *reinterpret_cast<const float4*>(w + c);
#pragma unroll
      for (int k = 1; k < MAX_OUTER; ++k) {
        if (k < p.n_outer) {
          const float4 v = *reinterpret_cast<const float4*>(w + k * CP + c);
          wc.x *= v.x;
          wc.y *= v.y;
          wc.z *= v.z;
          wc.w *= v.w;
        }
      }
      acc[c] = fmaf(wc.x, part[c], acc[c]);
      acc[c + 1] = fmaf(wc.y, part[c + 1], acc[c + 1]);
      acc[c + 2] = fmaf(wc.z, part[c + 2], acc[c + 2]);
      acc[c + 3] = fmaf(wc.w, part[c + 3], acc[c + 3]);
    }
    if (++co_n == n_o) {
      co_n = 0;
      ++cch;
    }
    cstage = cstage + 1 == MFC_STAGES ? 0 : cstage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every step read: the ring becomes the reduction buffer

  // The warps' sums, in warp order, into red[c * BI + row].
  float* red = smem;  // [WARPS][CP][BI]
#pragma unroll
  for (int c = 0; c < CP; ++c) red[(warp * CP + c) * BI + lane] = acc[c];
  __syncthreads();
  for (int e = threadIdx.x; e < CP * BI; e += THREADS) {
    float v = red[e];
    for (int w = 1; w < WARPS; ++w) v += red[w * CP * BI + e];
    red[e] = v;  // only this thread reads or writes index e of warp 0's slot
  }
  // The ranks' sums, in rank order, by cluster rank 0, into this (slab,
  // group)'s rows i, columns c < C.
  const int64_t groups = parts / splits, group = part / splits;
  float* __restrict__ out = a.out + ((z * groups + group) * rows + i0) * C;
  if (splits > 1) {
    cluster.sync();
    if (rank == 0) {
      for (int e = threadIdx.x; e < ni * C; e += THREADS) {
        const int off = (e % C) * BI + e / C;
        float v = red[off];
        for (int r = 1; r < splits; ++r) v += *cluster.map_shared_rank(red + off, r);
        out[e] = v;
      }
    }
    cluster.sync();  // no rank exits (freeing its shared memory) while rank 0 reads it
  } else {
    __syncthreads();
    for (int e = threadIdx.x; e < ni * C; e += THREADS) out[e] = red[(e % C) * BI + e / C];
  }
}

using MFCKernel = void (*)(MFCArgs);

// Raises an instance's dynamic-shared-memory limit to the most a CTA may use
// (a launch asks for what it needs), once per instance.
template <bool I_CONTIG, int CP>
cudaError_t mfc_prepare() {
  static const cudaError_t err =
      cudaFuncSetAttribute(matrix_free_cluster_kernel<I_CONTIG, CP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, MFC_BLOCK_SMEM);
  return err;
}

// The kernel instance for padded rank cp (kernel nullptr for none), prepared.
struct MFCInstance {
  MFCKernel kernel;
  cudaError_t err;
};

MFCInstance mfc_instance(int cp, bool i_contig) {
  switch (cp) {
#define MFC_CASE(CP)                                                                     \
  case CP:                                                                               \
    return i_contig ? MFCInstance{matrix_free_cluster_kernel<true, CP>,                  \
                                  mfc_prepare<true, CP>()}                               \
                    : MFCInstance{matrix_free_cluster_kernel<false, CP>,                 \
                                  mfc_prepare<false, CP>()};
    MFC_CASE(4) MFC_CASE(8) MFC_CASE(12) MFC_CASE(16)
    MFC_CASE(24) MFC_CASE(32) MFC_CASE(48) MFC_CASE(64)
#undef MFC_CASE
  }
  return MFCInstance{nullptr, cudaErrorInvalidValue};
}

cudaLaunchConfig_t mfc_config(unsigned row_blocks, int64_t parts, int splits, int slabs,
                              int64_t smem, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks, static_cast<unsigned>(parts), static_cast<unsigned>(slabs));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool mfc_split_ok(int splits) { return splits == 1 || splits == 2 || splits == 4 || splits == 8; }

// One launch of the kernel; out is (slabs, groups, I, c).
int run_cluster(const float* x, const void* const* factors, const int64_t* shape, int order,
                int n, int c, int slabs, int groups, int splits, int64_t qc, int vec, float* out,
                cudaStream_t s) {
  const int cp = padded_rank(c);
  if (cp == 0 || c < 1 || order < 3 || order > MAX_ORDER || n < 0 || n >= order ||
      slabs < 1 || slabs > 65535 || groups < 1 || !mfc_split_ok(splits) || qc < 4 ||
      qc % 4 != 0 || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < order; ++k) {
    if (shape[k] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  MFCArgs a{};
  fill_modes(a.p, x, factors, shape, order, n, c);
  const bool i_contig = n == order - 1;
  const int64_t eq = a.p.ext[a.p.q];
  const int64_t rows = a.p.ext[n];
  const int64_t contig = shape[order - 1];
  a.o_total = 1;
  for (int k = 0; k < a.p.n_outer; ++k) a.o_total *= a.p.ext[a.p.outer[k]];
  const int64_t parts = static_cast<int64_t>(groups) * splits;
  const int64_t smem = mfc_smem_bytes(qc, cp, i_contig);
  const int64_t row_blocks = (rows + BI - 1) / BI;
  if (parts > a.o_total || parts > MAX_GRID_Y || qc > 4 * ((eq + 3) / 4) ||
      smem > MFC_BLOCK_SMEM || row_blocks > 0x7fffffff ||
      (vec && (contig % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.out = out;
  a.qc = static_cast<int>(qc);
  a.qs = mfc_row_stride(a.qc);
  a.nq = (eq + qc - 1) / qc;
  a.vec = vec;
  const MFCInstance k = mfc_instance(cp, i_contig);
  if (k.err != cudaSuccess) return static_cast<int>(k.err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      mfc_config(static_cast<unsigned>(row_blocks), parts, splits, slabs, smem, s, attr);
  cfg.numAttrs = splits > 1 ? 1 : 0;  // a launch without the attribute is a cluster of one
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k.kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mttkrp

// x: contiguous, shape[0..order); factors: host array of `order` device
// pointers to the (shape[k], c) factors (entry n unused); out: (I, c).  The
// grid is (ceil(I / 32), groups * splits) in clusters of (1, splits, 1):
// splits in {1, 2, 4, 8}, groups * splits at most the outer indices there
// are and 65535.  With groups > 1 the clusters write (groups, I, c)
// partials to ws and a second kernel sums them in group order (ws unused,
// and may be null, with one group).  q_chunk and vec as for the batched
// entry below.  Returns cudaGetLastError() after the launches (0 on
// success); a geometry it cannot run returns cudaErrorInvalidValue.
extern "C" int matrix_free_mttkrp_f32(const float* x, const void* const* factors,
                                      const int64_t* shape, int order, int n, int c, int groups,
                                      int splits, int64_t q_chunk, int vec, float* ws, float* out,
                                      void* stream) {
  using namespace mttkrp;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups > 1 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err = run_cluster(x, factors, shape, order, n, c, 1, groups, splits, q_chunk, vec,
                              groups > 1 ? ws : out, s);
  if (err != 0 || groups == 1) return err;
  launch_sum_splits(ws, out, shape[n] * c, groups, 1, s);
  return static_cast<int>(cudaGetLastError());
}

// The same for `slabs` stacked problems, in one launch: x: contiguous
// (slabs, shape[0..order)); factors: device pointers to the (slabs,
// shape[k], c) factors; out: (slabs, I, c).  `shape` is one slab's.  The
// grid is (ceil(I / 32), splits, slabs) in clusters of (1, splits, 1),
// splits in {1, 2, 4, 8} and at most the outer indices there are; a stage
// holds q_chunk (a multiple of 4) indices of the contracted mode; vec != 0
// copies 16 bytes (the last mode's extent a multiple of 4 and x 16-byte
// aligned).  A geometry it cannot run returns cudaErrorInvalidValue.
extern "C" int matrix_free_mttkrp_batched_f32(const float* x, const void* const* factors,
                                              const int64_t* shape, int order, int n, int c,
                                              int slabs, int splits, int64_t q_chunk, int vec,
                                              float* out, void* stream) {
  return mttkrp::run_cluster(x, factors, shape, order, n, c, slabs, 1, splits, q_chunk, vec, out,
                             static_cast<cudaStream_t>(stream));
}

// The kernel's occupancy at rank c, target mode last or not, a stage of
// q_chunk indices and clusters of `splits`: CTAs an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and clusters the card
// holds (cudaOccupancyMaxActiveClusters).  Launches nothing.
extern "C" int matrix_free_occupancy_f32(int c, int i_contig, int64_t q_chunk, int splits,
                                         int* blocks_per_sm, int* clusters) {
  using namespace mttkrp;
  const int cp = padded_rank(c);
  if (cp == 0 || c < 1 || !mfc_split_ok(splits) || q_chunk < 4 || q_chunk % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = mfc_smem_bytes(q_chunk, cp, i_contig != 0);
  if (smem > MFC_BLOCK_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const MFCInstance k = mfc_instance(cp, i_contig != 0);
  if (k.err != cudaSuccess) return static_cast<int>(k.err);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k.kernel, THREADS, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];  // the query needs the cluster size even for one
  const cudaLaunchConfig_t cfg = mfc_config(1, splits, splits, 1, smem, nullptr, attr);
  err = cudaOccupancyMaxActiveClusters(clusters, k.kernel, &cfg);
  return static_cast<int>(err);
}
