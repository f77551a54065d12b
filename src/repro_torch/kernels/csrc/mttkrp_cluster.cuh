// The Hopper MTTKRP body shared by matrix_free.cu, fused_mttkrp.cu and the
// sources of the other element types (mttkrp_entries.cuh):
// matrix_free_cluster_kernel, which folds a tensor in its natural row-major
// layout (order 3..6) against the raw factors of its non-target modes,
//
//     M[i, c] = sum over every non-target index of x[...] * prod_k U_k[i_k, c]
//
// and the host code that sizes and makes its launch (run_cluster, and
// run_unbatched for one tensor).  Each source that includes this header is
// built into its own library; the design notes are at the top of
// matrix_free.cu, and fused_mttkrp.cu says how the bilinear form maps onto
// the fold.
//
// Steps: a (slab, row block) folds nq x O steps, one (q chunk, outer index)
// pair each, q chunk outer and outer index inner (O outer multi-indices, nq
// chunks of the contracted mode q).  Part p of the P = groups x splits parts
// (p = blockIdx.y) covers the flat steps [S p / P, S (p + 1) / P) of the
// S = nq x O there are: where q fits one stage (nq = 1) that is the balanced
// cut of the outer range, and where it does not a part walks only the 2-3
// chunks its steps touch, loading U_q's chunk at its first step and at each
// chunk start, instead of every chunk for a slice of the outer range.
//
// Column blocks: a CTA keeps a (1, CP) accumulator row a thread, CP <= 64,
// so a rank C above 64 is cut into nb = ceil(C / 64) blocks of cw =
// ceil(C / nb) columns (the last may be narrower), each padded to one CP
// (col_blocks, block_cols in mttkrp_common.cuh).  The block is the inner
// part of grid x (x = row block * nb + column block), so the CTAs that read
// one tensor tile are launched side by side and a second read can hit L2.
// The factors and the output keep their row stride C; a CTA reads and
// writes its columns [c0, c0 + ncols) only.  A column's sum runs in the
// same order whatever block holds it.  With C <= 64 there is one block
// and the launch is the one it was without blocks.
//
// Element types: the body is instantiated for T = float, bf16, fp16 and
// double, the type of the tensor and of every factor (Elem in
// mttkrp_common.cuh).  The tensor tile is staged in T: the ring holds T, a
// 16-byte unit is 4, 8 or 2 elements, and a tile row is padded to 16 mod
// 128 bytes.  cp.async copies only 4, 8 or 16 bytes, so a 16-bit tile that
// is not copied in units (a contiguous extent whose bytes are not a
// multiple of 16, or a view off a 16-byte line) is staged with ordinary
// loads and shared stores.  An element is converted to float where the
// tile is read; the factor rows are converted as they are staged (the
// outer rows through registers for T != float, since cp.async cannot
// convert), so the fold, the accumulators, the cross-warp and cross-rank
// sums and the output stay fp32, as the reference's kernels declare a
// float32 output whatever they read.  T = float is the kernel it was.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "mttkrp_common.cuh"

namespace mttkrp {

namespace cg = cooperative_groups;

constexpr int MAX_ORDER = 6;
constexpr int MAX_OUTER = MAX_ORDER - 2;
constexpr int MFC_STAGES = 3;
constexpr int MFC_BLOCK_SMEM = 232448;  // most dynamic shared memory a CTA may use
constexpr int64_t MAX_GRID_Y = 65535;

struct MFArgs {
  const void* x;             // the tensor, of the kernel's element type T
  const void* u[MAX_ORDER];  // factor of each mode, (ext[k], C), of T; u[n] unused
  int64_t ext[MAX_ORDER];
  int64_t stride[MAX_ORDER];
  int order, n, q;
  int n_outer;
  int outer[MAX_ORDER];  // outer modes, ascending (row-major decode order)
  int C;   // the rank: the row stride of every factor and of the output
  int nb;  // column blocks (grid x = row block * nb + column block)
  int cw;  // columns a block: block b holds [b cw, min(C, (b + 1) cw))
};

// Outer multi-index o (the outer modes enumerated row-major) and its offset
// in x (from `base`, the start of the block's slab), advanced one step at a
// time without division; a step past the last multi-index wraps to the
// first (offset `base`).
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
static inline void fill_modes(MFArgs& p, const void* x, const void* const* factors,
                              const int64_t* shape, int order, int n, int c) {
  p.x = x;
  p.order = order;
  p.n = n;
  p.C = c;
  p.nb = col_blocks(c);
  p.cw = block_cols(c);
  int64_t stride = 1;
  for (int k = order - 1; k >= 0; --k) {
    p.ext[k] = shape[k];
    p.stride[k] = stride;
    stride *= shape[k];
    p.u[k] = factors[k];
  }
  p.q = (n == order - 1) ? order - 2 : order - 1;
  p.n_outer = 0;
  for (int k = 0; k < order; ++k) {
    if (k != n && k != p.q) p.outer[p.n_outer++] = k;
  }
}

// The order-3 fold of the bilinear form's view (d0, d1, d2) at pos (see
// fused_mttkrp.cu): its shape and the factor of each mode (pos unused; A
// outer, B contracted).  False for a bad pos.
static inline bool bilinear_fold(int pos, const void* a, const void* b, int64_t d0,
                                 int64_t d1, int64_t d2, int64_t* shape,
                                 const void** factors) {
  if (pos < 0 || pos > 2) return false;
  shape[0] = d0;
  shape[1] = d1;
  shape[2] = d2;
  factors[pos] = nullptr;
  factors[pos == 0 ? 1 : 0] = a;
  factors[pos == 2 ? 1 : 2] = b;
  return true;
}

struct MFCArgs {
  MFArgs p;  // one slab's modes and the factors' bases
  float* out;  // (S, groups, I, C): the output with one group, else the workspace
  int64_t o_total;  // outer multi-indices of a (slab, row block)
  int qc;           // indices of q a stage holds (a multiple of mfc_q_multiple)
  int qs;           // elements between tile rows (!I_CONTIG)
  int64_t nq;       // chunks of q
  int vec;          // 16-byte copies
};

// Row stride of a !I_CONTIG tile of `isz`-byte elements: >= qc and 16 mod
// 128 bytes (4 mod 32 floats, 8 mod 64 16-bit elements, 2 mod 16 doubles),
// so every row starts on a 16-byte line and the 8 lanes of a quarter warp,
// each reading 16 bytes of its own row at one column, hit 8 distinct
// 16-byte bank groups.
static inline int mfc_row_stride(int qc, int isz) {
  const int line = 128 / isz, lead = 16 / isz;
  return qc + (line + lead - qc % line) % line;
}

// What a stage's q_chunk must be a multiple of: 4 (the fold reads quads of
// q), and 8 for a 16-bit tile whose rows run along q (!I_CONTIG: its rows
// are read, and copied, 16 bytes at a time).
static inline int mfc_q_multiple(bool i_contig, int isz) { return !i_contig && isz == 2 ? 8 : 4; }

// Dynamic shared memory of one CTA (matrix_free.py: cluster_smem): the ring
// of tiles of `isz`-byte elements, then the float outer rows and U_q chunk;
// the cross-warp sum reuses it.
static inline int64_t mfc_smem_bytes(int64_t qc, int cp, bool i_contig, int isz) {
  const int64_t qs = i_contig ? qc : mfc_row_stride(static_cast<int>(qc), isz);
  const int64_t main = MFC_STAGES * BI * qs * isz + 4 * (MFC_STAGES * MAX_OUTER * cp + qc * cp);
  const int64_t red = 4 * static_cast<int64_t>(WARPS) * cp * BI;
  return main > red ? main : red;
}

// Stages one element of a tile at d (zero when !valid; src is then still a
// mapped address): cp.async of 4 or 8 bytes, and for a 16-bit element,
// which cp.async cannot copy alone, an ordinary load and shared store of
// its bits (+0 is the zero bits in bf16 and fp16).
template <typename T>
__device__ __forceinline__ void stage_one(T* d, const T* src, bool valid) {
  if constexpr (sizeof(T) == 4) {
    cp_async_f32(d, src, valid);
  } else if constexpr (sizeof(T) == 8) {
    cp_async_8(d, src, valid);
  } else {
    *reinterpret_cast<unsigned short*>(d) =
        valid ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
  }
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
// (matrix_free.py: residency).  T: the element type of x and the factors.
template <typename T, bool I_CONTIG, int CP>
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
  const int C = p.C;  // row stride of the factors and the output
  const int c0 = static_cast<int>(blockIdx.x % p.nb) * p.cw;  // columns [c0, c0 + ncols)
  const int ncols = static_cast<int>(imin(p.cw, C - c0));
  const int qc = a.qc;
  const int nquad = qc / 4;
  const int64_t z = blockIdx.z;
  const T* __restrict__ xs = static_cast<const T*>(p.x) + z * p.stride[0] * p.ext[0];  // slab
  const T* __restrict__ uq = static_cast<const T*>(p.u[p.q]) + z * eq * C + c0;
  const int stage_elems = I_CONTIG ? qc * BI : BI * a.qs;
  T* ring = reinterpret_cast<T*>(smem);                                      // [STAGES][tile]
  float* wring = reinterpret_cast<float*>(ring + MFC_STAGES * stage_elems);  // [STAGES][MAX_OUTER][CP]
  float* us = wring + MFC_STAGES * MAX_OUTER * CP;                           // [qc][CP]

  const int64_t i0 = static_cast<int64_t>(blockIdx.x / p.nb) * BI;
  const int ni = static_cast<int>(imin(BI, rows - i0));
  // Part blockIdx.y = group * splits + rank of the groups x splits parts:
  // the flat steps [S p / P, S (p + 1) / P) of the S = nq x o_total there
  // are (q chunk outer, outer index inner), from chunk ch_lo, outer o_lo.
  const int64_t part = blockIdx.y, parts = gridDim.y;
  const int64_t steps = a.nq * a.o_total;
  const int64_t s_lo = steps * part / parts;
  const int64_t total = steps * (part + 1) / parts - s_lo;
  const int64_t ch_lo = s_lo / a.o_total, o_lo = s_lo - ch_lo * a.o_total;

  // This thread's first copy of a tile and its stride, as (row, unit)
  // counters: a unit is 16 bytes (vec) or 1 element along the contiguous axis.
  const int width = a.vec ? Elem<T>::kUnit : 1;
  const int upr = I_CONTIG ? BI / width : qc / width;  // units a tile row
  const int c_first = threadIdx.x / upr, u_first = threadIdx.x % upr;
  const int c_step = THREADS / upr, u_step = THREADS % upr;

  Odometer io;  // outer index of the next step to issue (offset within the slab)
  int64_t io_o = o_lo, ich = ch_lo;  // its position in the outer range, its q chunk
  io.reset(p, o_lo, 0);
  auto issue = [&](int stage) {
    const int64_t jc0 = ich * qc;
    const T* __restrict__ tb = xs + io.off + i0 * si + jc0 * sq;  // the tile's origin
    T* dst = ring + stage * stage_elems;
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
      const T* src = valid ? tb + i * si + j * sq : xs;
      T* d = I_CONTIG ? dst + j * BI + i : dst + i * a.qs + j;
      if (a.vec) {
        cp_async_16(d, src, valid);
      } else {
        stage_one(d, src, valid);
      }
    }
    if (static_cast<int>(threadIdx.x) < p.n_outer * CP) {  // the step's outer factor rows
      const int k = threadIdx.x / CP, c = threadIdx.x % CP;
      const int m = p.outer[k];
      const bool valid = c < ncols;
      const T* um = static_cast<const T*>(p.u[m]);
      const T* src = um + (z * p.ext[m] + io.idx[k]) * C + c0 + c;
      float* d = wring + (stage * MAX_OUTER + k) * CP + c;
      if constexpr (std::is_same<T, float>::value) {
        cp_async_f32(d, valid ? src : um, valid);
      } else {  // through a register: cp.async cannot convert
        *d = valid ? to_float(__ldg(src)) : 0.0f;
      }
    }
    io.step(p);  // after the last outer index it wraps to 0: the next chunk's first
    if (++io_o == a.o_total) {
      io_o = 0;
      ++ich;
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
  int64_t co_o = o_lo, cch = ch_lo;  // the computed step: position in the outer range, q chunk
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
    if (it == 0 || co_o == 0) {  // the part's first step, or a chunk's: its rows of U_q
      const int64_t jc0 = cch * qc;
      for (int e = threadIdx.x; e < qc * CP; e += THREADS) {
        const int c = e % CP;
        const int64_t j = jc0 + e / CP;
        us[e] = (c < ncols && j < eq) ? to_float(__ldg(uq + j * C + c)) : 0.0f;
      }
      __syncthreads();
    }
    const T* ts = ring + cstage * stage_elems;
    float part[CP];
#pragma unroll
    for (int c = 0; c < CP; ++c) part[c] = 0.0f;
    if constexpr (I_CONTIG) {
      for (int qd = warp; qd < nquad; qd += WARPS) {
        const T* tq = ts + 4 * qd * BI + lane;
        mfc_mac_quad<CP>(part, to_float(tq[0]), to_float(tq[BI]), to_float(tq[2 * BI]),
                         to_float(tq[3 * BI]), us + 4 * qd * CP);
      }
    } else if constexpr (sizeof(T) == 2) {  // 16 bytes a read: two quads
      const T* trow = ts + lane * a.qs;
      for (int qd = 2 * warp; qd < nquad; qd += 2 * WARPS) {
        const uint4 t = *reinterpret_cast<const uint4*>(trow + 4 * qd);
        mfc_mac_quad<CP>(part, Elem<T>::bits_to_float(t.x & 0xffffu),
                         Elem<T>::bits_to_float(t.x >> 16), Elem<T>::bits_to_float(t.y & 0xffffu),
                         Elem<T>::bits_to_float(t.y >> 16), us + 4 * qd * CP);
        mfc_mac_quad<CP>(part, Elem<T>::bits_to_float(t.z & 0xffffu),
                         Elem<T>::bits_to_float(t.z >> 16), Elem<T>::bits_to_float(t.w & 0xffffu),
                         Elem<T>::bits_to_float(t.w >> 16), us + 4 * (qd + 1) * CP);
      }
    } else if constexpr (sizeof(T) == 8) {  // two 16-byte reads a quad
      const T* trow = ts + lane * a.qs;
      for (int qd = warp; qd < nquad; qd += WARPS) {
        const double2 lo = *reinterpret_cast<const double2*>(trow + 4 * qd);
        const double2 hi = *reinterpret_cast<const double2*>(trow + 4 * qd + 2);
        mfc_mac_quad<CP>(part, to_float(lo.x), to_float(lo.y), to_float(hi.x), to_float(hi.y),
                         us + 4 * qd * CP);
      }
    } else {
      const T* trow = ts + lane * a.qs;
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
    if (++co_o == a.o_total) {
      co_o = 0;
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
  // group)'s rows i, columns [c0, c0 + ncols): element e of the block is
  // row e / ncols, column e % ncols (with one block, e is the output's own
  // offset).
  const int64_t groups = parts / splits, group = part / splits;
  float* __restrict__ out = a.out + ((z * groups + group) * rows + i0) * C + c0;
  if (splits > 1) {
    cluster.sync();
    if (rank == 0) {
      for (int e = threadIdx.x; e < ni * ncols; e += THREADS) {
        const int row = e / ncols, col = e - row * ncols;
        const int off = col * BI + row;
        float v = red[off];
        for (int r = 1; r < splits; ++r) v += *cluster.map_shared_rank(red + off, r);
        out[static_cast<int64_t>(row) * C + col] = v;
      }
    }
    cluster.sync();  // no rank exits (freeing its shared memory) while rank 0 reads it
  } else {
    __syncthreads();
    for (int e = threadIdx.x; e < ni * ncols; e += THREADS) {
      const int row = e / ncols, col = e - row * ncols;
      out[static_cast<int64_t>(row) * C + col] = red[col * BI + row];
    }
  }
}

using MFCKernel = void (*)(MFCArgs);

// Raises an instance's dynamic-shared-memory limit to the most a CTA may use
// (a launch asks for what it needs), once per instance and library.  Every
// host function here has internal linkage: the libraries built from this
// header (matrix_free.cu, fused_mttkrp.cu, the other element types'
// sources) load into one process, and the static below, were it in a
// function of external linkage, would be one object shared by them (the
// dynamic linker unifies such statics across libraries), so the second
// library's kernels would never be prepared.
template <typename T, bool I_CONTIG, int CP>
static cudaError_t mfc_prepare() {
  static const cudaError_t err =
      cudaFuncSetAttribute(matrix_free_cluster_kernel<T, I_CONTIG, CP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, MFC_BLOCK_SMEM);
  return err;
}

// The kernel instance for element type T and padded rank cp (kernel nullptr
// for none), prepared.
struct MFCInstance {
  MFCKernel kernel;
  cudaError_t err;
};

template <typename T>
static inline MFCInstance mfc_instance(int cp, bool i_contig) {
  switch (cp) {
#define MFC_CASE(CP)                                                                     \
  case CP:                                                                               \
    return i_contig ? MFCInstance{matrix_free_cluster_kernel<T, true, CP>,               \
                                  mfc_prepare<T, true, CP>()}                            \
                    : MFCInstance{matrix_free_cluster_kernel<T, false, CP>,              \
                                  mfc_prepare<T, false, CP>()};
    MFC_CASE(4) MFC_CASE(8) MFC_CASE(12) MFC_CASE(16)
    MFC_CASE(24) MFC_CASE(32) MFC_CASE(48) MFC_CASE(64)
#undef MFC_CASE
  }
  return MFCInstance{nullptr, cudaErrorInvalidValue};
}

static inline cudaLaunchConfig_t mfc_config(unsigned grid_x, int64_t parts, int splits,
                                             int slabs, int64_t smem, cudaStream_t s,
                                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, static_cast<unsigned>(parts), static_cast<unsigned>(slabs));
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

static inline bool mfc_split_ok(int splits) {
  return splits == 1 || splits == 2 || splits == 4 || splits == 8;
}

// One launch of the kernel on x and factors of T; out is (slabs, groups, I,
// c), float.  groups x splits parts may not outnumber the steps of a row
// block.  Any rank c >= 1: grid x holds the row blocks times the column
// blocks of c.
template <typename T>
static inline int run_cluster(const T* x, const void* const* factors, const int64_t* shape,
                              int order, int n, int c, int slabs, int groups, int splits,
                              int64_t qc, int vec, float* out, cudaStream_t s) {
  constexpr int isz = sizeof(T);
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int cp = padded_rank(block_cols(c));
  if (cp == 0 || order < 3 || order > MAX_ORDER || n < 0 || n >= order ||
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
  const int64_t smem = mfc_smem_bytes(qc, cp, i_contig, isz);
  const int64_t grid_x = (rows + BI - 1) / BI * a.p.nb;  // row blocks x column blocks
  const int qm = mfc_q_multiple(i_contig, isz);
  a.nq = (eq + qc - 1) / qc;
  if (parts > a.nq * a.o_total || parts > MAX_GRID_Y || qc % qm != 0 ||
      qc > qm * ((eq + qm - 1) / qm) || smem > MFC_BLOCK_SMEM || grid_x > 0x7fffffff ||
      (vec && (contig * isz % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.out = out;
  a.qc = static_cast<int>(qc);
  a.qs = mfc_row_stride(a.qc, isz);
  a.vec = vec;
  const MFCInstance k = mfc_instance<T>(cp, i_contig);
  if (k.err != cudaSuccess) return static_cast<int>(k.err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      mfc_config(static_cast<unsigned>(grid_x), parts, splits, slabs, smem, s, attr);
  cfg.numAttrs = splits > 1 ? 1 : 0;  // a launch without the attribute is a cluster of one
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k.kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One tensor (one slab): the launch and, with more than one group, the sum
// of the groups' (I, c) partials in ws, in group order (sum_splits_kernel).
// ws is unused, and may be null, with one group.  ws and out are float.
template <typename T>
static inline int run_unbatched(const T* x, const void* const* factors,
                                const int64_t* shape, int order, int n, int c, int groups,
                                int splits, int64_t qc, int vec, float* ws, float* out,
                                cudaStream_t s) {
  if (groups > 1 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err = run_cluster(x, factors, shape, order, n, c, 1, groups, splits, qc, vec,
                              groups > 1 ? ws : out, s);
  if (err != 0 || groups == 1) return err;
  launch_sum_splits(ws, out, shape[n] * c, groups, 1, s);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's occupancy (matrix_free.cu: matrix_free_occupancy_f32) for
// element type T.
template <typename T>
static inline int occupancy(int c, int i_contig, int64_t q_chunk, int splits, int* blocks_per_sm,
                            int* clusters) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int cp = padded_rank(block_cols(c));
  if (cp == 0 || !mfc_split_ok(splits) || q_chunk < 4 ||
      q_chunk % mfc_q_multiple(i_contig != 0, sizeof(T)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = mfc_smem_bytes(q_chunk, cp, i_contig != 0, sizeof(T));
  if (smem > MFC_BLOCK_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const MFCInstance k = mfc_instance<T>(cp, i_contig != 0);
  if (k.err != cudaSuccess) return static_cast<int>(k.err);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k.kernel, THREADS, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];  // the query needs the cluster size even for one
  const cudaLaunchConfig_t cfg = mfc_config(1, splits, splits, 1, smem, nullptr, attr);
  err = cudaOccupancyMaxActiveClusters(clusters, k.kernel, &cfg);
  return static_cast<int>(err);
}

}  // namespace mttkrp
