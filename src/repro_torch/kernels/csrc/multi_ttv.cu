// Multi-TTV for Hopper (sm_90a) -- the second step of the 2-step MTTKRP
// (paper Alg. 4), on float, bf16, fp16 or double operands, summed in fp32
// into a float output:
//
//     M[i, c] = sum_l T[l, i, c] * W[l, c]            (unbatched)
//     M[s, i, c] = sum_l T[s, l, i, c] * W[s, l, c]   (batched, slab s)
//
// Replaces the Pallas TPU kernels src/repro/kernels/multi_ttv.py::
// multi_ttv_kernel (body _kernel) and multi_ttv_batched_kernel (body
// _kernel_batched).  The TPU kernel walks an ordered grid (I blocks, L) and
// accumulates o[i-block, :] += T[l, i-block, :] * W[l, :] into a revisited
// output block.  Here the whole L reduction is one launch:
//   * Flat, coalesced mapping.  Each slab's output is the flat (I * C) plane
//     e = i * C + c, and T[l] is the same plane, so output e reads
//     T[l * I * C + e] and W[l, e % C].  A CTA owns one tile of `tile`
//     consecutive outputs (the wrapper's block_i rows times C) and walks it
//     in chunks of 4 * TX outputs; each of its TX threads across the tile
//     owns 4 outputs of a chunk: 4 consecutive ones read as one float4 when
//     I * C % 4 == 0 (VEC; the wrapper also checks T's alignment), else
//     outputs tx, tx + TX, tx + 2 TX, tx + 3 TX read as scalars, so that each
//     load instruction of a warp covers 128 or 512 contiguous bytes; that
//     scalar path masks the ragged end of each tile.  No rank template: a
//     thread keeps 4 sums whatever C is, so a 1024-thread CTA launches at
//     any rank.
//   * W is read through the read-only cache (__ldg), not staged in shared
//     memory: for one l a warp's 4 weight loads fall in one C-float row of W
//     (at most 256 bytes, a broadcast), and staging would put a load, a
//     barrier and a shared-memory budget (hence a bound on L) in front of
//     the first FMA.
//   * The L reduction stays on chip, in a fixed order.  The CTA's threads
//     form G warp groups of TX threads; group g sums its own sub-slice of
//     the CTA's l slice in ascending l.  Groups 1.. hand their sums to group
//     0 through shared memory, which adds them in group order.  The `cl`
//     CTAs of a thread-block cluster along gridDim.y (cl in {1, 2, 4, 8},
//     one cluster covers all of L) hold disjoint l slices; cluster rank 0
//     reads every rank's CTA sum through distributed shared memory
//     (map_shared_rank), adds them in rank order and writes the output.  No
//     workspace, no second launch, no atomics: the result is bitwise
//     repeatable.  Slices are balanced, [L * r / cl, L * (r + 1) / cl), and
//     likewise for the groups inside a rank's slice; an empty slice adds
//     zeros (the wrapper never makes one: it picks no more ranks or groups
//     than there are l).
//   * Batched, the slab is blockIdx.z; a slab reads only its own T and W and
//     writes only its own output, so slab 0's bits do not depend on the
//     others.
//   * Element types.  T is read at its own width (a VEC quad is 16 bytes of
//     float, 8 of a 16-bit type, 32 of double).  In float a step is an fp32
//     FMA; in the other types it is the reference's algebra, which forms
//     t * w in T and adds it to a float32 output: the product of two 16-bit
//     values is exact in fp32 and is rounded once to T, a product of
//     doubles is taken in fp64 and rounded to float, and then it is added in
//     fp32, with no FMA (Elem::round in mttkrp_common.cuh).  A double step
//     holds twice the registers, so it issues 2 l steps together, not 4
//     (the same sums in the same order).
// Launch geometry (tile, TX, G, cl) comes from the shape alone, in the
// wrapper (multi_ttv.py: launch_shape), so no device query is made a call.
// Bound: HBM bytes.  T is read once (4 |T| bytes in float, 2 |T| in 16 bits,
// 8 |T| in double) for 2 |T| FLOPs, at most 1 FLOP a byte, far below the
// card's 20 FLOP/byte fp32 ridge.  At the shapes the
// fMRI tensor gives (T up to 200 x 200 x 10, 1.6 MB) a call moves about
// 0.5 us of HBM traffic; its time on the card is launch latency, a few DRAM
// round trips of the 8 SMs of one cluster (one tile at the default
// block_i) and the two cluster barriers.  Between back-to-back calls the
// wrapper's host path, longer than all of that, sets the pace (PERF.md).
#include <cooperative_groups.h>

#include <type_traits>

#include "mttkrp_common.cuh"

namespace mttkrp {

namespace cg = cooperative_groups;

constexpr int TTV_MAX_THREADS = 1024;

// l steps whose loads are issued together.
template <typename T>
constexpr int kTtvUnroll = sizeof(T) == 8 ? 2 : 4;

// Four elements of T for the 4 outputs of a thread, in the type a product
// is taken in (float, exact for the 16-bit types; double for double).
template <typename T>
struct Four {
  typename Elem<T>::Wide x, y, z, w;
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// acc += t * w, output by output: an fp32 FMA in float, else the product
// rounded as the reference rounds it (Elem::round), then added in fp32.
template <typename T>
__device__ __forceinline__ float4 mac4(const Four<T>& t, const Four<T>& w, float4 acc) {
  if constexpr (std::is_same<T, float>::value) {
    return make_float4(fmaf(t.x, w.x, acc.x), fmaf(t.y, w.y, acc.y), fmaf(t.z, w.z, acc.z),
                       fmaf(t.w, w.w, acc.w));
  } else {
    return make_float4(acc.x + Elem<T>::round(t.x * w.x), acc.y + Elem<T>::round(t.y * w.y),
                       acc.z + Elem<T>::round(t.z * w.z), acc.w + Elem<T>::round(t.w * w.w));
  }
}

// Four consecutive elements at p (16-byte aligned for float and double,
// 8-byte for the 16-bit types) in one or two vector loads.
template <typename T>
__device__ __forceinline__ Four<T> ldg_quad(const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    return {v.x, v.y, v.z, v.w};
  } else if constexpr (sizeof(T) == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    return {Elem<T>::bits_to_float(v.x & 0xffffu), Elem<T>::bits_to_float(v.x >> 16),
            Elem<T>::bits_to_float(v.y & 0xffffu), Elem<T>::bits_to_float(v.y >> 16)};
  } else {
    const double2 lo = __ldg(reinterpret_cast<const double2*>(p));
    const double2 hi = __ldg(reinterpret_cast<const double2*>(p) + 1);
    return {lo.x, lo.y, hi.x, hi.y};
  }
}

// T[l, o] for the 4 outputs o of a thread (masked ones read as 0; in VEC a
// quad is all in or all out).
template <typename T, bool VEC>
__device__ __forceinline__ Four<T> load_t(const T* __restrict__ tl, const int (&o)[4],
                                          const bool (&ok)[4]) {
  if (VEC) {
    return ok[0] ? ldg_quad(tl + o[0]) : Four<T>{0, 0, 0, 0};
  }
  return {ok[0] ? widen(__ldg(tl + o[0])) : 0, ok[1] ? widen(__ldg(tl + o[1])) : 0,
          ok[2] ? widen(__ldg(tl + o[2])) : 0, ok[3] ? widen(__ldg(tl + o[3])) : 0};
}

template <typename T>
__device__ __forceinline__ Four<T> load_w(const T* __restrict__ wl, const int (&col)[4]) {
  return {widen(__ldg(wl + col[0])), widen(__ldg(wl + col[1])), widen(__ldg(wl + col[2])),
          widen(__ldg(wl + col[3]))};
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(TTV_MAX_THREADS)
    multi_ttv_kernel(const T* __restrict__ t, const T* __restrict__ w,
                     float* __restrict__ out, int64_t L, int64_t N, int C, int tile, int TX,
                     int G) {
  constexpr int TTV_UNROLL = kTtvUnroll<T>;
  __shared__ float4 red[TTV_MAX_THREADS];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // This slab's tile: outputs [tile0, tile0 + len) of the plane.  tile0 is a
  // multiple of C, so a tile offset's column is offset % C.
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int len = static_cast<int>(imin(N - tile0, tile));
  const int64_t z = blockIdx.z;
  t += z * L * N + tile0;
  w += z * L * C;
  out += z * N + tile0;
  const int g = threadIdx.x / TX;
  const int tx = threadIdx.x % TX;
  // This rank's l slice, then this group's part of it (balanced splits).
  const int64_t r0 = L * rank / cl, r1 = L * (rank + 1) / cl;
  const int64_t l0 = r0 + (r1 - r0) * g / G, l1 = r0 + (r1 - r0) * (g + 1) / G;

  // Uniform over the CTA (it depends on blockIdx.x only), so every thread
  // meets every barrier below the same number of times.
  for (int o0 = 0; o0 < len; o0 += 4 * TX) {
    int o[4], col[4];
    bool ok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = VEC ? o0 + 4 * tx + k : o0 + tx + k * TX;
      ok[k] = o[k] < len;
      col[k] = o[k] % C;
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const T* __restrict__ tl = t + l0 * N;
    const T* __restrict__ wl = w + l0 * C;
    int64_t n = l1 - l0;
    for (; n >= TTV_UNROLL; n -= TTV_UNROLL, tl += TTV_UNROLL * N, wl += TTV_UNROLL * C) {
      Four<T> tv[TTV_UNROLL], wv[TTV_UNROLL];
#pragma unroll
      for (int u = 0; u < TTV_UNROLL; ++u) {
        tv[u] = load_t<T, VEC>(tl + u * N, o, ok);
        wv[u] = load_w(wl + u * C, col);
      }
#pragma unroll
      for (int u = 0; u < TTV_UNROLL; ++u) acc = mac4(tv[u], wv[u], acc);
    }
    for (; n > 0; --n, tl += N, wl += C) acc = mac4(load_t<T, VEC>(tl, o, ok), load_w(wl, col), acc);

    // Groups 1.. -> group 0, in group order.
    if (G > 1) {
      if (g > 0) red[threadIdx.x] = acc;
      __syncthreads();
      if (g == 0) {
        for (int src = 1; src < G; ++src) acc = add4(acc, red[src * TX + tx]);
      }
    }
    // CTA sums -> cluster rank 0, in rank order.  Group 0 owns slots
    // [0, TX) of red, which groups 1.. never write.
    if (cl > 1) {
      if (g == 0) red[tx] = acc;
      cluster.sync();
      if (rank == 0 && g == 0) {
        for (int src = 1; src < cl; ++src) {
          acc = add4(acc, *cluster.map_shared_rank(&red[tx], src));
        }
      }
      cluster.sync();  // no rank reuses or frees red while rank 0 reads it
    } else if (G > 1) {
      __syncthreads();  // group 0 has read red before the next chunk writes it
    }
    if (rank == 0 && g == 0) {
      if (VEC) {
        if (ok[0]) *reinterpret_cast<float4*>(out + o[0]) = acc;
      } else {
        if (ok[0]) out[o[0]] = acc.x;
        if (ok[1]) out[o[1]] = acc.y;
        if (ok[2]) out[o[2]] = acc.z;
        if (ok[3]) out[o[3]] = acc.w;
      }
    }
  }
}

template <typename T>
int run(const T* t, const T* w, float* out, bool batched, int slabs, int64_t L,
        int64_t I, int C, int64_t tile_rows, int TX, int G, int cl, int vec, cudaStream_t s) {
  const int64_t N = I * C;
  const int64_t tiles = tile_rows < 1 ? 0 : (I + tile_rows - 1) / tile_rows;
  const bool aligned = (reinterpret_cast<uintptr_t>(t) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (C < 1 || L < 1 || I < 1 || slabs < 1 || slabs > 65535 ||
      (!batched && slabs != 1) || tile_rows < 1 || tile_rows > I || tiles > 0x7fffffff ||
      tile_rows * C > (1 << 30) ||
      TX < 32 || TX % 32 != 0 || G < 1 || TX * G > TTV_MAX_THREADS ||
      !(cl == 1 || cl == 2 || cl == 4 || cl == 8) ||
      (vec && (N % 4 != 0 || (tiles > 1 && tile_rows * C % 4 != 0) || !aligned))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(cl),
                     static_cast<unsigned>(slabs));
  cfg.blockDim = dim3(static_cast<unsigned>(TX * G));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(cl);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;  // a launch without the attribute is a cluster of one
  const int tile = static_cast<int>(tile_rows * C);
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, multi_ttv_kernel<T, true>, t, w, out, L, N, C, tile, TX, G)
          : cudaLaunchKernelEx(&cfg, multi_ttv_kernel<T, false>, t, w, out, L, N, C, tile, TX,
                               G);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mttkrp

// t: contiguous (L, I, c); w: (L, c); out: (I, c).  One launch of
// ceil(I / tile_rows) x cl CTAs of threads_x * groups threads, in clusters
// of (1, cl, 1); vec != 0 reads T as float4 (I * c % 4 == 0 and t, out
// 16-byte aligned).  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int multi_ttv_f32(const float* t, const float* w, float* out, int64_t L, int64_t I,
                             int c, int64_t tile_rows, int threads_x, int groups, int cl,
                             int vec, void* stream) {
  return mttkrp::run(t, w, out, false, 1, L, I, c, tile_rows, threads_x, groups, cl, vec,
                     static_cast<cudaStream_t>(stream));
}

// The same for `slabs` stacked problems, one per grid z: t: contiguous
// (slabs, L, I, c); w: (slabs, L, c); out: (slabs, I, c).
extern "C" int multi_ttv_batched_f32(const float* t, const float* w, float* out, int slabs,
                                     int64_t L, int64_t I, int c, int64_t tile_rows,
                                     int threads_x, int groups, int cl, int vec, void* stream) {
  return mttkrp::run(t, w, out, true, slabs, L, I, c, tile_rows, threads_x, groups, cl, vec,
                     static_cast<cudaStream_t>(stream));
}

// The same entries for T = bf16, fp16 and double: t and w of T, out float.
#define MULTI_TTV_ENTRIES(T, SUFFIX)                                                          \
  extern "C" int multi_ttv_##SUFFIX(const T* t, const T* w, float* out, int64_t L, int64_t I, \
                                    int c, int64_t tile_rows, int threads_x, int groups,      \
                                    int cl, int vec, void* stream) {                          \
    return mttkrp::run(t, w, out, false, 1, L, I, c, tile_rows, threads_x, groups, cl, vec,   \
                       static_cast<cudaStream_t>(stream));                                    \
  }                                                                                           \
  extern "C" int multi_ttv_batched_##SUFFIX(const T* t, const T* w, float* out, int slabs,    \
                                            int64_t L, int64_t I, int c, int64_t tile_rows,   \
                                            int threads_x, int groups, int cl, int vec,       \
                                            void* stream) {                                   \
    return mttkrp::run(t, w, out, true, slabs, L, I, c, tile_rows, threads_x, groups, cl,     \
                       vec, static_cast<cudaStream_t>(stream));                               \
  }

MULTI_TTV_ENTRIES(__nv_bfloat16, bf16)
MULTI_TTV_ENTRIES(__half, f16)
MULTI_TTV_ENTRIES(double, f64)
