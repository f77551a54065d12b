// The C entries of rows 1-4 (the matrix-free and fused bilinear MTTKRP,
// unbatched and batched, and the occupancy query) for an element type other
// than float: MTTKRP_ENTRIES(T, suffix) defines matrix_free_mttkrp_<suffix>,
// matrix_free_mttkrp_batched_<suffix>, matrix_free_occupancy_<suffix>,
// fused_mttkrp_bilinear_<suffix> and fused_mttkrp_bilinear_batched_<suffix>,
// each the float entry of matrix_free.cu or fused_mttkrp.cu (whose notes
// give the arguments) with x, t, the factors and A and B of T, and ws and
// out float: the body reads T and sums in fp32 (mttkrp_cluster.cuh).  One
// source a type (mttkrp_bf16.cu, mttkrp_f16.cu, mttkrp_f64.cu), so the
// build compiles the types' instances in parallel, and the matrix-free and
// fused entries of a type share one library's instances.  With T a 16-bit
// type, a stage of a tile whose rows run along q (the target mode not the
// last) holds a multiple of 8 indices of q, else of 4, and vec != 0 needs
// the last extent's bytes a multiple of 16.
#pragma once

#include "mttkrp_cluster.cuh"

#define MTTKRP_ENTRIES(T, SUFFIX)                                                            \
  extern "C" int matrix_free_mttkrp_##SUFFIX(const T* x, const void* const* factors,         \
                                             const int64_t* shape, int order, int n, int c,  \
                                             int groups, int splits, int64_t q_chunk,        \
                                             int vec, float* ws, float* out, void* stream) { \
    return mttkrp::run_unbatched(x, factors, shape, order, n, c, groups, splits, q_chunk,    \
                                 vec, ws, out, static_cast<cudaStream_t>(stream));           \
  }                                                                                          \
  extern "C" int matrix_free_mttkrp_batched_##SUFFIX(                                        \
      const T* x, const void* const* factors, const int64_t* shape, int order, int n, int c, \
      int slabs, int splits, int64_t q_chunk, int vec, float* out, void* stream) {           \
    return mttkrp::run_cluster(x, factors, shape, order, n, c, slabs, 1, splits, q_chunk,    \
                               vec, out, static_cast<cudaStream_t>(stream));                 \
  }                                                                                          \
  extern "C" int matrix_free_occupancy_##SUFFIX(int c, int i_contig, int64_t q_chunk,        \
                                                int splits, int* blocks_per_sm,              \
                                                int* clusters) {                             \
    return mttkrp::occupancy<T>(c, i_contig, q_chunk, splits, blocks_per_sm, clusters);      \
  }                                                                                          \
  extern "C" int fused_mttkrp_bilinear_##SUFFIX(                                             \
      const T* t, const T* a, const T* b, float* ws, float* out, int pos, int64_t d0,        \
      int64_t d1, int64_t d2, int c, int groups, int splits, int64_t q_chunk, int vec,       \
      void* stream) {                                                                        \
    int64_t shape[3];                                                                        \
    const void* factors[3];                                                                  \
    if (!mttkrp::bilinear_fold(pos, a, b, d0, d1, d2, shape, factors)) {                     \
      return static_cast<int>(cudaErrorInvalidValue);                                        \
    }                                                                                        \
    return mttkrp::run_unbatched(t, factors, shape, 3, pos, c, groups, splits, q_chunk, vec, \
                                 ws, out, static_cast<cudaStream_t>(stream));                \
  }                                                                                          \
  extern "C" int fused_mttkrp_bilinear_batched_##SUFFIX(                                     \
      const T* t, const T* a, const T* b, float* out, int pos, int slabs, int64_t d0,        \
      int64_t d1, int64_t d2, int c, int splits, int64_t q_chunk, int vec, void* stream) {   \
    int64_t shape[3];                                                                        \
    const void* factors[3];                                                                  \
    if (!mttkrp::bilinear_fold(pos, a, b, d0, d1, d2, shape, factors)) {                     \
      return static_cast<int>(cudaErrorInvalidValue);                                        \
    }                                                                                        \
    return mttkrp::run_cluster(t, factors, shape, 3, pos, c, slabs, 1, splits, q_chunk, vec, \
                               out, static_cast<cudaStream_t>(stream));                      \
  }
