// The factor update's C x C solve for Hopper (sm_90a), in float or double:
//
//     H = G_0 * ... * G_{n-1} * G_{n+1} * ... * G_{N-1}    (Hadamard, k != n)
//     P = pinv(H)                                            (cutoff 10 C eps)
//
// It replaces no TPU kernel: the reference's update calls jnp.linalg.pinv,
// which XLA lowers to its own SVD on the device.  It was added to take
// torch.linalg.pinv's host read out of the port's update: PyTorch checks
// cuSOLVER's info array on the host after every SVD, so each of a sweep's
// updates drained the device queue, and the operations after it were issued
// to an idle card.  This kernel reports nothing to the host: a non-finite H
// writes NaN into the whole of P, which the chunk's read of the fits shows.
//
// Bound: latency.  A C x C problem (C = 10 at the paper's rank) is a few
// hundred bytes and a few thousand operations; what costs is the chain of
// dependent steps of the eigensolver, tens of rounds each ending in a
// barrier.  The design:
//
// - One block a matrix of the batch, so a batch of 32 is one launch of 32
//   blocks.  H (padded to an even order m) and V (C x m) live in shared
//   memory; nothing goes to HBM but the Grams' read and P's write.
// - H is formed in the Hadamard's left-to-right order from the Grams' upper
//   triangles and mirrored, so H is bitwise the plain version's upper
//   triangle and a Gram that is not bitwise symmetric does not matter.
// - Parallel cyclic Jacobi (two-sided) on the symmetric H, round-robin
//   ordering: m / 2 disjoint rotations a round, m - 1 rounds a sweep; an odd
//   C gets a zero row and column whose rotations are the identity.  A round
//   has two steps, each ending in a __syncthreads.  First each pair's
//   rotation is worked out once, from the pair's two diagonal elements and
//   its off-diagonal one, into shared memory, and the pair's diagonal is
//   updated in place.  Then every thread applies the rotations to a fixed
//   set of tasks: 2 x 2 blocks (pair k, pair l), k < l, of H with their
//   mirrors, or a row of V at a pair, in groups that each start on a warp
//   so that a warp does not diverge over the kinds.  The blocks are
//   disjoint, so H is rotated in place; the owner of each element that is
//   a pair element of the next round writes it to the pairs' array too.
//   (One __syncthreads a round, with every thread working out the
//   rotations it applies, was no faster at C = 10 and slower at C = 32 on
//   an H100: PERF.md, section 6.)
// - A round is a chain of dependent steps, so each is kept short.  A
//   thread's tasks are decoded once, before the sweeps, into registers; a
//   round's pairs and the next round's partners are found by additions and
//   compares (no integer division).  A rotation takes no division and no
//   square root of the library's: its operands are scaled by a power of two
//   made from the exponent's bits (exact), and its reciprocal and
//   reciprocal square roots are the hardware's approximations refined by
//   Newton steps.
// - The sweeps stop when the off-diagonal norm is at most OFF_TOL eps ||H||_F
//   or after MAX_SWEEPS sweeps, both decided in the block.  Reductions go
//   in a fixed order, rotations in the matrix's type with no atomics and no
//   tensor cores: the same bits in give the same bits out on every launch
//   and on every rank of a sharded run.
// - The cutoff is torch.linalg.pinv's at rtol = 10 C eps: eigenvalue i is
//   kept when |lambda_i| > rtol max |lambda| (the singular values of a
//   symmetric H are the |lambda_i|), and P = V diag(1 / lambda kept) V^T,
//   written symmetric.
#include <cfloat>
#include <cmath>

#include "mttkrp_common.cuh"

namespace gram_pinv {

constexpr int MAX_ORDER = 16;      // Grams a call takes (the port runs orders 2 and up)
constexpr int MAX_SWEEPS = 20;     // Jacobi sweeps at most
constexpr double OFF_TOL = 1.0;    // stop at off(H) <= OFF_TOL eps ||H||_F
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr int MAX_TASKS = 16;      // tasks a thread holds in registers

// Threads of a block at most: 1024 for float; 512 for double, which leaves
// a thread the 128 registers its tasks' doubles take.
template <typename T>
struct Block {
  static constexpr int threads = sizeof(T) == 8 ? 512 : 1024;
};

struct Args {
  const void* g[MAX_ORDER];  // Gram k of the batch, (batch, c, c), contiguous
  void* out;                 // P, (batch, c, c)
  int order;
  int mode;  // n: the Gram left out
  int c;
};

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static constexpr double value = FLT_EPSILON;
};
template <>
struct Eps<double> {
  static constexpr double value = DBL_EPSILON;
};

// The padded order m: C, or C + 1 for an odd C.
__host__ __device__ __forceinline__ int padded(int c) { return c + (c & 1); }

// Shared memory of a block, in elements: H (m x m), V (C x m), the
// diagonal (m), each pair's off-diagonal element (m / 2), each pair's
// rotation (m), and 33 for the reductions.  Mirrored by
// repro_torch.kernels.gram_pinv.smem_bytes.
__host__ __device__ __forceinline__ int smem_elements(int c) {
  const int m = padded(c);
  return m * m + c * m + 2 * m + m / 2 + 33;
}

// A round's tasks, in two groups that each start on a warp: the 2 x 2
// blocks (k, l), k < l, of H's pairs; a row of V at a pair.  Mirrored by
// repro_torch.kernels.gram_pinv.tasks.
__host__ __device__ __forceinline__ int warps_of(int n) { return (n + 31) / 32 * 32; }
__host__ __device__ __forceinline__ int tasks_of(int c) {
  const int half = padded(c) / 2;
  return warps_of(half * (half - 1) / 2) + c * half;
}

// Round r of m - 1 (m even, w = m - 1): pair 0 is (r, w), pair k >= 1 is
// (r + k, r - k) mod w.
__device__ __forceinline__ void pair_of(int k, int r, int w, int& p, int& q) {
  if (k == 0) {
    p = r;
    q = w;
  } else {
    p = r + k;
    p -= p >= w ? w : 0;
    q = r - k;
    q += q < 0 ? w : 0;
  }
}

// The index paired with i in round r, and the slot of its pair.
__device__ __forceinline__ int partner_of(int i, int r, int w) {
  if (i == w) return r;
  if (i == r) return w;
  int x = 2 * r - i;  // in (-w, 2 w)
  x += x < 0 ? w : 0;
  x -= x >= w ? w : 0;
  return x;
}
__device__ __forceinline__ int slot_of(int i, int r, int w) {
  if (i == w || i == r) return 0;
  int k = i - r;
  k += k < 0 ? w : 0;
  return k < w - k ? k : w - k;
}

// Scale x and y by 2^-e, e the exponent of the larger magnitude (not 0),
// so that it lies in [1, 2); exact.  2^-e is made from that number's bits
// where it is a normal number well inside the range (always, but for
// matrices near the type's limits), else the library's functions scale.
__device__ __forceinline__ void normalize(float& x, float& y) {
  const float big = fmaxf(fabsf(x), fabsf(y));
  const int field = (__float_as_int(big) >> 23) & 0xff;
  if (field >= 2 && field <= 252) {
    const float s = __int_as_float((254 - field) << 23);
    x *= s;
    y *= s;
  } else {
    const int e = ilogbf(big);
    x = scalbnf(x, -e);
    y = scalbnf(y, -e);
  }
}
__device__ __forceinline__ void normalize(double& x, double& y) {
  const double big = fmax(fabs(x), fabs(y));
  const long long field = (__double_as_longlong(big) >> 52) & 0x7ff;
  if (field >= 2 && field <= 2044) {
    const double s = __longlong_as_double((2046 - field) << 52);
    x *= s;
    y *= s;
  } else {
    const int e = ilogb(big);
    x = scalbn(x, -e);
    y = scalbn(y, -e);
  }
}

// A reciprocal and a reciprocal square root of a in [1, 16): the hardware's
// float approximation refined by Newton steps (one for float, two for
// double).
template <typename T>
__device__ __forceinline__ T recip(T a) {
  T r = static_cast<T>(__fdividef(1.0f, static_cast<float>(a)));
  for (int i = 0; i < (sizeof(T) == 8 ? 2 : 1); ++i) r = fma(r, fma(-a, r, T(1)), r);
  return r;
}
template <typename T>
__device__ __forceinline__ T rsqrt_nr(T a) {
  T r = static_cast<T>(rsqrtf(static_cast<float>(a)));
  for (int i = 0; i < (sizeof(T) == 8 ? 2 : 1); ++i) r = fma(T(0.5) * r, fma(-a * r, r, T(1)), r);
  return r;
}

template <typename T>
struct Rotation {
  T c, s, t;
};

// The Jacobi rotation J = [[c, s], [-s, c]] that makes J^T [[app, apq],
// [apq, aqq]] J diagonal (Golub and Van Loan, sym.schur2), t = s / c: with
// x = aqq - app and y = 2 apq, t = sign(x) y / (|x| + sqrt(x^2 + y^2)), a
// root of t^2 + 2 (x / y) t - 1 = 0 of magnitude at most 1 (sign(0) = 1).
// x and y are first scaled by the power of two that brings the larger into
// [1, 2): t does not change, and x^2 + y^2 lies in [1, 8).
template <typename T>
__device__ __forceinline__ Rotation<T> rotation(T app, T aqq, T apq) {
  if (apq == T(0)) return {T(1), T(0), T(0)};
  T x = aqq - app, y = T(2) * apq;
  normalize(x, y);
  const T sum = fma(x, x, y * y);
  const T t = (x >= T(0) ? y : -y) * recip(fabs(x) + sum * rsqrt_nr(sum));
  const T c = rsqrt_nr(fma(t, t, T(1)));
  return {c, t * c, t};
}

// The sum of every thread's v, in a fixed order, the same bits in every
// thread.  red: 32 elements of shared memory; the caller's next use of red
// must follow a barrier.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warps = (blockDim.x + 31) / 32;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  T total = T(0);
  for (int w = 0; w < warps; ++w) total += red[w];
  return total;
}

// Block (k, l), k < l, of H with its mirror: B <- J_k^T B J_l, rows pk, qk
// and columns pl, ql.  Each element that is a pair element of round rn goes
// to that pair's slot of o too.
template <typename T>
__device__ __forceinline__ void rotate_block(T* h, T* o, int m, int w, int rn, int pk, int qk,
                                             int pl, int ql, T ca, T sa, T cb, T sb) {
  const T b00 = h[pk * m + pl], b01 = h[pk * m + ql];
  const T b10 = h[qk * m + pl], b11 = h[qk * m + ql];
  const T r00 = ca * b00 - sa * b10, r01 = ca * b01 - sa * b11;
  const T r10 = sa * b00 + ca * b10, r11 = sa * b01 + ca * b11;
  const int ri[2] = {pk, qk}, ci[2] = {pl, ql};
  const T val[2][2] = {{r00 * cb - r01 * sb, r00 * sb + r01 * cb},
                       {r10 * cb - r11 * sb, r10 * sb + r11 * cb}};
#pragma unroll
  for (int y = 0; y < 2; ++y) {
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const int i = ri[y], j = ci[z];
      h[i * m + j] = val[y][z];
      h[j * m + i] = val[y][z];
      if (partner_of(i, rn, w) == j) o[slot_of(i, rn, w)] = val[y][z];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Block<T>::threads)
    gram_pinv_kernel(const Args args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int c = args.c;
  const int m = padded(c);
  const int w = m - 1;
  const int half = m / 2;
  T* h = smem;          // m x m
  T* v = h + m * m;     // c x m
  T* d = v + c * m;     // m: the diagonal
  T* o = d + m;         // half: each pair's off-diagonal element
  T* rot = o + half;    // 2 x half: each pair's c and s
  T* red = rot + m;     // 33
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * c * c;
  T* out = static_cast<T*>(args.out) + base;

  // H from the Grams' upper triangles, mirrored; padding zero.  The diagonal
  // and round 0's pair elements go to d and o; ||H||_F^2 and whether every
  // element is finite are reduced.
  T fro = T(0);
  int bad = 0;
  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m, j = e - i * m;
    if (i > j) continue;
    T x = T(0);
    if (j < c) {
      bool first = true;
      for (int k = 0; k < args.order; ++k) {
        if (k == args.mode) continue;
        const T g = static_cast<const T*>(args.g[k])[base + static_cast<size_t>(i) * c + j];
        x = first ? g : x * g;
        first = false;
      }
    }
    bad |= !isfinite(x);
    h[i * m + j] = x;
    h[j * m + i] = x;
    fro += i == j ? x * x : T(2) * x * x;
    if (i == j) {
      d[i] = x;
    } else if (partner_of(i, 0, w) == j) {
      o[slot_of(i, 0, w)] = x;
    }
  }
  for (int e = tid; e < c * m; e += nt) v[e] = (e / m == e % m) ? T(1) : T(0);
  if (__syncthreads_or(bad)) {
    for (int e = tid; e < c * c; e += nt) out[e] = T(NAN);
    return;
  }
  fro = block_sum(fro, red);
  const T tol = T(OFF_TOL * Eps<T>::value);
  const T stop = tol * tol * fro;

  // this thread's tasks, decoded once: k | l << 8 for block (k, l), k < l;
  // k | row << 8 | 1 << 16 for a row of V at pair k; -1 for none (the
  // blocks' padding).  Block t lies in rows k and half - 2 - k of the strict
  // triangle (half - 1 - k and k + 1 blocks long) laid end to end as one
  // row of half, the middle row of an even half alone.
  const int blocks = half * (half - 1) / 2;
  const int rows0 = warps_of(blocks);
  const int tasks = rows0 + c * half;
  const int held = (tasks + nt - 1) / nt;  // <= MAX_TASKS (checked at the launch)
  int task[MAX_TASKS];
#pragma unroll
  for (int j = 0; j < MAX_TASKS; ++j) {
    const int t = tid + j * nt;
    int code = -1;
    if (j < held && t < tasks) {
      if (t < blocks) {
        const int i = t / half, col = t - i * half;
        const int k = col < half - 1 - i ? i : half - 2 - i;
        const int l = col < half - 1 - i ? i + 1 + col : k + 1 + col - (half - 1 - i);
        code = k | l << 8;
      } else if (t >= rows0) {
        const int row = (t - rows0) / half, k = (t - rows0) - row * half;
        code = k | row << 8 | 1 << 16;
      }
    }
    task[j] = code;
  }

  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    for (int r = 0; r < w; ++r) {
      const int rn = r + 1 < w ? r + 1 : 0;  // the next round
      // each pair's rotation, once; its diagonal in place, its element zero
      for (int k = tid; k < half; k += nt) {
        int p, q;
        pair_of(k, r, w, p, q);
        const T app = d[p], aqq = d[q], apq = o[k];
        const Rotation<T> a = rotation(app, aqq, apq);
        rot[k] = a.c;
        rot[half + k] = a.s;
        d[p] = app - a.t * apq;
        d[q] = aqq + a.t * apq;
        h[p * m + q] = T(0);
        h[q * m + p] = T(0);
        // a pair meets again in the next round only at m = 2 (one pair, one
        // thread): o is read here by no other thread then
        if (partner_of(p, rn, w) == q) o[slot_of(p, rn, w)] = T(0);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < MAX_TASKS; ++j) {
        if (j >= held) break;
        const int code = task[j];
        if (code < 0) continue;
        const int k = code & 0xff, x = (code >> 8) & 0xff;
        int pk, qk;
        pair_of(k, r, w, pk, qk);
        const T ca = rot[k], sa = rot[half + k];
        if (code >> 16) {  // row x of V: V <- V J
          const T vp = v[x * m + pk], vq = v[x * m + qk];
          v[x * m + pk] = ca * vp - sa * vq;
          v[x * m + qk] = sa * vp + ca * vq;
        } else {
          int pl, ql;
          pair_of(x, r, w, pl, ql);
          rotate_block(h, o, m, w, rn, pk, qk, pl, ql, ca, sa, rot[x], rot[half + x]);
        }
      }
      __syncthreads();
    }
    // the off-diagonal norm, squared, over the upper triangle (twice)
    T part = T(0);
    for (int e = tid; e < m * m; e += nt) {
      const int i = e / m, j = e - i * m;
      if (i < j) part += h[e] * h[e];
    }
    const T off2 = T(2) * block_sum(part, red);
    if (off2 <= stop) break;
    __syncthreads();  // red is read by every thread before its next write
  }

  // the cutoff and the reciprocals kept (in rot), then P = V diag(wk) V^T
  T* wk = rot;
  T top = T(0);
  for (int i = 0; i < c; ++i) top = fmax(top, fabs(d[i]));
  const T cut = T(10.0 * c * Eps<T>::value) * top;
  for (int i = tid; i < m; i += nt) wk[i] = (i < c && fabs(d[i]) > cut) ? T(1) / d[i] : T(0);
  __syncthreads();
  for (int e = tid; e < c * c; e += nt) {
    const int a = e / c, b = e - a * c;
    if (a > b) continue;
    T acc = T(0);
    for (int i = 0; i < c; ++i) acc += v[a * m + i] * wk[i] * v[b * m + i];
    out[a * c + b] = acc;
    out[b * c + a] = acc;
  }
}

// Threads of a block at order c: one a task, in whole warps, at most the
// type's limit.
template <typename T>
int threads_for(int c) {
  const int warps = (tasks_of(c) + 31) / 32;
  return warps * 32 < Block<T>::threads ? warps * 32 : Block<T>::threads;
}

template <typename T>
int run(const void* const* grams, int order, int mode, int c, int batch, void* out,
        cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (grams == nullptr || out == nullptr || order < 2 || order > MAX_ORDER || mode < 0 ||
      mode >= order || c < 1 || c > 255 || batch < 1) {
    return invalid;
  }
  const size_t bytes = sizeof(T) * static_cast<size_t>(smem_elements(c));
  const int threads = threads_for<T>(c);
  if (bytes > SMEM_LIMIT || tasks_of(c) > MAX_TASKS * threads) return invalid;
  Args args{};
  for (int k = 0; k < order; ++k) {
    if (grams[k] == nullptr) return invalid;
    args.g[k] = grams[k];
  }
  args.out = out;
  args.order = order;
  args.mode = mode;
  args.c = c;
  if (bytes > 48 * 1024) {  // past the default a block may take
    const cudaError_t err = cudaFuncSetAttribute(
        gram_pinv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gram_pinv_kernel<T><<<batch, threads, bytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gram_pinv

// grams: order pointers to contiguous (batch, c, c) Grams of one type;
// mode: the Gram left out; out: (batch, c, c).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue, launching nothing, for an
// order outside 2..16, a mode outside it, a null pointer, or a c whose
// matrices do not fit a block's shared memory or whose round has more
// tasks than a block holds.
#define GRAM_PINV_ENTRY(T, SUFFIX)                                                        \
  extern "C" int gram_pinv_##SUFFIX(const void* const* grams, int order, int mode, int c, \
                                    int batch, void* out, void* stream) {                 \
    return gram_pinv::run<T>(grams, order, mode, c, batch, out,                           \
                             static_cast<cudaStream_t>(stream));                          \
  }

GRAM_PINV_ENTRY(float, f32)
GRAM_PINV_ENTRY(double, f64)
