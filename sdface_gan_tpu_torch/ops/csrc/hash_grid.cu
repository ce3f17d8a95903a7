// Multiresolution hash-grid kernels for Hopper (sm_90a): the encode forward,
// its backward and double backward, and a row gather.
//
// hash_encode_kernel replaces the forward of `hash_encode`
// (sdface_gan_tpu/ops/hash_encoder.py:205), which the JAX package leaves to
// XLA's gather (no Pallas kernel there).  For each (point, level) it maps the
// point to [0, 1], finds its cell, hashes (or densely indexes) the 8 corners
// and sums the corner rows weighted by the d-linear weights:
//
//   x01  = (x + bound) / (2 bound)            any x01 outside [0, 1] -> zeros
//   pos  = clip(x01) * scale_l + 0.5          cell = floor(pos), f = pos - cell
//   row  = (hash or dense index of cell + corner) % size_l + offset_l
//   out  = sum_k w_k * table[row_k]           w_k = prod_d (f_d or 1 - f_d)
//
// x01, pos and f use __fdiv_rn / __fmul_rn / __fadd_rn / __fsub_rn so that
// nvcc cannot contract them into FMAs: floor(pos) picks the corner rows, and
// a point on a cell face that moved by one rounding would read the
// neighbouring cell.  The weights are products in the order d = 0, 1, 2, as
// the plain version takes them.  Index arithmetic is uint32 and wraps, as the
// reference hash does (x*1 ^ y*2654435761 ^ z*805459861).
//
// What bounds it on this card: bytes.  Per (point, level) it reads 12 B of
// xyz (shared by the levels of a point, so once from memory) and writes
// C * sizeof(T) bytes; the table is read once in the bound's count.  The real
// cost is 8 random row reads per (point, level): the tables (1 MB on the
// tuned grid, 25 MB in bf16 on the upstream grid) sit in the 50 MB L2, so
// the kernel is bound by the L1/L2 requests of those reads and by the
// integer work that finds them, not by device memory.  One thread per
// (point, level), a point's levels on neighbouring lanes, would spread a
// warp over 2 points and 16 level tables on the upstream grid: every corner
// load its own sector, each point normalised once per level, a division by
// the table size per corner.  This design instead:
// * one block takes a tile of 256 consecutive points; a thread owns one
//   point, normalises it once and loops over the selected levels, so a
//   warp's 32 lanes are 32 consecutive points at one level.  The renderer's
//   flat order puts a ray's samples, then the neighbouring rays, next to
//   each other: at the coarse levels their corners coincide, so those loads
//   coalesce and hit L1;
// * the x-neighbour corners of a cell (k, k + 1) sit in one aligned pair of
//   rows when the row of k is even: on hashed levels an even x gives rows
//   r and r ^ 1, on dense levels `row` and `row + 1`.  Where the pair's
//   two rows fit one load (2 C sizeof(T) <= 16 bytes), corner k reads its
//   whole pair and corner k + 1 takes its row from that load when it is
//   the other half, else loads its own;
// * `% size` is a mask when the size is a power of two (every hashed
//   level), the same value as the division;
// * the output: a point's row is L * C * sizeof(T) bytes (64 B on the
//   upstream grid, 32 B on the tuned grid's two served levels).  A row of
//   one 32-byte sector goes out from its own lane, as 16-byte stores that
//   fill the sector.  Other rows are staged in shared memory a group of
//   levels at a time, level-major with one padding row per level
//   (conflict-free both ways), then written out so that a warp's stores
//   cover consecutive C * sizeof(T)-byte pieces of the tile's contiguous
//   rows.
// The arithmetic is fixed: x01, pos and f as above, weights multiplied
// d = 0, 1, 2, corners summed k = 0..7 with fmaf.

// hash_encode_backward_kernel (K1) and hash_encode_double_backward_kernel (K2)
// replace the gradient of `hash_encode` that the JAX package takes by
// autodiff (jax.grad of sdface_gan_tpu/ops/hash_encoder.py:205: XLA's
// deterministic scatter-add for the table, the interpolation weights'
// derivative for the points) and its explicit table VJP
// `hash_encode_vjp_sorted` (:245, a sort and a sorted segment sum).  With
// g = d loss / d enc [N, L * C] and, for K2, v = the cotangent of d x [N, 3]:
//
//   K1  d table[row_k] += w_k * g_l                         (every point, level, corner)
//       d x = tie / (2 bound) * sum_l scale_l * s'(f) * sum_k dw_k/df * <g_l, table[row_k]>
//   K2  q_k = sum_d u_d dw_k/df_d,   u_d = v_d * tie_d / (2 bound) * scale_l * s'(f_d)
//       d table[row_k] += q_k * g_l,  d g_l = sum_k q_k * table[row_k]
//
// tie_d is 1/2 where x01_d lies exactly on a face of the box (0 or 1), as
// jnp.clip's derivative splits a tie, else 1; s' is the smoothstep's
// derivative (1 for linear).  Points outside the box give zeros in every
// output.  The second-order term of K2 with respect to x (the d-linear
// weights' cross derivatives) is not computed: the callers' points are
// detached leaves with no parameter upstream.  Each output is written only
// when its pointer is not null.
//
// The table gradients are summed with atomicAdd into an f32 buffer that the
// caller zeroes (and casts once to a bf16 table's type): as the upstream
// CUDA encoder scatters (gridencoder.cu:249-336), not as XLA's
// deterministic scatter.  Their summation order is not deterministic, so
// reruns differ in the last bits; the plain version (the sorted segment
// sum) is deterministic.  The cell arithmetic is the forward's (__f*_rn, the
// same weights in the same order), so a point on a cell face takes the same
// corners, and the one-sided derivative of floor agrees with the plain one.
//
// What bounds them on this card: bytes in the count (x, g and v read once,
// the table read once, d table and d x or d g written once), but the real
// cost is L * 8 * C f32 atomics per point into the L2 (for the stage-A
// render of the tuned grid 786,432 x 4 x 8 x 8 = 201 M) and 8 random row
// reads per (point, level).  The design is the forward's simplest form: one
// point per thread, the levels in a loop, the corner rows recomputed.

// table_gather_kernel replaces the Pallas probe `probe_pallas_gather.kernel`
// (scripts/bench_packed_gather.py:128): `o = t[i, :][..., 0]`, a row gather
// from a table held on chip.  Its production form is the packed-level gather
// of `hash_encode_packed` (sdface_gan_tpu/ops/hash_encoder.py:477-478).  It
// copies bytes, so one kernel serves every element type: each thread moves
// one 16-byte chunk of one selected row slice with a 16-byte load and store
// when both addresses allow it, and element by element otherwise (the
// probe's single f32 column, or a ragged tail).  Indices are clamped to the
// table, as XLA's gather clamps them.  Bound: bytes (indices read once,
// selected rows read once, output written once); on the packed NGP table
// the 9.35 MB of rows stay in L2, so the output write dominates.
//
// C interface for ctypes: each *_forward returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kStageBytes = 16384;  // the encode's output tile per level group

struct Level {
  float scale;
  unsigned side, size, offset, use_hash;
};

struct Levels {
  Level l[kMaxLevels];
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
};

// The widest load whose size divides kBytes (and so every row's offset).
template <int kBytes>
struct Vec {
  using type = typename std::conditional<
      kBytes % 16 == 0, uint4,
      typename std::conditional<
          kBytes % 8 == 0, uint2,
          typename std::conditional<kBytes % 4 == 0, unsigned int,
                                    unsigned short>::type>::type>::type;
};

template <typename T, int C>
__device__ __forceinline__ void load_row(const T* __restrict__ table, size_t r, float (&v)[C]) {
  constexpr int kBytes = C * sizeof(T);
  using V = typename Vec<kBytes>::type;
  alignas(16) T row[C];
  const V* src = reinterpret_cast<const V*>(table + (size_t)r * C);
#pragma unroll
  for (int q = 0; q < kBytes / (int)sizeof(V); ++q) reinterpret_cast<V*>(row)[q] = __ldg(src + q);
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = Elem<T>::to_float(row[c]);
}

// The rows r0 and r1 of the x-neighbour corners k, k + 1.  Where two rows
// fit one load, r0's aligned pair is read whole, and r1 comes from it when
// it is r0's other half (r1 == r0 ^ 1), from its own load otherwise.
template <typename T, int C>
__device__ __forceinline__ void load_corner_pair(const T* __restrict__ table, unsigned r0,
                                                 unsigned r1, float (&v0)[C], float (&v1)[C]) {
  constexpr int kBytes = C * sizeof(T);
  if constexpr (2 * kBytes <= 16) {
    using P = typename Vec<2 * kBytes>::type;
    alignas(16) T pair[2 * C];
    *reinterpret_cast<P*>(pair) = __ldg(reinterpret_cast<const P*>(table + (size_t)(r0 & ~1u) * C));
    const bool odd = r0 & 1u;
#pragma unroll
    for (int c = 0; c < C; ++c) v0[c] = Elem<T>::to_float(odd ? pair[C + c] : pair[c]);
    if (r1 == (r0 ^ 1u)) {
#pragma unroll
      for (int c = 0; c < C; ++c) v1[c] = Elem<T>::to_float(odd ? pair[c] : pair[C + c]);
    } else {
      load_row<T, C>(table, r1, v1);
    }
  } else {
    load_row<T, C>(table, r0, v0);
    load_row<T, C>(table, r1, v1);
  }
}

// One level of one point inside the box: acc = sum_k w_k * table[row_k].
template <typename T, int C>
__device__ __forceinline__ void encode_level(const Level& lv, const float (&x01)[3], float half,
                                             int smoothstep, const T* __restrict__ table,
                                             float (&acc)[C]) {
  unsigned cell[3];
  float frac[3], one_minus[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float xc = fminf(fmaxf(x01[d], 0.0f), 1.0f);
    const float pos = __fadd_rn(__fmul_rn(xc, lv.scale), half);
    const float base = floorf(pos);
    float f = __fsub_rn(pos, base);
    if (smoothstep) f = __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.0f, __fmul_rn(2.0f, f)));
    cell[d] = (unsigned)base;
    frac[d] = f;
    one_minus[d] = __fsub_rn(1.0f, f);
  }
  const bool pow2 = (lv.size & (lv.size - 1u)) == 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    const unsigned c1 = cell[1] + ((k >> 1) & 1);
    const unsigned c2 = cell[2] + ((k >> 2) & 1);
    unsigned r[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const unsigned c0 = cell[0] + u;
      const unsigned idx = lv.use_hash
          ? (c0 ^ (c1 * 2654435761u) ^ (c2 * 805459861u))
          : (c0 + c1 * lv.side + c2 * (lv.side * lv.side));
      r[u] = (pow2 ? idx & (lv.size - 1u) : idx % lv.size) + lv.offset;
    }
    float v[2][C];
    load_corner_pair<T, C>(table, r[0], r[1], v[0], v[1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float w = __fmul_rn(
          __fmul_rn(u ? frac[0] : one_minus[0], ((k >> 1) & 1) ? frac[1] : one_minus[1]),
          ((k >> 2) & 1) ? frac[2] : one_minus[2]);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(w, v[u][c], acc[c]);
    }
  }
}

// kDirect: each lane writes its point's output row itself (launch_encode
// picks it for rows of one 32-byte sector); else the rows are staged.
template <typename T, int C, bool kDirect>
__global__ void __launch_bounds__(kThreads)
hash_encode_kernel(const float* __restrict__ x, const T* __restrict__ table,
                   T* __restrict__ out, long long n_points, int n_levels,
                   float bound, float half, int smoothstep, Levels levels) {
  constexpr int kBytes = C * sizeof(T);  // one level's row of one point
  using V = typename Vec<kBytes>::type;
  constexpr int kVecs = kBytes / sizeof(V);
  constexpr int kGroup = kDirect ? kMaxLevels : kStageBytes / (kThreads * kBytes);
  // stage[(g * (kThreads + 1) + p) * kVecs + q]: level g of the group, point
  // p.  The direct kernel keeps no stage: shared memory taken from the L1
  // would cost its coherent corner reads more than the staging saves.
  __shared__ V stage[kDirect ? 1 : kGroup * (kThreads + 1) * kVecs];

  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kThreads;
  const int n_valid = (int)min((long long)kThreads, n_points - p0);

  // the thread's point, mapped to [0, 1] once for all levels
  const float two_bound = __fmul_rn(2.0f, bound);
  float x01[3];
  bool oob = tid >= n_valid;
  if (!oob) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      x01[d] = __fdiv_rn(__fadd_rn(__ldg(x + (p0 + tid) * 3 + d), bound), two_bound);
      oob |= (x01[d] < 0.0f) || (x01[d] > 1.0f);
    }
  }

  V* out_v = reinterpret_cast<V*>(out);
  for (int l0 = 0; l0 < n_levels; l0 += kGroup) {
    const int n_group = min(kGroup, n_levels - l0);
    for (int g = 0; g < n_group; ++g) {
      float acc[C];
      if (oob) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = 0.0f;
      } else {
        encode_level<T, C>(levels.l[l0 + g], x01, half, smoothstep, table, acc);
      }
      alignas(16) T row[C];
#pragma unroll
      for (int c = 0; c < C; ++c) row[c] = Elem<T>::from_float(acc[c]);
#pragma unroll
      for (int q = 0; q < kVecs; ++q) {
        const V v = reinterpret_cast<const V*>(row)[q];
        if (!kDirect)
          stage[(g * (kThreads + 1) + tid) * kVecs + q] = v;
        else if (tid < n_valid)
          out_v[((p0 + tid) * n_levels + l0 + g) * kVecs + q] = v;
      }
    }
    if (kDirect) continue;
    __syncthreads();
    // the group's columns of the tile's rows; with every level in one group
    // (both served grids) the tile's output is one contiguous run
    const int units = n_group * kVecs;  // per point
    for (int i = tid; i < n_valid * units; i += kThreads) {
      const int p = i / units, rem = i - p * units, g = rem / kVecs, q = rem - g * kVecs;
      out_v[((p0 + p) * n_levels + l0 + g) * kVecs + q] =
          stage[(g * (kThreads + 1) + p) * kVecs + q];
    }
    __syncthreads();  // the stage is free for the next group
  }
}

template <typename T, int C>
int launch_encode(const void* x, const void* table, void* out, long long n_points,
                  int n_levels, float bound, float half, int smoothstep,
                  const Levels& levels, cudaStream_t stream) {
  const long long blocks = (n_points + kThreads - 1) / kThreads;  // one point per thread
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // A point's row of one 32-byte sector (the tuned grid's two served levels)
  // goes out from its own lane as 16-byte stores that fill the sector.  Other
  // rows are staged so that a warp's stores are contiguous: lanes writing 16
  // bytes at a wider stride leave half-written sectors.
  constexpr int kBytes = C * sizeof(T);
  if (kBytes >= 16 && n_levels * kBytes <= 32)
    hash_encode_kernel<T, C, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const float*)x, (const T*)table, (T*)out, n_points, n_levels, bound, half,
        smoothstep, levels);
  else
    hash_encode_kernel<T, C, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const float*)x, (const T*)table, (T*)out, n_points, n_levels, bound, half,
        smoothstep, levels);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_encode(int C, const void* x, const void* table, void* out,
                    long long n_points, int n_levels, float bound, float half,
                    int smoothstep, const Levels& levels, cudaStream_t s) {
  switch (C) {
    case 1: return launch_encode<T, 1>(x, table, out, n_points, n_levels, bound, half, smoothstep, levels, s);
    case 2: return launch_encode<T, 2>(x, table, out, n_points, n_levels, bound, half, smoothstep, levels, s);
    case 4: return launch_encode<T, 4>(x, table, out, n_points, n_levels, bound, half, smoothstep, levels, s);
    case 8: return launch_encode<T, 8>(x, table, out, n_points, n_levels, bound, half, smoothstep, levels, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The 8 corners of one level of a point inside the box: table rows,
// d-linear weights, the factors (1 - f, f) per axis and d f / d pos.
struct Corners {
  unsigned row[8];
  float w[8];
  float fac[2][3];  // fac[0][d] = 1 - f_d, fac[1][d] = f_d
  float dfrac[3];   // d f_d / d pos_d: 1, or the smoothstep's derivative
};

__device__ __forceinline__ void level_corners(const Level& lv, const float (&x01)[3],
                                              float half, int smoothstep, Corners& cr) {
  unsigned cell[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float xc = fminf(fmaxf(x01[d], 0.0f), 1.0f);
    const float pos = __fadd_rn(__fmul_rn(xc, lv.scale), half);
    const float base = floorf(pos);
    float f = __fsub_rn(pos, base);
    cr.dfrac[d] = 1.0f;
    if (smoothstep) {  // s = f f (3 - 2 f), s' = (f + f)(3 - 2 f) - 2 f f
      const float ff = __fmul_rn(f, f), b = __fsub_rn(3.0f, __fmul_rn(2.0f, f));
      cr.dfrac[d] = __fsub_rn(__fmul_rn(__fadd_rn(f, f), b), __fmul_rn(2.0f, ff));
      f = __fmul_rn(ff, b);
    }
    cell[d] = (unsigned)base;
    cr.fac[1][d] = f;
    cr.fac[0][d] = __fsub_rn(1.0f, f);
  }
  const bool pow2 = (lv.size & (lv.size - 1u)) == 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b0 = k & 1, b1 = (k >> 1) & 1, b2 = (k >> 2) & 1;
    const unsigned c0 = cell[0] + b0, c1 = cell[1] + b1, c2 = cell[2] + b2;
    const unsigned idx = lv.use_hash
        ? (c0 ^ (c1 * 2654435761u) ^ (c2 * 805459861u))
        : (c0 + c1 * lv.side + c2 * (lv.side * lv.side));
    cr.row[k] = (pow2 ? idx & (lv.size - 1u) : idx % lv.size) + lv.offset;
    cr.w[k] = __fmul_rn(__fmul_rn(cr.fac[b0][0], cr.fac[b1][1]), cr.fac[b2][2]);
  }
}

// d w_k / d f_d for the three axes.
__device__ __forceinline__ void weight_derivs(const Corners& cr, int k, float (&dw)[3]) {
  const int b0 = k & 1, b1 = (k >> 1) & 1, b2 = (k >> 2) & 1;
  const float p12 = __fmul_rn(cr.fac[b1][1], cr.fac[b2][2]);
  const float p02 = __fmul_rn(cr.fac[b0][0], cr.fac[b2][2]);
  const float p01 = __fmul_rn(cr.fac[b0][0], cr.fac[b1][1]);
  dw[0] = b0 ? p12 : -p12;
  dw[1] = b1 ? p02 : -p02;
  dw[2] = b2 ? p01 : -p01;
}

// The point mapped to [0, 1] as the forward maps it; whether it lies
// outside the box; and d x01 / d x with jnp.clip's half derivative on a face.
__device__ __forceinline__ bool map_point(const float* __restrict__ x, long long p,
                                          float bound, float (&x01)[3], float (&dx01)[3]) {
  const float two_bound = __fmul_rn(2.0f, bound);
  bool oob = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    x01[d] = __fdiv_rn(__fadd_rn(__ldg(x + p * 3 + d), bound), two_bound);
    oob |= (x01[d] < 0.0f) || (x01[d] > 1.0f);
    const float tie = (x01[d] == 0.0f || x01[d] == 1.0f) ? 0.5f : 1.0f;
    dx01[d] = __fdiv_rn(tie, two_bound);
  }
  return oob;
}

template <typename T, int C>
__device__ __forceinline__ void store_row(T* __restrict__ out, size_t r, const float (&v)[C]) {
  constexpr int kBytes = C * sizeof(T);
  using V = typename Vec<kBytes>::type;
  alignas(16) T row[C];
#pragma unroll
  for (int c = 0; c < C; ++c) row[c] = Elem<T>::from_float(v[c]);
  V* dst = reinterpret_cast<V*>(out + r * C);
#pragma unroll
  for (int q = 0; q < kBytes / (int)sizeof(V); ++q) dst[q] = reinterpret_cast<const V*>(row)[q];
}

// K1.  dx (f32 [N, 3]) and dtable (f32 [T, C], zeroed by the caller) may
// each be null; the table is read only for dx.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
hash_encode_backward_kernel(const float* __restrict__ x, const T* __restrict__ table,
                            const T* __restrict__ g, float* __restrict__ dx,
                            float* __restrict__ dtable, long long n_points, int n_levels,
                            float bound, float half, int smoothstep, Levels levels) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_points) return;
  float x01[3], dx01[3];
  if (map_point(x, p, bound, x01, dx01)) {
    if (dx)
      for (int d = 0; d < 3; ++d) dx[p * 3 + d] = 0.0f;
    return;
  }
  float gx[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < n_levels; ++l) {
    const Level& lv = levels.l[l];
    Corners cr;
    level_corners(lv, x01, half, smoothstep, cr);
    float gl[C];
    load_row<T, C>(g, (size_t)p * n_levels + l, gl);
    if (dtable) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float* dst = dtable + (size_t)cr.row[k] * C;
#pragma unroll
        for (int c = 0; c < C; ++c) atomicAdd(dst + c, __fmul_rn(cr.w[k], gl[c]));
      }
    }
    if (dx) {
      float gf[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float v[C], dw[3];
        load_row<T, C>(table, cr.row[k], v);
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) dot = fmaf(gl[c], v[c], dot);
        weight_derivs(cr, k, dw);
#pragma unroll
        for (int d = 0; d < 3; ++d) gf[d] = fmaf(dot, dw[d], gf[d]);
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) gx[d] = fmaf(__fmul_rn(gf[d], cr.dfrac[d]), lv.scale, gx[d]);
    }
  }
  if (dx)
    for (int d = 0; d < 3; ++d) dx[p * 3 + d] = __fmul_rn(gx[d], dx01[d]);
}

// K2.  v is the cotangent of K1's dx; dtable (f32, zeroed by the caller)
// and dg ([N, L * C] in the table's type) may each be null.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
hash_encode_double_backward_kernel(const float* __restrict__ x, const T* __restrict__ table,
                                   const T* __restrict__ g, const float* __restrict__ v,
                                   float* __restrict__ dtable, T* __restrict__ dg,
                                   long long n_points, int n_levels, float bound, float half,
                                   int smoothstep, Levels levels) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_points) return;
  float x01[3], dx01[3];
  if (map_point(x, p, bound, x01, dx01)) {
    if (dg) {
      const float zeros[C] = {};
      for (int l = 0; l < n_levels; ++l) store_row<T, C>(dg, (size_t)p * n_levels + l, zeros);
    }
    return;
  }
  float vs[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) vs[d] = __fmul_rn(__ldg(v + p * 3 + d), dx01[d]);
  for (int l = 0; l < n_levels; ++l) {
    const Level& lv = levels.l[l];
    Corners cr;
    level_corners(lv, x01, half, smoothstep, cr);
    float u[3], q[8];
#pragma unroll
    for (int d = 0; d < 3; ++d) u[d] = __fmul_rn(__fmul_rn(vs[d], lv.scale), cr.dfrac[d]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float dw[3];
      weight_derivs(cr, k, dw);
      q[k] = fmaf(u[2], dw[2], fmaf(u[1], dw[1], __fmul_rn(u[0], dw[0])));
    }
    if (dtable) {
      float gl[C];
      load_row<T, C>(g, (size_t)p * n_levels + l, gl);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float* dst = dtable + (size_t)cr.row[k] * C;
#pragma unroll
        for (int c = 0; c < C; ++c) atomicAdd(dst + c, __fmul_rn(q[k], gl[c]));
      }
    }
    if (dg) {
      float acc[C] = {};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float tv[C];
        load_row<T, C>(table, cr.row[k], tv);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(q[k], tv[c], acc[c]);
      }
      store_row<T, C>(dg, (size_t)p * n_levels + l, acc);
    }
  }
}

struct GradArgs {
  const void *x, *table, *g, *v;
  void *dx, *dtable, *dg;
  long long n_points;
  int n_levels;
  float bound, half;
  int smoothstep;
};

template <typename T, int C>
int launch_grad(bool second, const GradArgs& a, const Levels& levels, cudaStream_t stream) {
  const long long blocks = (a.n_points + kThreads - 1) / kThreads;  // one point per thread
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (second)
    hash_encode_double_backward_kernel<T, C><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const float*)a.x, (const T*)a.table, (const T*)a.g, (const float*)a.v,
        (float*)a.dtable, (T*)a.dg, a.n_points, a.n_levels, a.bound, a.half, a.smoothstep,
        levels);
  else
    hash_encode_backward_kernel<T, C><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const float*)a.x, (const T*)a.table, (const T*)a.g, (float*)a.dx, (float*)a.dtable,
        a.n_points, a.n_levels, a.bound, a.half, a.smoothstep, levels);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_grad(int C, bool second, const GradArgs& a, const Levels& levels,
                  cudaStream_t s) {
  switch (C) {
    case 1: return launch_grad<T, 1>(second, a, levels, s);
    case 2: return launch_grad<T, 2>(second, a, levels, s);
    case 4: return launch_grad<T, 4>(second, a, levels, s);
    case 8: return launch_grad<T, 8>(second, a, levels, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The selected levels' geometry as the kernels take it; false on bad input.
bool make_levels(int n_levels, const float* scales, const unsigned* sides,
                 const unsigned* sizes, const unsigned* offsets, const unsigned* use_hash,
                 Levels& levels) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  for (int l = 0; l < n_levels; ++l) {
    if (sizes[l] == 0) return false;
    levels.l[l] = Level{scales[l], sides[l], sizes[l], offsets[l], use_hash[l]};
  }
  return true;
}

template <typename E>
__device__ __forceinline__ void copy_elems(const char* src, char* dst, int nbytes) {
  for (int b = 0; b < nbytes; b += (int)sizeof(E))
    *reinterpret_cast<E*>(dst + b) = *reinterpret_cast<const E*>(src + b);
}

__global__ void __launch_bounds__(kThreads)
table_gather_kernel(const char* __restrict__ table, const int* __restrict__ idx,
                    char* __restrict__ out, long long n_idx, int n_rows,
                    int row_bytes, int col_bytes, int out_bytes, int elsize) {
  const int chunks = (out_bytes + 15) / 16;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_idx * chunks) return;
  const long long i = t / chunks;
  const int c = (int)(t - i * chunks);
  int r = __ldg(idx + i);
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  const char* src = table + (size_t)r * row_bytes + col_bytes + c * 16;
  char* dst = out + i * out_bytes + c * 16;
  const int nbytes = min(16, out_bytes - c * 16);
  if (nbytes == 16 && ((reinterpret_cast<uintptr_t>(src) |
                        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else if (elsize == 4) {
    copy_elems<unsigned int>(src, dst, nbytes);
  } else {
    copy_elems<unsigned short>(src, dst, nbytes);
  }
}

}  // namespace

extern "C" {

// x: f32 [n_points, 3]; table: [T, C] bf16 (table_bf16 = 1) or f32; out:
// [n_points, n_levels * C] in the table's type.  Per selected level: its
// f32 scale, dense side, table slice size and offset, and whether it hashes.
int hash_encode_forward(int table_bf16, const void* x, const void* table, void* out,
                        long long n_points, int n_levels, int C, float bound,
                        int align_corners, int smoothstep, const float* scales,
                        const unsigned* sides, const unsigned* sizes,
                        const unsigned* offsets, const unsigned* use_hash,
                        void* stream) {
  Levels levels;
  if (n_points < 1 || !make_levels(n_levels, scales, sides, sizes, offsets, use_hash, levels))
    return (int)cudaErrorInvalidValue;
  const float half = align_corners ? 0.0f : 0.5f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_bf16)
    return dispatch_encode<__nv_bfloat16>(C, x, table, out, n_points, n_levels,
                                          bound, half, smoothstep, levels, s);
  return dispatch_encode<float>(C, x, table, out, n_points, n_levels, bound, half,
                                smoothstep, levels, s);
}

// K1: g is d loss / d out [n_points, n_levels * C] in the table's type; dx
// f32 [n_points, 3] and dtable f32 [T, C] (zeroed by the caller) may each be
// null.  The level arguments are hash_encode_forward's.
int hash_encode_backward(int table_bf16, const void* x, const void* table, const void* g,
                         void* dx, void* dtable, long long n_points, int n_levels, int C,
                         float bound, int align_corners, int smoothstep, const float* scales,
                         const unsigned* sides, const unsigned* sizes,
                         const unsigned* offsets, const unsigned* use_hash, void* stream) {
  Levels levels;
  if (n_points < 1 || !make_levels(n_levels, scales, sides, sizes, offsets, use_hash, levels))
    return (int)cudaErrorInvalidValue;
  const GradArgs a{x, table, g, nullptr, dx, dtable, nullptr, n_points, n_levels, bound,
                   align_corners ? 0.0f : 0.5f, smoothstep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return table_bf16 ? dispatch_grad<__nv_bfloat16>(C, false, a, levels, s)
                    : dispatch_grad<float>(C, false, a, levels, s);
}

// K2: v f32 [n_points, 3] is the cotangent of K1's dx; dtable f32 [T, C]
// (zeroed by the caller) and dg [n_points, n_levels * C] in the table's type
// may each be null.
int hash_encode_double_backward(int table_bf16, const void* x, const void* table,
                                const void* g, const void* v, void* dtable, void* dg,
                                long long n_points, int n_levels, int C, float bound,
                                int align_corners, int smoothstep, const float* scales,
                                const unsigned* sides, const unsigned* sizes,
                                const unsigned* offsets, const unsigned* use_hash,
                                void* stream) {
  Levels levels;
  if (n_points < 1 || !make_levels(n_levels, scales, sides, sizes, offsets, use_hash, levels))
    return (int)cudaErrorInvalidValue;
  const GradArgs a{x, table, g, v, nullptr, dtable, dg, n_points, n_levels, bound,
                   align_corners ? 0.0f : 0.5f, smoothstep};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return table_bf16 ? dispatch_grad<__nv_bfloat16>(C, true, a, levels, s)
                    : dispatch_grad<float>(C, true, a, levels, s);
}

// out[i, :] = bytes [col_bytes, col_bytes + out_bytes) of table row
// clamp(idx[i], 0, n_rows - 1); rows are row_bytes apart; elsize is 2 or 4.
int table_gather_forward(const void* table, const void* idx, void* out,
                         long long n_idx, int n_rows, int row_bytes, int col_bytes,
                         int out_bytes, int elsize, void* stream) {
  if (n_idx < 1 || n_rows < 1 || out_bytes < 1 || (elsize != 2 && elsize != 4) ||
      out_bytes % elsize || col_bytes + out_bytes > row_bytes)
    return (int)cudaErrorInvalidValue;
  const long long threads = n_idx * ((out_bytes + 15) / 16);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  table_gather_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      (const char*)table, (const int*)idx, (char*)out, n_idx, n_rows, row_bytes,
      col_bytes, out_bytes, elsize);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
