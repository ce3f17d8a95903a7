// Fused FiLM-SIREN field for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_siren_kernel` driven by
// `siren_field_fused_parts` (sdface_gan_tpu/ops/siren_kernel.py).  For each
// point, with gamma/beta computed per batch element outside the kernel:
//
//   h_0 = fast_sin(g_0 * (xyz . W_0 + b_0) + be_0)
//   h_l = fast_sin(g_l * (h_{l-1} . W_l + b_l) + be_l)          l = 1 .. D-1
//   sdf = h_{D-1} . W_sdf + b_sdf
//   f   = fast_sin(g_D * (h_{D-1} . Wv_h + dirs . Wv_d + b_v) + be_D)  -> feat
//   rgb = f . W_rgb + b_rgb
//
// Every product rounds its operands to the dot type (bf16 or f32) and
// accumulates in f32; FiLM and the sine run in f32; each activation is
// rounded to the dot type before the next product.
//
// What bounds it on this card: the work is ~1.05 MFLOP per point against
// ~554 B of device-memory traffic (bf16 feature out), so it is bound by
// operations.  Two kernels, chosen by the dot type alone:
//
// * bf16: siren_field_mma_kernel, on the tensor cores.  At the served shape
//   (W = 256, D = 8, 786,432 points) the products are 828.66 GFLOP, 0.838 ms
//   at the card's 989 TFLOP/s bf16; the FiLM-sine epilogue is 786,432 x 9 x
//   256 = 1.81 G evaluations of ~14 f32 instructions, ~0.75 ms on the FP32
//   pipes, which this design does not overlap with the products.
//   One block of 8 warps (256 threads) takes a tile of `rows` points of one
//   batch element (a tile never crosses an element, since gamma/beta differ
//   per element).  Each warp owns a 64 x 64 block of a layer's output, so
//   rows = 64 * floor(8 / (W / 64)): 512 at W = 64, 256 at 128, 128 at 192
//   and 256 (six of the eight warps work at 192), 64 at 320..512.  The
//   tile's activations stay in one bf16 shared buffer h [rows, W + 8]
//   (the 8-element pad keeps ldmatrix free of bank conflicts), updated in
//   place: the K loop, a barrier, the epilogue writes h, a barrier.  The
//   W x W matrices (D - 1 hidden, then the views layer's point rows) stream
//   through shared memory as one sequence of [64, W + 8] K-chunks in a
//   2-stage cp.async ring (the next chunk, across layer boundaries too,
//   loads while this one is multiplied; a deeper ring measured no faster),
//   read straight from the [in, out] layout with ldmatrix.x4.trans; A comes
//   from h with ldmatrix.x4; the products are mma.sync.m16n8k16 bf16 -> f32
//   into 4 x 8 m16n8 accumulator tiles per warp (128 registers).  W is a
//   template parameter (one instantiation per width), so tile geometry and
//   copy indices are constants.  Every block reads all ~1.05 MB of weights
//   from L2 once per request: ~6.5 GB at 128 rows, which is why the tile is
//   not smaller.  The small layers stay on the FMA pipes: 3 -> W first
//   layer, the views layer's direction rows (added in its epilogue), the
//   sdf and rgb heads (warp reductions over h).  The feature goes out from
//   h as coalesced 16-byte stores.  Shared memory per block, rows x 32 B of
//   inputs + (rows + 128) x (W + 8) x 2 B: 108,544 B at W = 64, 112,640 at
//   128, 106,496 at 192, 139,264 at 256, 128,000 at 320, 152,576 at 384,
//   177,152 at 448, 201,728 at 512 (the card allows 232,448).
//
// * f32: siren_field_f32_kernel<W>, on the FMA pipes, f32 throughout.  At
//   the served shape the products are the same 828.66 GFLOP: 12.37 ms at
//   the card's 67 TFLOP/s FP32, plus the same ~0.76 ms of FiLM-sine
//   epilogue on those pipes.  The tensor cores would make an f32 product
//   TF32, which cannot hold the f32 contract; 3xTF32 on mma.sync takes three
//   products at half the bf16 rate, ~12-13 ms for the products alone by the
//   bf16 kernel's measured 2.1 ms mma.sync phase: no better than the FMA
//   bound, and more code.  The design is the bf16 kernel's with f32 parts.
//   One block of 8 warps takes a tile of `rows` points of one batch element;
//   each working thread holds an 8-point x 16-column register block (128 f32
//   accumulators) fed by outer products from shared memory: 512 FMAs per 24
//   16-byte shared loads, conflict-free (a warp's rows are neighbours in a
//   buffer padded by 4 floats per row, its column quads contiguous).  The
//   activations stay in one f32 buffer h [rows, W + 4], updated in place
//   (K loop, barrier, epilogue writes h, barrier).  The W x W matrices
//   stream through a 2-stage cp.async ring of [kc, W] f32 K-chunks, across
//   layer boundaries too, so every block reads the ~2.1 MB of f32 weights
//   from L2 once per tile (~12.9 GB per request at 128 rows) while it
//   multiplies the chunk before.  rows = 8 * floor(256 / (W / 16)): 512 at
//   W = 64, 256 at 128, 168 at 192, 128 at 256, 96 at 320, 80 at 384, 72 at
//   448, 64 at 512 (at 192, 320, 384 and 448 a few threads only copy);
//   kc = 32 up to W = 384, 16 above.  Shared memory per block, rows x (W +
//   12) x 4 B + 2 x kc x W x 4 B: 172,032 B at W = 64, 176,128 at 128,
//   186,240 at 192, 202,752 at 256, 209,408 at 320, 225,024 at 384, 189,824
//   at 448, 199,680 at 512.  The small layers run as in the bf16 kernel.
//
// C interface for ctypes: siren_field_forward(...) returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr float kS1 = 9.9999959990e-01f;
constexpr float kS3 = -1.6666552631e-01f;
constexpr float kS5 = 8.3324029612e-03f;
constexpr float kS7 = -1.9808632624e-04f;
constexpr float kS9 = 2.6997138288e-06f;
constexpr float kS11 = -2.0362212148e-08f;

// sdface_gan_tpu/ops/transcendental.py fast_sin: f32 round-half-even range
// reduction to [-pi, pi] (kept unfused, as the plain version computes it),
// then the degree-11 odd polynomial.
__device__ __forceinline__ float fast_sin(float x) {
  const float r = rintf(__fmul_rn(x, kInvTwoPi));
  x = __fsub_rn(x, __fmul_rn(r, kTwoPi));
  const float x2 = __fmul_rn(x, x);
  float p = fmaf(kS11, x2, kS9);
  p = fmaf(p, x2, kS7);
  p = fmaf(p, x2, kS5);
  p = fmaf(p, x2, kS3);
  p = fmaf(p, x2, kS1);
  return __fmul_rn(x, p);
}

template <typename WT>
struct FieldArgs {
  const float* pts;    // [B, P, 3]
  const float* views;  // [B, P, 3]
  const WT* w_first;   // [3, W]      weights are [in, out], row-major
  const float* b_first;  // [W]
  const WT* w_hidden;  // [D-1, W, W]
  const float* b_hidden;  // [D-1, W]
  const WT* wv_h;      // [W, W]  views layer, point-feature rows
  const WT* wv_d;      // [3, W]  views layer, view-direction rows
  const float* b_v;    // [W]
  const WT* w_sdf;     // [W]
  const float* b_sdf;  // [1]
  const WT* w_rgb;     // [W, 3]
  const float* b_rgb;  // [3]
  const float* gamma;  // [B, D+1, W]  rows 0..D-1 pts layers, row D views
  const float* beta;   // [B, D+1, W]
  float* rgb;          // [B, P, 3]
  float* sdf;          // [B, P]
  WT* feat;            // [B, P, W]
  int P, D, W;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kThreads = 256;  // 8 warps, in both kernels

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- f32, FMA pipes

constexpr int kF32BlocksPerSM = 1;

// Tile geometry of siren_field_f32_kernel<W>.  Each of the kCols x
// kRowThreads working threads holds a kTM-point x 16-column register block
// of a layer's output (128 f32 accumulators); the other threads of the
// block only copy and synchronise.
template <int W>
struct F32Tile {
  static constexpr int kTM = 8;                         // points per thread
  static constexpr int kCols = W / 16;                  // threads across the columns
  static constexpr int kRowThreads = kThreads / kCols;  // threads down the rows
  static constexpr int kWorking = kCols * kRowThreads;
  static constexpr int rows = kTM * kRowThreads;        // points per tile
  static constexpr int ld = W + 4;                      // h row pitch, in floats
  static constexpr int kc = W <= 384 ? 32 : 16;         // K rows per weight chunk
  static constexpr int n_chunk = W / kc;                // weight chunks per matrix
  static constexpr int kRing = 2;                       // weight ring depth
  static constexpr size_t smem =
      sizeof(float) * ((size_t)rows * 8 + (size_t)rows * ld + (size_t)kRing * kc * W);
  static_assert(smem * kF32BlocksPerSM <= 232448, "shared memory of the blocks of one SM");
  static_assert(kc * W / 4 % kThreads == 0, "whole 16-byte copies per thread");
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Start the cp.async copy of f32 weight chunk c into its ring stage when c
// is a chunk (c < total), and commit a group either way so that the wait
// counts stay uniform.  Chunk c is rows [k0, k0 + kc) of matrix c / n_chunk:
// hidden matrices 0 .. D-2, then the views layer's point rows.
template <int W>
__device__ __forceinline__ void fetch_f32_chunk(const float* w_hidden, const float* wv_h, int D,
                                                float* ring, int c, int total) {
  using G = F32Tile<W>;
  constexpr int per_row = W / 4;  // 16-byte pieces per weight row
  if (c < total) {
    const int mat = c / G::n_chunk, k0 = (c % G::n_chunk) * G::kc;
    const float* src = (mat < D - 1 ? w_hidden + (size_t)mat * W * W : wv_h) + (size_t)k0 * W;
    float* dst = ring + (c % G::kRing) * G::kc * W;
#pragma unroll
    for (int j = 0; j < G::kc * per_row / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      cp_async16(dst + i * 4, src + i * 4);  // the chunk is contiguous in both
    }
  }
  cp_async_commit();
}

// acc[i][4 q + u] is the output at row tr + i * kRowThreads, column
// q * 4 kCols + 4 tc + u.  h[r, col] = fast_sin(g * (z + bias) + e), z the
// product (plus, for the views layer, the direction rows' 3 -> W product).
template <int W, bool kViews>
__device__ __forceinline__ void film_sine_f32(const float (&acc)[F32Tile<W>::kTM][16], float* h,
                                              const float* g, const float* e,
                                              const float* bias, const float* xin,
                                              const float* wv_d, int tr, int tc) {
  using G = F32Tile<W>;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = q * 4 * G::kCols + 4 * tc;
    const float4 gg = ldg4(g + col), ee = ldg4(e + col), bb = ldg4(bias + col);
    float4 w0, w1, w2;
    if (kViews) {
      w0 = ldg4(wv_d + col);
      w1 = ldg4(wv_d + W + col);
      w2 = ldg4(wv_d + 2 * W + col);
    }
#pragma unroll
    for (int i = 0; i < G::kTM; ++i) {
      const int r = tr + i * G::kRowThreads;
      float z0 = acc[i][4 * q], z1 = acc[i][4 * q + 1];
      float z2 = acc[i][4 * q + 2], z3 = acc[i][4 * q + 3];
      if (kViews) {
        const float4 d = *reinterpret_cast<const float4*>(xin + r * 8 + 4);
        z0 += fmaf(d.z, w2.x, fmaf(d.y, w1.x, d.x * w0.x));
        z1 += fmaf(d.z, w2.y, fmaf(d.y, w1.y, d.x * w0.y));
        z2 += fmaf(d.z, w2.z, fmaf(d.y, w1.z, d.x * w0.z));
        z3 += fmaf(d.z, w2.w, fmaf(d.y, w1.w, d.x * w0.w));
      }
      *reinterpret_cast<float4*>(h + r * G::ld + col) = make_float4(
          fast_sin(fmaf(gg.x, z0 + bb.x, ee.x)), fast_sin(fmaf(gg.y, z1 + bb.y, ee.y)),
          fast_sin(fmaf(gg.z, z2 + bb.z, ee.z)), fast_sin(fmaf(gg.w, z3 + bb.w, ee.w)));
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, kF32BlocksPerSM)
    siren_field_f32_kernel(const FieldArgs<float> a) {
  using G = F32Tile<W>;
  constexpr int rows = G::rows, ld = G::ld, kc = G::kc, n_chunk = G::n_chunk;
  constexpr int TM = G::kTM, TR = G::kRowThreads, TC = G::kCols;
  extern __shared__ float4 smem4[];
  float* xin = reinterpret_cast<float*>(smem4);  // [rows, 8]: xyz 0..2, dirs 4..6
  float* h = xin + rows * 8;                     // [rows, ld]
  float* ring = h + rows * ld;                   // [kRing, kc, W]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = a.D;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * rows;
  const int n_valid = min(rows, a.P - p0);
  const size_t row0 = (size_t)b * a.P + p0;  // first point of the tile
  const float* gam = a.gamma + (size_t)b * (D + 1) * W;
  const float* bet = a.beta + (size_t)b * (D + 1) * W;

  const int total = D * n_chunk;  // D - 1 hidden matrices, then wv_h
  for (int c = 0; c < G::kRing - 1; ++c) fetch_f32_chunk<W>(a.w_hidden, a.wv_h, D, ring, c, total);

  for (int i = tid; i < rows * 3; i += kThreads) {
    const int t = i / 3, c = i % 3;
    float pv = 0.f, vv = 0.f;
    if (t < n_valid) {
      pv = a.pts[(row0 + t) * 3 + c];
      vv = a.views[(row0 + t) * 3 + c];
    }
    xin[t * 8 + c] = pv;
    xin[t * 8 + 4 + c] = vv;
  }
  __syncthreads();

  // layer 0: 3 -> W; a thread owns four neighbouring columns
  {
    constexpr int quads = W / 4, step = kThreads / quads;
    if (tid < step * quads) {
      const int j = 4 * (tid % quads);
      const float4 w0 = ldg4(a.w_first + j), w1 = ldg4(a.w_first + W + j);
      const float4 w2 = ldg4(a.w_first + 2 * W + j);
      const float4 g = ldg4(gam + j), e = ldg4(bet + j), bb = ldg4(a.b_first + j);
      for (int t = tid / quads; t < rows; t += step) {
        const float x0 = xin[t * 8], x1 = xin[t * 8 + 1], x2 = xin[t * 8 + 2];
        const float z0 = fmaf(x2, w2.x, fmaf(x1, w1.x, x0 * w0.x));
        const float z1 = fmaf(x2, w2.y, fmaf(x1, w1.y, x0 * w0.y));
        const float z2 = fmaf(x2, w2.z, fmaf(x1, w1.z, x0 * w0.z));
        const float z3 = fmaf(x2, w2.w, fmaf(x1, w1.w, x0 * w0.w));
        *reinterpret_cast<float4*>(h + t * ld + j) = make_float4(
            fast_sin(fmaf(g.x, z0 + bb.x, e.x)), fast_sin(fmaf(g.y, z1 + bb.y, e.y)),
            fast_sin(fmaf(g.z, z2 + bb.z, e.z)), fast_sin(fmaf(g.w, z3 + bb.w, e.w)));
      }
    }
  }

  // hidden layers and the views layer's W x W part: register-blocked outer
  // products, A = 4 K-columns of the thread's 8 rows of h, B = the thread's
  // 16 columns of one K-row of the chunk (conflict-free 16-byte shared loads:
  // a warp's rows are neighbours, its column quads contiguous)
  const int tr = tid / TC, tc = tid % TC;
  const bool working = tid < G::kWorking;
  float acc[TM][16];
  for (int c = 0; c < total; ++c) {
    const int m = c / n_chunk, kci = c % n_chunk;
    cp_async_wait<G::kRing - 2>();  // this thread's part of chunk c has landed
    __syncthreads();  // chunk c and h complete; chunk c - 1's stage is free
    fetch_f32_chunk<W>(a.w_hidden, a.wv_h, D, ring, c + G::kRing - 1, total);

    if (m == D - 1 && kci == 0) {
      // sdf head on h_{D-1}, before the views layer overwrites it: W -> 1,
      // one warp per point, lanes split k
      for (int t = warp; t < rows; t += kThreads / 32) {
        float s = 0.f;
        for (int k = 4 * lane; k < W; k += 128) {
          const float4 hv = *reinterpret_cast<const float4*>(h + t * ld + k);
          const float4 wv = ldg4(a.w_sdf + k);
          s = fmaf(hv.w, wv.w, fmaf(hv.z, wv.z, fmaf(hv.y, wv.y, fmaf(hv.x, wv.x, s))));
        }
        s = warp_sum(s);
        if (lane == 0 && t < n_valid) a.sdf[row0 + t] = s + a.b_sdf[0];
      }
    }

    if (working) {
      if (kci == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
      }
      const float* wk = ring + (c % G::kRing) * kc * W + 4 * tc;
      const float* hk = h + tr * ld + kci * kc;
#pragma unroll
      for (int k = 0; k < kc; k += 4) {
        float4 av[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          av[i] = *reinterpret_cast<const float4*>(hk + i * TR * ld + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 bv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bv[q] = *reinterpret_cast<const float4*>(wk + (k + kk) * W + q * 4 * TC);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[i][4 * q] = fmaf(x, bv[q].x, acc[i][4 * q]);
              acc[i][4 * q + 1] = fmaf(x, bv[q].y, acc[i][4 * q + 1]);
              acc[i][4 * q + 2] = fmaf(x, bv[q].z, acc[i][4 * q + 2]);
              acc[i][4 * q + 3] = fmaf(x, bv[q].w, acc[i][4 * q + 3]);
            }
          }
        }
      }
    }

    if (kci == n_chunk - 1) {
      __syncthreads();  // every warp has read h for this layer
      if (working) {
        if (m < D - 1) {
          film_sine_f32<W, false>(acc, h, gam + (m + 1) * W, bet + (m + 1) * W,
                                  a.b_hidden + m * W, xin, a.wv_d, tr, tc);
        } else {
          film_sine_f32<W, true>(acc, h, gam + D * W, bet + D * W, a.b_v, xin, a.wv_d, tr, tc);
        }
      }
    }
  }
  __syncthreads();  // h holds the feature

  // the feature out, coalesced 16-byte stores
  {
    constexpr int per_row = W / 4;
    for (int i = tid; i < n_valid * per_row; i += kThreads) {
      const int t = i / per_row, q = i % per_row;
      *reinterpret_cast<float4*>(a.feat + (row0 + t) * W + q * 4) =
          *reinterpret_cast<const float4*>(h + t * ld + q * 4);
    }
  }

  // rgb head: W -> 3 on the feature, one warp per point
  for (int t = warp; t < rows; t += kThreads / 32) {
    float r0 = 0.f, r1 = 0.f, r2 = 0.f;
    for (int k = lane; k < W; k += 32) {
      const float f = h[t * ld + k];
      const float* w = a.w_rgb + k * 3;
      r0 = fmaf(f, __ldg(w), r0);
      r1 = fmaf(f, __ldg(w + 1), r1);
      r2 = fmaf(f, __ldg(w + 2), r2);
    }
    r0 = warp_sum(r0);
    r1 = warp_sum(r1);
    r2 = warp_sum(r2);
    if (lane == 0 && t < n_valid) {
      a.rgb[(row0 + t) * 3] = r0 + a.b_rgb[0];
      a.rgb[(row0 + t) * 3 + 1] = r1 + a.b_rgb[1];
      a.rgb[(row0 + t) * 3 + 2] = r2 + a.b_rgb[2];
    }
  }
}

template <int W>
int launch_f32(const FieldArgs<float>& a, int B, cudaStream_t stream) {
  using G = F32Tile<W>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&siren_field_f32_kernel<W>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.P + G::rows - 1) / G::rows, B);
  siren_field_f32_kernel<W><<<grid, kThreads, G::smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_f32(const FieldArgs<float>& a, int B, cudaStream_t stream) {
  switch (a.W) {
    case 64: return launch_f32<64>(a, B, stream);
    case 128: return launch_f32<128>(a, B, stream);
    case 192: return launch_f32<192>(a, B, stream);
    case 256: return launch_f32<256>(a, B, stream);
    case 320: return launch_f32<320>(a, B, stream);
    case 384: return launch_f32<384>(a, B, stream);
    case 448: return launch_f32<448>(a, B, stream);
    case 512: return launch_f32<512>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- bf16, mma.sync

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;     // weight ring depth
constexpr int kChunk = 64;     // K rows per weight chunk
constexpr int kPad = 8;        // bf16 pad per shared row

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a (16 x 16, row-major fragment) * b (16 x 8, col-major fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 -> f32 is exact: the bf16 bits are the f32's top half.
__device__ __forceinline__ float ldg_bf16(const bf16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// two neighbouring bf16 (p even-aligned) as f32: .x the lower address
__device__ __forceinline__ float2 bf16x2_f32(unsigned u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// Start the cp.async copy of weight chunk c (c < total) into its ring
// stage, and commit a group either way so that the wait counts stay uniform.
// Chunk c is rows [k0, k0 + kChunk) of matrix c / n_chunk: hidden matrices
// 0 .. D-2, then the views layer's point rows.
template <int W>
__device__ __forceinline__ void fetch_chunk(const bf16* w_hidden, const bf16* wv_h, int D,
                                            bf16* ring, int c, int total) {
  constexpr int ld = W + kPad, n_chunk = W / kChunk, per_row = W / 8;  // 16-byte pieces
  if (c < total) {
    const int m = c / n_chunk, k0 = (c % n_chunk) * kChunk;
    const bf16* src = (m < D - 1 ? w_hidden + (size_t)m * W * W : wv_h) + (size_t)k0 * W;
    bf16* dst = ring + (c % kStages) * kChunk * ld;
    static_assert(kChunk * per_row % kThreads == 0, "whole copies per thread");
#pragma unroll
    for (int j = 0; j < kChunk * per_row / kThreads; ++j) {
      const int i = threadIdx.x + j * kThreads, r = i / per_row, q = i % per_row;
      cp_async16(dst + r * ld + q * 8, src + (size_t)r * W + q * 8);
    }
  }
  cp_async_commit();
}

// acc[mi][ni] is the m16n8 tile at rows m0 + 16 mi, columns n0 + 8 ni.
// h[r, col] = bf16(fast_sin(g * (z + bias) + e)), z the product (plus, for
// the views layer, the direction rows' 3 -> W product).
template <bool kViews>
__device__ __forceinline__ void film_sine_epilogue(float (&acc)[4][8][4], bf16* h, int ld,
                                                   const float* g, const float* e,
                                                   const float* bias, const float* xin,
                                                   const bf16* wv_d, int W, int m0, int n0,
                                                   int lane) {
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = n0 + ni * 8 + 2 * (lane % 4);
    const float2 gg = __ldg(reinterpret_cast<const float2*>(g + col));
    const float2 ee = __ldg(reinterpret_cast<const float2*>(e + col));
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
    float2 wd[3];
    if (kViews) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        wd[c] = bf16x2_f32(__ldg(reinterpret_cast<const unsigned*>(wv_d + c * W + col)));
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + mi * 16 + lane / 4 + hf * 8;
        float z0 = acc[mi][ni][2 * hf], z1 = acc[mi][ni][2 * hf + 1];
        if (kViews) {
          const float d0 = xin[r * 8 + 4], d1 = xin[r * 8 + 5], d2 = xin[r * 8 + 6];
          z0 += fmaf(d2, wd[2].x, fmaf(d1, wd[1].x, d0 * wd[0].x));
          z1 += fmaf(d2, wd[2].y, fmaf(d1, wd[1].y, d0 * wd[0].y));
        }
        store_bf16x2(h + r * ld + col, fast_sin(fmaf(gg.x, z0 + bb.x, ee.x)),
                     fast_sin(fmaf(gg.y, z1 + bb.y, ee.y)));
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1)
    siren_field_mma_kernel(const FieldArgs<bf16> a) {
  extern __shared__ float4 smem4[];
  constexpr int ld = W + kPad;
  constexpr int wn = W / 64;           // warps across the columns
  constexpr int rows = 64 * (8 / wn);  // points per tile
  constexpr int n_chunk = W / kChunk;  // weight chunks per matrix
  const int D = a.D;
  float* xin = reinterpret_cast<float*>(smem4);            // [rows, 8]: xyz 0..2, dirs 4..6
  bf16* h = reinterpret_cast<bf16*>(xin + rows * 8);      // [rows, ld]
  bf16* ring = h + rows * ld;                             // [kStages, kChunk, ld]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * rows;
  const int n_valid = min(rows, a.P - p0);
  const size_t row0 = (size_t)b * a.P + p0;  // first point of the tile
  const float* gam = a.gamma + (size_t)b * (D + 1) * W;
  const float* bet = a.beta + (size_t)b * (D + 1) * W;

  const int total = D * n_chunk;  // D - 1 hidden matrices, then wv_h
  for (int c = 0; c < kStages - 1; ++c) fetch_chunk<W>(a.w_hidden, a.wv_h, D, ring, c, total);

  for (int i = tid; i < rows * 3; i += kThreads) {
    const int t = i / 3, c = i % 3;
    float pv = 0.f, vv = 0.f;
    if (t < n_valid) {
      pv = a.pts[(row0 + t) * 3 + c];
      vv = a.views[(row0 + t) * 3 + c];
    }
    xin[t * 8 + c] = round_bf16(pv);
    xin[t * 8 + 4 + c] = round_bf16(vv);
  }
  __syncthreads();

  // layer 0: 3 -> W on the FMA pipes; thread owns columns j, j + 1
  {
    constexpr int pairs = W / 2, step = kThreads / pairs;
    const int j = 2 * (tid % pairs);
    if (tid / pairs < step) {
      float wa[3], wb[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        wa[c] = ldg_bf16(a.w_first + c * W + j);
        wb[c] = ldg_bf16(a.w_first + c * W + j + 1);
      }
      const float g0 = gam[j], g1 = gam[j + 1], e0 = bet[j], e1 = bet[j + 1];
      const float c0 = a.b_first[j], c1 = a.b_first[j + 1];
      for (int t = tid / pairs; t < rows; t += step) {
        const float x0 = xin[t * 8], x1 = xin[t * 8 + 1], x2 = xin[t * 8 + 2];
        const float z0 = fmaf(x2, wa[2], fmaf(x1, wa[1], x0 * wa[0]));
        const float z1 = fmaf(x2, wb[2], fmaf(x1, wb[1], x0 * wb[0]));
        store_bf16x2(h + t * ld + j, fast_sin(fmaf(g0, z0 + c0, e0)),
                     fast_sin(fmaf(g1, z1 + c1, e1)));
      }
    }
  }

  // hidden layers and the views layer's W x W part on the tensor cores
  const int wr = warp / wn, wc = warp % wn;
  const bool active = wr < 8 / wn;  // idle warps only copy and synchronise
  const int m0 = wr * 64, n0 = wc * 64;
  float acc[4][8][4];
  for (int c = 0; c < total; ++c) {
    const int m = c / n_chunk, kc = c % n_chunk;
    cp_async_wait<kStages - 2>();  // this thread's part of chunk c has landed
    __syncthreads();  // chunk c and h complete; chunk c - 1's stage is free
    fetch_chunk<W>(a.w_hidden, a.wv_h, D, ring, c + kStages - 1, total);

    if (m == D - 1 && kc == 0) {
      // sdf head on h_{D-1}, before the views layer overwrites it: W -> 1,
      // one warp per point, lanes split k
      for (int t = warp; t < rows; t += kThreads / 32) {
        float s = 0.f;
        for (int k = 2 * lane; k < W; k += 64) {
          const float2 hv = bf16x2_f32(*reinterpret_cast<const unsigned*>(h + t * ld + k));
          const float2 wv = bf16x2_f32(__ldg(reinterpret_cast<const unsigned*>(a.w_sdf + k)));
          s = fmaf(hv.x, wv.x, s);
          s = fmaf(hv.y, wv.y, s);
        }
        s = warp_sum(s);
        if (lane == 0 && t < n_valid) a.sdf[row0 + t] = s + a.b_sdf[0];
      }
    }

    if (active) {
      if (kc == 0) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
      }
      const bf16* wk = ring + (c % kStages) * kChunk * ld;
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        const int k = kc * kChunk + ks * 16;
        unsigned af[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(af[mi], h + (m0 + mi * 16 + lane % 16) * ld + k + (lane / 16) * 8);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          unsigned bw[4];  // n-tiles 2 nj (bw[0], bw[1]) and 2 nj + 1 (bw[2], bw[3])
          ldmatrix_x4_trans(bw, wk + (ks * 16 + lane % 16) * ld + n0 + nj * 16 + (lane / 16) * 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16(acc[mi][2 * nj], af[mi], bw[0], bw[1]);
            mma_bf16(acc[mi][2 * nj + 1], af[mi], bw[2], bw[3]);
          }
        }
      }
    }

    if (kc == n_chunk - 1) {
      __syncthreads();  // every warp has read h for this layer
      if (active) {
        if (m < D - 1) {
          film_sine_epilogue<false>(acc, h, ld, gam + (m + 1) * W, bet + (m + 1) * W,
                                    a.b_hidden + m * W, xin, a.wv_d, W, m0, n0, lane);
        } else {
          film_sine_epilogue<true>(acc, h, ld, gam + D * W, bet + D * W, a.b_v, xin, a.wv_d,
                                   W, m0, n0, lane);
        }
      }
    }
  }
  __syncthreads();  // h holds the feature

  // the feature out, coalesced 16-byte stores
  {
    constexpr int per_row = W / 8;
    for (int i = tid; i < n_valid * per_row; i += kThreads) {
      const int t = i / per_row, q = i % per_row;
      *reinterpret_cast<uint4*>(a.feat + (row0 + t) * W + q * 8) =
          *reinterpret_cast<const uint4*>(h + t * ld + q * 8);
    }
  }

  // rgb head: W -> 3 on the bf16 feature, one warp per point
  for (int t = warp; t < rows; t += kThreads / 32) {
    float r0 = 0.f, r1 = 0.f, r2 = 0.f;
    for (int k = 2 * lane; k < W; k += 64) {
      const float2 f = bf16x2_f32(*reinterpret_cast<const unsigned*>(h + t * ld + k));
      const bf16* w = a.w_rgb + k * 3;
      r0 = fmaf(f.y, ldg_bf16(w + 3), fmaf(f.x, ldg_bf16(w), r0));
      r1 = fmaf(f.y, ldg_bf16(w + 4), fmaf(f.x, ldg_bf16(w + 1), r1));
      r2 = fmaf(f.y, ldg_bf16(w + 5), fmaf(f.x, ldg_bf16(w + 2), r2));
    }
    r0 = warp_sum(r0);
    r1 = warp_sum(r1);
    r2 = warp_sum(r2);
    if (lane == 0 && t < n_valid) {
      a.rgb[(row0 + t) * 3] = r0 + a.b_rgb[0];
      a.rgb[(row0 + t) * 3 + 1] = r1 + a.b_rgb[1];
      a.rgb[(row0 + t) * 3 + 2] = r2 + a.b_rgb[2];
    }
  }
}

template <int W>
int launch_mma(const FieldArgs<bf16>& a, int B, cudaStream_t stream) {
  constexpr int rows = 64 * (8 / (W / 64));
  constexpr size_t smem = (size_t)rows * 8 * sizeof(float) +
                          (size_t)(rows + kStages * kChunk) * (W + kPad) * sizeof(bf16);
  static_assert(smem <= 232448, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&siren_field_mma_kernel<W>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.P + rows - 1) / rows, B);
  siren_field_mma_kernel<W><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_mma(const FieldArgs<bf16>& a, int B, cudaStream_t stream) {
  switch (a.W) {
    case 64: return launch_mma<64>(a, B, stream);
    case 128: return launch_mma<128>(a, B, stream);
    case 192: return launch_mma<192>(a, B, stream);
    case 256: return launch_mma<256>(a, B, stream);
    case 320: return launch_mma<320>(a, B, stream);
    case 384: return launch_mma<384>(a, B, stream);
    case 448: return launch_mma<448>(a, B, stream);
    case 512: return launch_mma<512>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dot_bf16 selects the dot type of the weights and of `feat`, and with it
// the kernel: 1 = bf16 (siren_field_mma_kernel), 0 = f32
// (siren_field_f32_kernel).  Every other tensor is f32.  W must be a
// multiple of 64 in [64, 512], and every pointer 16-byte aligned; the
// wrapper checks both too.
int siren_field_forward(int dot_bf16, const void* pts, const void* views,
                        const void* w_first, const void* b_first,
                        const void* w_hidden, const void* b_hidden,
                        const void* wv_h, const void* wv_d, const void* b_v,
                        const void* w_sdf, const void* b_sdf, const void* w_rgb,
                        const void* b_rgb, const void* gamma, const void* beta,
                        void* rgb, void* sdf, void* feat, int B, int P, int D,
                        int W, void* stream) {
  if (W < 64 || W > 512 || W % 64 != 0 || D < 1 || B < 1 || B > 65535 || P < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dot_bf16) {
    using T = bf16;
    const FieldArgs<T> a{
        (const float*)pts, (const float*)views, (const T*)w_first,
        (const float*)b_first, (const T*)w_hidden, (const float*)b_hidden,
        (const T*)wv_h, (const T*)wv_d, (const float*)b_v, (const T*)w_sdf,
        (const float*)b_sdf, (const T*)w_rgb, (const float*)b_rgb,
        (const float*)gamma, (const float*)beta, (float*)rgb, (float*)sdf,
        (T*)feat, P, D, W};
    return launch_mma(a, B, s);
  }
  using T = float;
  const FieldArgs<T> a{
      (const float*)pts, (const float*)views, (const T*)w_first,
      (const float*)b_first, (const T*)w_hidden, (const float*)b_hidden,
      (const T*)wv_h, (const T*)wv_d, (const float*)b_v, (const T*)w_sdf,
      (const float*)b_sdf, (const T*)w_rgb, (const float*)b_rgb,
      (const float*)gamma, (const float*)beta, (float*)rgb, (float*)sdf,
      (T*)feat, P, D, W};
  return launch_f32(a, B, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
