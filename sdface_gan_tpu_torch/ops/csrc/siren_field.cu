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
// Every product rounds its operands to the dot type WT (bf16 or f32) and
// accumulates in f32; FiLM and the sine run in f32.  A bf16 x bf16 product
// is exact in f32, so rounding the operands and using f32 FMAs gives
// "bf16 operands, f32 accumulate".
//
// What bounds it on this card: the work is ~1.05 MFLOP per point against
// ~554 B of device-memory traffic (bf16 feature out), so it is bound by
// operations.
// This first version runs them on the f32 FMA pipes, not the tensor cores:
// a block of W/2 threads holds one tile of kTile points of one batch
// element (a tile never crosses a batch element, since gamma/beta differ
// per element); the tile's activations live in shared memory as f32
// ping-pong buffers and never reach device memory; thread j owns output
// columns j and j + W/2 and streams W_l[k, j] from global memory
// (coalesced; the ~1.2 MB of bf16 weights stay in L2) while h[t, k] is a
// broadcast read from shared memory.  Tensor cores (wgmma), TMA and
// pipelining are left for a later change.
//
// C interface for ctypes: siren_field_forward(...) returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // points per block

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
struct Dot;

template <>
struct Dot<float> {
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Dot<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

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

// acc{0,1}[t] = sum_k h[t, k] * w[k, j{0,1}] for the kTile points of a tile.
template <typename WT>
__device__ __forceinline__ void tile_matmul(const float* __restrict__ h,
                                            const WT* __restrict__ w, int W,
                                            int j0, int j1, float (&acc0)[kTile],
                                            float (&acc1)[kTile]) {
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    acc0[t] = 0.f;
    acc1[t] = 0.f;
  }
#pragma unroll 2
  for (int k = 0; k < W; k += 4) {
    float wa[4], wb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wa[q] = Dot<WT>::load(w + (size_t)(k + q) * W + j0);
      wb[q] = Dot<WT>::load(w + (size_t)(k + q) * W + j1);
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float4 hv = *reinterpret_cast<const float4*>(h + t * W + k);
      acc0[t] = fmaf(hv.x, wa[0], acc0[t]);
      acc0[t] = fmaf(hv.y, wa[1], acc0[t]);
      acc0[t] = fmaf(hv.z, wa[2], acc0[t]);
      acc0[t] = fmaf(hv.w, wa[3], acc0[t]);
      acc1[t] = fmaf(hv.x, wb[0], acc1[t]);
      acc1[t] = fmaf(hv.y, wb[1], acc1[t]);
      acc1[t] = fmaf(hv.z, wb[2], acc1[t]);
      acc1[t] = fmaf(hv.w, wb[3], acc1[t]);
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(256)
    siren_field_kernel(const FieldArgs<WT> a) {
  extern __shared__ float4 smem4[];
  const int W = a.W;
  float* h_in = reinterpret_cast<float*>(smem4);  // [kTile, W]
  float* h_out = h_in + kTile * W;                 // [kTile, W]
  float* xin = h_out + kTile * W;                  // [kTile, 8]: xyz 0..2, dirs 4..6

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int n_valid = min(kTile, a.P - p0);
  const size_t row0 = (size_t)b * a.P + p0;  // first point of the tile
  const float* gam = a.gamma + (size_t)b * (a.D + 1) * W;
  const float* bet = a.beta + (size_t)b * (a.D + 1) * W;
  const int j0 = tid, j1 = tid + W / 2;

  for (int i = tid; i < kTile * 3; i += blockDim.x) {
    const int t = i / 3, c = i % 3;
    float pv = 0.f, vv = 0.f;
    if (t < n_valid) {
      pv = a.pts[(row0 + t) * 3 + c];
      vv = a.views[(row0 + t) * 3 + c];
    }
    xin[t * 8 + c] = Dot<WT>::round(pv);
    xin[t * 8 + 4 + c] = Dot<WT>::round(vv);
  }
  __syncthreads();

  // layer 0: 3 -> W
  {
    float wa[3], wb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      wa[c] = Dot<WT>::load(a.w_first + c * W + j0);
      wb[c] = Dot<WT>::load(a.w_first + c * W + j1);
    }
    const float g0 = gam[j0], g1 = gam[j1], e0 = bet[j0], e1 = bet[j1];
    const float c0 = a.b_first[j0], c1 = a.b_first[j1];
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      const float x0 = xin[t * 8], x1 = xin[t * 8 + 1], x2 = xin[t * 8 + 2];
      const float z0 = fmaf(x2, wa[2], fmaf(x1, wa[1], x0 * wa[0]));
      const float z1 = fmaf(x2, wb[2], fmaf(x1, wb[1], x0 * wb[0]));
      h_in[t * W + j0] = Dot<WT>::round(fast_sin(g0 * (z0 + c0) + e0));
      h_in[t * W + j1] = Dot<WT>::round(fast_sin(g1 * (z1 + c1) + e1));
    }
  }
  __syncthreads();

  // hidden layers: W -> W
  float acc0[kTile], acc1[kTile];
  for (int l = 1; l < a.D; ++l) {
    tile_matmul<WT>(h_in, a.w_hidden + (size_t)(l - 1) * W * W, W, j0, j1, acc0, acc1);
    const float g0 = gam[l * W + j0], g1 = gam[l * W + j1];
    const float e0 = bet[l * W + j0], e1 = bet[l * W + j1];
    const float c0 = a.b_hidden[(l - 1) * W + j0], c1 = a.b_hidden[(l - 1) * W + j1];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      h_out[t * W + j0] = Dot<WT>::round(fast_sin(g0 * (acc0[t] + c0) + e0));
      h_out[t * W + j1] = Dot<WT>::round(fast_sin(g1 * (acc1[t] + c1) + e1));
    }
    __syncthreads();
    float* tmp = h_in;
    h_in = h_out;
    h_out = tmp;
  }

  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;

  // sdf head: W -> 1, one warp per point, lanes split k
  for (int t = warp; t < kTile; t += n_warps) {
    float s = 0.f;
    for (int k = lane; k < W; k += 32) s = fmaf(h_in[t * W + k], Dot<WT>::load(a.w_sdf + k), s);
    s = warp_sum(s);
    if (lane == 0 && t < n_valid) a.sdf[row0 + t] = s + a.b_sdf[0];
  }

  // views layer: [h, dirs] -> W, FiLM and sine; its output is the feature
  {
    tile_matmul<WT>(h_in, a.wv_h, W, j0, j1, acc0, acc1);
    float wa[3], wb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      wa[c] = Dot<WT>::load(a.wv_d + c * W + j0);
      wb[c] = Dot<WT>::load(a.wv_d + c * W + j1);
    }
    const int D = a.D;
    const float g0 = gam[D * W + j0], g1 = gam[D * W + j1];
    const float e0 = bet[D * W + j0], e1 = bet[D * W + j1];
    const float c0 = a.b_v[j0], c1 = a.b_v[j1];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const float d0 = xin[t * 8 + 4], d1 = xin[t * 8 + 5], d2 = xin[t * 8 + 6];
      const float u0 = fmaf(d2, wa[2], fmaf(d1, wa[1], d0 * wa[0]));
      const float u1 = fmaf(d2, wb[2], fmaf(d1, wb[1], d0 * wb[0]));
      const float f0 = Dot<WT>::round(fast_sin(g0 * ((acc0[t] + u0) + c0) + e0));
      const float f1 = Dot<WT>::round(fast_sin(g1 * ((acc1[t] + u1) + c1) + e1));
      h_out[t * W + j0] = f0;
      h_out[t * W + j1] = f1;
      if (t < n_valid) {
        Dot<WT>::store(a.feat + (row0 + t) * W + j0, f0);
        Dot<WT>::store(a.feat + (row0 + t) * W + j1, f1);
      }
    }
  }
  __syncthreads();

  // rgb head: W -> 3 on the (rounded) feature, one warp per point
  for (int t = warp; t < kTile; t += n_warps) {
    float r0 = 0.f, r1 = 0.f, r2 = 0.f;
    for (int k = lane; k < W; k += 32) {
      const float f = h_out[t * W + k];
      r0 = fmaf(f, Dot<WT>::load(a.w_rgb + k * 3), r0);
      r1 = fmaf(f, Dot<WT>::load(a.w_rgb + k * 3 + 1), r1);
      r2 = fmaf(f, Dot<WT>::load(a.w_rgb + k * 3 + 2), r2);
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

template <typename WT>
int launch(const FieldArgs<WT>& a, int B, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * kTile * a.W + kTile * 8) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&siren_field_kernel<WT>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.P + kTile - 1) / kTile, B);
  siren_field_kernel<WT><<<grid, a.W / 2, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dot_bf16 selects the dot type of the weights and of `feat`: 1 = bf16,
// 0 = f32.  Every other tensor is f32.  W must be a multiple of 64 in
// [64, 512] (W/2 threads, whole warps); the wrapper checks it too.
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
    using T = __nv_bfloat16;
    const FieldArgs<T> a{
        (const float*)pts, (const float*)views, (const T*)w_first,
        (const float*)b_first, (const T*)w_hidden, (const float*)b_hidden,
        (const T*)wv_h, (const T*)wv_d, (const float*)b_v, (const T*)w_sdf,
        (const float*)b_sdf, (const T*)w_rgb, (const float*)b_rgb,
        (const float*)gamma, (const float*)beta, (float*)rgb, (float*)sdf,
        (T*)feat, P, D, W};
    return launch<T>(a, B, s);
  }
  using T = float;
  const FieldArgs<T> a{
      (const float*)pts, (const float*)views, (const T*)w_first,
      (const float*)b_first, (const T*)w_hidden, (const float*)b_hidden,
      (const T*)wv_h, (const T*)wv_d, (const float*)b_v, (const T*)w_sdf,
      (const float*)b_sdf, (const T*)w_rgb, (const float*)b_rgb,
      (const float*)gamma, (const float*)beta, (float*)rgb, (float*)sdf,
      (T*)feat, P, D, W};
  return launch<T>(a, B, s);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
