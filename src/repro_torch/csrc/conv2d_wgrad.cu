// The filter gradient of the valid, stride-1 2-D convolution (NHWC x HWIO):
// the conv layer's weight gradient on every backward pass of the paper's
// digit CNN in training (repro_torch/kernels/ops.py, the autograd Function
// around conv2d).
//
// The TPU side has no kernel for it: the reference trains through lax.conv
// and its transpose (src/repro/models/cnn.py:37-46), not through its Pallas
// conv2d (src/repro/kernels/conv2d.py:37). Semantics: repro_torch/kernels/
// ref.py conv2d_wgrad_ref:
//
//   dw[i, j, ci, co] = sum_{b < B, y < Ho, x < Wo}
//                        x[b, y + i, x + j, ci] * dy[b, y, x, co]
//
// summed in float32 and stored in x's type (float32 or bfloat16).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on CUDA cores, data
// sheet), counting each input read once and the output written once: at
// the paper's training step (B=64, 28x28x1 images, 32 filters of 3x3) dy
// is 5.54 MB, x 0.20 MB, dw 1.2 KB: 1.7 us; the 2 * 64 * 676 * 288 = 24.9
// MFLOP take 0.37 us. Bytes bound it.
//
// Design, simple and deterministic (no atomics: two launches on the same
// inputs give the same bits):
//
// - Pass 1: `ctas` CTAs (kernels/conv2d_wgrad.py:plan, computed on the host
//   from the shapes and the SM count, validated here), CTA c over a
//   contiguous range of the B * Ho (image, output row) pairs. It stages
//   `group` pairs at a time in shared memory as float32 (a pair's KH input
//   rows, and its dy row: consecutive pairs' dy rows are contiguous), with
//   four loads in flight a thread. Thread t owns outputs t, t + threads,
//   ... (`per` of them) and accumulates each in a register, over its pairs
//   in order and each pair's Wo pixels in order; at the paper's shape one
//   output a thread, 288 threads, and a warp reads 32 consecutive dy
//   channels beside one broadcast input value. The CTA writes its partial
//   (KH * KW * Cin * Cout float32) to a workspace.
// - Pass 2: one thread an output sums slices of the partials and a fixed
//   tree of the slices, in an order that depends on the plan alone, and
//   stores dw in x's type.
//
// Operands must be contiguous (the wrapper checks); nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kMaxThreads = 512;   // pass 1's threads (the plan's cap)
constexpr int kMaxPer = 8;         // outputs a thread accumulates
constexpr int kMaxSmem = 232448;   // bytes of shared memory a CTA may use
constexpr int kSlices = 16;        // pass 2: partial slices an output sums

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Shape {
  int B, H, W, Cin, KH, KW, Cout, Ho, Wo;
  int rows;    // B * Ho (image, output row) pairs
  int nout;    // KH * KW * Cin * Cout
  int ctas, group, per;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    wgrad_partial(const T* __restrict__ x, const T* __restrict__ dy,
                  float* __restrict__ part, const Shape p) {
  extern __shared__ __align__(16) float smem[];
  const int win = p.KH * p.W * p.Cin;   // input elements of a pair
  const int drow = p.Wo * p.Cout;       // dy elements of a pair
  float* const sx = smem;               // `group` input windows
  float* const sd = smem + p.group * win;   // then `group` dy rows
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int q0 = (int)((long long)blockIdx.x * p.rows / p.ctas);
  const int q1 = (int)((long long)(blockIdx.x + 1) * p.rows / p.ctas);

  // the thread's outputs, as offsets into a staged window and dy row
  // (xo < 0: none)
  int xo[kMaxPer], dof[kMaxPer];
  float acc[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int o = tid + k * nt;
    acc[k] = 0.f;
    xo[k] = -1;
    dof[k] = 0;
    if (k < p.per && o < p.nout) {
      int r = o / p.Cout;
      dof[k] = o - r * p.Cout;
      const int ci = r % p.Cin;
      r /= p.Cin;
      const int j = r % p.KW;
      const int i = r / p.KW;
      xo[k] = (i * p.W + j) * p.Cin + ci;
    }
  }

  for (int g0 = q0; g0 < q1; g0 += p.group) {
    const int ng = min(p.group, q1 - g0);
    __syncthreads();   // the previous group read by every thread
    // dy rows of pairs g0 .. g0 + ng - 1: one contiguous range
    const T* const dsrc = dy + (long long)g0 * drow;
    const int nd = ng * drow;
    for (int e0 = tid; e0 < nd; e0 += 4 * nt) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * nt;
        v[u] = e < nd ? to_f32(dsrc[e]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * nt;
        if (e < nd) sd[e] = v[u];
      }
    }
    // the pairs' KH input rows, window by window
    const int nx = ng * win;
    for (int e0 = tid; e0 < nx; e0 += 4 * nt) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * nt;
        v[u] = 0.f;
        if (e < nx) {
          const int g = e / win;
          const int q = g0 + g;
          const int b = q / p.Ho;
          const int y = q - b * p.Ho;
          v[u] = to_f32(
              x[((long long)b * p.H + y) * p.W * p.Cin + (e - g * win)]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * nt;
        if (e < nx) sx[e] = v[u];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      if (xo[k] < 0) continue;
      float a = acc[k];
      for (int g = 0; g < ng; ++g) {
        const float* xr = sx + g * win + xo[k];
        const float* dr = sd + g * drow + dof[k];
        for (int c = 0; c < p.Wo; ++c, xr += p.Cin, dr += p.Cout)
          a = fmaf(*xr, *dr, a);
      }
      acc[k] = a;
    }
  }
  float* const out = part + (long long)blockIdx.x * p.nout;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k)
    if (xo[k] >= 0) out[tid + k * nt] = acc[k];
}

// 32 outputs a CTA, kSlices threads each: slice s sums partials s, s +
// kSlices, ... in order, then thread s == 0 sums the slices in order.
template <typename T>
__global__ void __launch_bounds__(32 * kSlices)
    wgrad_reduce(const float* __restrict__ part, T* __restrict__ dw,
                 int ctas, int nout) {
  __shared__ float red[kSlices][32];
  const int lane = threadIdx.x;
  const int s = threadIdx.y;
  const int o = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (o < nout) {
#pragma unroll 4
    for (int c = s; c < ctas; c += kSlices) a += part[(long long)c * nout + o];
  }
  red[s][lane] = a;
  __syncthreads();
  if (s == 0 && o < nout) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) t += red[k][lane];
    dw[o] = from_f32<T>(t);
  }
}

template <typename T>
int launch(const void* x, const void* dy, float* part, void* dw,
           const Shape& p, int threads, int smem, cudaStream_t stream) {
  // raised once per type and size, so a launch being captured into a CUDA
  // graph makes no attribute call
  static int cap = 48 * 1024;
  if (smem > cap) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgrad_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cap = smem;
  }
  wgrad_partial<T><<<p.ctas, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wgrad_reduce<T><<<(p.nout + 31) / 32, dim3(32, kSlices), 0, stream>>>(
      part, static_cast<T*>(dw), p.ctas, p.nout);
  return (int)cudaGetLastError();
}

// The plan (kernels/conv2d_wgrad.py:plan) must describe this shape and fit
// the kernel; nothing of it is recomputed here.
inline bool plan_ok(const Shape& p, int threads, int smem) {
  if (p.B < 1 || p.Cin < 1 || p.Cout < 1 || p.KH < 1 || p.KW < 1 ||
      p.Ho < 1 || p.Wo < 1)
    return false;
  const long long rows = (long long)p.B * p.Ho;
  const long long nout = (long long)p.KH * p.KW * p.Cin * p.Cout;
  if (rows > 0x7fffffffLL || p.rows != rows || p.nout != nout) return false;
  if (p.ctas < 1 || p.ctas > p.rows || p.group < 1 || p.per < 1 ||
      p.per > kMaxPer)
    return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (long long)threads * p.per < nout)
    return false;
  const long long pair =
      4LL * ((long long)p.KH * p.W * p.Cin + (long long)p.Wo * p.Cout);
  return smem == p.group * pair && smem <= kMaxSmem;
}

}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (x, dy and dw share it). x (B, H, W, Cin),
// dy (B, H-KH+1, W-KW+1, Cout), dw (KH, KW, Cin, Cout), all contiguous;
// part: ctas x KH*KW*Cin*Cout float32 of workspace. ctas .. smem: the
// launch plan of kernels/conv2d_wgrad.py:plan. Two launches on `stream`.
// Returns a cudaError_t (0 = launched; cudaErrorInvalidValue for a bad
// plan).
extern "C" int conv2d_wgrad_launch(int dtype, const void* x, const void* dy,
                                   void* part, void* dw, int B, int H, int W,
                                   int Cin, int KH, int KW, int Cout,
                                   int ctas, int group, int threads, int per,
                                   int smem, void* stream) {
  const long long nout = (long long)KH * KW * Cin * Cout;
  if (nout < 1 || nout > 0x7fffffffLL || (long long)B * (H - KH + 1) >
                                             0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const repro_torch::Shape p{B,
                             H,
                             W,
                             Cin,
                             KH,
                             KW,
                             Cout,
                             H - KH + 1,
                             W - KW + 1,
                             B * (H - KH + 1),
                             (int)nout,
                             ctas,
                             group,
                             per};
  if ((dtype != 0 && dtype != 1) || !repro_torch::plan_ok(p, threads, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  if (dtype == 0)
    return repro_torch::launch<float>(x, dy, pp, dw, p, threads, smem, s);
  return repro_torch::launch<__nv_bfloat16>(x, dy, pp, dw, p, threads, smem,
                                            s);
}
