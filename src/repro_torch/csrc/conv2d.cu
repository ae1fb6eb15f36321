// Valid, stride-1 2-D convolution, NHWC x HWIO -> NHWC: the conv layer of
// the paper's digit CNN, on every forward pass of the Stratus pipeline
// (evaluation over whole sets, and the consumer's batches of 1 to 32).
//
// Replaces the Pallas TPU kernel src/repro/kernels/conv2d.py:37 (conv2d,
// body _kernel). Semantics: repro_torch/kernels/ref.py conv2d_ref:
//
//   out[b, y, x, co] = sum_{i < KH, j < KW, c < Cin}
//                        x[b, y + i, x + j, c] * w[i, j, c, co]
//
// summed in float32 and stored in x's type (float32 or bfloat16).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on CUDA cores,
// data sheet), counting each input read once and each output written
// once: at the paper's shape (28x28x1 images, 32 filters of 3x3) an
// image reads 3,136 bytes and writes 86,528, 28x more, so the output
// decides. B=1: 90.8 KB, 0.027 us (the launch's own latency dominates);
// B=32: 2.87 MB, 0.86 us; B=2000: 179.3 MB, 53.5 us. The least
// operations, 2 * B * 676 * 288, take 11.6 us at B=2000: bytes bound it
// at every batch.
//
// Design: one CTA per band of R output rows (b, oy0 .. oy0+R-1), one
// thread per output element (ox, cout) of a row, cout fastest, so a warp
// stores one pixel's 32 channels as 128 contiguous bytes; a row of the
// paper's shape is 26 x 32 = 832 threads. The CTA stages the whole filter
// and the R+KH-1 input rows its band reads (contiguous in NHWC) in shared
// memory as float32, all loads in flight together behind one barrier;
// each thread then walks the band's rows, reading shared memory only,
// where a warp's threads read the same input value (one broadcast). The
// launcher picks R: enough CTAs for two per SM, at most Ho rows, and
// input rows within 48 KB; at the paper's shape B=2000 gets R=26 (one CTA
// per image, 784 input values), B=32 R=3 and B=1 R=1. Each thread splits
// its index once, with 32-bit arithmetic; the batch walks the grid's y
// axis (and loops past 65,535 of it). The TPU kernel's padding of the
// batch to its block and of the channels to 128 lanes was tiling for the
// MXU: here nothing is padded. Operands must be contiguous (the wrapper
// checks).
//
// The paper's 3x3x1 filter has a compiled variant: the thread's 9 taps
// in registers, the tap loops unrolled, so an output element costs 9
// broadcast shared-memory reads, 9 FMAs and one coalesced store (~25
// instructions); other shapes run the general variant, with runtime tap
// loops and two shared-memory reads an FMA.
//
// What bounds it today: the store stream at B=2000, with instruction
// issue close behind; at the serving batches (1 to 32), one launch's
// fixed cost of a few microseconds against a bound under 1 us. Each CTA
// needs that much work: with one CTA per output row (52,000 CTAs at
// B=2000, a few instructions a thread between barriers), or with x read
// from device memory inside the tap loop (9 dependent loads a thread),
// the kernel measured 9-13x its bound at B=2000 on an H100.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kMaxThreads = 1024;  // a CTA's threads: one output row
constexpr int kMaxSmem = 232448;   // bytes of shared memory a CTA may use
constexpr int kMaxGridY = 65535;   // grid rows; larger batches loop
constexpr size_t kBandBytes = 48 * 1024;  // a band's input rows, float32

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
  return __float2bfloat16(v);      // round to nearest even, as .to(bf16)
}

// FK, FCIN > 0: a KH = KW = FK, Cin = FCIN filter known at compile time
// (the paper's 3x3x1): its taps for the thread's cout sit in registers
// and the tap loops unroll. 0: any shape, read from shared memory. Both
// sum the taps in the same order (i, j, c).
template <typename T, int FK, int FCIN>
__global__ void __launch_bounds__(kMaxThreads)
    conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ out, int B, int H, int W, int Cin, int KH,
                  int KW, int Cout, int Ho, int Wo, int R) {
  extern __shared__ float smem[];
  const int nw = KH * KW * Cin * Cout;
  float* sw = smem;                // (KH, KW, Cin, Cout) as float32
  float* sx = smem + nw;           // (R + KH - 1, W, Cin): the band's input
  for (int i = threadIdx.x; i < nw; i += blockDim.x) sw[i] = to_f32(w[i]);

  const int oy0 = blockIdx.x * R;
  const int nr = min(R, Ho - oy0);             // rows of this band
  const int nx = (nr + KH - 1) * W * Cin;
  const int row = Wo * Cout;                   // output elements of a row
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T* xin = x + (b * H + oy0) * (long long)W * Cin;
    __syncthreads();               // the previous image's reads are done
    for (int i = threadIdx.x; i < nx; i += blockDim.x) sx[i] = to_f32(xin[i]);
    __syncthreads();
    T* oband = out + (b * Ho + oy0) * row;
    for (int t = threadIdx.x; t < row; t += blockDim.x) {
      const int ox = t / Cout, co = t - ox * Cout;
      if constexpr (FK > 0) {
        constexpr int kTaps = FK * FK * FCIN;
        float wr[kTaps];
#pragma unroll
        for (int k = 0; k < kTaps; ++k) wr[k] = sw[k * Cout + co];
        for (int r = 0; r < nr; ++r) {
          const float* xr = sx + (r * W + ox) * FCIN;
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < FK; ++i)
#pragma unroll
            for (int j = 0; j < FK; ++j)
#pragma unroll
              for (int c = 0; c < FCIN; ++c)
                acc = fmaf(xr[(i * W + j) * FCIN + c],
                           wr[(i * FK + j) * FCIN + c], acc);
          oband[(long long)r * row + t] = from_f32<T>(acc);
        }
      } else {
        for (int r = 0; r < nr; ++r) {
          float acc = 0.f;
          for (int i = 0; i < KH; ++i) {
            const float* xr = sx + ((r + i) * W + ox) * Cin;
            const float* wr = sw + i * KW * Cin * Cout + co;
            for (int j = 0; j < KW; ++j) {
              const float* xp = xr + j * Cin;
              const float* wp = wr + j * Cin * Cout;
              for (int c = 0; c < Cin; ++c)
                acc = fmaf(xp[c], wp[c * Cout], acc);
            }
          }
          oband[(long long)r * row + t] = from_f32<T>(acc);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int H, int W,
           int Cin, int KH, int KW, int Cout, cudaStream_t stream) {
  const int Ho = H - KH + 1, Wo = W - KW + 1;
  if (B < 1 || Cin < 1 || Cout < 1 || KH < 1 || KW < 1 || Ho < 1 ||
      Wo < 1 || (long long)Wo * Cout > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t filter = (size_t)KH * KW * Cin * Cout * sizeof(float);
  const size_t in_row = (size_t)W * Cin * sizeof(float);
  if (filter + KH * in_row > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // rows a band: enough bands for two CTAs per SM, at most Ho, and the
  // band's input rows within kBandBytes (at least one output row's)
  long long fill = (2LL * (sms > 0 ? sms : 132) + B - 1) / B;  // bands/img
  long long r = (Ho + fill - 1) / fill;
  const long long fit = (long long)(kBandBytes / in_row) - (KH - 1);
  if (r > fit) r = fit;
  if (r < 1) r = 1;
  const int R = (int)r;
  const size_t smem = filter + (size_t)(R + KH - 1) * in_row;
  auto kernel = (KH == 3 && KW == 3 && Cin == 1) ? conv2d_kernel<T, 3, 1>
                                                 : conv2d_kernel<T, 0, 0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int row = Wo * Cout;
  const int threads = row >= kMaxThreads ? kMaxThreads : (row + 31) / 32 * 32;
  dim3 grid((Ho + R - 1) / R, B < kMaxGridY ? B : kMaxGridY);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      B, H, W, Cin, KH, KW, Cout, Ho, Wo, R);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (x, w and out share it). x (B, H, W, Cin),
// w (KH, KW, Cin, Cout), out (B, H-KH+1, W-KW+1, Cout), all contiguous.
// Returns a cudaError_t (0 = launched).
extern "C" int conv2d_launch(int dtype, const void* x, const void* w,
                             void* out, int B, int H, int W, int Cin, int KH,
                             int KW, int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch<float>(x, w, out, B, H, W, Cin, KH, KW, Cout,
                                      s);
  if (dtype == 1)
    return repro_torch::launch<__nv_bfloat16>(x, w, out, B, H, W, Cin, KH, KW,
                                              Cout, s);
  return (int)cudaErrorInvalidValue;
}

