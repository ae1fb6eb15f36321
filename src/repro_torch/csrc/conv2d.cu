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
// summed in float32, taps in the order (i, j, c), and stored in x's type
// (float32 or bfloat16).
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
// Design, for the store stream and for latency:
//
// - Persistent CTAs over work items. An item is a band of output rows of
//   one image; CTA c walks items c, c + grid, ... The plan
//   (kernels/conv2d.py:plan, computed on the host from the shapes and
//   the SM count, validated here) picks the band's rows and the CTAs:
//   whole images at evaluation's batches (B=2000: 2,000 items on 264
//   CTAs), bands of a few rows where the batch is small, so that every
//   CTA the card holds gets one (B=32: 416 bands of 2 rows; B=1: 26 of
//   one). The filter is read once per CTA.
// - A ring of `stages` (8) slots in shared memory holds the input rows
//   of the CTA's next items. Thread 0 fills a slot with one 1-D bulk
//   copy (cp.async.bulk ... mbarrier::complete_tx::bytes: an item's input
//   rows are contiguous in NHWC) and writes the item's descriptor beside
//   it; the CTA's first 8 items are in flight while the filter arrives,
//   and each slot, once read, takes the item 8 ahead. So loads run ahead
//   of compute, and while an item computes the stores of the items
//   before it drain: they leave the threads as 16-byte vector stores,
//   each warp writing 512 contiguous bytes, with no staging (an output
//   ring drained by bulk stores measured no faster and, holding 13 to 87
//   KB a slot, left fewer CTAs per SM). One barrier per item.
// - Bulk copies need 16-byte aligned addresses and sizes. A slot holds
//   its window at the window's own offset within a 16-byte chunk, so the
//   copy covers the whole chunks around it, clipped to those inside x;
//   thread 0 copies the few elements of a misaligned first or last chunk
//   of x itself (a bfloat16 row of 28 pixels is 56 bytes, so a one-row
//   band may start 8 bytes into a chunk). No read leaves x.
// - One thread computes 4 output channels of a pixel: each broadcast
//   read of an input value feeds 4 FMAs, and the 4 results leave as one
//   vector (16 bytes in float32). The paper's 3x3x1 filter (Cout % 4 ==
//   0) has a variant whose threads load their 9 x 4 taps from device
//   memory straight into registers, while the first rows arrive, and
//   keep them for the whole launch, the tap loops unrolled; other shapes
//   stage the filter in shared memory as float32 and run runtime tap
//   loops, and a Cout that is not a multiple of 4 ends in a scalar tail.
//
// Operands must be contiguous (the wrapper checks); nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kMaxThreads = 512;   // a CTA's threads (the plan's cap)
constexpr int kMaxSmem = 232448;   // bytes of shared memory a CTA may use
constexpr int kBarBytes = 64;      // mbarriers at the base of shared memory
constexpr int kMaxStages = kBarBytes / 8;
constexpr int kDescBytes = kMaxStages * 16;   // then the items' descriptors

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// thread 0's arrival on a slot's barrier, expecting `bytes` of bulk copy
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uintptr_t down16(uintptr_t a) {
  return a & ~(uintptr_t)15;
}
__device__ __forceinline__ uintptr_t up16(uintptr_t a) {
  return (a + 15) & ~(uintptr_t)15;
}
__device__ __forceinline__ uintptr_t amin(uintptr_t a, uintptr_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ uintptr_t amax(uintptr_t a, uintptr_t b) {
  return a > b ? a : b;
}

// Stores acc[0 .. n) at p: one vector where n == 4 and p is aligned to
// it, else element by element.
template <typename T>
__device__ __forceinline__ void store4(T* p, const float* acc, int n);
template <>
__device__ __forceinline__ void store4<float>(float* p, const float* acc,
                                              int n) {
  if (n == 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  } else {
    for (int u = 0; u < n; ++u) p[u] = acc[u];
  }
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      const float* acc,
                                                      int n) {
  if (n == 4 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&lo);
    v.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = v;
  } else {
    for (int u = 0; u < n; ++u) p[u] = __float2bfloat16(acc[u]);
  }
}

struct Shape {
  int B, H, W, Cin, KH, KW, Cout, Ho, Wo;
  int R, bands, items, stages, slot;
};

// What thread 0 tells the CTA of the item in a slot, beside it.
struct Item {
  long long obase;   // the band's first output element
  int nr;            // rows of the band
  int lead;          // bytes of the slot before the window's first
};

// FIXED: the 3x3x1 filter with Cout % 4 == 0, taps in registers; else
// runtime tap loops. Both sum the taps in the same order (i, j, c).
template <typename T, bool FIXED>
__global__ void __launch_bounds__(kMaxThreads)
    conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ out, const Shape p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  Item* desc = reinterpret_cast<Item*>(smem + kBarBytes);
  float* sw = reinterpret_cast<float*>(smem + kBarBytes + kDescBytes);
  const int nw = p.KH * p.KW * p.Cin * p.Cout;
  unsigned char* sx = reinterpret_cast<unsigned char*>(sw) +
                      ((nw * 4 + 15) & ~15);
  const int tid = threadIdx.x;
  const int es = (int)sizeof(T);
  const int row = p.Wo * p.Cout;       // output elements of a row
  const int quads = (p.Cout + 3) / 4;
  const int work = p.Wo * quads;       // (pixel, quad) pairs of a row
  const size_t in_row = (size_t)p.W * p.Cin * es;   // bytes

  // thread 0: fill slot s with the item's rows oy0 .. oy0+nr+KH-2, and
  // its descriptor
  auto issue_load = [&](unsigned item, int s) {
    const int b = (int)(item / (unsigned)p.bands);
    const int oy0 = (int)(item - (unsigned)b * p.bands) * p.R;
    const int nr = min(p.R, p.Ho - oy0);
    const uintptr_t x_lo = reinterpret_cast<uintptr_t>(x);
    const uintptr_t x_hi = x_lo + (size_t)p.B * p.H * in_row;
    const uintptr_t lo = x_lo + ((size_t)b * p.H + oy0) * in_row;
    const uintptr_t hi = lo + (size_t)(nr + p.KH - 1) * in_row;
    unsigned char* slot = sx + (size_t)s * p.slot;
    const uintptr_t base = down16(lo);   // slot byte 0 <-> this address
    const uintptr_t c0 = amax(base, up16(x_lo));
    const uintptr_t c1 = amin(up16(hi), down16(x_hi));
    uint32_t bulk = 0;
    if (c1 > c0) {
      bulk = (uint32_t)(c1 - c0);
      bulk_load(slot + (c0 - base), reinterpret_cast<const void*>(c0), bulk,
                &full[s]);
    }
    // elements of the window outside the bulk copy: in a misaligned
    // first or last chunk of x, or all of a window too short for a chunk
    for (uintptr_t a = lo; a < hi; a += es) {
      if (bulk && a >= c0 && a < c1) a = c1 - es;   // skip the bulk part
      else
        *reinterpret_cast<T*>(slot + (a - base)) =
            *reinterpret_cast<const T*>(a);
    }
    desc[s] = Item{((long long)b * p.Ho + oy0) * row, nr, (int)(lo - base)};
    mbar_arrive_tx(&full[s], bulk);    // releases the copies and desc[s]
  };

  // the first `stages` items' rows in flight while the filter arrives
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < p.stages; ++s) {
      const long long item = blockIdx.x + (long long)s * gridDim.x;
      if (item < p.items) issue_load((unsigned)item, s);
    }
  }
  // FIXED: the thread's 9 x 4 taps straight into registers (a 16-byte
  // load each in float32), so their latency overlaps the first rows'
  float wr[FIXED ? 9 : 1][4];
  auto load_taps = [&](int co) {
    const T* wp = w + co;
    const bool vec = ((reinterpret_cast<uintptr_t>(w) | (p.Cout * es)) &
                      (4 * es - 1)) == 0;
#pragma unroll
    for (int k = 0; k < (FIXED ? 9 : 1); ++k, wp += p.Cout) {
      if (vec && es == 4) {
        const float4 v = *reinterpret_cast<const float4*>(wp);
        wr[k][0] = v.x, wr[k][1] = v.y, wr[k][2] = v.z, wr[k][3] = v.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) wr[k][u] = to_f32(wp[u]);
      }
    }
  };
  // the pixel, channels and taps of a thread are the same for every item
  // where a row takes one pass (the paper's 26 x 8 pairs)
  const bool one_pass = work <= (int)blockDim.x;
  if (FIXED && one_pass) load_taps(4 * (tid % quads));
  // other filters: staged in shared memory as float32, 16 loads in
  // flight per thread
  constexpr int kBatch = 16;
  for (int i0 = 0; i0 < (FIXED ? 0 : nw); i0 += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * blockDim.x + tid;
      v[k] = i < nw ? to_f32(w[i]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * blockDim.x + tid;
      if (i < nw) sw[i] = v[k];
    }
  }
  __syncthreads();               // barriers initialised, filter staged

  int s = 0;
  uint32_t parity = 0;
  for (long long item = blockIdx.x; item < p.items; item += gridDim.x) {
    mbar_wait(&full[s], parity);
    const Item d = desc[s];
    const T* xs =
        reinterpret_cast<const T*>(sx + (size_t)s * p.slot + d.lead);
    T* const os = out + d.obase;

    for (int t = tid; t < work; t += blockDim.x) {
      const int ox = t / quads;
      const int co = 4 * (t - ox * quads);
      if constexpr (FIXED) {
        if (!one_pass) load_taps(co);
        const T* xr = xs + ox;
        T* o = os + ox * p.Cout + co;
        for (int r = 0; r < d.nr; ++r, xr += p.W, o += row) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const float xv = to_f32(xr[i * p.W + j]);
#pragma unroll
              for (int u = 0; u < 4; ++u)
                acc[u] = fmaf(xv, wr[i * 3 + j][u], acc[u]);
            }
          store4<T>(o, acc, 4);
        }
      } else {
        const int nu = min(4, p.Cout - co);
        for (int r = 0; r < d.nr; ++r) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int i = 0; i < p.KH; ++i) {
            const T* xr = xs + ((r + i) * p.W + ox) * p.Cin;
            const float* wi = sw + i * p.KW * p.Cin * p.Cout + co;
            for (int j = 0; j < p.KW; ++j)
              for (int c = 0; c < p.Cin; ++c) {
                const float xv = to_f32(xr[j * p.Cin + c]);
                const float* wp = wi + (j * p.Cin + c) * p.Cout;
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  if (u < nu) acc[u] = fmaf(xv, wp[u], acc[u]);
              }
          }
          store4<T>(os + (long long)r * row + ox * p.Cout + co, acc, nu);
        }
      }
    }

    __syncthreads();   // slot s read by every thread
    // the slot just read takes the item `stages` ahead
    const long long next = item + (long long)p.stages * gridDim.x;
    if (tid == 0 && next < p.items) issue_load((unsigned)next, s);
    if (++s == p.stages) {
      s = 0;
      parity ^= 1;
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, const Shape& p,
           int ctas, int threads, int smem, cudaStream_t stream) {
  auto kernel = (p.KH == 3 && p.KW == 3 && p.Cin == 1 && p.Cout % 4 == 0)
                    ? conv2d_kernel<T, true>
                    : conv2d_kernel<T, false>;
  // raised once per variant and size, so a launch being captured into a
  // CUDA graph makes no attribute call
  static int allowed[2] = {48 * 1024, 48 * 1024};
  int& cap = allowed[kernel == conv2d_kernel<T, true> ? 1 : 0];
  if (smem > cap) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cap = smem;
  }
  kernel<<<ctas, threads, smem, stream>>>(static_cast<const T*>(x),
                                          static_cast<const T*>(w),
                                          static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

__host__ inline long long round16(long long n) { return (n + 15) / 16 * 16; }

// The plan (kernels/conv2d.py:plan) must describe this shape and fit
// the kernel; nothing of it is recomputed here.
inline bool plan_ok(const Shape& p, int es, int ctas, int threads,
                    int smem) {
  if (p.B < 1 || p.Cin < 1 || p.Cout < 1 || p.KH < 1 || p.KW < 1 ||
      p.Ho < 1 || p.Wo < 1)
    return false;
  const long long items = (long long)p.B * p.bands;
  if (p.R < 1 || p.R > p.Ho || p.bands != (p.Ho + p.R - 1) / p.R ||
      p.items != items || items > 0x7fffffffLL)
    return false;
  if (ctas < 1 || ctas > p.items || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || p.stages < 1 || p.stages > kMaxStages)
    return false;
  const long long win = (long long)(p.R + p.KH - 1) * p.W * p.Cin * es;
  if (p.slot % 16 != 0 || p.slot < win + 16 - es) return false;
  const long long total =
      kBarBytes + kDescBytes +
      round16((long long)p.KH * p.KW * p.Cin * p.Cout * 4) +
      (long long)p.stages * p.slot;
  return total == smem && smem <= kMaxSmem;
}

}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (x, w and out share it). x (B, H, W, Cin),
// w (KH, KW, Cin, Cout), out (B, H-KH+1, W-KW+1, Cout), all contiguous.
// R .. smem: the launch plan of kernels/conv2d.py:plan. Returns a
// cudaError_t (0 = launched; cudaErrorInvalidValue for a bad plan).
extern "C" int conv2d_launch(int dtype, const void* x, const void* w,
                             void* out, int B, int H, int W, int Cin, int KH,
                             int KW, int Cout, int R, int bands, int items,
                             int ctas, int threads, int stages, int slot,
                             int smem, void* stream) {
  const repro_torch::Shape p{B,     H,     W,      Cin,    KH,      KW,
                             Cout,  H - KH + 1,    W - KW + 1,     R,
                             bands, items, stages, slot};
  const int es = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) ||
      !repro_torch::plan_ok(p, es, ctas, threads, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch<float>(x, w, out, p, ctas, threads, smem, s);
  return repro_torch::launch<__nv_bfloat16>(x, w, out, p, ctas, threads,
                                            smem, s);
}
