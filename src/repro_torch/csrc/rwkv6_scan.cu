// WKV6 recurrence of RWKV-6 (Finch): the time-mix core of every rwkv6
// layer, in the slot engine's whole-prompt prefill and its decode step.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:90
// (rwkv6_scan, body _kernel). Semantics: repro_torch/kernels/ref.py
// rwkv6_scan_ref. Per (batch row b, head h), from the state S = s0[b, h]:
//
//   o_t[j] = sum_i r_t[i] (S[i,j] + u[i] k_t[i] v_t[j])
//   S[i,j] = w_t[i] S[i,j] + k_t[i] v_t[j]
//
// Layout: r, k, v, w, out (B, H, S, hd) float32, each given by element
// strides over (B, H, S) with head_dim contiguous, so the model's
// (B, S, H, hd) projections go in as transposed views without copies;
// u (H, hd), s0 and s_final (B, H, hd, hd) contiguous float32.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on CUDA cores,
// data sheet), counting each input read once and each output written
// once, and the least operations, 5 hd^2 + 5 hd per (b, h, step): 2 for
// r.S and 3 for the state update per (i, j), the bonus term per i/j:
//  - prefill at B=1, H=32, S=200, hd=64: r, k, v, w, out 8.19 MB, s0 and
//    s_final 1.05 MB, u 8 KB: 9.25 MB, 2.76 us; 0.133 GFLOP, 1.99 us.
//    Bytes bound it. (The reference's recurrence_cost counts 8 hd^2 per
//    step, 0.21 GFLOP, 3.1 us: it counts the k (x) v product and the
//    u-weighted sum that the least count folds away.)
//  - decode at B=4 slots, S=1: the state read and written, 4.19 MB, plus
//    r, k, v, w, out 0.16 MB: 4.37 MB, 1.30 us. Bytes bound it.
//
// What holds a plain per-step kernel back is parallelism and latency: a
// (b, h) pair is one chain of S dependent steps, and a prompt row has only
// 32 of them. The model calls the scan in float32 against 1e-4 limits,
// which TF32 tensor cores (the chunked closed form) cannot hold, so the
// recurrence stays the plain per-step form, spread wider:
//
//   * Value columns over CTAs: column j of S depends only on r, k, w
//     (every i) and v[j], so a CTA takes (b, h, a block of kCols = 16
//     columns). A prompt row gets 32 x 4 = 128 CTAs, a 4-slot decode 512.
//   * State rows over threads: 16 threads share a column, each keeping 4
//     rows of it in registers, so a CTA is 256 threads (8 warps). Per step
//     a thread does 4 FMA chains of one step each; o_t[j] is a sum over
//     the 16 threads, taken every 16 steps as one reduce-scatter (15
//     shuffles leave lane i with step i's output) instead of a 64-long
//     chain per step.
//   * Inputs staged with 16-byte cp.async copies, double-buffered: chunk
//     c + 1's r, k, w (all hd rows) and v (the CTA's columns) are in
//     flight while chunk c runs; one barrier per chunk.
//   * The state slice is read and written with coalesced 16-byte accesses
//     through shared memory, so at S = 1 the kernel is a stream of the
//     state.
//
// Per (i, j) and step: kv = k v, o += r (S + u kv), S = w S + kv, as the
// reference rounds it. The plain form needs neither the Pallas kernel's
// logarithms of w nor its 1e-30 clamp. Any S >= 1 and head_dim <= 64;
// unaligned operands or odd head dims take 4-byte copies.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace wkv {

constexpr int kMaxHd = 64;                  // head_dim limit
constexpr int kCols = 16;                   // value columns per CTA
constexpr int kRowThreads = 16;             // threads sharing a column
constexpr int kRows = kMaxHd / kRowThreads; // state rows per thread
constexpr int kThreads = kCols * kRowThreads;
constexpr int kSteps = 32;                  // time steps staged per chunk
constexpr int kStatePitch = 32;             // floats per staged state row

// element strides of a (B, H, S, hd) operand; head_dim's is 1
struct Strides {
  long long b, h, s;
};

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;
  float* out;
  float* s_final;
  Strides rs, ks, vs, ws, os;
  int H, S, hd;
  int steps;   // staged per chunk: min(kSteps, S)
  int vec;     // every row 16-byte aligned: 16-byte copies
};

// floats of one staging buffer: r, k, w [steps][kMaxHd], v [steps][kCols]
__host__ __device__ constexpr int buffer_floats(int steps) {
  return steps * (3 * kMaxHd + kCols);
}
__host__ __device__ constexpr size_t smem_bytes(int steps) {
  return ((size_t)2 * buffer_floats(steps) + kMaxHd * kStatePitch) *
         sizeof(float);
}

// Where (row i, column j) of the CTA's state slice lies in shared memory:
// rows padded to 32 floats and their 16-byte chunks XOR-swizzled by i / 4,
// so the 16 threads of a column (rows 4t .. 4t + 3) meet in 16 banks, two
// to a bank, where unswizzled 16-float rows put all 16 in one.
__device__ __forceinline__ int sidx(int i, int j) {
  return i * kStatePitch + ((((j >> 2) ^ (i >> 2)) & 7) << 2) + (j & 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sum N values over the lanes that differ in the bits below 2 * OFF,
// halving them at each level: afterwards v[0] of lane l holds the sum of
// value (l mod 2 OFF) (N = 2 OFF; compile-time indices, so v stays in
// registers).
template <int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (OFF >= 1) {
    const bool upper = lane & OFF;
#pragma unroll
    for (int x = 0; x < N / 2; ++x) {
      const float send = upper ? v[x] : v[x + N / 2];
      const float keep = upper ? v[x + N / 2] : v[x];
      v[x] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    reduce_scatter<N / 2, OFF / 2>(v, lane);
  }
}

// Copy n rows of width floats, row x from src + x * stride, into dst rows
// of pitch floats: 16 bytes a thread where vec, else 4.
__device__ __forceinline__ void copy_rows(float* dst, int pitch,
                                          const float* src, long long stride,
                                          int n, int width, bool vec) {
  if (vec) {
    const int q = width / 4;
    for (int e = threadIdx.x; e < n * q; e += kThreads)
      cp16(dst + (e / q) * pitch + (e % q) * 4,
           src + (e / q) * stride + (e % q) * 4);
  } else {
    for (int e = threadIdx.x; e < n * width; e += kThreads)
      cp4(dst + (e / width) * pitch + e % width,
          src + (e / width) * stride + e % width);
  }
}

__global__ void __launch_bounds__(kThreads) rwkv6_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int j0 = blockIdx.x * kCols, h = blockIdx.y, b = blockIdx.z;
  const int hd = a.hd, steps = a.steps;
  const int ncols = min(kCols, hd - j0);
  const int tid = threadIdx.x, lane = tid & 31;
  const int jj = (tid >> 5) * 2 + (lane >> 4);   // the thread's column
  const int ti = lane & 15, i0 = ti * kRows;      // and its 4 rows
  const bool vec = a.vec != 0;
  float* sst = smem + 2 * buffer_floats(steps);   // sidx(row, column)

  const float* rp = a.r + b * a.rs.b + h * a.rs.h;
  const float* kp = a.k + b * a.ks.b + h * a.ks.h;
  const float* vp = a.v + b * a.vs.b + h * a.vs.h + j0;
  const float* wp = a.w + b * a.ws.b + h * a.ws.h;
  const long long state0 = ((long long)b * a.H + h) * hd * hd;

  auto stage = [&](int c) {
    float* buf = smem + (c & 1) * buffer_floats(steps);
    const long long t0 = (long long)c * steps;
    const int nt = min(steps, a.S - (int)t0);
    copy_rows(buf, kMaxHd, rp + t0 * a.rs.s, a.rs.s, nt, hd, vec);
    copy_rows(buf + steps * kMaxHd, kMaxHd, kp + t0 * a.ks.s, a.ks.s, nt, hd,
              vec);
    copy_rows(buf + 2 * steps * kMaxHd, kMaxHd, wp + t0 * a.ws.s, a.ws.s, nt,
              hd, vec);
    copy_rows(buf + 3 * steps * kMaxHd, kCols, vp + t0 * a.vs.s, a.vs.s, nt,
              ncols, vec);
  };

  // rows past hd are never copied: zero them once (r = k = 0 there keeps
  // those rows' state at 0 and out of every sum), and the state slice's
  // padding; then the state slice and chunk 0 in one group
  for (int e = tid; e < 2 * steps * kMaxHd; e += kThreads) {
    if (e % kMaxHd >= hd) {
      float* buf = smem + (e / (steps * kMaxHd)) * buffer_floats(steps);
      const int x = e % (steps * kMaxHd);
      buf[x] = buf[steps * kMaxHd + x] = buf[2 * steps * kMaxHd + x] = 0.f;
    }
  }
  for (int e = tid; e < kMaxHd * kCols; e += kThreads)
    if (e / kCols >= hd || e % kCols >= ncols)
      sst[sidx(e / kCols, e % kCols)] = 0.f;
  const float* s0p = a.s0 + state0 + j0;
  if (vec) {
    const int q4 = ncols / 4;
    for (int e = tid; e < hd * q4; e += kThreads)
      cp16(sst + sidx(e / q4, (e % q4) * 4),
           s0p + (e / q4) * hd + (e % q4) * 4);
  } else {
    for (int e = tid; e < hd * ncols; e += kThreads)
      cp4(sst + sidx(e / ncols, e % ncols),
          s0p + (e / ncols) * hd + e % ncols);
  }
  stage(0);
  commit();

  float u[kRows], st[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q)
    u[q] = i0 + q < hd ? a.u[h * hd + i0 + q] : 0.f;

  const int n_chunks = (a.S + steps - 1) / steps;
  float* op = a.out + b * a.os.b + h * a.os.h + j0 + jj;
  const bool col = jj < ncols;
  for (int c = 0; c < n_chunks; ++c) {
    wait_all();
    // chunk c is here for every thread, and chunk c - 1's buffer is free
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) st[q] = sst[sidx(i0 + q, jj)];
    }
    if (c + 1 < n_chunks) {
      stage(c + 1);
      commit();
    }
    const float* buf = smem + (c & 1) * buffer_floats(steps);
    const float* sr = buf;
    const float* sk = buf + steps * kMaxHd;
    const float* sw = buf + 2 * steps * kMaxHd;
    const float* sv = buf + 3 * steps * kMaxHd;
    const int t0 = c * steps, nt = min(steps, a.S - t0);
    for (int g0 = 0; g0 < nt; g0 += kRowThreads) {
      // o[x]: this thread's part of step g0 + x's output
      float o[kRowThreads];
#pragma unroll
      for (int x = 0; x < kRowThreads; ++x) {
        o[x] = 0.f;
        if (g0 + x < nt) {
          const int t = g0 + x;
          const int x0 = t * kMaxHd + i0;
          const float4 r4 = *reinterpret_cast<const float4*>(sr + x0);
          const float4 k4 = *reinterpret_cast<const float4*>(sk + x0);
          const float4 w4 = *reinterpret_cast<const float4*>(sw + x0);
          const float vj = sv[t * kCols + jj];
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
          const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
          // the thread's rows summed in order, as the plain version's
          // float32 product sums them: the model amplifies the rounding
          // of any other order through its 24 layers
          float acc = 0.f;
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const float kv = kk[q] * vj;
            acc += rr[q] * fmaf(u[q], kv, st[q]);
            st[q] = fmaf(ww[q], st[q], kv);
          }
          o[x] = acc;
        }
      }
      // reduce-scatter over the column's 16 threads: lane ti ends with the
      // whole sum of step g0 + ti in o[0]
      reduce_scatter<kRowThreads, kRowThreads / 2>(o, lane);
      if (col && g0 + ti < nt) op[(long long)(t0 + g0 + ti) * a.os.s] = o[0];
    }
  }

  // the final state through shared memory, stored 16 bytes a thread
#pragma unroll
  for (int q = 0; q < kRows; ++q) sst[sidx(i0 + q, jj)] = st[q];
  __syncthreads();
  float* sf = a.s_final + state0 + j0;
  if (vec) {
    const int q4 = ncols / 4;
    for (int e = tid; e < hd * q4; e += kThreads)
      *reinterpret_cast<float4*>(sf + (long long)(e / q4) * hd +
                                 (e % q4) * 4) =
          *reinterpret_cast<const float4*>(sst + sidx(e / q4, (e % q4) * 4));
  } else {
    for (int e = tid; e < hd * ncols; e += kThreads)
      sf[(long long)(e / ncols) * hd + e % ncols] =
          sst[sidx(e / ncols, e % ncols)];
  }
}

}  // namespace wkv
}  // namespace repro_torch

// strides: 15 element strides, (b, head, seq) of r, k, v, w and out in
// that order. Returns a cudaError_t (0 = launched).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* out, void* s_final,
                                 const long long* st, int B, int H, int S,
                                 int hd, void* stream) {
  using namespace repro_torch::wkv;
  if (hd < 1 || hd > kMaxHd || S < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.out = static_cast<float*>(out);
  a.s_final = static_cast<float*>(s_final);
  a.rs = {st[0], st[1], st[2]};
  a.ks = {st[3], st[4], st[5]};
  a.vs = {st[6], st[7], st[8]};
  a.ws = {st[9], st[10], st[11]};
  a.os = {st[12], st[13], st[14]};
  a.H = H;
  a.S = S;
  a.hd = hd;
  a.steps = S < kSteps ? S : kSteps;
  // 16-byte copies need every row start (and column block) 16-byte aligned
  bool vec = hd % 4 == 0;
  const void* const bases[] = {r, k, v, w, s0, s_final};
  for (const void* p : bases)
    vec = vec && (reinterpret_cast<uintptr_t>(p) % 16 == 0);
  for (int i = 0; i < 12; ++i) vec = vec && st[i] % 4 == 0;
  a.vec = vec;
  const size_t smem = smem_bytes(a.steps);
  static unsigned long long allowed = 0;   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(allowed >> dev & 1ull)) {
    err = cudaFuncSetAttribute(rwkv6_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kSteps));
    if (err != cudaSuccess) return (int)err;
    allowed |= 1ull << dev;
  }
  dim3 grid((hd + kCols - 1) / kCols, H, B);
  rwkv6_scan_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
