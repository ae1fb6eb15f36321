// Mamba's selective scan: the recurrence of every mamba layer (jamba's),
// in the paged engine's ragged chunks and decode steps and in the slot
// engine's whole-prompt prefill and decode.
//
// Replaces the reference's lax.scan step in src/repro/models/ssm.py:131-170
// (ssm_forward), which runs outside any Pallas kernel. Semantics:
// repro_torch/kernels/ref.py ssm_scan_ref. Per batch row b and channel d,
// from the state h = h0[b, d, :]:
//
//   h[n] = exp(dt[b,t,d] a[d,n]) h[n] + dt[b,t,d] x[b,t,d] bm[b,t,n]
//   y[b,t,d] = sum_n h[n] cm[b,t,n]
//
// Layout: dt, x, y (B, S, di), bm, cm (B, S, N), a (di, N), h0 and
// h_final (B, di, N), all contiguous float32; N = 16 (every mamba config).
// The kernel takes no sequence length: a caller that pads a row sets dt
// to 0 past its valid lanes, where exp(0) = 1 and 0 * x = 0 carry the
// state through exactly.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on CUDA cores,
// data sheet), each input read once and each output written once, and
// 7 N + 1 operations per (b, t, d) (dt a, its exponential counted as one,
// the decay and input products and their sum, the output term and its
// sum, for each of the N states; dt x once):
//  - jamba's chunk at B=8, S=256, di=16,384: dt, x, y 402.7 MB, h0 and
//    h_final 16.8 MB, a 1.0 MB, bm and cm 0.3 MB: 420.8 MB, 125.6 us;
//    3.8 GFLOP, 56.6 us. Bytes bound it.
//  - a decode step at B=8, S=1: the state read and written 16.8 MB, a
//    1.0 MB, dt, x, y 1.6 MB: 19.4 MB, 5.8 us. Bytes bound it.
//
// Design: one thread per (b, d), its N = 16 states and a[d, :] in
// registers for the whole sequence; a CTA takes 128 neighbouring
// channels of one row, so the per-step reads of dt and x and the write
// of y are 512-byte coalesced rows. Each step's bm and cm are shared by
// the CTA: kSteps steps of both are staged in shared memory at a time
// and read as broadcasts. The next step's dt and x are loaded before the
// current step's arithmetic. A (b, d) pair is one chain of S dependent
// steps; its 16 state updates are independent, which is the
// instruction-level parallelism each step has. At jamba's width a row
// gives 128 CTAs, so B >= 2 rows fill the card's 132 SMs more than once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace ssm {

constexpr int kN = 16;         // state size
constexpr int kThreads = 128;  // channels per CTA
constexpr int kSteps = 32;     // steps of bm / cm staged at a time

struct Args {
  const float* dt;
  const float* bm;
  const float* cm;
  const float* x;
  const float* a;
  const float* h0;
  float* y;
  float* h_final;
  int S;
  int di;
  bool vec;  // a, h0, h_final 16-byte aligned: float4 accesses
};

__device__ __forceinline__ void load16(const float* __restrict__ p,
                                       float (&v)[kN], bool vec) {
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) {
      float4 f = __ldg(p4 + i);
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = __ldg(p + i);
  }
}

__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(const Args a) {
  __shared__ float bs[kSteps][kN];
  __shared__ float cs[kSteps][kN];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < a.di;
  const long long row = (long long)b * a.S;           // (b, t=0) of (B, S)
  float h[kN], an[kN];
  if (live) {
    load16(a.h0 + ((long long)b * a.di + d) * kN, h, a.vec);
    load16(a.a + (long long)d * kN, an, a.vec);
  }
  // the first step's dt and x; each step loads the next one's
  float dt_next = 0.f, x_next = 0.f;
  if (live) {
    dt_next = __ldg(a.dt + row * a.di + d);
    x_next = __ldg(a.x + row * a.di + d);
  }
  for (int t0 = 0; t0 < a.S; t0 += kSteps) {
    const int steps = min(kSteps, a.S - t0);
    __syncthreads();  // the previous chunk's reads are done
    const float* bsrc = a.bm + (row + t0) * kN;
    const float* csrc = a.cm + (row + t0) * kN;
    for (int i = threadIdx.x; i < steps * kN; i += kThreads) {
      bs[i / kN][i % kN] = __ldg(bsrc + i);
      cs[i / kN][i % kN] = __ldg(csrc + i);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < steps; ++j) {
      const long long at = (row + t0 + j) * a.di + d;
      const float dtv = dt_next, xv = x_next;
      if (t0 + j + 1 < a.S) {
        dt_next = __ldg(a.dt + at + a.di);
        x_next = __ldg(a.x + at + a.di);
      }
      const float dx = dtv * xv;
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        h[n] = expf(dtv * an[n]) * h[n] + dx * bs[j][n];
        y = fmaf(h[n], cs[j][n], y);
      }
      a.y[at] = y;
    }
  }
  if (!live) return;
  float* dst = a.h_final + ((long long)b * a.di + d) * kN;
  if (a.vec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int i = 0; i < kN / 4; ++i)
      d4[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) dst[i] = h[i];
  }
}

}  // namespace ssm
}  // namespace repro_torch

extern "C" int ssm_scan_launch(const void* dt, const void* bm, const void* cm,
                               const void* x, const void* a, const void* h0,
                               void* y, void* h_final, int B, int S, int di,
                               int N, void* stream) {
  using namespace repro_torch::ssm;
  if (N != kN || B < 1 || S < 1 || di < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Args args{};
  args.dt = static_cast<const float*>(dt);
  args.bm = static_cast<const float*>(bm);
  args.cm = static_cast<const float*>(cm);
  args.x = static_cast<const float*>(x);
  args.a = static_cast<const float*>(a);
  args.h0 = static_cast<const float*>(h0);
  args.y = static_cast<float*>(y);
  args.h_final = static_cast<float*>(h_final);
  args.S = S;
  args.di = di;
  bool vec = true;
  const void* const bases[] = {a, h0, h_final};
  for (const void* p : bases)
    vec = vec && (reinterpret_cast<uintptr_t>(p) % 16 == 0);
  args.vec = vec;
  dim3 grid((di + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args);
  return (int)cudaGetLastError();
}
