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
//    u-weighted sum that this kernel folds away.)
//  - decode at B=4 slots, S=1: the state read and written, 4.19 MB, plus
//    r, k, v, w, out 0.16 MB: 4.37 MB, 1.30 us. Bytes bound it.
//
// Design: column j of S depends only on r, k, w (every i) and v[j], so
// one CTA per (b, h) runs kMaxHd threads and thread j keeps column j of
// S in registers for the whole sequence. The TPU kernel's sequential
// chunk grid axis becomes a loop inside the CTA, and no state passes
// between CTAs. Each pass stages kT time steps of r, k, w and v in shared
// memory (zero past hd and past S, so no step or row is padded in device
// memory), the two warps reduce the bonus sum_i r_t[i] u[i] k_t[i] of
// each staged step with shuffles, and then every thread walks the kT
// steps: o_t[j] = r_t . S[:, j] + v_t[j] bonus_t, then the update. The
// recurrence runs in the plain form, so it needs neither the Pallas
// kernel's logarithms of w nor its 1e-30 clamp.
//
// What bounds it today: one CTA of two warps per (b, h), so the prefill
// grid is 32 CTAs on 132 SMs and each step is a chain of 64 dependent
// shared-memory reads and FMAs per thread; the chunked closed form on
// tensor cores (and splitting the value columns over CTAs) is later
// work.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kMaxHd = 64;       // head_dim limit; also the CTA's threads
constexpr int kT = 32;           // time steps staged per pass

// element strides of a (B, H, S, hd) operand; head_dim's is 1
struct Strides {
  long long b, h, s;
};

__global__ void __launch_bounds__(kMaxHd)
    rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, float* __restrict__ out,
                      float* __restrict__ s_final, Strides rs,
                      Strides ks, Strides vs, Strides ws, Strides os, int H,
                      int S, int hd) {
  __shared__ __align__(16) float sr[kT][kMaxHd];
  __shared__ __align__(16) float sk[kT][kMaxHd];
  __shared__ __align__(16) float sw[kT][kMaxHd];
  __shared__ float sv[kT][kMaxHd];
  __shared__ float su[kMaxHd];
  __shared__ float bonus[kT];

  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const bool col = j < hd;
  const long long state0 = ((long long)b * H + h) * hd * hd;

  float st[kMaxHd];              // column j of S; rows past hd stay 0
#pragma unroll
  for (int i = 0; i < kMaxHd; ++i)
    st[i] = (col && i < hd) ? s0[state0 + (long long)i * hd + j] : 0.f;
  su[j] = col ? u[h * hd + j] : 0.f;

  const float* rp = r + b * rs.b + h * rs.h;
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;
  const float* wp = w + b * ws.b + h * ws.h;
  float* op = out + b * os.b + h * os.h;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int nt = min(kT, S - t0);
    // every thread is past the previous pass's reads of the buffers
    __syncthreads();
#pragma unroll 4
    for (int e = j; e < kT * kMaxHd; e += kMaxHd) {
      const int t = e / kMaxHd, i = e % kMaxHd;
      const bool ok = t < nt && i < hd;
      const long long ts = t0 + t;
      sr[t][i] = ok ? rp[ts * rs.s + i] : 0.f;
      sk[t][i] = ok ? kp[ts * ks.s + i] : 0.f;
      sw[t][i] = ok ? wp[ts * ws.s + i] : 0.f;
      sv[t][i] = ok ? vp[ts * vs.s + i] : 0.f;
    }
    __syncthreads();
    // bonus_t = sum_i r_t[i] u[i] k_t[i]: warp 0 takes the even steps,
    // warp 1 the odd ones, lane l rows l and l + 32
    for (int t = warp; t < kT; t += 2) {
      float p = sr[t][lane] * su[lane] * sk[t][lane] +
                sr[t][lane + 32] * su[lane + 32] * sk[t][lane + 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) bonus[t] = p;
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float vj = sv[t][j];
      const float4* r4 = reinterpret_cast<const float4*>(sr[t]);
      const float4* k4 = reinterpret_cast<const float4*>(sk[t]);
      const float4* w4 = reinterpret_cast<const float4*>(sw[t]);
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxHd / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        o0 = fmaf(rr.x, st[4 * q], o0);
        o1 = fmaf(rr.y, st[4 * q + 1], o1);
        o2 = fmaf(rr.z, st[4 * q + 2], o2);
        o3 = fmaf(rr.w, st[4 * q + 3], o3);
        st[4 * q] = fmaf(ww.x, st[4 * q], kk.x * vj);
        st[4 * q + 1] = fmaf(ww.y, st[4 * q + 1], kk.y * vj);
        st[4 * q + 2] = fmaf(ww.z, st[4 * q + 2], kk.z * vj);
        st[4 * q + 3] = fmaf(ww.w, st[4 * q + 3], kk.w * vj);
      }
      if (col)
        op[(long long)(t0 + t) * os.s + j] =
            (o0 + o1) + (o2 + o3) + vj * bonus[t];
    }
  }

  if (col) {
#pragma unroll
    for (int i = 0; i < kMaxHd; ++i)
      if (i < hd) s_final[state0 + (long long)i * hd + j] = st[i];
  }
}

}  // namespace repro_torch

// strides: 15 element strides, (b, head, seq) of r, k, v, w and out in
// that order. Returns a cudaError_t (0 = launched).
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* s0,
                                 void* out, void* s_final,
                                 const long long* st, int B, int H, int S,
                                 int hd, void* stream) {
  using repro_torch::Strides;
  if (hd < 1 || hd > repro_torch::kMaxHd || S < 1)
    return (int)cudaErrorInvalidValue;
  const Strides rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]},
      os{st[12], st[13], st[14]};
  dim3 grid(H, B);
  repro_torch::rwkv6_scan_kernel<<<grid, repro_torch::kMaxHd, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_final), rs, ks, vs, ws,
      os, H, S, hd);
  return (int)cudaGetLastError();
}
