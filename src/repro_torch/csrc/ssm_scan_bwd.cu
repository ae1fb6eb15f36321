// The backward of mamba's selective scan (csrc/ssm_scan.cu): the gradients
// of every mamba layer's recurrence in training (jamba's).
//
// Replaces jax.grad of the reference's selective lax.scan,
// src/repro/models/ssm.py:134-145 (no Pallas kernel on either side of it).
// Semantics: repro_torch/kernels/ref.py ssm_scan_bwd_ref. Per batch row b
// and channel d, with h_t the state after step t (h_{-1} = h0), the decay
// e_t[n] = exp(dt_t a[n]) and g the state's adjoint, from g = dh_final
// back to step 0:
//
//   g       = C_t dy_t + g                     (g: the adjoint of h_t)
//   dC_t[n] = sum_d dy_t[d] h_t[d, n]          (over the channels)
//   dB_t[n] = sum_d g[d, n] dt_t[d] x_t[d]     (over the channels)
//   dx_t    = dt_t sum_n g[n] B_t[n]
//   ddt_t   = sum_n g[n] (a[n] e_t[n] h_{t-1}[n] + x_t B_t[n])
//   da[n]  += g[n] dt_t e_t[n] h_{t-1}[n]      (over b and t)
//   g       = e_t g
//
// and dh0 = g after step 0. Layout: dt, ddt (B, S, di), bm, cm, dbm, dcm
// (B, S, N), a, da (di, N), h0, dh_final, dh0 (B, di, N), contiguous
// float32; x, dy, dx (B, S, di) contiguous in x's dtype (float32 or
// bfloat16). N = 16. exp(v a) is taken as 2 ** (v (a log2 e)), as the
// forward takes it.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on CUDA cores),
// each input read once and each output written once, at jamba's training
// shape B=8, S=128, di=16,384, bf16 x: dt read and ddt written 134.2 MB,
// x, dy read and dx written 100.7 MB, h0, dh_final read and dh0 written
// 25.2 MB, a read and da written 2.1 MB, bm, cm, dbm, dcm 0.3 MB: 262.4
// MB, 78.3 us; the least operations, 18 a (row, step, channel, state)
// (the state recomputed: dt a, the exponent's argument, and e h + (dt x)
// B, 4; g's C dy + g and e g, 3; the sums of dC, dB and dx, 2 each; q =
// (e g) h_{t-1}, 1; da's dt q and ddt's a q, 2 each), 4.83 GFLOP, 72.1 us,
// plus the decays' exponentials, 268 M, 64 us on the SFU (16 a clock per
// SM at 1.98 GHz). Bytes bound it, with the arithmetic close behind.
//
// Design (a first, simple kernel: right, deterministic, no float atomics):
//  - The forward's split over channels: a CTA of 256 threads per (row b,
//    64 channels), a channel's 16 states over 4 neighbouring threads.
//  - Saved states: none from the forward (it stays the serving kernel,
//    unchanged). Phase 1 re-runs the recurrence from h0 (the forward's own
//    expression, so the same bits) and writes the state at the start of
//    every chunk of kL = 16 steps to a workspace, each thread its own 16
//    bytes. Phase 2 walks the chunks backwards, re-runs a chunk's 17
//    states from its checkpoint into registers, then its steps in reverse,
//    taking each decay's ex2 again. The recurrence is never run
//    backwards: the decays underflow toward 0.
//  - Sums: ddt and dx over a channel's 4 threads by shuffles; dB and dC
//    over the warp's 8 channels by shuffles, then the CTA's 8 warps in
//    shared memory at the chunk's end, written per CTA as partials
//    (B, S, di / 64, N); da per thread over the steps, written per row b.
//    A second kernel adds the partials in block order (da in row order).
//    Every sum has a fixed order, so two launches on the same inputs give
//    the same bits.
//  - Inputs staged a chunk at a time with 16-byte cp.async copies (the
//    launcher takes only 16-byte aligned operands and di a multiple of 8,
//    so every row piece is whole 16-byte pieces), the next chunk in flight
//    while the current one computes; ddt and dx leave through shared
//    memory as whole rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace ssm_bwd {

constexpr int kN = 16;                 // state size
constexpr int kG = 4;                  // threads per channel
constexpr int kPer = kN / kG;          // states per thread
constexpr int kC = 64;                 // channels per CTA
constexpr int kThreads = kC * kG;      // 256
constexpr int kWarps = kThreads / 32;
constexpr int kL = 16;                 // steps per chunk
constexpr float kLog2e = 1.4426950408889634f;

// which gradients the caller wants (the others are neither summed nor
// written)
constexpr int kNeedDdt = 1, kNeedDbm = 2, kNeedDcm = 4, kNeedDx = 8,
              kNeedDa = 16, kNeedDh0 = 32;

struct Args {
  const float* dt;
  const float* bm;
  const float* cm;
  const void* x;
  const float* a;
  const float* h0;
  const void* dy;
  const float* dhf;    // null: zeros
  float* ddt;
  void* dx;
  float* dh0;
  float* dbm_part;     // [B][S][nblk][kN]
  float* dcm_part;     // [B][S][nblk][kN]
  float* da_part;      // [B][di][kN]
  float4* ckpt;        // [B][nblk][nchunks - 1][kThreads]
  int B, S, di, nblk, nchunks, need;
};

struct ReduceArgs {
  const float* dbm_part;
  const float* dcm_part;
  const float* da_part;
  float* dbm;
  float* dcm;
  float* da;
  int B, S, di, nblk, need;
};

// one staging buffer: dt [kL][kC] float32, x and dy [kL][kC] in x's type,
// bm and cm [kL][kN]
template <typename XT>
__host__ __device__ constexpr int buf_bytes() {
  return kL * (kC * 4 + 2 * kC * (int)sizeof(XT) + 2 * kN * 4);
}
// then the sums: dB, dC per warp [kWarps][kL][2 kN], ddt and dx [kL][kC]
constexpr int kRedBytes = kWarps * kL * 2 * kN * 4;
constexpr int kRowBytes = 2 * kL * kC * 4;
template <typename XT>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * buf_bytes<XT>() + kRedBytes + kRowBytes;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^v on the SFU, as the forward takes it (ex2 of -0 and +0 is +1)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// Copy n rows of `bytes` bytes, row x from src + x * stride bytes, into
// dst rows of pitch bytes, in 16-byte pieces.
__device__ __forceinline__ void copy_rows(unsigned char* dst, int pitch,
                                          const unsigned char* src,
                                          long long stride, int n,
                                          int bytes) {
  const int q = bytes / 16;
  for (int e = threadIdx.x; e < n * q; e += kThreads)
    cp16(dst + (e / q) * pitch + (e % q) * 16,
         src + (e / q) * stride + (e % q) * 16);
}

// Sum N values over the lanes that differ in bits OFF, OFF/2, .., LAST,
// halving them at each level: afterwards v[0] holds the sum of the value
// whose index is those lane bits (the highest first).
template <int N, int OFF, int LAST>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (OFF >= LAST && N >= 2) {
    const bool upper = lane & OFF;
#pragma unroll
    for (int x = 0; x < N / 2; ++x) {
      const float send = upper ? v[x] : v[x + N / 2];
      const float keep = upper ? v[x + N / 2] : v[x];
      v[x] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    reduce_scatter<N / 2, OFF / 2, LAST>(v, lane);
  }
}

// The pieces of staging buffer `buf`.
template <typename XT>
struct Buf {
  float* dt;   // [kL][kC]
  XT* x;       // [kL][kC]
  XT* dy;      // [kL][kC]
  float* bm;   // [kL][kN]
  float* cm;   // [kL][kN]
  __device__ explicit Buf(unsigned char* base) {
    dt = reinterpret_cast<float*>(base);
    x = reinterpret_cast<XT*>(base + kL * kC * 4);
    dy = x + kL * kC;
    bm = reinterpret_cast<float*>(base + kL * kC * (4 + 2 * sizeof(XT)));
    cm = bm + kL * kN;
  }
};

// Thread (c, g) holds states [g kPer, (g + 1) kPer) of the CTA's channel c.
template <typename XT>
__global__ void __launch_bounds__(kThreads, 2)
    ssm_scan_bwd_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / kG, g = tid % kG;
  const int b = blockIdx.y, blk = blockIdx.x, d0 = blk * kC;
  const int nc = min(kC, p.di - d0);
  const bool live = c < nc;
  const int d = d0 + c;
  const int S = p.S;
  float* sred = reinterpret_cast<float*>(smem + 2 * buf_bytes<XT>());
  float* sddt = sred + kWarps * kL * 2 * kN;     // [kL][kC]
  float* sdx = sddt + kL * kC;                   // [kL][kC]
  float4* ckpt = p.ckpt + ((long long)b * p.nblk + blk) * (p.nchunks - 1) *
                              kThreads + tid;

  // chunk k into buffer k & 1: dt, x, bm always, dy and cm for phase 2
  auto stage = [&](int k, bool all) {
    const Buf<XT> st(smem + (k & 1) * buf_bytes<XT>());
    const long long row = (long long)b * S + (long long)k * kL;
    const int nt = min(kL, S - k * kL);
    copy_rows(reinterpret_cast<unsigned char*>(st.dt), kC * 4,
              reinterpret_cast<const unsigned char*>(p.dt + row * p.di + d0),
              (long long)p.di * 4, nt, nc * 4);
    copy_rows(reinterpret_cast<unsigned char*>(st.x), kC * sizeof(XT),
              reinterpret_cast<const unsigned char*>(
                  static_cast<const XT*>(p.x) + row * p.di + d0),
              (long long)p.di * sizeof(XT), nt, nc * sizeof(XT));
    copy_rows(reinterpret_cast<unsigned char*>(st.bm), 0,
              reinterpret_cast<const unsigned char*>(p.bm + row * kN), 0, 1,
              nt * kN * 4);
    if (all) {
      copy_rows(reinterpret_cast<unsigned char*>(st.dy), kC * sizeof(XT),
                reinterpret_cast<const unsigned char*>(
                    static_cast<const XT*>(p.dy) + row * p.di + d0),
                (long long)p.di * sizeof(XT), nt, nc * sizeof(XT));
      copy_rows(reinterpret_cast<unsigned char*>(st.cm), 0,
                reinterpret_cast<const unsigned char*>(p.cm + row * kN), 0, 1,
                nt * kN * 4);
    }
  };

  // channels past d_inner are never copied: zero them in both buffers (dt =
  // x = dy = 0 keeps their states and adjoints at 0 and out of every sum)
  for (int k = 0; k < 2; ++k) {
    const Buf<XT> st(smem + k * buf_bytes<XT>());
    for (int e = tid; e < kL * kC; e += kThreads) {
      if (e % kC >= nc) {
        st.dt[e] = 0.f;
        from_f32(st.x + e, 0.f);
        from_f32(st.dy + e, 0.f);
      }
    }
  }

  // the state, the decays (a and a log2 e)
  float h[kPer], av[kPer], a2[kPer];
  {
    const long long at = ((long long)b * p.di + d) * kN + g * kPer;
    const float4 hv = live ? *reinterpret_cast<const float4*>(p.h0 + at)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 aa =
        live ? __ldg(reinterpret_cast<const float4*>(p.a + (long long)d * kN +
                                                     g * kPer))
             : make_float4(0.f, 0.f, 0.f, 0.f);
    h[0] = hv.x, h[1] = hv.y, h[2] = hv.z, h[3] = hv.w;
    av[0] = aa.x, av[1] = aa.y, av[2] = aa.z, av[3] = aa.w;
#pragma unroll
    for (int n = 0; n < kPer; ++n) a2[n] = __fmul_rn(av[n], kLog2e);
  }
  __syncthreads();

  // ---- phase 1: the recurrence from h0, a checkpoint a chunk
  if (p.nchunks > 1) {
    stage(0, false);
    commit();
  }
  for (int k = 0; k + 1 < p.nchunks; ++k) {
    wait_all();
    __syncthreads();   // chunk k is here; chunk k - 1's buffer is free
    if (k + 2 < p.nchunks) {
      stage(k + 1, false);
      commit();
    }
    const Buf<XT> st(smem + (k & 1) * buf_bytes<XT>());
#pragma unroll 4
    for (int x = 0; x < kL; ++x) {   // every chunk but the last is whole
      const float dtv = st.dt[x * kC + c];
      const float dx = __fmul_rn(dtv, to_f32(st.x[x * kC + c]));
      const float4 bv = reinterpret_cast<const float4*>(st.bm + x * kN)[g];
      const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int n = 0; n < kPer; ++n)
        h[n] = __fmaf_rn(ex2(__fmul_rn(dtv, a2[n])), h[n],
                         __fmul_rn(dx, bb[n]));
    }
    ckpt[(long long)k * kThreads] = make_float4(h[0], h[1], h[2], h[3]);
  }

  // ---- phase 2: the chunks backwards
  float gs[kPer], da[kPer];
  {
    const long long at = ((long long)b * p.di + d) * kN + g * kPer;
    const float4 gv = (p.dhf && live)
                          ? *reinterpret_cast<const float4*>(p.dhf + at)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    gs[0] = gv.x, gs[1] = gv.y, gs[2] = gv.z, gs[3] = gv.w;
#pragma unroll
    for (int n = 0; n < kPer; ++n) da[n] = 0.f;
  }
  __syncthreads();     // phase 1's buffers are read
  stage(p.nchunks - 1, true);
  commit();
  for (int k = p.nchunks - 1; k >= 0; --k) {
    wait_all();
    // chunk k is here; chunk k + 1's buffer and sums are written out
    __syncthreads();
    if (k > 0) {
      stage(k - 1, true);
      commit();
    }
    const Buf<XT> st(smem + (k & 1) * buf_bytes<XT>());
    const int t0 = k * kL, n = min(kL, S - t0);

    // hs[x]: the state before the chunk's step x; hs[n]: after its last
    float hs[kL + 1][kPer];
    if (k == 0) {
      const long long at = ((long long)b * p.di + d) * kN + g * kPer;
      const float4 hv = live ? *reinterpret_cast<const float4*>(p.h0 + at)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      hs[0][0] = hv.x, hs[0][1] = hv.y, hs[0][2] = hv.z, hs[0][3] = hv.w;
    } else {
      const float4 f = ckpt[(long long)(k - 1) * kThreads];
      hs[0][0] = f.x, hs[0][1] = f.y, hs[0][2] = f.z, hs[0][3] = f.w;
    }
#pragma unroll
    for (int x = 0; x < kL; ++x) {
      if (x < n) {
        const float dtv = st.dt[x * kC + c];
        const float dx = __fmul_rn(dtv, to_f32(st.x[x * kC + c]));
        const float4 bv = reinterpret_cast<const float4*>(st.bm + x * kN)[g];
        const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          hs[x + 1][q] = __fmaf_rn(ex2(__fmul_rn(dtv, a2[q])), hs[x][q],
                                   __fmul_rn(dx, bb[q]));
      }
    }

#pragma unroll
    for (int x = kL - 1; x >= 0; --x) {
      if (x < n) {
        const float dtv = st.dt[x * kC + c];
        const float xv = to_f32(st.x[x * kC + c]);
        const float dyv = to_f32(st.dy[x * kC + c]);
        const float dx = __fmul_rn(dtv, xv);
        const float4 bv = reinterpret_cast<const float4*>(st.bm + x * kN)[g];
        const float4 cv = reinterpret_cast<const float4*>(st.cm + x * kN)[g];
        const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[kPer] = {cv.x, cv.y, cv.z, cv.w};
        float sums[2 * kPer];        // dB[0..3], dC[0..3]
        float sb = 0.f, sa = 0.f;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const float e = ex2(__fmul_rn(dtv, a2[q]));
          const float gq = fmaf(cc[q], dyv, gs[q]);     // adjoint of h_t
          sums[kPer + q] = dyv * hs[x + 1][q];
          sums[q] = gq * dx;
          sb = fmaf(gq, bb[q], sb);
          const float gh = gq * (e * hs[x][q]);
          sa = fmaf(gh, av[q], sa);
          da[q] = fmaf(gh, dtv, da[q]);
          gs[q] = e * gq;
        }
        // ddt and dx over the channel's 4 threads
        sa += __shfl_xor_sync(0xffffffffu, sa, 1);
        sb += __shfl_xor_sync(0xffffffffu, sb, 1);
        sa += __shfl_xor_sync(0xffffffffu, sa, 2);
        sb += __shfl_xor_sync(0xffffffffu, sb, 2);
        if (g == 0) {
          sddt[x * kC + c] = fmaf(xv, sb, sa);
          sdx[x * kC + c] = dtv * sb;
        }
        // dB and dC over the warp's 8 channels: the lane keeps value
        // (lane >> 2) & 7, dB for its state group's states below 4, dC
        // above
        reduce_scatter<2 * kPer, 16, 4>(sums, lane);
        const int slot = (lane >> 2) & 7;
        sred[(warp * kL + x) * 2 * kN + (slot / kPer) * kN + g * kPer +
             slot % kPer] = sums[0];
      }
    }
    __syncthreads();   // the chunk's sums are in

    const long long row = (long long)b * S + t0;
    if (p.need & (kNeedDdt | kNeedDx)) {
      for (int e = tid; e < n * nc; e += kThreads) {
        const int x = e / nc, cc = e % nc;
        const long long at = (row + x) * p.di + d0 + cc;
        if (p.need & kNeedDdt) p.ddt[at] = sddt[x * kC + cc];
        if (p.need & kNeedDx)
          from_f32(static_cast<XT*>(p.dx) + at, sdx[x * kC + cc]);
      }
    }
    if (p.need & (kNeedDbm | kNeedDcm)) {
      for (int e = tid; e < n * 2 * kN; e += kThreads) {
        const int x = e / (2 * kN), kn = e % (2 * kN);
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += sred[(w * kL + x) * 2 * kN + kn];
        float* part = kn < kN ? p.dbm_part : p.dcm_part;
        if (p.need & (kn < kN ? kNeedDbm : kNeedDcm))
          part[((row + x) * p.nblk + blk) * kN + kn % kN] = acc;
      }
    }
  }

  const long long at = ((long long)b * p.di + d) * kN + g * kPer;
  if (live && (p.need & kNeedDh0))
    *reinterpret_cast<float4*>(p.dh0 + at) =
        make_float4(gs[0], gs[1], gs[2], gs[3]);
  if (live && (p.need & kNeedDa))
    *reinterpret_cast<float4*>(p.da_part + at) =
        make_float4(da[0], da[1], da[2], da[3]);
}

// dbm, dcm: the channel blocks' partials added in block order; da: the
// rows' partials added in row order.
__global__ void ssm_scan_bwd_reduce(const ReduceArgs p) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nbc = (long long)p.B * p.S * kN;
  for (long long e = first; e < nbc; e += stride) {
    const long long bt = e / kN, n = e % kN;
    if (p.need & kNeedDbm) {
      float acc = 0.f;
      for (int q = 0; q < p.nblk; ++q)
        acc += p.dbm_part[(bt * p.nblk + q) * kN + n];
      p.dbm[e] = acc;
    }
    if (p.need & kNeedDcm) {
      float acc = 0.f;
      for (int q = 0; q < p.nblk; ++q)
        acc += p.dcm_part[(bt * p.nblk + q) * kN + n];
      p.dcm[e] = acc;
    }
  }
  if (!(p.need & kNeedDa)) return;
  const long long nda = (long long)p.di * kN;
  for (long long e = first; e < nda; e += stride) {
    float acc = 0.f;
    for (int bb = 0; bb < p.B; ++bb) acc += p.da_part[bb * nda + e];
    p.da[e] = acc;
  }
}

template <typename XT>
int launch(const Args& args, const ReduceArgs& ra, cudaStream_t stream) {
  static unsigned long long allowed = 0;   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(allowed >> dev & 1ull)) {
    err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<XT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<XT>());
    if (err != cudaSuccess) return (int)err;
    allowed |= 1ull << dev;
  }
  ssm_scan_bwd_kernel<XT>
      <<<dim3(args.nblk, args.B), kThreads, smem_bytes<XT>(), stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!(args.need & (kNeedDbm | kNeedDcm | kNeedDa))) return 0;
  const long long n = (long long)args.B * args.S * kN > (long long)args.di * kN
                          ? (long long)args.B * args.S * kN
                          : (long long)args.di * kN;
  const long long blocks = (n + 255) / 256;
  ssm_scan_bwd_reduce<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                        stream>>>(ra);
  return (int)cudaGetLastError();
}

}  // namespace ssm_bwd
}  // namespace repro_torch

// x_bf16: x, dy and dx are bfloat16 (else float32). dh_final may be null
// (zeros); an output whose bit is clear in `need` (ddt 1, dbm 2, dcm 4,
// dx 8, da 16, dh0 32) may be null. Every operand 16-byte aligned and di a
// multiple of 8 (the wrapper checks both first). Workspace: dbm_part and
// dcm_part B*S*nblk*16 floats each, da_part B*di*16, ckpt
// B*nblk*(nchunks - 1)*256*4 (nblk = ceil(di / 64), nchunks =
// ceil(S / 16)). Returns a cudaError_t (0 = launched).
extern "C" int ssm_scan_bwd_launch(
    const void* dt, const void* bm, const void* cm, const void* x,
    const void* a, const void* h0, const void* dy, const void* dhf,
    void* ddt, void* dbm, void* dcm, void* dx, void* da, void* dh0,
    void* dbm_part, void* dcm_part, void* da_part, void* ckpt, int B, int S,
    int di, int N, int x_bf16, int need, void* stream) {
  using namespace repro_torch::ssm_bwd;
  if (N != kN || B < 1 || S < 1 || di < 1 || B > 65535 || di % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const void* const ptrs[] = {dt, bm, cm, x, a, h0, dy, dhf, ddt, dbm,
                              dcm, dx, da, dh0, dbm_part, dcm_part, da_part,
                              ckpt};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  Args args{};
  args.dt = static_cast<const float*>(dt);
  args.bm = static_cast<const float*>(bm);
  args.cm = static_cast<const float*>(cm);
  args.x = x;
  args.a = static_cast<const float*>(a);
  args.h0 = static_cast<const float*>(h0);
  args.dy = dy;
  args.dhf = static_cast<const float*>(dhf);
  args.ddt = static_cast<float*>(ddt);
  args.dx = dx;
  args.dh0 = static_cast<float*>(dh0);
  args.dbm_part = static_cast<float*>(dbm_part);
  args.dcm_part = static_cast<float*>(dcm_part);
  args.da_part = static_cast<float*>(da_part);
  args.ckpt = static_cast<float4*>(ckpt);
  args.B = B;
  args.S = S;
  args.di = di;
  args.nblk = (di + kC - 1) / kC;
  args.nchunks = (S + kL - 1) / kL;
  args.need = need;
  ReduceArgs ra{};
  ra.dbm_part = args.dbm_part;
  ra.dcm_part = args.dcm_part;
  ra.da_part = args.da_part;
  ra.dbm = static_cast<float*>(dbm);
  ra.dcm = static_cast<float*>(dcm);
  ra.da = static_cast<float*>(da);
  ra.B = B;
  ra.S = S;
  ra.di = di;
  ra.nblk = args.nblk;
  ra.need = need;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(args, ra, st)
                : launch<float>(args, ra, st);
}
