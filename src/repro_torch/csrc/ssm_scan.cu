// Mamba's selective scan: the recurrence of every mamba layer (jamba's),
// in the paged engine's ragged chunks and decode steps and in the slot
// engine's whole-prompt prefill and decode.
//
// Replaces the reference's lax.scan step in src/repro/models/ssm.py:113-177
// (ssm_forward), which runs outside any Pallas kernel. Semantics:
// repro_torch/kernels/ref.py ssm_scan_ref. Per batch row b and channel d,
// from the state h = h0[b, d, :]:
//
//   h[n] = exp(dt[b,t,d] a[d,n]) h[n] + (dt[b,t,d] float32(x[b,t,d])) bm[b,t,n]
//   y[b,t,d] = to_x_dtype(sum_n h[n] cm[b,t,n])
//
// with exp(v a) taken as 2 ** (v (a log2 e)).
//
// Layout: dt (B, S, di), bm, cm (B, S, N), a (di, N), h0 and h_final
// (B, di, N), contiguous float32; x and y (B, S, di) contiguous, float32
// or bfloat16 (x's dtype; the reference casts x to float32 inside its step
// and the scan's output back to x's dtype after it, so reading and writing
// the model dtype here computes the same function without two elementwise
// passes around the launch). N = 16 (every mamba config). The kernel takes
// no sequence length: a caller that pads a row sets dt to 0 past its valid
// lanes, where the decay is exactly 1 (ex2 of -0 is +1) and 0 * x = 0, so
// the state carries through exactly.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on CUDA cores;
// data sheet), each input read once and each output written once:
//  - jamba's chunk at B=8, S=256, di=16,384: float32 dt, x, y 402.7 MB,
//    h0 and h_final 16.8 MB, a 1.0 MB, bm and cm 0.3 MB: 420.8 MB,
//    125.6 us (bf16 x and y: 286.6 MB, 85.5 us). Bytes bound it.
//  - the exponentials: one per (row, step, channel, state), 537 M at that
//    shape. The SFU issues 16 a clock per SM: 132 SMs at 1.98 GHz take
//    128 us for them alone, as long as the float32 bytes. The other
//    arithmetic is 4 operations a state a step (dt a2, dx bm, the state's
//    FMA, y's FMA) and ~10 a thread-step for loads, dx, the shuffles and
//    the stores: ~120 us of issue at 4 warp instructions a clock per SM.
//    So the SFU and the issue slots bound it about equally, above the
//    bytes; the design keeps both busy and the bytes off the chain.
//  - a decode step at B=8, S=1: the state read and written 16.8 MB, a
//    1.0 MB: 19.4 MB, 5.8 us. Bytes bound it.
//
// Design:
//  - A channel's 16 states are split over kG = 4 neighbouring threads,
//    4 states and 4 decays a2 = a log2(e) in registers each, for a pair of
//    neighbouring channels (kCT = 2): each step's bm and cm, read from
//    shared memory once, serve both. A CTA of 128 threads takes 64
//    channels of one row; at one row that is 32,768 threads. A channel's
//    y is its threads' partial sums added by butterfly shuffles, always as
//    (p0 + p2) + (p1 + p3): for 4 steps at once (reduce4: 3 shuffles, lane
//    g keeping step g's y) or one (reduce1), the same bits either way.
//  - Time is walked in order within each thread: each state's update is
//    one fixed expression, fma(ex2(dt a2), h, (dt x) bm), so the state is
//    bit-identical however a prompt is cut into calls (the paged engine's
//    chunks against the slot engine's whole prompt; masked lanes against
//    the row unpadded). No scan runs parallel over time.
//  - Steps are staged in chunks of kL steps (16 or 32, a template
//    parameter; kernels/ssm_scan.py slot_steps picks) in a ring of two
//    shared-memory slots: per chunk, the CTA's dt and x rows (256 and 256
//    or 128 contiguous bytes a step) and the chunk's bm and cm
//    (contiguous), each one 1-D bulk copy (cp.async.bulk) completing on
//    the slot's mbarrier, issued by warp 0's lanes. The ring holds the
//    next chunk in flight while the current one computes, so no step
//    waits on device memory. The launcher takes only 16-byte aligned
//    operands and d_inner a multiple of 8, so every row and chunk is whole
//    16-byte pieces, and a thread's two channels are both live or both
//    past d_inner.
//  - Each decay is one FMUL and one ex2.approx (MUFU.EX2), independent of
//    the state, so it issues ahead of the chain; the chain itself is one
//    FMA a state a step.
//  - y goes from registers to device memory: after reduce4, lane g of a
//    channel group stores step g's pair, so a warp writes 4 rows of 32
//    (float32) or 16 (bf16) contiguous bytes.
//  - 64 registers at most (__launch_bounds__(128, 8)): 8 CTAs, 32 warps,
//    share an SM where the ring fits; slot_steps takes 16-step slots
//    (20.6 KB a CTA in float32) where the grid outnumbers the CTAs
//    resident at once with 32-step ones (41.1 KB), fewer barriers a step
//    where not. Both fit the 48 KB a launch gets without asking.
//  - Decode (S = 1) reads its step straight from device memory (no ring,
//    no shared memory): the state is the traffic, read and written as
//    float4s, 512 contiguous bytes a warp.
//  - Checkpoints for the backward (csrc/ssm_scan_bwd.cu), only where the
//    caller asks (the training forward of ops.ssm_scan's autograd
//    Function): the state after every kCkptSteps = 16 steps that is not
//    the last, ckpt (B, ceil(S / 16) - 1, di, N) float32, written as
//    h_final is, after the group of 4 steps that ends at the boundary (16
//    is a multiple of the group and of both slot sizes, so a boundary
//    always ends a group). A separate instantiation (kCk): the serving
//    kernels are compiled as before and write nothing more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace ssm {

constexpr int kN = 16;               // state size
constexpr int kG = 4;                // threads per channel
constexpr int kPer = kN / kG;        // states per thread
constexpr int kCT = 2;               // neighbouring channels per thread
constexpr int kThreads = 128;
constexpr int kC = kThreads / kG * kCT;   // channels per CTA (64)
constexpr int kGroup = 4;            // steps whose y one reduce4 takes
constexpr int kStages = 2;           // ring slots
constexpr int kBarBytes = 128;       // the slots' mbarriers, then the ring
constexpr int kCkptSteps = 16;       // steps between checkpoints
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* dt;
  const float* bm;
  const float* cm;
  const void* x;
  const float* a;
  const float* h0;
  void* y;
  float* h_final;
  float* ckpt;         // kCk: [B][ceil(S / kCkptSteps) - 1][di][kN]
  int S;
  int di;
};

__host__ __device__ constexpr int slot_bytes(int steps, int xsize) {
  return steps * (kC * 4 + kC * xsize + 2 * kN * 4);
}

__host__ __device__ constexpr int smem_bytes(int steps, int xsize) {
  return kBarBytes + kStages * slot_bytes(steps, xsize);
}

static_assert(smem_bytes(32, 4) <= 48 * 1024,
              "the widest ring fits a launch's default shared memory");

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

// a lane's arrival on a slot's barrier, expecting `bytes` of bulk copy
// that it issues after arriving
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

// 2^v on the SFU: one MUFU.EX2 (ex2 of -0 and of +0 is exactly +1)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// The pieces of a slot of kL steps: per step, kC dt, kC x, kN bm, kN cm.
template <typename XT, int kL>
struct Slot {
  float* dt;   // [kL][kC]
  XT* x;       // [kL][kC]
  float* bm;   // [kL][kN]
  float* cm;   // [kL][kN]
  __device__ explicit Slot(unsigned char* base) {
    dt = reinterpret_cast<float*>(base);
    x = reinterpret_cast<XT*>(base + kL * kC * 4);
    bm = reinterpret_cast<float*>(base + kL * kC * (4 + sizeof(XT)));
    cm = bm + kL * kN;
  }
};

// Warp 0 fills slot `st` with chunk steps [t0, t0 + n) of row b, channels
// [d0, d0 + nc). Item i < n is dt's row t0 + i, n <= i < 2n x's, then bm's
// and cm's blocks, each one bulk copy of whole 16-byte pieces. Each lane
// arrives on the slot's barrier expecting the bytes of its items, then
// issues them.
template <typename XT, int kL>
__device__ __forceinline__ void issue_chunk(const Args& p,
                                            const Slot<XT, kL>& st,
                                            uint64_t* bar, int b, int d0,
                                            int nc, int t0, int n,
                                            int lane) {
  const long long row = (long long)b * p.S + t0;
  uint32_t bytes = 0;
  for (int i = lane; i < 2 * n + 2; i += 32)
    bytes += i < n ? nc * 4 : i < 2 * n ? nc * sizeof(XT) : n * kN * 4;
  mbar_arrive_tx(bar, bytes);
  // the slot's earlier contents were read by the generic proxy; the bulk
  // copies write it through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (int i = lane; i < 2 * n + 2; i += 32) {
    if (i < n)
      bulk_load(st.dt + i * kC, p.dt + (row + i) * p.di + d0, nc * 4, bar);
    else if (i < 2 * n)
      bulk_load(st.x + (i - n) * kC,
                static_cast<const XT*>(p.x) + (row + i - n) * p.di + d0,
                nc * sizeof(XT), bar);
    else
      bulk_load(i == 2 * n ? st.bm : st.cm,
                (i == 2 * n ? p.bm : p.cm) + row * kN, n * kN * 4, bar);
  }
}

// One step of a thread's kPer states of one channel, in the one order
// every path uses; -> the thread's partial sum of y.
__device__ __forceinline__ float update(float (&h)[kPer],
                                        const float (&a2)[kPer], float dt,
                                        float x, const float4& bv,
                                        const float4& cv) {
  const float dx = __fmul_rn(dt, x);
  const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
  const float cc[kPer] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
  for (int n = 0; n < kPer; ++n)
    h[n] = __fmaf_rn(ex2(__fmul_rn(dt, a2[n])), h[n], __fmul_rn(dx, bb[n]));
  float yp = __fmul_rn(h[0], cc[0]);
#pragma unroll
  for (int n = 1; n < kPer; ++n) yp = __fmaf_rn(h[n], cc[n], yp);
  return yp;
}

// A channel's y from its kG = 4 lanes' partials p_0..p_3 (lane g of the
// group holds p_g): (p_0 + p_2) + (p_1 + p_3), on every lane.
__device__ __forceinline__ float reduce1(float p) {
  p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 2));
  return __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 1));
}

// The same sums for 4 steps at once: lane g gets step g's y, bit-equal to
// reduce1's (the additions are the same pairs; a + b = b + a exactly),
// in 3 shuffles instead of 8.
__device__ __forceinline__ float reduce4(const float (&p)[4], int g) {
  const bool hi2 = g & 2, hi1 = g & 1;
  const float r0 = __fadd_rn(
      hi2 ? p[2] : p[0], __shfl_xor_sync(0xffffffffu, hi2 ? p[0] : p[2], 2));
  const float r1 = __fadd_rn(
      hi2 ? p[3] : p[1], __shfl_xor_sync(0xffffffffu, hi2 ? p[1] : p[3], 2));
  return __fadd_rn(hi1 ? r1 : r0,
                   __shfl_xor_sync(0xffffffffu, hi1 ? r0 : r1, 1));
}

// A thread's kCT neighbouring channels of one step row (one vector
// load), as float32.
template <typename XT>
__device__ __forceinline__ void load_row(const XT* row, float (&v)[kCT]) {
  static_assert(kCT == 2, "a thread's channels are one pair");
  if constexpr (sizeof(XT) == 4) {
    const float2 f = *reinterpret_cast<const float2*>(row);
    v[0] = f.x, v[1] = f.y;
  } else {
    const __nv_bfloat162 f = *reinterpret_cast<const __nv_bfloat162*>(row);
    v[0] = __low2float(f), v[1] = __high2float(f);
  }
}

// y of a thread's kCT channels at one step to device memory, one store,
// rounded once to XT.
template <typename XT>
__device__ __forceinline__ void store_y(XT* dst, const float (&v)[kCT]) {
  if constexpr (sizeof(XT) == 4)
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  else
    *reinterpret_cast<__nv_bfloat162*>(dst) =
        __floats2bfloat162_rn(v[0], v[1]);
}

// Thread (c, g) holds states [g kPer, (g + 1) kPer) of the CTA's kCT
// neighbouring channels kCT c + i. kL > 0: steps staged kL at a time in
// the shared-memory ring (any S); kL = 0: each step read straight from
// device memory (a decode step). kCk: write the checkpoints too.
template <typename XT, int kL, bool kCk>
__global__ void __launch_bounds__(kThreads, 8)
    ssm_scan_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32;
  const int c = tid / kG, g = tid % kG;
  const int b = blockIdx.y, d0 = blockIdx.x * kC;
  const int nc = min(kC, p.di - d0);
  // d_inner % 8 == 0: a thread's channels are both live or both past it
  // (the dead ones still take part in the shuffles)
  const bool live = kCT * c < nc;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  if (kL > 0 && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the state and the decays while the barriers are made
  float h[kCT][kPer], a2[kCT][kPer];
#pragma unroll
  for (int i = 0; i < kCT; ++i) {
    const int d = d0 + kCT * c + i;
    const long long at = ((long long)b * p.di + d) * kN + g * kPer;
    const long long aa = (long long)d * kN + g * kPer;
    const float4 hv = live ? *reinterpret_cast<const float4*>(p.h0 + at)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 av =
        live ? __ldg(reinterpret_cast<const float4*>(p.a + aa))
             : make_float4(0.f, 0.f, 0.f, 0.f);
    h[i][0] = hv.x, h[i][1] = hv.y, h[i][2] = hv.z, h[i][3] = hv.w;
    a2[i][0] = av.x, a2[i][1] = av.y, a2[i][2] = av.z, a2[i][3] = av.w;
#pragma unroll
    for (int n = 0; n < kPer; ++n) a2[i][n] = __fmul_rn(a2[i][n], kLog2e);
  }
  // y of (b, t, kCT c) is yg[t * di]
  XT* yg = static_cast<XT*>(p.y) + (long long)b * p.S * p.di + d0 + kCT * c;

  if constexpr (kL == 0) {
    const XT* x = static_cast<const XT*>(p.x);
    for (int t = 0; t < p.S; ++t) {
      const long long r = (long long)b * p.S + t;
      const float4 bv =
          __ldg(reinterpret_cast<const float4*>(p.bm + r * kN) + g);
      const float4 cv =
          __ldg(reinterpret_cast<const float4*>(p.cm + r * kN) + g);
      const long long at = r * p.di + d0 + kCT * c;
      float dtv[kCT] = {0.f, 0.f}, xv[kCT] = {0.f, 0.f}, yv[kCT];
      if (live) {
        load_row<float>(p.dt + at, dtv);
        load_row<XT>(x + at, xv);
      }
#pragma unroll
      for (int i = 0; i < kCT; ++i)
        yv[i] = reduce1(update(h[i], a2[i], dtv[i], xv[i], bv, cv));
      if (g == 0 && live) store_y<XT>(yg + (long long)t * p.di, yv);
    }
  } else {
    constexpr int slot = slot_bytes(kL, sizeof(XT));
    unsigned char* ring = smem + kBarBytes;
    const int chunks = (p.S + kL - 1) / kL;
    __syncthreads();   // barriers made
    // the first two chunks in flight
    if (tid < 32)
      for (int k = 0; k < min(kStages, chunks); ++k)
        issue_chunk<XT, kL>(p, Slot<XT, kL>(ring + k * slot), &bar[k], b,
                            d0, nc, k * kL, min(kL, p.S - k * kL), lane);
    uint32_t phase = 0;      // the parity of chunk k's barrier phase
    for (int k = 0; k < chunks; ++k) {
      const int s = k % kStages;   // chunk k's slot
      if (k > 0) {
        __syncthreads();   // chunk k - 1 read: its slot is free
        const int next = k + kStages - 1;
        if (tid < 32 && next < chunks)
          issue_chunk<XT, kL>(p, Slot<XT, kL>(ring + (s ^ 1) * slot),
                              &bar[s ^ 1], b, d0, nc, next * kL,
                              min(kL, p.S - next * kL), lane);
      }
      mbar_wait(&bar[s], phase);
      const Slot<XT, kL> st(ring + s * slot);
      const float* sdt = st.dt + kCT * c;
      const XT* sx = st.x + kCT * c;
      const float4* sb = reinterpret_cast<const float4*>(st.bm) + g;
      const float4* sc = reinterpret_cast<const float4*>(st.cm) + g;
      XT* yk = yg + (long long)k * kL * p.di;
      const int n = min(kL, p.S - k * kL);
      int j = 0;
      for (; j + kGroup <= n; j += kGroup) {
        float part[kCT][kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const float4 bv = sb[(j + q) * kG], cv = sc[(j + q) * kG];
          float dtv[kCT], xv[kCT];
          load_row<float>(sdt + (j + q) * kC, dtv);
          load_row<XT>(sx + (j + q) * kC, xv);
#pragma unroll
          for (int i = 0; i < kCT; ++i)
            part[i][q] = update(h[i], a2[i], dtv[i], xv[i], bv, cv);
        }
        float yv[kCT];
#pragma unroll
        for (int i = 0; i < kCT; ++i) yv[i] = reduce4(part[i], g);
        if (live) store_y<XT>(yk + (long long)(j + g) * p.di, yv);
        if constexpr (kCk) {
          const int done = k * kL + j + kGroup;   // steps taken so far
          if (done % kCkptSteps == 0 && done < p.S && live) {
            const int nck = (p.S - 1) / kCkptSteps;
#pragma unroll
            for (int i = 0; i < kCT; ++i)
              *reinterpret_cast<float4*>(
                  p.ckpt + (((long long)b * nck + done / kCkptSteps - 1) *
                                p.di + d0 + kCT * c + i) * kN + g * kPer) =
                  make_float4(h[i][0], h[i][1], h[i][2], h[i][3]);
          }
        }
      }
      for (; j < n; ++j) {
        const float4 bv = sb[j * kG], cv = sc[j * kG];
        float dtv[kCT], xv[kCT], yv[kCT];
        load_row<float>(sdt + j * kC, dtv);
        load_row<XT>(sx + j * kC, xv);
#pragma unroll
        for (int i = 0; i < kCT; ++i)
          yv[i] = reduce1(update(h[i], a2[i], dtv[i], xv[i], bv, cv));
        if (g == 0 && live) store_y<XT>(yk + (long long)j * p.di, yv);
      }
      if (s == kStages - 1) phase ^= 1;
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < kCT; ++i)
      *reinterpret_cast<float4*>(p.h_final +
                                 ((long long)b * p.di + d0 + kCT * c + i) *
                                     kN + g * kPer) =
          make_float4(h[i][0], h[i][1], h[i][2], h[i][3]);
  }
}

// kCk (checkpoints kept) where the caller passes them and S > 16: a
// sequence of 16 steps or fewer has none, and a decode step never
template <typename XT, int kL>
int launch(const Args& args, int B, cudaStream_t stream) {
  const dim3 grid((args.di + kC - 1) / kC, B);
  const int smem = kL > 0 ? smem_bytes(kL, sizeof(XT)) : 0;
  if constexpr (kL > 0) {
    if (args.ckpt != nullptr && args.S > kCkptSteps) {
      ssm_scan_kernel<XT, kL, true><<<grid, kThreads, smem, stream>>>(args);
      return (int)cudaGetLastError();
    }
  }
  ssm_scan_kernel<XT, kL, false><<<grid, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_steps(const Args& args, int B, int steps, cudaStream_t stream) {
  if (args.S == 1) return launch<XT, 0>(args, B, stream);
  return steps == 32 ? launch<XT, 32>(args, B, stream)
                     : launch<XT, 16>(args, B, stream);
}

}  // namespace ssm
}  // namespace repro_torch

// x_bf16: x and y are bfloat16 (else float32); steps: the ring's slot
// size, 16 or 32 (kernels/ssm_scan.py slot_steps); ckpt: null, or the
// checkpoints' B * (ceil(S / 16) - 1) * di * N floats. Every operand
// 16-byte aligned and di a multiple of 8 (the wrapper checks both first).
extern "C" int ssm_scan_launch(const void* dt, const void* bm, const void* cm,
                               const void* x, const void* a, const void* h0,
                               void* y, void* h_final, void* ckpt, int B,
                               int S, int di, int N, int x_bf16, int steps,
                               void* stream) {
  using namespace repro_torch::ssm;
  if (N != kN || B < 1 || S < 1 || di < 1 || B > 65535 || di % 8 != 0 ||
      (steps != 16 && steps != 32))
    return (int)cudaErrorInvalidValue;
  const void* const ptrs[] = {dt, bm, cm, x, a, h0, y, h_final, ckpt};
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
  args.y = y;
  args.h_final = static_cast<float*>(h_final);
  args.ckpt = static_cast<float*>(ckpt);
  args.S = S;
  args.di = di;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_steps<__nv_bfloat16>(args, B, steps, st)
                : launch_steps<float>(args, B, steps, st);
}
