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
// bfloat16); ckpt (B, ceil(S / 16) - 1, di, N) float32, the state after
// every 16 steps short of S, as the training forward (ssm_scan.cu with
// checkpoints) writes it. N = 16. exp(v a) is taken as 2 ** (v (a log2 e)),
// as the forward takes it.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on CUDA cores),
// each input read once and each output written once, at jamba's training
// shape B=8, S=128, di=16,384, bf16 x: dt read and ddt written 134.2 MB,
// x, dy read and dx written 100.7 MB, h0, dh_final read and dh0 written
// 25.2 MB, a read and da written 2.1 MB, bm, cm, dbm, dcm 0.3 MB: 262.4
// MB, 78.3 us (the checkpoints, 58.7 MB more, are scratch the forward
// keeps for this design, not counted); the least operations, 18 a (row, step, channel, state) (the
// state recomputed: dt a, the exponent's argument, and e h + (dt x) B, 4;
// g's C dy + g and e g, 3; the sums of dC, dB and dx, 2 each; q = (e g)
// h_{t-1}, 1; da's dt q and ddt's a q, 2 each), 4.83 GFLOP, 72.1 us, plus
// the decays' exponentials, 268 M, 64 us on the SFU (16 a clock per SM at
// 1.98 GHz). Bytes bound it, with the arithmetic close behind.
//
// Design (deterministic, no float atomics):
//  - The forward's split over channels: a CTA of 256 threads per (row b,
//    64 channels), a channel's 16 states over 4 neighbouring threads.
//  - No walk from h0: chunk k of kL = 16 steps starts from the forward's
//    checkpoint k - 1 (h0 for the first), read as one float4 a thread.
//    The chunks go backwards. Each re-runs its states with the forward's
//    own expression, fma(ex2(dt a2), h, (dt x) B), so the same bits, and
//    takes each decay e = ex2(dt a2) once: the first 8 steps' decays go to
//    a shared-memory array of its own (a float4 a thread a step, 32 KB)
//    while the state runs through them; the last 8 steps' decays and
//    states stay in registers and are walked in reverse; then the first 8
//    steps' states are re-run from the chunk's start with the kept decays
//    (an FMA a state a step, no ex2) into the same registers and walked.
//    Sixteen steps of both in registers would take 132 a thread; all
//    sixteen steps' decays in shared memory (64 KB, with spills and
//    little L1 left) measured slower than taking ex2 twice (PERF.md).
//    The recurrence is never run backwards: the decays underflow toward
//    0.
//  - Steps past S in the last chunk are zeros in the staging buffer (dt,
//    x, dy, B, C), which makes them the identity (e = 1, nothing added or
//    summed), so every chunk walks all 16 steps without a test.
//  - Sums: ddt and dx over a channel's 4 threads by shuffles, kept by the
//    channel's first thread in shared memory and written as whole rows at
//    the chunk's end; dB and dC over the warp's 8 channels by
//    a reduce-scatter of shuffles, then over the CTA's 8 warps in shared
//    memory, then over the kCluster = 2 column blocks of a thread-block
//    cluster (clusters of 4-16 measured slower: the card holds fewer CTAs
//    at once, 248-224 against 264, which costs a wave at 2 x 2,048;
//    PERF.md): rank o owns half of a chunk's 512 sums; each CTA pushes
//    its chunk sums into their owners' inboxes (remote stores into
//    distributed shared memory, nothing waits on them), and after the
//    cluster's barrier each owner adds its inbox in rank order and writes
//    the cluster's partial (B, S, clusters, N). One cluster barrier a
//    chunk: a chunk's pushes are taken at the next chunk's end, and two
//    inboxes alternate. A second kernel adds the clusters' partials in
//    cluster order (a warp a (row, step), two interleaved halves), and
//    da's per-row partials in row order. Every sum has
//    a fixed order, so two launches on the same inputs give the same
//    bits.
//  - Inputs staged a chunk at a time with 16-byte cp.async copies, a
//    thread's piece of each tensor fixed once (no division in the loop;
//    the launcher takes only 16-byte aligned operands and di a multiple of
//    8, so every row piece is whole 16-byte pieces), the next chunk in
//    flight while the current one computes.
//  - __launch_bounds__(256, 2): 128 registers, and 88 KB of shared memory
//    at float32 x (80 KB at bf16), so two CTAs, 16 warps, share an SM
//    (one CTA an SM with free registers measured 1.5x slower: latency,
//    not issue, holds a step).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace repro_torch {
namespace ssm_bwd {

constexpr int kN = 16;                 // state size
constexpr int kG = 4;                  // threads per channel
constexpr int kPer = kN / kG;          // states per thread
constexpr int kC = 64;                 // channels per CTA
constexpr int kThreads = kC * kG;      // 256
constexpr int kWarps = kThreads / 32;
constexpr int kL = 16;                 // steps per chunk = checkpoint interval
constexpr int kH = kL / 2;             // steps whose states are in registers
constexpr int kSums = kL * 2 * kN;     // a chunk's dB and dC sums
constexpr int kCluster = 2;            // column blocks a cluster takes
constexpr int kPerRank = kSums / kCluster;   // sums a rank owns
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
  const float* ckpt;   // [B][nchunks - 1][di][kN]
  float* ddt;
  void* dx;
  float* dh0;
  float* dbm_part;     // [B][S][nclus][kN]
  float* dcm_part;     // [B][S][nclus][kN]
  float* da_part;      // [B][di][kN]
  int B, S, di, nclus, nchunks, need;
};

struct ReduceArgs {
  const float* dbm_part;
  const float* dcm_part;
  const float* da_part;
  float* dbm;
  float* dcm;
  float* da;
  int B, S, di, nclus, need;
};

// one staging buffer: dt [kL][kC] float32, x and dy [kL][kC] in x's type,
// bm and cm [kL][kN]
template <typename XT>
__host__ __device__ constexpr int buf_bytes() {
  return kL * (kC * 4 + 2 * kC * (int)sizeof(XT) + 2 * kN * 4);
}
// then the first half-chunk's decays [kH][kThreads] float4, the warps'
// sums [kWarps][kSums], two inboxes of the ranks' pushed sums [2][kSums],
// the chunk's ddt and dx rows [2][kL][kC] float32
constexpr int kDecayBytes = kH * kThreads * 16;
constexpr int kRedBytes = kWarps * kSums * 4;
constexpr int kInboxBytes = 2 * kSums * 4;
constexpr int kRowBytes = 2 * kL * kC * 4;
template <typename XT>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * buf_bytes<XT>() + kDecayBytes + kRedBytes + kInboxBytes +
         kRowBytes;
}
static_assert(2 * (smem_bytes<float>() + 1024) <= 233472,
              "two CTAs share an SM");

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
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// 2^v on the SFU, as the forward takes it (ex2 of -0 and +0 is +1)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
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

// blockIdx.x = column block (a cluster of kCluster consecutive ones, rank
// = blockIdx.x % kCluster; blocks past di take part in the sums as zeros),
// blockIdx.y = row. Thread (c, g) holds states [g kPer, (g + 1) kPer) of
// the CTA's channel c.
template <typename XT>
__global__ void __launch_bounds__(kThreads, 2)
    ssm_scan_bwd_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / kG, g = tid % kG;
  const int b = blockIdx.y, blk = blockIdx.x, d0 = blk * kC;
  const int rank = blk % kCluster, clus = blk / kCluster;
  const int nc = max(0, min(kC, p.di - d0));
  const bool live = c < nc;
  const int d = d0 + c;
  const int S = p.S;
  float4* const sdecay =
      reinterpret_cast<float4*>(smem + 2 * buf_bytes<XT>());   // [kH][kThreads]
  float* const sred = reinterpret_cast<float*>(sdecay + kH * kThreads);
  float* const inbox = sred + kWarps * kSums;          // [2][sender][kPerRank]
  float* const sddt = inbox + 2 * kSums;               // [kL][kC]
  float* const sdx = sddt + kL * kC;                   // [kL][kC]
  const bool sums = p.need & (kNeedDbm | kNeedDcm);
  static_assert(kSums % kCluster == 0, "a chunk's sums split evenly");
  cg::cluster_group cluster = cg::this_cluster();
  if (sums) cluster_arrive_relaxed();                  // this CTA started

  // chunk k into buffer k & 1, a 16-byte copy of each tensor a thread at
  // most (a chunk's dt, x or dy rows are 16 x nc / 4 or fewer pieces, bm's
  // and cm's 64), the thread's piece fixed here once
  constexpr int kXE = 16 / (int)sizeof(XT);         // x elements a copy
  const int qd = nc / 4, qx = nc / kXE;             // pieces a row
  const int rd = qd ? tid / qd : kL, cd = qd ? tid % qd * 4 : 0;
  const int rx = qx ? tid / qx : kL, cx = qx ? tid % qx * kXE : 0;
  auto stage = [&](int k) {
    const Buf<XT> st(smem + (k & 1) * buf_bytes<XT>());
    const long long row = (long long)b * S + (long long)k * kL;
    const int nt = min(kL, S - k * kL);
    if (rd < nt)
      cp16(st.dt + rd * kC + cd, p.dt + (row + rd) * p.di + d0 + cd);
    if (rx < nt) {
      const long long at = (row + rx) * p.di + d0 + cx;
      cp16(st.x + rx * kC + cx, static_cast<const XT*>(p.x) + at);
      cp16(st.dy + rx * kC + cx, static_cast<const XT*>(p.dy) + at);
    }
    if (tid < 4 * nt)
      cp16(st.bm + 4 * tid, p.bm + row * kN + 4 * tid);
    else if (tid >= 128 && tid - 128 < 4 * nt)
      cp16(st.cm + 4 * (tid - 128), p.cm + row * kN + 4 * (tid - 128));
  };

  // zeros that no copy overwrites: channels past d_inner in both buffers,
  // and the last chunk's steps past S (its buffer's later chunks are whole)
  {
    const int last = p.nchunks - 1, tail = S - last * kL;
    for (int k = 0; k < 2; ++k) {
      const Buf<XT> st(smem + k * buf_bytes<XT>());
      const int from = k == (last & 1) ? tail : kL;
      for (int e = tid; e < kL * kC; e += kThreads) {
        if (e % kC >= nc || e / kC >= from) {
          st.dt[e] = 0.f;
          from_f32(st.x + e, 0.f);
          from_f32(st.dy + e, 0.f);
        }
      }
      for (int e = tid; e < kL * kN; e += kThreads) {
        if (e / kN >= from) st.bm[e] = st.cm[e] = 0.f;
      }
    }
  }

  // the decays a, the adjoint from dh_final
  float av[kPer], gs[kPer], da[kPer];
  const long long at = ((long long)b * p.di + d) * kN + g * kPer;
  {
    const float4 aa =
        live ? __ldg(reinterpret_cast<const float4*>(p.a + (long long)d * kN +
                                                     g * kPer))
             : make_float4(0.f, 0.f, 0.f, 0.f);
    av[0] = aa.x, av[1] = aa.y, av[2] = aa.z, av[3] = aa.w;
    const float4 gv = (p.dhf && live)
                          ? *reinterpret_cast<const float4*>(p.dhf + at)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    gs[0] = gv.x, gs[1] = gv.y, gs[2] = gv.z, gs[3] = gv.w;
#pragma unroll
    for (int n = 0; n < kPer; ++n) da[n] = 0.f;
  }

  // this CTA's chunk-k sums (its warps' added in order) into the inbox of
  // each sum's owner, at this rank's place
  auto push = [&](int k) {
    float* const box = inbox + (k & 1) * kSums + rank * kPerRank;
    for (int e = tid; e < kSums; e += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += sred[w * kSums + e];
      cluster.map_shared_rank(box, e / kPerRank)[e % kPerRank] = acc;
    }
  };
  // chunk k's sums this rank owns, its inbox added in rank order: the
  // cluster's partials of dB and dC
  auto take = [&](int k) {
    const float* const box = inbox + (k & 1) * kSums;
    const long long row = (long long)b * S + (long long)k * kL;
    const int total = min(kL, S - k * kL) * 2 * kN;
    for (int i = tid; i < kPerRank; i += kThreads) {
      const int e = rank * kPerRank + i;
      if (e >= total) break;
      float acc = 0.f;
#pragma unroll
      for (int o = 0; o < kCluster; ++o) acc += box[o * kPerRank + i];
      const int x = e / (2 * kN), kn = e % (2 * kN);
      if (p.need & (kn < kN ? kNeedDbm : kNeedDcm))
        (kn < kN ? p.dbm_part : p.dcm_part)[((row + x) * p.nclus + clus) *
                                                kN + kn % kN] = acc;
    }
  };

  stage(p.nchunks - 1);
  commit();
  for (int k = p.nchunks - 1; k >= 0; --k) {
    wait_all();
    // chunk k is here; chunk k + 1's buffer and warp sums are read
    __syncthreads();
    if (k > 0) {
      stage(k - 1);
      commit();
    }
    const Buf<XT> st(smem + (k & 1) * buf_bytes<XT>());
    const int t0 = k * kL, n = min(kL, S - t0);

    // the chunk's start state
    float h0v[kPer];
    {
      const float4 hv =
          !live ? make_float4(0.f, 0.f, 0.f, 0.f)
          : k == 0
              ? *reinterpret_cast<const float4*>(p.h0 + at)
              : *reinterpret_cast<const float4*>(
                    p.ckpt + (((long long)b * (p.nchunks - 1) + k - 1) * p.di +
                              d) * kN + g * kPer);
      h0v[0] = hv.x, h0v[1] = hv.y, h0v[2] = hv.z, h0v[3] = hv.w;
    }
    float a2[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) a2[q] = __fmul_rn(av[q], kLog2e);

    // one step of the recurrence, as the forward takes it
    auto step = [&](int x, const float (&e)[kPer], const float (&h)[kPer],
                    float (&out)[kPer]) {
      const float dx = __fmul_rn(st.dt[x * kC + c], to_f32(st.x[x * kC + c]));
      const float4 bv = reinterpret_cast<const float4*>(st.bm + x * kN)[g];
      const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        out[q] = __fmaf_rn(e[q], h[q], __fmul_rn(dx, bb[q]));
    };
    auto decay = [&](int x, float (&e)[kPer]) {
      const float dtv = st.dt[x * kC + c];
#pragma unroll
      for (int q = 0; q < kPer; ++q) e[q] = ex2(__fmul_rn(dtv, a2[q]));
    };

    // the first half's decays into shared memory, its states run through
    float hs[kH + 1][kPer], ee[kH][kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) hs[0][q] = h0v[q];
#pragma unroll
    for (int x = 0; x < kH; ++x) {
      float e[kPer];
      decay(x, e);
      sdecay[x * kThreads + tid] = make_float4(e[0], e[1], e[2], e[3]);
      step(x, e, hs[0], hs[0]);
    }
    // the second half's decays and states in registers
#pragma unroll
    for (int x = 0; x < kH; ++x) {
      decay(kH + x, ee[x]);
      step(kH + x, ee[x], hs[x], hs[x + 1]);
    }

    const int slot = (lane >> 2) & 7;
    float* const wsum = sred + warp * kSums + (slot / kPer) * kN + g * kPer +
                        slot % kPer;
    // steps base + kH - 1 down to base, from hs (hs[x]: the state before
    // step base + x) and ee
    auto walk = [&](int base) {
#pragma unroll
      for (int i = kH - 1; i >= 0; --i) {
        const int x = base + i;
        const float dtv = st.dt[x * kC + c];
        const float xv = to_f32(st.x[x * kC + c]);
        const float dyv = to_f32(st.dy[x * kC + c]);
        const float dx = __fmul_rn(dtv, xv);
        const float4 bv = reinterpret_cast<const float4*>(st.bm + x * kN)[g];
        const float4 cv = reinterpret_cast<const float4*>(st.cm + x * kN)[g];
        const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[kPer] = {cv.x, cv.y, cv.z, cv.w};
        float sums8[2 * kPer];        // dB[0..3], dC[0..3]
        float sb = 0.f, sa = 0.f;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const float gq = fmaf(cc[q], dyv, gs[q]);     // adjoint of h_t
          sums8[kPer + q] = dyv * hs[i + 1][q];
          sums8[q] = gq * dx;
          sb = fmaf(gq, bb[q], sb);
          const float gh = gq * (ee[i][q] * hs[i][q]);
          sa = fmaf(gh, av[q], sa);
          da[q] = fmaf(gh, dtv, da[q]);
          gs[q] = ee[i][q] * gq;
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
        // `slot`, dB for its state group's states below 4, dC above
        reduce_scatter<2 * kPer, 16, 4>(sums8, lane);
        wsum[x * 2 * kN] = sums8[0];
      }
    };
    walk(kH);
    // the first half again from the chunk's start, its decays read back
#pragma unroll
    for (int q = 0; q < kPer; ++q) hs[0][q] = h0v[q];
#pragma unroll
    for (int x = 0; x < kH; ++x) {
      const float4 ev = sdecay[x * kThreads + tid];
      ee[x][0] = ev.x, ee[x][1] = ev.y, ee[x][2] = ev.z, ee[x][3] = ev.w;
      step(x, ee[x], hs[x], hs[x + 1]);
    }
    walk(0);

    __syncthreads();   // the chunk's rows and warp sums are in
    // ddt and dx as whole rows, 16 bytes a thread (the staging's pieces)
    {
      const long long row = (long long)b * S + t0;
      if ((p.need & kNeedDdt) && rd < n) {
        const float* r = sddt + rd * kC + cd;
        *reinterpret_cast<float4*>(p.ddt + (row + rd) * p.di + d0 + cd) =
            make_float4(r[0], r[1], r[2], r[3]);
      }
      if ((p.need & kNeedDx) && rx < n) {
        alignas(16) XT v[kXE];
#pragma unroll
        for (int i = 0; i < kXE; ++i) from_f32(v + i, sdx[rx * kC + cx + i]);
        *reinterpret_cast<uint4*>(static_cast<XT*>(p.dx) +
                                  (row + rx) * p.di + d0 + cx) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
    if (sums) {
      // every rank has started (the last chunk) or pushed chunk k + 1's
      // sums and taken chunk k + 2's (whose inbox chunk k takes)
      cluster_wait();
      push(k);
      if (k + 1 < p.nchunks) take(k + 1);
      cluster_arrive();  // this CTA's pushes of chunk k are made
    }
  }
  if (sums) {
    cluster_wait();    // every rank's chunk-0 sums are in
    take(0);
  }

  if (live && (p.need & kNeedDh0))
    *reinterpret_cast<float4*>(p.dh0 + at) =
        make_float4(gs[0], gs[1], gs[2], gs[3]);
  if (live && (p.need & kNeedDa))
    *reinterpret_cast<float4*>(p.da_part + at) =
        make_float4(da[0], da[1], da[2], da[3]);
}

// dbm, dcm: a warp per (row b, step t, which of the two): lane (n, h)
// adds the clusters' partials h, h + 2, .. in cluster order, then the two
// halves are added (a fixed order); da: a thread per (channel, state), the
// rows' partials in row order.
__global__ void ssm_scan_bwd_reduce(const ReduceArgs p) {
  const long long nbt = (long long)p.B * p.S;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31, n = lane & (kN - 1), h = lane / kN;
  for (long long w = first >> 5; w < 2 * nbt; w += stride >> 5) {
    const bool c = w & 1;
    if (!(p.need & (c ? kNeedDcm : kNeedDbm))) continue;
    const long long bt = w >> 1;
    const float* src = (c ? p.dcm_part : p.dbm_part) + bt * p.nclus * kN + n;
    float acc = 0.f;
    int q = h;
    for (; q + 6 < p.nclus; q += 8) {
      const float v0 = src[q * kN], v1 = src[(q + 2) * kN],
                  v2 = src[(q + 4) * kN], v3 = src[(q + 6) * kN];
      acc = (((acc + v0) + v1) + v2) + v3;
    }
    for (; q < p.nclus; q += 2) acc += src[q * kN];
    acc += __shfl_xor_sync(0xffffffffu, acc, kN);
    if (h == 0) (c ? p.dcm : p.dbm)[bt * kN + n] = acc;
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
cudaError_t allow(void) {
  static unsigned long long allowed = 0;   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed >> dev & 1ull)) {
    err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<XT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<XT>());
    if (err != cudaSuccess) return err;
    allowed |= 1ull << dev;
  }
  return cudaSuccess;
}

// the column blocks of a row, kCluster at a time, form a cluster
template <typename XT>
int launch(const Args& args, const ReduceArgs& ra, cudaStream_t stream) {
  cudaError_t err = allow<XT>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(args.nclus * kCluster, args.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<XT>();
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssm_scan_bwd_kernel<XT>, args);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!(args.need & (kNeedDbm | kNeedDcm | kNeedDa))) return 0;
  // a warp per (row, step) and partial array, a thread per (channel, state)
  const long long n = 64LL * args.B * args.S > (long long)args.di * kN
                          ? 64LL * args.B * args.S
                          : (long long)args.di * kN;
  const long long blocks = (n + 255) / 256;
  ssm_scan_bwd_reduce<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0,
                        stream>>>(ra);
  return (int)cudaGetLastError();
}

}  // namespace ssm_bwd
}  // namespace repro_torch

// x_bf16: x, dy and dx are bfloat16 (else float32). dh_final may be null
// (zeros); ckpt is the forward's (null where S <= 16); an output whose bit
// is clear in `need` (ddt 1, dbm 2, dcm 4, dx 8, da 16, dh0 32) may be null.
// nclus = ceil(ceil(di / 64) / 2), the clusters of a row. Every operand
// 16-byte aligned and di a multiple of 8 (the wrapper checks both first).
// Workspace: dbm_part and dcm_part B*S*nclus*16 floats each, da_part
// B*di*16. Returns a cudaError_t (0 = launched).
extern "C" int ssm_scan_bwd_launch(
    const void* dt, const void* bm, const void* cm, const void* x,
    const void* a, const void* h0, const void* dy, const void* dhf,
    const void* ckpt, void* ddt, void* dbm, void* dcm, void* dx, void* da,
    void* dh0, void* dbm_part, void* dcm_part, void* da_part, int B, int S,
    int di, int N, int x_bf16, int need, void* stream) {
  using namespace repro_torch::ssm_bwd;
  if (N != kN || B < 1 || S < 1 || di < 1 || B > 65535 || di % 8 != 0 ||
      (S > kL && ckpt == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* const ptrs[] = {dt, bm, cm, x, a, h0, dy, dhf, ckpt, ddt, dbm,
                              dcm, dx, da, dh0, dbm_part, dcm_part, da_part};
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
  args.ckpt = static_cast<const float*>(ckpt);
  args.ddt = static_cast<float*>(ddt);
  args.dx = dx;
  args.dh0 = static_cast<float*>(dh0);
  args.dbm_part = static_cast<float*>(dbm_part);
  args.dcm_part = static_cast<float*>(dcm_part);
  args.da_part = static_cast<float*>(da_part);
  args.B = B;
  args.S = S;
  args.di = di;
  args.nclus = ((di + kC - 1) / kC + kCluster - 1) / kCluster;
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
  ra.nclus = args.nclus;
  ra.need = need;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(args, ra, st)
                : launch<float>(args, ra, st);
}
