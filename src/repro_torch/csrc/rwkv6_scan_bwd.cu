// The backward of the WKV6 recurrence (csrc/rwkv6_scan.cu): the gradients
// of every rwkv6 layer's time-mix scan in training.
//
// Replaces jax.grad of the reference's WKV lax.scan,
// src/repro/models/rwkv6.py:190-199 (the reference trains through the jnp
// scan; its Pallas kernel has no VJP). Semantics:
// repro_torch/kernels/ref.py rwkv6_scan_bwd_ref. Per (batch row b, head
// h), with S_t the state before step t (S_0 = s0) and G the adjoint of the
// state after step t, from G = ds_final back to step 0:
//
//   dr_t[i] = sum_j do_t[j] S_t[i,j]  + u[i] k_t[i] (do_t . v_t)
//   dw_t[i] = sum_j G[i,j] S_t[i,j]
//   dk_t[i] = sum_j G[i,j] v_t[j]     + r_t[i] u[i] (do_t . v_t)
//   dv_t[j] = sum_i G[i,j] k_t[i]     + do_t[j] sum_i r_t[i] u[i] k_t[i]
//   du[i]  += r_t[i] k_t[i] (do_t . v_t)                  (over b and t)
//   G[i,j]  = w_t[i] G[i,j] + r_t[i] do_t[j]
//
// and ds0 = G after step 0. Layout: r, k, v, w, dout, and dr, dk, dv, dw
// (B, H, S, hd) float32 through element strides over (B, H, S) with
// head_dim contiguous (the model's transposed views go in without copies);
// u and du (H, hd), s0, ds_final and ds0 (B, H, hd, hd) contiguous.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on CUDA cores),
// each input read once and each output written once, at rwkv6-1.6b's
// training shape B=8, H=32, S=128, hd=64: r, k, v, w, dout read and dr,
// dk, dv, dw written 75.5 MB, s0, ds_final, ds0 12.6 MB: 88.1 MB, 26.3 us;
// the least operations, 14 a (row, head, step, i, j) (the state
// recomputed: k v and w S + kv, 3; the adjoint r do and w G + ., 3; the
// sums of dr, dw, dk, dv, 2 each; the bonus term u k v factors out of
// every sum, O(hd) a step): 1.88 GFLOP, 28.0 us. Operations bound it, the
// bytes close behind.
//
// Design: both recurrences are elementwise in (i, j), so the time axis
// splits into chunks of kL = 16 steps that run in parallel once each
// chunk knows the state at its start and the adjoint at its end. Both
// kernels give a thread rows p and p + 32 of 4 neighbouring columns of a
// span of kSpan = 32 value columns (256 threads a span), so a row's
// operands serve 8 elements a step and dv sums the two rows in registers.
//  - rwkv6_bwd_carry_kernel (a CTA per (b, h, span, direction)): the
//    light serial passes. One runs the state forward from s0 and writes
//    it at the start of every chunk past the first; the other runs the
//    adjoint backward from ds_final and writes it at the end of every
//    chunk but the last. 2 operations an element a step (a product and an
//    fmaf), no sums, no shuffles; chunks staged with cp.async in a ring,
//    kRing - 1 ahead.
//  - rwkv6_scan_bwd_kernel (a CTA per (b, h, span, chunk), the spans of a
//    (b, h, chunk) one thread-block cluster): the heavy body, every chunk
//    at once. It re-runs its chunk's states from the checkpoint into
//    registers, kSub = 4 at a time (the start of each sub-chunk kept in
//    shared memory), and walks them in reverse from the adjoint
//    checkpoint. The same fmaf sequence as the carry, so a chunk's edge
//    states carry the bits the serial walk gives them; w may be ~0, so
//    nothing runs backwards or divides by it. Steps past S are staged as
//    the identity (w = 1, the rest 0), so every walk takes whole
//    sub-chunks without a branch a step.
//  - Sums: dv over the CTA's 64 rows (the thread's 2 rows in registers,
//    the warp's 4 row pairs by shuffles, the 8 warps through shared
//    memory in warp order); dr, dk, dw over the thread's 4 columns, the
//    span's 8 quads by shuffles, then over the cluster's spans: each rank
//    owns a run of rows, the others push their partials of them into its
//    shared memory as the walk makes them (distributed shared memory,
//    remote stores), and the owner adds them in span order after one
//    split cluster barrier (its wait after the dv pass), each gradient
//    written once. The bonus terms take one sum a step (do . v over the
//    spans, r u k over the rows) and are added after the column sums.
//    du: a chunk's partial from the cluster's first span, and the last of
//    a head's (b, chunk) clusters to draw a ticket sums the partials in
//    (b, chunk) order. No float atomics: every sum has a fixed order, so
//    two launches give the same bits.
//  - Registers and occupancy: the body 79 registers, 74 KB of shared
//    memory, 3 CTAs (24 warps) an SM; the carry 64, 4 CTAs. No division
//    in a copy loop: each thread's 16-byte pieces are fixed at compile
//    time.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace repro_torch {
namespace wkv_bwd {

constexpr int kMaxHd = 64;                     // head_dim limit
constexpr int kQuad = 4;                       // columns per thread
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kL = 16;                         // steps per chunk
constexpr int kSub = 4;                        // a row's states in registers
constexpr int kNSub = kL / kSub;
static_assert(kL == 2 * kThreads / 32, "a warp takes two steps' sums");
constexpr int kKinds = 3;                      // dr, dk, dw

// which gradients the caller wants (the others are not written)
constexpr int kNeedDr = 1, kNeedDk = 2, kNeedDv = 4, kNeedDw = 8,
              kNeedDu = 16, kNeedDs0 = 32;
constexpr int kNeedS = kNeedDr | kNeedDw;                   // states
constexpr int kNeedG = kNeedDk | kNeedDv | kNeedDw | kNeedDs0;  // adjoint

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
  const float* dout;
  const float* dsf;    // null: zeros
  float* out[kKinds];  // dr, dk, dw
  float* dv;
  float* du;
  float* ds0;
  float4* ck_s;        // [B][H][nchunks - 1][nspan][kThreads][2]
  float4* ck_g;        // [B][H][nchunks - 1][nspan][kThreads][2]
  float* du_part;      // [B][nchunks][H][hd]
  unsigned* tickets;   // [H]
  Strides rs, ks, vs, ws, dos, dvs, os[kKinds];
  int B, H, S, hd, nspan, nchunks, need, vec;
};


// the heavy kernel: r, k, w [kL][kMaxHd], v, dout [kL][kSpan]; dv per
// warp; the later sub-chunks' start states; the inbox of the rows this
// CTA owns (every rank's dr, dk, dw partials of them), every rank's do .
// v a step, and sum_i r u k a step
constexpr int kSpan = 32;                      // value columns a body CTA
constexpr int kMaxSpan = kMaxHd / kSpan;       // a cluster's ranks, at most
constexpr int kRowsPer = kMaxHd / 2;           // rows a rank owns, at most
constexpr int kStageFloats = kL * (3 * kMaxHd + 2 * kSpan);
constexpr int kDvFloats = kWarps * kL * kSpan;
constexpr int kSubFloats = (kNSub - 1) * kThreads * 2 * 4;
constexpr int kInboxFloats = kMaxSpan * kL * kRowsPer * 4;
constexpr size_t kSmemBytes =
    (size_t)(kStageFloats + kMaxHd + kDvFloats + kSubFloats + kInboxFloats +
             kMaxSpan * kL + kL) * sizeof(float);
static_assert(kThreads == (kMaxHd / 2) * (kSpan / kQuad),
              "a thread a (row pair, quad)");

// the carry kernel's staging ring: kRing chunks, each two rows arrays
// [kL][kMaxHd] (k, w or r, w) and one of columns [kL][kSpan] (v or dout)
constexpr int kRing = 4;
constexpr int kCarryFloats = kL * (2 * kMaxHd + kSpan);
constexpr size_t kCarrySmem = kRing * kCarryFloats * sizeof(float);

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
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Copy n <= kL rows of width <= W floats, row x from src + x * stride,
// into dst rows of pitch W: 16 bytes a thread where vec, else 4 (the
// pieces a thread takes are fixed at compile time: no division)
template <int W>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          long long stride, int n, int width,
                                          bool vec) {
  constexpr int kQ = W / 4;   // 16-byte pieces a row
  if (vec) {
#pragma unroll
    for (int it = 0; it < (kL * kQ + kThreads - 1) / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int x = e / kQ, c = e % kQ;
      if (e < kL * kQ && x < n && 4 * c < width)
        cp16(dst + x * W + 4 * c, src + x * stride + 4 * c);
    }
  } else {
#pragma unroll
    for (int it = 0; it < (kL * W + kThreads - 1) / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int x = e / W, c = e % W;
      if (e < kL * W && x < n && c < width)
        cp4(dst + x * W + c, src + x * stride + c);
    }
  }
}

// A thread's 4 columns of its row of a (hd, hd) state at p (row-major),
// zeros past hd and past the block's columns; p null: zeros.
__device__ __forceinline__ void load_state(const float* p, int i, int hd,
                                           int jq, int ncols, bool vec,
                                           float (&s)[kQuad]) {
  if (p && vec && i < hd && jq < ncols) {
    const float4 f = *reinterpret_cast<const float4*>(p + i * hd + jq);
    s[0] = f.x, s[1] = f.y, s[2] = f.z, s[3] = f.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < kQuad; ++e)
    s[e] = (p && i < hd && jq + e < ncols) ? p[i * hd + jq + e] : 0.f;
}

__device__ __forceinline__ void store_state(float* p, int i, int hd, int jq,
                                            int ncols, bool vec,
                                            const float (&s)[kQuad]) {
  if (i >= hd) return;
  if (vec && jq < ncols) {
    *reinterpret_cast<float4*>(p + i * hd + jq) =
        make_float4(s[0], s[1], s[2], s[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < kQuad; ++e)
    if (jq + e < ncols) p[i * hd + jq + e] = s[e];
}

// One step of either light recurrence on a thread's 4 columns: the state
// (a = k, c = v) or the adjoint (a = r, c = dout), x = w x + a c. Every
// pass that re-runs a step uses this expression, so a state or an
// adjoint has the same bits wherever it is computed.
__device__ __forceinline__ void carry_step(float (&x)[kQuad], float a,
                                           float ww, float4 c4) {
  const float cc[kQuad] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
  for (int e = 0; e < kQuad; ++e) x[e] = fmaf(ww, x[e], __fmul_rn(a, cc[e]));
}

// The same step from x into y (the chunk's states into registers).
__device__ __forceinline__ void carry_next(float (&y)[kQuad],
                                           const float (&x)[kQuad], float a,
                                           float ww, float4 c4) {
  const float cc[kQuad] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
  for (int e = 0; e < kQuad; ++e) y[e] = fmaf(ww, x[e], __fmul_rn(a, cc[e]));
}

// a chunk boundary's checkpoint of column span sp: a float4 pair (rows p
// and p + 32) a thread, from here on
__device__ __forceinline__ long long ckpt_index(const Args& a, int b, int h,
                                                int c, int sp) {
  return ((((long long)b * a.H + h) * (a.nchunks - 1) + c) * a.nspan + sp) *
         kThreads;
}

// The light serial passes: blockIdx.x = (direction, column span of
// kSpan = 32), a thread rows p and p + 32 of 4 neighbouring columns (p =
// tid / 8, the body's threads); the forward pass writes S at the start of
// chunks 1.., the backward one G at the end of chunks ..nchunks-2, two
// float4 a thread. Chunks are staged kRing - 1 ahead. Also zeroes the
// heads' du tickets.
__global__ void __launch_bounds__(kThreads, 4)
    rwkv6_bwd_carry_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int dir = blockIdx.x / a.nspan, sp = blockIdx.x % a.nspan;
  const int h = blockIdx.y, b = blockIdx.z;
  if (blockIdx.x == 0 && h == 0 && b == 0)
    for (int x = threadIdx.x; x < a.H; x += kThreads) a.tickets[x] = 0u;
  if (a.nchunks < 2 || !(a.need & (dir == 0 ? kNeedS : kNeedG))) return;
  const int j0 = sp * kSpan, hd = a.hd, S = a.S;
  const int ncols = min(kSpan, hd - j0);
  const int tid = threadIdx.x, i0 = tid >> 3, i1 = i0 + kMaxHd / 2;
  const int jq = (tid & 7) * kQuad;
  const bool vec = a.vec != 0;
  const long long state0 = ((long long)b * a.H + h) * hd * hd + j0;
  // forward: rows k (A), w; columns v. backward: rows r (A), w; dout
  const float* ap = dir == 0 ? a.k + b * a.ks.b + h * a.ks.h
                             : a.r + b * a.rs.b + h * a.rs.h;
  const long long as = dir == 0 ? a.ks.s : a.rs.s;
  const float* wp = a.w + b * a.ws.b + h * a.ws.h;
  const float* cp = dir == 0 ? a.v + b * a.vs.b + h * a.vs.h + j0
                             : a.dout + b * a.dos.b + h * a.dos.h + j0;
  const long long cs = dir == 0 ? a.vs.s : a.dos.s;
  float4* const ck = dir == 0 ? a.ck_s : a.ck_g;
  const int passes = a.nchunks - 1;   // chunks walked
  // pass q walks chunk first + step * q, staged in buffer q % kRing
  const int first = dir == 0 ? 0 : a.nchunks - 1;
  const int step = dir == 0 ? 1 : -1;

  // pass q's chunk into its buffer (nothing past the last pass); one
  // commit group a pass either way
  auto stage = [&](int q) {
    if (q < passes) {
      float* buf = smem + (q % kRing) * kCarryFloats;
      const long long t0 = (long long)(first + step * q) * kL;
      const int nt = min(kL, S - (int)t0);
      copy_rows<kMaxHd>(buf, ap + t0 * as, as, nt, hd, vec);
      copy_rows<kMaxHd>(buf + kL * kMaxHd, wp + t0 * a.ws.s, a.ws.s, nt, hd,
                        vec);
      copy_rows<kSpan>(buf + 2 * kL * kMaxHd, cp + t0 * cs, cs, nt, ncols,
                       vec);
    }
    commit();
  };
  // rows past hd and columns past the span are never copied: zero them
  // (a = w = 0 keeps those rows at 0, c = 0 those columns)
  if (hd < kMaxHd || ncols < kSpan) {
    for (int e = tid; e < kRing * kCarryFloats; e += kThreads) {
      const int x = e % kCarryFloats;
      const bool pad = x < 2 * kL * kMaxHd ? x % kMaxHd >= hd
                                           : x % kSpan >= ncols;
      if (pad) smem[e] = 0.f;
    }
  }
  // the backward pass starts on the last chunk, which may be part-full:
  // its missing steps are a = c = 0, w = 1 (the identity), so every pass
  // walks kL steps
  const int n_last = S - passes * kL;
  if (dir == 1 && n_last < kL) {
    for (int e = tid + n_last * kMaxHd; e < kL * kMaxHd; e += kThreads) {
      smem[e] = 0.f;
      smem[kL * kMaxHd + e] = 1.f;
    }
    for (int e = tid + n_last * kSpan; e < kL * kSpan; e += kThreads)
      smem[2 * kL * kMaxHd + e] = 0.f;
  }
  __syncthreads();

  float st[2][kQuad];
  const float* const st_src =
      dir == 0 ? a.s0 + state0 : (a.dsf ? a.dsf + state0 : nullptr);
  load_state(st_src, i0, hd, jq, ncols, vec, st[0]);
  load_state(st_src, i1, hd, jq, ncols, vec, st[1]);
#pragma unroll
  for (int q = 0; q + 1 < kRing; ++q) stage(q);
  for (int q = 0; q < passes; ++q) {
    wait_group<kRing - 2>();   // pass q's chunk is here
    __syncthreads();           // ...for every thread; pass q - 1's buffer
                               // is free
    stage(q + kRing - 1);
    const int c = first + step * q;
    const float* buf = smem + (q % kRing) * kCarryFloats;
    auto walk = [&](int x) {
      const float4 c4 = *reinterpret_cast<const float4*>(
          buf + 2 * kL * kMaxHd + x * kSpan + jq);
      carry_step(st[0], buf[x * kMaxHd + i0], buf[(kL + x) * kMaxHd + i0],
                 c4);
      carry_step(st[1], buf[x * kMaxHd + i1], buf[(kL + x) * kMaxHd + i1],
                 c4);
    };
    if (dir == 0) {
#pragma unroll
      for (int x = 0; x < kL; ++x) walk(x);
    } else {
#pragma unroll
      for (int x = kL - 1; x >= 0; --x) walk(x);
    }
    // forward: S at the start of chunk c + 1; backward: G at the end of
    // chunk c - 1
    float4* const dst =
        ck + (ckpt_index(a, b, h, dir == 0 ? c : c - 1, sp) + tid) * 2;
    dst[0] = make_float4(st[0][0], st[0][1], st[0][2], st[0][3]);
    dst[1] = make_float4(st[1][0], st[1][1], st[1][2], st[1][3]);
  }
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

// The heavy body: blockIdx.x = (chunk, column span of kSpan = 32), the
// spans of a chunk one cluster (rank = span). A thread takes rows p and p
// + 32 of 4 neighbouring columns of its span (p = tid / 8, quad tid % 8).
// Rank o owns rows [o rpb, (o + 1) rpb) of the chunk's dr, dk, dw (rpb =
// ceil(hd / spans) <= 32): every rank pushes its partials of them into
// o's inbox as the walk makes them (remote stores, nothing waits on
// them), and o sums them in rank order after one cluster barrier, split
// (arrive, then wait after the local dv pass).
__global__ void __launch_bounds__(kThreads, 3)
    rwkv6_scan_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* const sr = smem;                       // [kL][kMaxHd]
  float* const sk = sr + kL * kMaxHd;
  float* const sw = sk + kL * kMaxHd;
  float* const sv = sw + kL * kMaxHd;           // [kL][kSpan]
  float* const sdo = sv + kL * kSpan;
  float* const su = smem + kStageFloats;        // u of the head [kMaxHd]
  float* const sdv = su + kMaxHd;               // [kWarps][kL][kSpan]
  // the later sub-chunks' start states, [kNSub - 1][kThreads][2 rows]
  float4* const ssub = reinterpret_cast<float4*>(sdv + kDvFloats);
  // inbox: [sender][kL][kRowsPer][4] (dr, dk, dw, -); then do . v of each
  // sender's columns [sender][kL]; then sum_i r u k [kL]
  float* const inbox = reinterpret_cast<float*>(ssub + kSubFloats / 4);
  float* const idov = inbox + kInboxFloats;
  float* const srk = idov + kMaxSpan * kL;

  const int nsp = a.nspan, sp = blockIdx.x % nsp, c = blockIdx.x / nsp;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hd = a.hd, S = a.S;
  const int j0 = sp * kSpan, ncols = min(kSpan, hd - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = tid & 7, jq = q * kQuad;
  const int i0 = tid >> 3, i1 = i0 + kMaxHd / 2;    // the thread's rows
  const bool vec = a.vec != 0;
  const long long bh = (long long)b * a.H + h;
  const long long state0 = bh * hd * hd + j0;
  const int t0 = c * kL, n = min(kL, S - t0);
  const int rpb = (hd + nsp - 1) / nsp;         // rows a rank owns
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();   // this CTA has started

  // the state at the chunk's start, the adjoint at its end (their loads
  // first: the checkpoints come from device memory); the carry writes
  // them by 16-column block, a float4 a (row, quad of the block)
  float st[2][kQuad], g[2][kQuad];
  const bool has_s = a.need & kNeedS, has_g = a.need & kNeedG;
  auto load_ckpt = [&](const float4* ck, int cidx, float (&x)[2][kQuad]) {
    const float4* const src = ck + (ckpt_index(a, b, h, cidx, sp) + tid) * 2;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float4 f = src[rr];
      x[rr][0] = f.x, x[rr][1] = f.y, x[rr][2] = f.z, x[rr][3] = f.w;
    }
  };
  if (c == 0 || !has_s) {
    load_state(has_s ? a.s0 + state0 : nullptr, i0, hd, jq, ncols, vec,
               st[0]);
    load_state(has_s ? a.s0 + state0 : nullptr, i1, hd, jq, ncols, vec,
               st[1]);
  } else {
    load_ckpt(a.ck_s, c - 1, st);
  }
  if (c == a.nchunks - 1 || !has_g) {
    const float* const src = has_g && a.dsf ? a.dsf + state0 : nullptr;
    load_state(src, i0, hd, jq, ncols, vec, g[0]);
    load_state(src, i1, hd, jq, ncols, vec, g[1]);
  } else {
    load_ckpt(a.ck_g, c, g);
  }
  if (tid < kMaxHd) su[tid] = tid < hd ? a.u[h * hd + tid] : 0.f;

  // the chunk's rows: r, k, w (every row), v and dout (the span's columns)
  copy_rows<kMaxHd>(sr, a.r + b * a.rs.b + h * a.rs.h + t0 * a.rs.s, a.rs.s,
                    n, hd, vec);
  copy_rows<kMaxHd>(sk, a.k + b * a.ks.b + h * a.ks.h + t0 * a.ks.s, a.ks.s,
                    n, hd, vec);
  copy_rows<kMaxHd>(sw, a.w + b * a.ws.b + h * a.ws.h + t0 * a.ws.s, a.ws.s,
                    n, hd, vec);
  copy_rows<kSpan>(sv, a.v + b * a.vs.b + h * a.vs.h + t0 * a.vs.s + j0,
                   a.vs.s, n, ncols, vec);
  copy_rows<kSpan>(sdo,
                   a.dout + b * a.dos.b + h * a.dos.h + t0 * a.dos.s + j0,
                   a.dos.s, n, ncols, vec);
  commit();
  // rows past hd, columns past the span and steps past n are never
  // copied: r = k = 0 there and v = dout = 0 (out of every sum), w = 0
  // on the rows past hd and 1 on the steps past n (there both recurrences
  // are the identity, so the walks take whole sub-chunks; those steps'
  // outputs are not written)
  if (hd < kMaxHd || ncols < kSpan || n < kL) {
    for (int e = tid; e < kStageFloats; e += kThreads) {
      const bool rows = e < 3 * kL * kMaxHd;
      const int x = rows ? (e % (kL * kMaxHd)) / kMaxHd
                         : ((e - 3 * kL * kMaxHd) % (kL * kSpan)) / kSpan;
      const bool pad =
          x >= n || (rows ? e % kMaxHd >= hd : e % kSpan >= ncols);
      if (pad) smem[e] = x >= n && e >= 2 * kL * kMaxHd && rows ? 1.f : 0.f;
    }
  }
  wait_all();
  __syncthreads();
  const float u0 = su[lane], u1 = su[lane + 32];

  // per step: do . v over the span's columns, r u k over the rows (warp
  // w takes steps 2w and 2w + 1; shuffles in a fixed order)
  float dov[2];
#pragma unroll
  for (int y = 0; y < 2; ++y) {
    const int x = 2 * warp + y;
    float pv = sdo[x * kSpan + lane] * sv[x * kSpan + lane];
    float qv = fmaf(sr[x * kMaxHd + lane + 32] * u1,
                    sk[x * kMaxHd + lane + 32],
                    sr[x * kMaxHd + lane] * u0 * sk[x * kMaxHd + lane]);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      pv += __shfl_xor_sync(0xffffffffu, pv, off);
      qv += __shfl_xor_sync(0xffffffffu, qv, off);
    }
    dov[y] = pv;
    if (lane == 0) srk[x] = qv;
  }
  cluster_wait();   // every CTA of the cluster has started
  // the span's do . v to every rank
  if (lane < nsp) {
    float* const dst = cluster.map_shared_rank(idov, lane);
    dst[sp * kL + 2 * warp] = dov[0];
    dst[sp * kL + 2 * warp + 1] = dov[1];
  }
  // after the sums below lane q holds (row q < 4 ? i0 : i1, kind q % 4):
  // pushed to the row's owner
  const int prow = q < 4 ? i0 : i1, pkind = q & 3;
  float* const outbox =
      cluster.map_shared_rank(inbox, min(prow / rpb, nsp - 1)) +
      (sp * kL * kRowsPer + prow % rpb) * 4 + pkind;
  const bool push = pkind < kKinds && prow < hd;

  // the sub-chunks' start states, forward from the chunk's start (the
  // first's stays in st)
  {
    float run[2][kQuad];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < kQuad; ++e) run[rr][e] = st[rr][e];
#pragma unroll
    for (int x = 0; x + kSub < kL; ++x) {
      if (x + 1 >= n) break;   // no later sub-chunk starts past it
      const float4 v4 =
          *reinterpret_cast<const float4*>(sv + x * kSpan + jq);
      carry_step(run[0], sk[x * kMaxHd + i0], sw[x * kMaxHd + i0], v4);
      carry_step(run[1], sk[x * kMaxHd + i1], sw[x * kMaxHd + i1], v4);
      if ((x + 1) % kSub == 0) {
        float4* const dst = ssub + (((x + 1) / kSub - 1) * kThreads + tid) * 2;
        dst[0] = make_float4(run[0][0], run[0][1], run[0][2], run[0][3]);
        dst[1] = make_float4(run[1][0], run[1][1], run[1][2], run[1][3]);
      }
    }
  }

  // the sub-chunks backwards: their states into registers, then the
  // steps in reverse
  for (int qs = kNSub - 1; qs >= 0; --qs) {
    const int x0 = qs * kSub;
    if (x0 >= n) continue;
    float hs[kSub][2][kQuad];
    if (qs == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int e = 0; e < kQuad; ++e) hs[0][rr][e] = st[rr][e];
    } else {
      const float4* const src = ssub + ((qs - 1) * kThreads + tid) * 2;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float4 f = src[rr];
        hs[0][rr][0] = f.x, hs[0][rr][1] = f.y, hs[0][rr][2] = f.z,
        hs[0][rr][3] = f.w;
      }
    }
#pragma unroll
    for (int y = 0; y + 1 < kSub; ++y) {
      const int x = x0 + y;
      const float4 v4 =
          *reinterpret_cast<const float4*>(sv + x * kSpan + jq);
      carry_next(hs[y + 1][0], hs[y][0], sk[x * kMaxHd + i0],
                 sw[x * kMaxHd + i0], v4);
      carry_next(hs[y + 1][1], hs[y][1], sk[x * kMaxHd + i1],
                 sw[x * kMaxHd + i1], v4);
    }
#pragma unroll
    for (int y = kSub - 1; y >= 0; --y) {
      const int x = x0 + y;
      const float r0 = sr[x * kMaxHd + i0], k0 = sk[x * kMaxHd + i0];
      const float w0 = sw[x * kMaxHd + i0];
      const float r1 = sr[x * kMaxHd + i1], k1 = sk[x * kMaxHd + i1];
      const float w1 = sw[x * kMaxHd + i1];
      const float4 v4 = *reinterpret_cast<const float4*>(sv + x * kSpan + jq);
      const float4 d4 =
          *reinterpret_cast<const float4*>(sdo + x * kSpan + jq);
      const float vv[kQuad] = {v4.x, v4.y, v4.z, v4.w};
      const float dd[kQuad] = {d4.x, d4.y, d4.z, d4.w};
      // dr, dk, dw, - of row i0, then of row i1
      float sums[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float dvp[kQuad];
#pragma unroll
      for (int e = 0; e < kQuad; ++e) {
        const float p0 = hs[y][0][e], p1 = hs[y][1][e];
        sums[0] = fmaf(dd[e], p0, sums[0]);
        sums[1] = fmaf(vv[e], g[0][e], sums[1]);
        sums[2] = fmaf(g[0][e], p0, sums[2]);
        sums[4] = fmaf(dd[e], p1, sums[4]);
        sums[5] = fmaf(vv[e], g[1][e], sums[5]);
        sums[6] = fmaf(g[1][e], p1, sums[6]);
        dvp[e] = fmaf(k1, g[1][e], k0 * g[0][e]);
        g[0][e] = fmaf(w0, g[0][e], __fmul_rn(r0, dd[e]));
        g[1][e] = fmaf(w1, g[1][e], __fmul_rn(r1, dd[e]));
      }
      // the rows' sums over the span's 8 quads: lane q keeps slot q
      reduce_scatter<8, 4, 1>(sums, lane);
      if (push) outbox[x * kRowsPer * 4] = sums[0];
      // dv over the warp's 4 row pairs: lane keeps column (lane >> 3) & 3
      // of its quad
      reduce_scatter<kQuad, 16, 8>(dvp, lane);
      sdv[(warp * kL + x) * kSpan + jq + ((lane >> 3) & 3)] = dvp[0];
    }
  }
  if (c == 0 && (a.need & kNeedDs0)) {
    store_state(a.ds0 + state0, i0, hd, jq, ncols, vec, g[0]);
    store_state(a.ds0 + state0, i1, hd, jq, ncols, vec, g[1]);
  }
  // this thread's pushes are made: the cluster barrier completes once
  // every thread of every rank has arrived; the dv pass runs meanwhile
  cluster_arrive();
  __syncthreads();   // the chunk's dv parts and step sums are in

  static_assert(kL * kSpan == 2 * kThreads, "two dv outputs a thread");
  if (a.need & kNeedDv) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int x = tid / kSpan + it * (kThreads / kSpan), jj = tid % kSpan;
      if (x < n && jj < ncols) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          acc += sdv[(w * kL + x) * kSpan + jj];
        a.dv[b * a.dvs.b + h * a.dvs.h + (long long)(t0 + x) * a.dvs.s +
             j0 + jj] = fmaf(sdo[x * kSpan + jj], srk[x], acc);
      }
    }
  }

  // every rank's partials of this rank's rows are in its inbox
  cluster_wait();
  auto dov_total = [&](int x) {
    float t = 0.f;
#pragma unroll
    for (int o = 0; o < kMaxSpan; ++o)
      if (o < nsp) t += idov[o * kL + x];
    return t;
  };
  const int r0 = sp * rpb, mine = max(0, min(rpb, hd - r0));
  static_assert(kL * kRowsPer == 2 * kThreads, "two (step, row) a thread");
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int x = tid / kRowsPer + it * (kThreads / kRowsPer);
    const int lr = tid % kRowsPer, row = r0 + lr;
    if (x >= n || lr >= mine) continue;
#pragma unroll
    for (int kind = 0; kind < kKinds; ++kind) {
      if (!(a.need & (kind == 0 ? kNeedDr : kind == 1 ? kNeedDk : kNeedDw)))
        continue;
      float acc = 0.f;
#pragma unroll
      for (int o = 0; o < kMaxSpan; ++o)
        if (o < nsp) acc += inbox[((o * kL + x) * kRowsPer + lr) * 4 + kind];
      if (kind == 0)
        acc = fmaf(su[row] * sk[x * kMaxHd + row], dov_total(x), acc);
      else if (kind == 1)
        acc = fmaf(sr[x * kMaxHd + row] * su[row], dov_total(x), acc);
      const Strides os = kind == 0 ? a.os[0] : kind == 1 ? a.os[1] : a.os[2];
      float* const out = kind == 0 ? a.out[0] : kind == 1 ? a.out[1]
                                                          : a.out[2];
      out[b * os.b + h * os.h + (long long)(t0 + x) * os.s + row] = acc;
    }
  }

  // du: the chunk's partial (span 0), then a ticket for the head; the
  // last of its B * nchunks clusters sums the partials in (b, chunk) order
  if (!(a.need & kNeedDu) || sp != 0) return;
  __shared__ int last;
  if (tid < hd) {
    float acc = 0.f;
    for (int y = 0; y < n; ++y)
      acc = fmaf(sr[y * kMaxHd + tid] * sk[y * kMaxHd + tid], dov_total(y),
                 acc);
    a.du_part[(((long long)b * a.nchunks + c) * a.H + h) * hd + tid] = acc;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(a.tickets + h, 1u) == (unsigned)(a.B * a.nchunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < hd) {
    float acc = 0.f;
    const long long cnt = (long long)a.B * a.nchunks;
#pragma unroll 8
    for (long long qq = 0; qq < cnt; ++qq)
      acc += __ldcg(a.du_part + (qq * a.H + h) * hd + tid);
    a.du[h * hd + tid] = acc;
  }
}

// Allow a kernel its dynamic shared memory and the largest shared-memory
// carveout, once per device (the attributes persist), so an SM holds as
// many CTAs as its registers allow.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

}  // namespace wkv_bwd
}  // namespace repro_torch

// strides: 27 element strides, (b, head, seq) of r, k, v, w, dout, dv,
// dr, dk and dw in that order. ds_final may be null (zeros); an output
// whose bit is clear in `need` (dr 1, dk 2, dv 4, dw 8, du 16, ds0 32) may
// be null. ck_s and ck_g: B*H*(nchunks - 1)*nspan*512 float4 each (at
// least one), du_part: B*nchunks*H*hd floats, tickets: H unsigned ints
// (nspan = ceil(hd / 32), nchunks = ceil(S / 16)). Returns a cudaError_t
// (0 = launched).
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dout, const void* dsf,
    void* dr, void* dk, void* dv, void* dw, void* du, void* ds0, void* ck_s,
    void* ck_g, void* du_part, void* tickets, const long long* st, int B,
    int H, int S, int hd, int need, void* stream) {
  using namespace repro_torch::wkv_bwd;
  if (hd < 1 || hd > kMaxHd || S < 1 || B < 1 || H < 1 || B > 65535 ||
      H > 65535 || !s0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.dout = static_cast<const float*>(dout);
  a.dsf = static_cast<const float*>(dsf);
  a.out[0] = static_cast<float*>(dr);
  a.out[1] = static_cast<float*>(dk);
  a.out[2] = static_cast<float*>(dw);
  a.dv = static_cast<float*>(dv);
  a.du = static_cast<float*>(du);
  a.ds0 = static_cast<float*>(ds0);
  a.ck_s = static_cast<float4*>(ck_s);
  a.ck_g = static_cast<float4*>(ck_g);
  a.du_part = static_cast<float*>(du_part);
  a.tickets = static_cast<unsigned*>(tickets);
  a.rs = {st[0], st[1], st[2]};
  a.ks = {st[3], st[4], st[5]};
  a.vs = {st[6], st[7], st[8]};
  a.ws = {st[9], st[10], st[11]};
  a.dos = {st[12], st[13], st[14]};
  a.dvs = {st[15], st[16], st[17]};
  a.os[0] = {st[18], st[19], st[20]};
  a.os[1] = {st[21], st[22], st[23]};
  a.os[2] = {st[24], st[25], st[26]};
  a.B = B;
  a.H = H;
  a.S = S;
  a.hd = hd;
  a.nspan = (hd + kSpan - 1) / kSpan;
  a.nchunks = (S + kL - 1) / kL;
  a.need = need;
  // 16-byte pieces need every row start (and column block) 16-byte aligned
  bool vec = hd % 4 == 0;
  const void* const bases[] = {r, k, v, w, dout, s0, dsf, ds0};
  for (const void* p : bases)
    vec = vec && (reinterpret_cast<uintptr_t>(p) % 16 == 0);
  for (int x = 0; x < 15; ++x) vec = vec && st[x] % 4 == 0;
  a.vec = vec;
  if ((long long)a.nspan * a.nchunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static unsigned long long carry_ok = 0, body_ok = 0;   // a bit a device
  cudaError_t err = allow_smem(rwkv6_bwd_carry_kernel, kCarrySmem, carry_ok);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(rwkv6_scan_bwd_kernel, kSmemBytes, body_ok);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rwkv6_bwd_carry_kernel<<<dim3(2 * a.nspan, H, B), kThreads, kCarrySmem,
                           s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the column spans of a (b, h, chunk) form a cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nspan * a.nchunks, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nspan;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rwkv6_scan_bwd_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

