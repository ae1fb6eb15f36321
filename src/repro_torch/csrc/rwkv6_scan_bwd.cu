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
//   dr_t[i] = sum_j do_t[j] (S_t[i,j] + u[i] k_t[i] v_t[j])
//   dw_t[i] = sum_j G[i,j] S_t[i,j]
//   dk_t[i] = sum_j (G[i,j] + r_t[i] u[i] do_t[j]) v_t[j]
//   dv_t[j] = sum_i (G[i,j] + r_t[i] u[i] do_t[j]) k_t[i]
//   du[i]  += r_t[i] k_t[i] sum_j do_t[j] v_t[j]        (over b and t)
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
// every sum, as u k (do . v), r u (do . v) and do sum_i r u k, O(hd) a
// step): 1.88 GFLOP, 28.0 us. Operations bound it, the bytes close
// behind. The kernel sums the bonus term inside the loop (18 a (i, j));
// taking it out of the loop did not make the kernel faster (PERF.md).
//
// Design (a first, simple kernel: right, deterministic, no float atomics):
//  - The forward's split: a CTA per (b, h, block of kCols = 16 value
//    columns), since column j of S and of G depends only on r, k, w
//    (every row) and v[j], do[j]. 256 threads, a row to 4 threads, each
//    with 4 neighbouring columns in registers.
//  - Saved states: none from the forward (it stays the serving kernel,
//    unchanged). Phase 1 re-runs the state forward from s0 and writes the
//    state at the start of every chunk of kL = 16 steps to a workspace,
//    each thread its own 16 bytes (coalesced). Phase 2 walks the chunks
//    backwards: it re-runs the chunk's 16 states from its checkpoint into
//    registers (the same fmaf as the forward, so the same bits), then the
//    16 steps in reverse. The recurrence is never run backwards: w can be
//    ~0, and dividing by it is not an option.
//  - Sums: dv sums over the CTA's rows (8 rows of a warp by shuffles, the
//    8 warps through shared memory at the chunk's end); dr, dk, dw sum over
//    the thread's 4 columns, then the row's 4 threads by shuffles, and are
//    written per column block as partials; du per thread over the steps,
//    then per column block. A second kernel adds the partials in block
//    order (and du's over the rows b). Every sum has a fixed order, so two
//    launches on the same inputs give the same bits.
//  - Inputs staged a chunk at a time with cp.async (16-byte pieces where
//    aligned), the next chunk in flight while the current one computes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace wkv_bwd {

constexpr int kMaxHd = 64;                     // head_dim limit
constexpr int kCols = 16;                      // value columns per CTA
constexpr int kQuad = 4;                       // columns per thread
constexpr int kRowThreads = kCols / kQuad;     // threads per state row (4)
constexpr int kThreads = kMaxHd * kRowThreads; // 256
constexpr int kWarps = kThreads / 32;
constexpr int kL = 16;                         // steps per chunk
constexpr int kKinds = 3;                      // partials: dr, dk, dw

// which gradients the caller wants (the others are neither summed nor
// written)
constexpr int kNeedDr = 1, kNeedDk = 2, kNeedDv = 4, kNeedDw = 8,
              kNeedDu = 16, kNeedDs0 = 32;

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
  float* dv;
  float* ds0;
  float* part;         // [kKinds][nblk][B][H][S][hd]
  float* du_part;      // [nblk][B][H][hd]
  float4* ckpt;        // [B][H][nblk][nchunks - 1][kThreads]
  Strides rs, ks, vs, ws, dos, dvs;
  int B, H, S, hd, nblk, nchunks, need, vec;
};

struct ReduceArgs {
  const float* part;
  const float* du_part;
  float* out[kKinds];  // dr, dk, dw
  Strides os[kKinds];
  float* du;
  int B, H, S, hd, nblk, need;
};

// one staging buffer: r, k, w [kL][kMaxHd], v, dout [kL][kCols]
constexpr int kBufFloats = kL * (3 * kMaxHd + 2 * kCols);
constexpr int kPartFloats = kKinds * kL * kMaxHd;
constexpr int kDvFloats = kWarps * kL * kCols;
constexpr size_t kSmemBytes =
    (size_t)(2 * kBufFloats + kPartFloats + kDvFloats) * sizeof(float);

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

// A thread's 4 columns of its row of a (hd, hd) state at p (row-major),
// zeros past hd and past the block's columns.
__device__ __forceinline__ void load_state(const float* p, int i, int hd,
                                           int jq, int ncols, bool vec,
                                           float (&s)[kQuad]) {
  if (vec && i < hd && jq < ncols) {
    const float4 f = *reinterpret_cast<const float4*>(p + i * hd + jq);
    s[0] = f.x, s[1] = f.y, s[2] = f.z, s[3] = f.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < kQuad; ++e)
    s[e] = (i < hd && jq + e < ncols) ? p[i * hd + jq + e] : 0.f;
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

__global__ void __launch_bounds__(kThreads, 2)
    rwkv6_scan_bwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* spart = smem + 2 * kBufFloats;        // [kKinds][kL][kMaxHd]
  float* sdv = spart + kPartFloats;            // [kWarps][kL][kCols]
  const int blk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int j0 = blk * kCols, hd = a.hd, S = a.S;
  const int ncols = min(kCols, hd - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid >> 2, cq = tid & 3, jq = cq * kQuad;
  const bool vec = a.vec != 0;
  const long long state0 = ((long long)b * a.H + h) * hd * hd + j0;

  const float* rp = a.r + b * a.rs.b + h * a.rs.h;
  const float* kp = a.k + b * a.ks.b + h * a.ks.h;
  const float* wp = a.w + b * a.ws.b + h * a.ws.h;
  const float* vp = a.v + b * a.vs.b + h * a.vs.h + j0;
  const float* dop = a.dout + b * a.dos.b + h * a.dos.h + j0;
  float4* ckpt = a.ckpt + (((long long)b * a.H + h) * a.nblk + blk) *
                              (a.nchunks - 1) * kThreads + tid;

  // chunk c into buffer c & 1: k, w, v always, r and dout for phase 2
  auto stage = [&](int c, bool all) {
    float* buf = smem + (c & 1) * kBufFloats;
    const long long t0 = (long long)c * kL;
    const int nt = min(kL, S - (int)t0);
    if (all)
      copy_rows(buf, kMaxHd, rp + t0 * a.rs.s, a.rs.s, nt, hd, vec);
    copy_rows(buf + kL * kMaxHd, kMaxHd, kp + t0 * a.ks.s, a.ks.s, nt, hd,
              vec);
    copy_rows(buf + 2 * kL * kMaxHd, kMaxHd, wp + t0 * a.ws.s, a.ws.s, nt,
              hd, vec);
    copy_rows(buf + 3 * kL * kMaxHd, kCols, vp + t0 * a.vs.s, a.vs.s, nt,
              ncols, vec);
    if (all)
      copy_rows(buf + 3 * kL * kMaxHd + kL * kCols, kCols,
                dop + t0 * a.dos.s, a.dos.s, nt, ncols, vec);
  };

  // rows past hd and columns past the block are never copied: zero them
  // in both buffers (r = k = w = 0 there keeps those rows of S and G at 0;
  // v = dout = 0 keeps those columns out of every sum)
  for (int e = tid; e < 2 * kBufFloats; e += kThreads) {
    const int x = e % kBufFloats;
    const bool pad = x < 3 * kL * kMaxHd ? x % kMaxHd >= hd
                                         : x % kCols >= ncols;
    if (pad) smem[e] = 0.f;
  }
  __syncthreads();

  // ---- phase 1: the state forward from s0, a checkpoint a chunk
  float st[kQuad];
  load_state(a.s0 + state0, i, hd, jq, ncols, vec, st);
  if (a.nchunks > 1) {
    stage(0, false);
    commit();
  }
  for (int c = 0; c + 1 < a.nchunks; ++c) {
    wait_all();
    __syncthreads();   // chunk c is here; chunk c - 1's buffer is free
    if (c + 2 < a.nchunks) {
      stage(c + 1, false);
      commit();
    }
    const float* buf = smem + (c & 1) * kBufFloats;
#pragma unroll 4
    for (int x = 0; x < kL; ++x) {   // every chunk but the last is whole
      const float kk = buf[kL * kMaxHd + x * kMaxHd + i];
      const float ww = buf[2 * kL * kMaxHd + x * kMaxHd + i];
      const float4 v4 =
          *reinterpret_cast<const float4*>(buf + 3 * kL * kMaxHd +
                                           x * kCols + jq);
      const float vv[kQuad] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < kQuad; ++e)
        st[e] = fmaf(ww, st[e], __fmul_rn(kk, vv[e]));
    }
    ckpt[(long long)c * kThreads] = make_float4(st[0], st[1], st[2], st[3]);
  }

  // ---- phase 2: the chunks backwards
  float g[kQuad];
  if (a.dsf) {
    load_state(a.dsf + state0, i, hd, jq, ncols, vec, g);
  } else {
#pragma unroll
    for (int e = 0; e < kQuad; ++e) g[e] = 0.f;
  }
  const float u_i = i < hd ? a.u[h * hd + i] : 0.f;
  float du_acc = 0.f;
  __syncthreads();     // phase 1's buffers are read
  stage(a.nchunks - 1, true);
  commit();
  for (int c = a.nchunks - 1; c >= 0; --c) {
    wait_all();
    // chunk c is here; chunk c + 1's buffer, partials and dv are written
    // out
    __syncthreads();
    if (c > 0) {
      stage(c - 1, true);
      commit();
    }
    const float* buf = smem + (c & 1) * kBufFloats;
    const float* sr = buf;
    const float* sk = buf + kL * kMaxHd;
    const float* sw = buf + 2 * kL * kMaxHd;
    const float* sv = buf + 3 * kL * kMaxHd;
    const float* sdo = sv + kL * kCols;
    const int t0 = c * kL, n = min(kL, S - t0);

    // the chunk's states before each step, from its checkpoint
    float hs[kL][kQuad];
    if (c == 0) {
      load_state(a.s0 + state0, i, hd, jq, ncols, vec, hs[0]);
    } else {
      const float4 f = ckpt[(long long)(c - 1) * kThreads];
      hs[0][0] = f.x, hs[0][1] = f.y, hs[0][2] = f.z, hs[0][3] = f.w;
    }
#pragma unroll
    for (int x = 0; x + 1 < kL; ++x) {
      if (x + 1 < n) {
        const float kk = sk[x * kMaxHd + i], ww = sw[x * kMaxHd + i];
        const float4 v4 =
            *reinterpret_cast<const float4*>(sv + x * kCols + jq);
        const float vv[kQuad] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < kQuad; ++e)
          hs[x + 1][e] = fmaf(ww, hs[x][e], __fmul_rn(kk, vv[e]));
      }
    }

#pragma unroll
    for (int x = kL - 1; x >= 0; --x) {
      if (x < n) {
        const float rr = sr[x * kMaxHd + i], kk = sk[x * kMaxHd + i];
        const float ww = sw[x * kMaxHd + i];
        const float4 v4 =
            *reinterpret_cast<const float4*>(sv + x * kCols + jq);
        const float4 d4 =
            *reinterpret_cast<const float4*>(sdo + x * kCols + jq);
        const float vv[kQuad] = {v4.x, v4.y, v4.z, v4.w};
        const float dd[kQuad] = {d4.x, d4.y, d4.z, d4.w};
        const float uk = u_i * kk, ru = rr * u_i;
        float sums[4] = {0.f, 0.f, 0.f, 0.f};   // dr, dk, dw parts, pad
        float dvp[kQuad];
        float dov = 0.f;
#pragma unroll
        for (int e = 0; e < kQuad; ++e) {
          const float p = hs[x][e];
          sums[0] = fmaf(dd[e], fmaf(uk, vv[e], p), sums[0]);
          sums[2] = fmaf(g[e], p, sums[2]);
          const float dkv = fmaf(ru, dd[e], g[e]);
          sums[1] = fmaf(vv[e], dkv, sums[1]);
          dvp[e] = kk * dkv;
          dov = fmaf(dd[e], vv[e], dov);
          g[e] = fmaf(ww, g[e], rr * dd[e]);
        }
        du_acc = fmaf(rr * kk, dov, du_acc);
        // dr, dk, dw over the row's 4 threads: thread cq keeps kind cq
        reduce_scatter<4, 2, 1>(sums, lane);
        if (cq < kKinds) spart[(cq * kL + x) * kMaxHd + i] = sums[0];
        // dv over the warp's 8 rows: lanes with bit 2 clear keep column
        // (lane >> 3) & 3 of their quad
        reduce_scatter<kQuad, 16, 8>(dvp, lane);
        dvp[0] += __shfl_xor_sync(0xffffffffu, dvp[0], 4);
        if (!(lane & 4))
          sdv[(warp * kL + x) * kCols + jq + ((lane >> 3) & 3)] = dvp[0];
      }
    }
    __syncthreads();   // the chunk's partials and dv parts are in

    const long long bh = (long long)b * a.H + h;
    for (int kind = 0; kind < kKinds; ++kind) {
      const int bit = kind == 0 ? kNeedDr : kind == 1 ? kNeedDk : kNeedDw;
      if (!(a.need & bit)) continue;
      float* dst = a.part + (((long long)kind * a.nblk + blk) * a.B * a.H +
                             bh) * S * hd + (long long)t0 * hd;
      for (int e = tid; e < n * hd; e += kThreads)
        dst[e] = spart[(kind * kL + e / hd) * kMaxHd + e % hd];
    }
    if (a.need & kNeedDv) {
      float* dvb = a.dv + b * a.dvs.b + h * a.dvs.h + j0;
      for (int e = tid; e < n * ncols; e += kThreads) {
        const int x = e / ncols, jj = e % ncols;
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) acc += sdv[(q * kL + x) * kCols + jj];
        dvb[(long long)(t0 + x) * a.dvs.s + jj] = acc;
      }
    }
  }

  if (a.need & kNeedDs0) store_state(a.ds0 + state0, i, hd, jq, ncols, vec, g);
  if (a.need & kNeedDu) {
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 1);
    du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 2);
    if (cq == 0 && i < hd)
      a.du_part[(((long long)blk * a.B + b) * a.H + h) * hd + i] = du_acc;
  }
}

// dr, dk, dw: the column blocks' partials added in block order; du: the
// blocks' and rows' partials added in (row, block) order.
__global__ void rwkv6_scan_bwd_reduce(const ReduceArgs a) {
  const long long n = (long long)a.B * a.H * a.S * a.hd;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int bits[kKinds] = {kNeedDr, kNeedDk, kNeedDw};
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int i = e % a.hd;
    const long long t = e / a.hd % a.S, bh = e / ((long long)a.hd * a.S);
    const long long hh = bh % a.H, bb = bh / a.H;
#pragma unroll
    for (int kind = 0; kind < kKinds; ++kind) {
      if (!(a.need & bits[kind])) continue;
      float acc = 0.f;
      for (int q = 0; q < a.nblk; ++q)
        acc += a.part[((long long)kind * a.nblk + q) * n + e];
      a.out[kind][bb * a.os[kind].b + hh * a.os[kind].h + t * a.os[kind].s +
                  i] = acc;
    }
  }
  if (!(a.need & kNeedDu)) return;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < (long long)a.H * a.hd; e += stride) {
    float acc = 0.f;
    for (int bb = 0; bb < a.B; ++bb)
      for (int q = 0; q < a.nblk; ++q)
        acc += a.du_part[((long long)q * a.B + bb) * a.H * a.hd + e];
    a.du[e] = acc;
  }
}

}  // namespace wkv_bwd
}  // namespace repro_torch

// strides: 27 element strides, (b, head, seq) of r, k, v, w, dout, dv,
// dr, dk and dw in that order. ds_final may be null (zeros); an output
// whose bit is clear in `need` (dr 1, dk 2, dv 4, dw 8, du 16, ds0 32) may
// be null. part: 3 * nblk * B*H*S*hd floats, du_part: nblk * B*H*hd,
// ckpt: B*H*nblk*(nchunks - 1)*256*4 (nblk = ceil(hd / 16), nchunks =
// ceil(S / 16)). Returns a cudaError_t (0 = launched).
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dout, const void* dsf,
    void* dr, void* dk, void* dv, void* dw, void* du, void* ds0, void* part,
    void* du_part, void* ckpt, const long long* st, int B, int H, int S,
    int hd, int need, void* stream) {
  using namespace repro_torch::wkv_bwd;
  if (hd < 1 || hd > kMaxHd || S < 1 || B < 1 || H < 1 || B > 65535 ||
      H > 65535)
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
  a.dv = static_cast<float*>(dv);
  a.ds0 = static_cast<float*>(ds0);
  a.part = static_cast<float*>(part);
  a.du_part = static_cast<float*>(du_part);
  a.ckpt = static_cast<float4*>(ckpt);
  a.rs = {st[0], st[1], st[2]};
  a.ks = {st[3], st[4], st[5]};
  a.vs = {st[6], st[7], st[8]};
  a.ws = {st[9], st[10], st[11]};
  a.dos = {st[12], st[13], st[14]};
  a.dvs = {st[15], st[16], st[17]};
  a.B = B;
  a.H = H;
  a.S = S;
  a.hd = hd;
  a.nblk = (hd + kCols - 1) / kCols;
  a.nchunks = (S + kL - 1) / kL;
  a.need = need;
  // 16-byte pieces need every row start (and column block) 16-byte aligned
  bool vec = hd % 4 == 0;
  const void* const bases[] = {r, k, v, w, dout, s0, dsf, ds0};
  for (const void* p : bases)
    vec = vec && (reinterpret_cast<uintptr_t>(p) % 16 == 0);
  for (int x = 0; x < 15; ++x) vec = vec && st[x] % 4 == 0;
  a.vec = vec;
  static unsigned long long allowed = 0;   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(allowed >> dev & 1ull)) {
    err = cudaFuncSetAttribute(rwkv6_scan_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    allowed |= 1ull << dev;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rwkv6_scan_bwd_kernel<<<dim3(a.nblk, H, B), kThreads, kSmemBytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (!(need & (kNeedDr | kNeedDk | kNeedDw | kNeedDu))) return 0;
  ReduceArgs ra{};
  ra.part = a.part;
  ra.du_part = a.du_part;
  ra.out[0] = static_cast<float*>(dr);
  ra.out[1] = static_cast<float*>(dk);
  ra.out[2] = static_cast<float*>(dw);
  ra.os[0] = {st[18], st[19], st[20]};
  ra.os[1] = {st[21], st[22], st[23]};
  ra.os[2] = {st[24], st[25], st[26]};
  ra.du = static_cast<float*>(du);
  ra.B = B;
  ra.H = H;
  ra.S = S;
  ra.hd = hd;
  ra.nblk = a.nblk;
  ra.need = need;
  const long long n = (long long)B * H * S * hd;
  const long long blocks = (n + 255) / 256;
  rwkv6_scan_bwd_reduce<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      ra);
  return (int)cudaGetLastError();
}
