// The filter gradient of the valid, stride-1 2-D convolution (NHWC x HWIO):
// the conv layer's weight gradient on every backward pass of the paper's
// digit CNN in training (repro_torch/kernels/ops.py, the autograd Function
// around conv2d).
//
// The TPU side has no kernel for it: the reference trains through lax.conv
// and its transpose (src/repro/models/cnn.py:37-46), not through its Pallas
// conv2d (src/repro/kernels/conv2d.py:37). Semantics: repro_torch/kernels/
// ref.py conv2d_wgrad_ref:
//
//   dw[i, j, ci, co] = sum_{b < B, y < Ho, x < Wo}
//                        x[b, y + i, x + j, ci] * dy[b, y, x, co]
//
// summed in float32 and stored in x's type (float32 or bfloat16).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s float32 on CUDA cores, data
// sheet), counting each input read once and the output written once: at
// the paper's training step (B=64, 28x28x1 images, 32 filters of 3x3) dy
// is 5.54 MB, x 0.20 MB, dw 1.2 KB: 1.7 us; the 2 * 64 * 676 * 288 = 24.9
// MFLOP take 0.37 us. At B=2000, 53.5 us against 11.6 us. Bytes bound it.
//
// Design: one launch, deterministic (no float atomics: the bits depend on
// the plan alone).
//
// - `ctas` CTAs (kernels/conv2d_wgrad.py:plan, computed on the host from
//   the shapes and the SM count, validated here), CTA c over a contiguous
//   range of the B * Ho (image, output row) pairs, `ctas_per_sm` of them
//   resident on every SM (the plan pads shared memory so no more fit).
//   The range is cut into chunks of `slot_pairs` pairs. A chunk's dy rows
//   are one contiguous span, and so are its input rows, also where it
//   runs into the next image (whose rows follow in memory).
// - Loads: the CTA's last warp produces. Its lane 0 fills a ring of
//   `stages` shared-memory slots, each chunk's input rows and dy rows by
//   two 1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx::bytes)
//   that complete on the slot's `full` barrier, and refills a slot once
//   every consumer warp has arrived on its `empty` barrier. So several
//   chunks are in flight while the warps compute, with no CTA-wide
//   barrier in the loop. Bulk copies need 16-byte aligned addresses and
//   sizes: a slot holds each window at the window's own offset within a
//   16-byte chunk, the copy covering the whole chunks around it that lie
//   inside the array; the producer copies the few elements of a
//   misaligned first or last chunk of the array itself (conv2d.cu's
//   scheme: a bfloat16 input row of 28 pixels is 56 bytes). Slots hold
//   the operands in their own type, converted at use.
// - Arithmetic, the paper's 3x3x1 filter with 32 output channels (FIXED):
//   the consumer warps take the CTA's pairs in turn (pair j of the range
//   to warp j % warps; a chunk holds a multiple of the warps); lane l owns
//   output channel l and its 9 taps as 9 float32 accumulators. Walking a
//   row of Wo pixels, the lane keeps a 3x3 window of input values in
//   registers, so a pixel costs one coalesced dy load, 3 broadcast input
//   loads and 9 FMAs. Other filters (up to 4,096
//   outputs): every consumer thread owns `per` outputs and walks every
//   pair of the CTA, two shared loads an FMA.
// - Sum across CTAs: each CTA sums its warps' accumulators in warp order.
//   The CTAs of a thread-block cluster (`cluster`, at most 8; 2 by
//   default, as clusters of 4 leave SMs unused) then merge: rank r owns
//   outputs [r m, (r + 1) m); every CTA sends each rank its share of them
//   over distributed shared memory, and after one cluster barrier rank r
//   sums the shares in rank order and writes them to a float32 workspace
//   row, one per cluster. Each CTA then takes a ticket from a device
//   counter (an integer atomicAdd, after __threadfence); the CTA that
//   draws the last one sums the rows in index order (as `slices`
//   interleaved runs, added in slice order), stores dw in x's type and
//   sets the counter back to 0, so the next launch, or a CUDA graph's
//   replay, finds it at 0.
//
// Operands must be contiguous (the wrapper checks) and are not padded.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace repro_torch {

constexpr int kMaxThreads = 544;   // 16 consumer warps and the producer
constexpr int kMaxPer = 8;         // outputs a thread accumulates (general)
constexpr int kTaps = 9;           // FIXED: the 3x3x1 taps a lane holds
constexpr int kMaxSmem = 232448;   // bytes of shared memory a CTA may use
constexpr int kMaxStages = 8;      // ring slots
constexpr int kMaxCluster = 8;     // CTAs of a portable cluster
constexpr int kHead = 256;         // full and empty mbarriers, a flag
constexpr int kBatch = 16;         // the final sum's loads in flight

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
  return __float2bfloat16(v);
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// the producer's arrival on a slot's barrier, expecting `bytes` of bulk
// copy
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

// Copies the elements [lo, hi) of the array [a_lo, a_hi) into `dst`, the
// element at address a landing at dst + (a - down16(lo)): one bulk copy of
// the whole 16-byte chunks around the window that lie inside the array,
// completing on `bar`, and the rest element by element. -> the bulk
// copy's bytes. (kernels/conv2d_wgrad.py:copy_window mirrors it.)
template <typename T>
__device__ uint32_t copy_window(unsigned char* dst, uintptr_t lo,
                                uintptr_t hi, uintptr_t a_lo, uintptr_t a_hi,
                                uint64_t* bar) {
  constexpr int es = (int)sizeof(T);
  const uintptr_t base = down16(lo);
  const uintptr_t c0 = amax(base, up16(a_lo));
  const uintptr_t c1 = amin(up16(hi), down16(a_hi));
  uint32_t bulk = 0;
  if (c1 > c0) {
    bulk = (uint32_t)(c1 - c0);
    bulk_load(dst + (c0 - base), reinterpret_cast<const void*>(c0), bulk,
              bar);
  }
  for (uintptr_t a = lo; a < hi; a += es) {
    if (bulk && a >= c0 && a < c1) a = c1 - es;   // skip the bulk part
    else
      *reinterpret_cast<T*>(dst + (a - base)) =
          *reinterpret_cast<const T*>(a);
  }
  return bulk;
}

__host__ __device__ inline int round16(long long n) {
  return (int)((n + 15) / 16 * 16);
}

struct Shape {
  int B, H, W, Cin, KH, KW, Cout, Ho, Wo;
  int rows;    // B * Ho (image, output row) pairs
  int nout;    // KH * KW * Cin * Cout
  // the plan
  int ctas, cluster, stages, slot_pairs, warps, per, x_slot, dy_slot,
      slices;
};

// A pair's first input row, counted over the whole batch: image b's rows
// follow image b - 1's, so a chunk's input rows are one contiguous span
// even where the chunk runs into the next image.
__device__ __forceinline__ int x_row(const Shape& p, int q) {
  return q + (p.KH - 1) * (q / p.Ho);
}

// FIXED: one pair's row of Wo pixels into a lane's 9 taps; xr: the pair's
// first input row (3 rows of W pixels follow), d: the lane's channel of
// the pair's dy row (a stride of 32 a pixel)
template <typename T>
__device__ __forceinline__ void pair_taps(const T* xr, const T* d, int W,
                                          int Wo, float (&acc)[kTaps]) {
  const T* x0 = xr;
  const T* x1 = xr + W;
  const T* x2 = xr + 2 * W;
  float a0 = to_f32(x0[0]), a1 = to_f32(x1[0]), a2 = to_f32(x2[0]);
  float b0 = to_f32(x0[1]), b1 = to_f32(x1[1]), b2 = to_f32(x2[1]);
#pragma unroll 3
  for (int c = 0; c < Wo; ++c) {
    const float g = to_f32(d[c * 32]);
    const float c0 = to_f32(x0[c + 2]), c1 = to_f32(x1[c + 2]),
                c2 = to_f32(x2[c + 2]);
    acc[0] = fmaf(a0, g, acc[0]);
    acc[1] = fmaf(b0, g, acc[1]);
    acc[2] = fmaf(c0, g, acc[2]);
    acc[3] = fmaf(a1, g, acc[3]);
    acc[4] = fmaf(b1, g, acc[4]);
    acc[5] = fmaf(c1, g, acc[5]);
    acc[6] = fmaf(a2, g, acc[6]);
    acc[7] = fmaf(b2, g, acc[7]);
    acc[8] = fmaf(c2, g, acc[8]);
    a0 = b0, b0 = c0;
    a1 = b1, b1 = c1;
    a2 = b2, b2 = c2;
  }
}

template <typename T, bool FIXED>
__global__ void __launch_bounds__(kMaxThreads, 1)
    wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 float* __restrict__ ws, unsigned* __restrict__ counter,
                 T* __restrict__ dw, const Shape p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int* flag = reinterpret_cast<int*>(empty + kMaxStages);
  float* inbox = reinterpret_cast<float*>(smem + kHead);
  unsigned char* ring =
      smem + kHead + round16(4LL * p.cluster * ((p.nout + p.cluster - 1) /
                                                p.cluster));
  float* red = reinterpret_cast<float*>(ring);   // once the ring is done
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = p.warps;                        // warp nw produces
  const int slot = p.x_slot + p.dy_slot;
  const int q0 = (int)((long long)blockIdx.x * p.rows / p.ctas);
  const int q1 = (int)((long long)(blockIdx.x + 1) * p.rows / p.ctas);
  const size_t in_row = (size_t)p.W * p.Cin;    // elements
  const size_t dy_row = (size_t)p.Wo * p.Cout;
  auto x_at = [&](int q) { return x + (size_t)x_row(p, q) * in_row; };
  auto dy_at = [&](int q) { return dy + (size_t)q * dy_row; };

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the cluster's CTAs may write to each other's inbox once all have
  // started: arrive now, wait before the first write
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");

  float acc[FIXED ? kTaps : kMaxPer];
#pragma unroll
  for (int k = 0; k < (FIXED ? kTaps : kMaxPer); ++k) acc[k] = 0.f;
  // general: the thread's outputs, as offsets into a pair's input window
  // and dy row (xo < 0: none)
  int xo[FIXED ? 1 : kMaxPer], dof[FIXED ? 1 : kMaxPer];
  if constexpr (!FIXED) {
#pragma unroll
    for (int k = 0; k < kMaxPer; ++k) {
      const int o = tid + k * nw * 32;
      xo[k] = -1;
      dof[k] = 0;
      if (warp < nw && k < p.per && o < p.nout) {
        int r = o / p.Cout;
        dof[k] = o - r * p.Cout;
        const int ci = r % p.Cin;
        r /= p.Cin;
        const int j = r % p.KW;
        const int i = r / p.KW;
        xo[k] = (i * p.W + j) * p.Cin + ci;
      }
    }
  }

  if (warp == nw) {
    // the producer: chunk k into slot k % stages, once the consumers have
    // freed the slot's previous chunk
    if (lane == 0) {
      const uintptr_t x_lo = reinterpret_cast<uintptr_t>(x);
      const uintptr_t x_hi = x_lo + (size_t)p.B * p.H * in_row * sizeof(T);
      const uintptr_t d_lo = reinterpret_cast<uintptr_t>(dy);
      const uintptr_t d_hi = d_lo + (size_t)p.rows * dy_row * sizeof(T);
      int s = 0, k = 0;
      uint32_t ph = 0;
      for (int q = q0; q < q1; ++k) {
        const int n = min(p.slot_pairs, q1 - q);
        if (k >= p.stages) mbar_wait(&empty[s], ph ^ 1);
        unsigned char* sl = ring + (size_t)s * slot;
        const uintptr_t xa = reinterpret_cast<uintptr_t>(x_at(q));
        const uintptr_t da = reinterpret_cast<uintptr_t>(dy_at(q));
        uint32_t tx = copy_window<T>(
            sl, xa,
            reinterpret_cast<uintptr_t>(x_at(q + n - 1) + p.KH * in_row),
            x_lo, x_hi, &full[s]);
        tx += copy_window<T>(sl + p.x_slot, da, da + n * dy_row * sizeof(T),
                             d_lo, d_hi, &full[s]);
        mbar_arrive_tx(&full[s], tx);   // releases the element copies too
        q += n;
        if (++s == p.stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    // a consumer warp: every chunk's full barrier, its own pairs, then the
    // chunk's empty barrier. FIXED: a chunk's pairs are a multiple of the
    // warps (but the range's last), so warp w takes pairs w, w + warps, ...
    // of every chunk
    int s = 0;
    uint32_t ph = 0;
    for (int q = q0; q < q1;) {
      const int n = min(p.slot_pairs, q1 - q);
      const int r0 = x_row(p, q);
      mbar_wait(&full[s], ph);
      const unsigned char* sl = ring + (size_t)s * slot;
      const T* xs = reinterpret_cast<const T*>(
          sl + (reinterpret_cast<uintptr_t>(x_at(q)) & 15));
      const T* ds = reinterpret_cast<const T*>(
          sl + p.x_slot + (reinterpret_cast<uintptr_t>(dy_at(q)) & 15));
      if constexpr (FIXED) {
        for (int i = warp; i < n; i += nw)
          pair_taps(xs + (x_row(p, q + i) - r0) * p.W,
                    ds + i * 32 * p.Wo + lane, p.W, p.Wo, acc);
      } else {
        for (int i = 0; i < n; ++i) {
          const T* xi = xs + (x_row(p, q + i) - r0) * in_row;
          const T* di = ds + i * dy_row;
#pragma unroll
          for (int k = 0; k < kMaxPer; ++k) {
            if (xo[k] < 0) continue;
            const T* xr = xi + xo[k];
            const T* dr = di + dof[k];
            float a = acc[k];
            for (int c = 0; c < p.Wo; ++c, xr += p.Cin, dr += p.Cout)
              a = fmaf(to_f32(*xr), to_f32(*dr), a);
            acc[k] = a;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      q += n;
      if (++s == p.stages) {
        s = 0;
        ph ^= 1;
      }
    }
  }
  __syncthreads();   // every chunk read: the ring is free

  // The CTA's partial goes to the ranks that own its outputs: rank r owns
  // outputs [r m, (r + 1) m) and keeps every rank's share of them in its
  // inbox, row by sending rank (distributed shared memory).
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int m = (p.nout + p.cluster - 1) / p.cluster;
  auto send = [&](int o, float v) {
    const int r = o / m;
    cluster.map_shared_rank(inbox, r)[rank * m + (o - r * m)] = v;
  };
  asm volatile("barrier.cluster.wait;\n" ::: "memory");   // all started
  if constexpr (FIXED) {
    if (warp < nw) {
#pragma unroll
      for (int t = 0; t < kTaps; ++t)
        red[warp * p.nout + t * 32 + lane] = acc[t];
    }
    __syncthreads();
    for (int o = tid; o < p.nout; o += blockDim.x) {
      float a = red[o];
      for (int w = 1; w < nw; ++w) a += red[w * p.nout + o];
      send(o, a);
    }
  } else {
    if (warp < nw) {
#pragma unroll
      for (int k = 0; k < kMaxPer; ++k)
        if (xo[k] >= 0) send(tid + k * nw * 32, acc[k]);
    }
  }
  cluster.sync();   // every rank's inbox full; no remote access follows

  // the cluster's partial of the rank's outputs, summed in rank order, to
  // the workspace; then a ticket
  const int lo = rank * m;
  const int mm = max(0, min(p.nout, lo + m) - lo);
  const int cl = blockIdx.x / p.cluster;
  for (int o = tid; o < mm; o += blockDim.x) {
    float a = inbox[o];
    for (int r = 1; r < p.cluster; ++r) a += inbox[r * m + o];
    ws[(size_t)cl * p.nout + lo + o] = a;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned t = atomicAdd(counter, 1u);
    *flag = t == (unsigned)(p.ctas - 1);
    if (*flag) atomicExch(counter, 0u);   // every other ticket is drawn
  }
  __syncthreads();
  if (!*flag) return;

  // the last CTA: dw = the cluster partials summed in index order, as
  // `slices` interleaved runs added in slice order; a thread adds a run
  // for 4 consecutive outputs at once where nout allows (16-byte loads),
  // 16 loads in flight
  __threadfence();
  const int clusters = p.ctas / p.cluster;
  const int vw = p.nout % 4 == 0 ? 4 : 1;
  const int nq = p.nout / vw;
  for (int i = tid; i < p.slices * nq; i += blockDim.x) {
    const int sl = i / nq;
    const int o = (i - sl * nq) * vw;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = sl; c0 < clusters; c0 += kBatch * p.slices) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = c0 + u * p.slices;
        const float* src = ws + (size_t)c * p.nout + o;
        if (c >= clusters)
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        else if (vw == 4)
          v[u] = __ldcg(reinterpret_cast<const float4*>(src));
        else
          v[u] = make_float4(__ldcg(src), 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (c0 + u * p.slices >= clusters) break;
        a.x += v[u].x, a.y += v[u].y, a.z += v[u].z, a.w += v[u].w;
      }
    }
    float* r = red + sl * p.nout + o;
    r[0] = a.x;
    if (vw == 4) r[1] = a.y, r[2] = a.z, r[3] = a.w;
  }
  __syncthreads();
  for (int o = tid; o < p.nout; o += blockDim.x) {
    float a = red[o];
    for (int sl = 1; sl < p.slices; ++sl) a += red[sl * p.nout + o];
    dw[o] = from_f32<T>(a);
  }
}

// The plan (kernels/conv2d_wgrad.py:plan) must describe this shape and fit
// the kernel; nothing of it is recomputed here.
inline bool plan_ok(const Shape& p, bool fixed, int es, int smem) {
  if (p.B < 1 || p.Cin < 1 || p.Cout < 1 || p.KH < 1 || p.KW < 1 ||
      p.Ho < 1 || p.Wo < 1)
    return false;
  const long long rows = (long long)p.B * p.Ho;
  const long long nout = (long long)p.KH * p.KW * p.Cin * p.Cout;
  if (rows > 0x7fffffffLL || p.rows != rows || p.nout != nout) return false;
  if (p.ctas < 1 || p.ctas > p.rows || p.cluster < 1 ||
      p.cluster > kMaxCluster || p.ctas % p.cluster != 0 || p.stages < 1 ||
      p.stages > kMaxStages || p.slot_pairs < 1 || p.warps < 1 ||
      32 * (p.warps + 1) > kMaxThreads || p.slices < 1 ||
      p.slices > p.ctas / p.cluster)
    return false;
  if (fixed ? p.per != kTaps || p.slot_pairs % p.warps != 0
            : (p.per < 1 || p.per > kMaxPer ||
               32LL * p.warps * p.per < nout))
    return false;
  // a chunk's input rows: one window a pair, KH - 1 more at each image it
  // runs into
  const long long crossings = (p.slot_pairs + p.Ho - 2) / p.Ho;
  const long long xwin = (p.slot_pairs - 1 + p.KH + (p.KH - 1) * crossings) *
                         p.W * p.Cin * es;
  const long long dwin = (long long)p.slot_pairs * p.Wo * p.Cout * es;
  if (p.x_slot != round16(xwin + 16 - es) ||
      p.dy_slot != round16(dwin + 16 - es))
    return false;
  const long long m = (nout + p.cluster - 1) / p.cluster;
  long long region = (long long)p.stages * (p.x_slot + p.dy_slot);
  if (fixed) region = region > 4 * nout * p.warps ? region
                                                  : 4 * nout * p.warps;
  if (4 * nout * p.slices > region) region = 4 * nout * p.slices;
  // the plan may pad the layout (so that fewer CTAs fit an SM)
  const long long total = kHead + round16(4 * p.cluster * m) + region;
  return total <= smem && smem <= kMaxSmem;
}

template <typename T, bool FIXED>
int launch(const void* x, const void* dy, float* ws, unsigned* counter,
           void* dw, const Shape& p, int smem, cudaStream_t stream) {
  auto kernel = wgrad_kernel<T, FIXED>;
  // the largest dynamic shared memory, allowed once per device: the
  // attribute persists, so a launch being captured into a CUDA graph makes
  // no attribute call
  static unsigned long long allowed = 0;   // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(allowed >> dev & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    allowed |= 1ull << dev;
  }
  // consecutive CTAs form a cluster (of one where the plan merges none)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(32 * (p.warps + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const T*>(dy), ws, counter,
                           static_cast<T*>(dw), p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_type(const void* x, const void* dy, float* ws, unsigned* counter,
                 void* dw, const Shape& p, bool fixed, int smem,
                 cudaStream_t stream) {
  return fixed ? launch<T, true>(x, dy, ws, counter, dw, p, smem, stream)
               : launch<T, false>(x, dy, ws, counter, dw, p, smem, stream);
}

}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (x, dy and dw share it). x (B, H, W, Cin),
// dy (B, H-KH+1, W-KW+1, Cout), dw (KH, KW, Cin, Cout), all contiguous;
// ws: ctas / cluster x KH*KW*Cin*Cout float32 of workspace; counter: one
// unsigned int, 0 before the launch and left 0 after it. ctas .. smem: the
// launch plan of kernels/conv2d_wgrad.py:plan. One launch on `stream`.
// Returns a cudaError_t (0 = launched; cudaErrorInvalidValue for a bad
// plan).
extern "C" int conv2d_wgrad_launch(int dtype, const void* x, const void* dy,
                                   void* ws, void* counter, void* dw, int B,
                                   int H, int W, int Cin, int KH, int KW,
                                   int Cout, int ctas, int cluster,
                                   int stages, int slot_pairs, int warps,
                                   int per, int x_slot, int dy_slot,
                                   int slices, int smem, void* stream) {
  const long long nout = (long long)KH * KW * Cin * Cout;
  if (nout < 1 || nout > 0x7fffffffLL || KH > H || KW > W ||
      (long long)B * (H - KH + 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const repro_torch::Shape p{B,          H,     W,          Cin,
                             KH,         KW,    Cout,       H - KH + 1,
                             W - KW + 1, B * (H - KH + 1), (int)nout,
                             ctas,       cluster, stages,   slot_pairs,
                             warps,      per,   x_slot,     dy_slot,
                             slices};
  const bool fixed = KH == 3 && KW == 3 && Cin == 1 && Cout == 32;
  const int es = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) ||
      !repro_torch::plan_ok(p, fixed, es, smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  unsigned* c = static_cast<unsigned*>(counter);
  if (dtype == 0)
    return repro_torch::launch_type<float>(x, dy, w, c, dw, p, fixed, smem,
                                            s);
  return repro_torch::launch_type<__nv_bfloat16>(x, dy, w, c, dw, p, fixed,
                                                  smem, s);
}
