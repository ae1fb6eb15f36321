// Online-softmax attention over bf16 operands on the tensor cores, shared
// by the whole-prompt (flash_attention.cu) and ragged-prefill
// (paged_prefill.cu) kernels.  float32 operands keep the CUDA-core tile of
// attention_tile.cuh.
//
// A CTA of 4 warps serves up to 64 query rows, each row one (query
// position, group head) pair: row r = (query s0 + r / g, head kvh * g +
// r % g), so every K/V tile is read once per head group and query tile.
// It walks one piece of its query tile's key range in tiles of 64 keys,
// the FlashAttention-2 way:
//
//   * Q is staged once through shared memory into mma.sync.m16n8k16 A
//     fragments (ldmatrix) and stays in registers; at head_dim 256
//     (kQSmem) it stays in shared memory instead, each fragment read by
//     ldmatrix where Q.K^T needs it: a thread's 128 float32 accumulator
//     registers plus 64 of Q would pass the 255 a thread can have, as in
//     FlashAttention-2's head_dim-256 tile (Q re-read from shared memory
//     costs 32 KB a key tile against K's and V's 128 KB each);
//   * K and V tiles stay bf16 in shared memory, rows padded by 16 bytes
//     so that the 8 rows one ldmatrix phase reads fall in distinct banks;
//     one buffer each, as in FlashAttention-2: V(t) is copied with
//     cp.async (16 bytes a thread) while Q.K(t)^T and the softmax run,
//     K(t+1) while P.V(t) runs;
//   * S = Q.K^T is summed in float32 registers; the masked online
//     softmax runs in registers (row max and sum over the 4 threads of a
//     quad), in base 2 with the scale folded in; a masked p is exactly 0;
//   * P is rounded to bf16 in registers and is the A operand of P.V
//     (kSplitP: as a bf16 hi + lo pair, two products, ~16 bits of p);
//     the float32 accumulator stays in registers;
//   * a tile is masked only where some key in it can be invisible to the
//     warp's rows; fully visible tiles skip the mask;
//   * each thread writes its rows' outputs straight from registers.
//
// Two shapes of work inside the CTA.  With more than 16 rows each warp
// owns 16 of them and the whole 64-key tile.  With 16 rows or fewer
// (kWarpKeys: one query lane of a decode step) every warp holds the same
// 16 rows and takes its own 16 keys of each tile, so no warp idles; the
// four partial softmax states merge through shared memory at the end.
//
// Key-range split.  The host planner (kernels/attention_split.py) cuts
// each query tile's key tiles [tlo, thi) into pieces of C tiles; the 1-D
// grid is (piece, KV head, batch row), pieces of the last query tile
// (the heaviest causal one) first.  A query tile with one piece writes
// its output; otherwise each piece writes its rows' float32 (m, l, acc)
// to scratch and combine_pieces merges them by log-sum-exp.  Rows that
// see no key come out 0.
//
// int8 prefix (kQuant, the int8 KV cache's ragged prefill): keys [0, Lp)
// are int8 rows with a float32 scale each, keys [Lp, Sk) the chunk's own
// bf16 rows, and the tile loader picks a key's source by its index (a
// tile may straddle Lp, a multiple of the block size and not of 64).  A
// tile's int8 rows are copied 16 elements a cp.async into a staging
// buffer of their own, beside their scales; once they are in, the CTA
// converts them to bf16 in the K or V tile (int8 times its scale in
// float32, rounded to bf16: the reference's dequantization) and the tile
// goes through the same ldmatrix / mma.sync path as a bf16 one, two more
// barriers a tile.  So a launch equals, bit for bit, the bf16 launch over
// the concatenated dequantized keys.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace repro_torch {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kTK = 64;        // keys per tile (and per piece boundary)
constexpr int kRows = 64;      // query rows per CTA
constexpr int kThreads = 128;  // 4 warps
constexpr int kPad = 8;        // bf16 padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

// element strides over (batch, head, sequence); head_dim's is 1
struct Strides {
  long long b, h, s;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  Strides qs, ks, vs, os;
  const int* kpos;   // (B, Sk) key positions, paged only (kQuant: the
                     // chunk's, (B, Sk - Lp))
  const int* qpos;   // (B, Sq) query positions, paged only
  // kQuant only: the int8 prefix, keys [0, Lp): k8 / v8 (B, Lp, KV, hd),
  // their float32 scales (B, Lp, KV), positions kpos8 (B, Lp)
  const int8_t* k8;
  const int8_t* v8;
  const float* k8_scale;
  const float* v8_scale;
  const int* kpos8;
  int Lp;
  int B, KV, g, Sq, Sk, TQ, window, causal;
  int n_qtiles;      // ceil(Sq / TQ)
  int C;             // key tiles per piece
  int n_pieces;      // pieces of all query tiles, one (batch, KV head)
  int combine_lo;    // first query tile with several pieces
  float scale_log2;  // softmax scale * log2(e)
  float* part_acc;   // [B*KV][n_pieces][TQ*g][hd] when split
  float2* part_ml;   // [B*KV][n_pieces][TQ*g] (m, l) when split
};

// Keys query tile i can see, [lo, hi): flash's causal and window bounds,
// or every lane for the paged kernel.  attention_split.py mirrors this.
template <bool kPaged>
__host__ __device__ __forceinline__ void key_range(const Params& p, int i,
                                                   int& lo, int& hi) {
  if (kPaged) {
    lo = 0;
    hi = p.Sk;
    return;
  }
  const int s0 = i * p.TQ, s_end = s0 + p.TQ < p.Sq ? s0 + p.TQ : p.Sq;
  lo = p.window && s0 - p.window + 1 > 0 ? s0 - p.window + 1 : 0;
  hi = p.causal && s_end < p.Sk ? s_end : p.Sk;
}

template <bool kPaged>
__host__ __device__ __forceinline__ int pieces_of(const Params& p, int i,
                                                  int& tlo, int& thi) {
  int lo, hi;
  key_range<kPaged>(p, i, lo, hi);
  tlo = lo / kTK;
  thi = hi > lo ? (hi + kTK - 1) / kTK : tlo;
  const int n = (thi - tlo + p.C - 1) / p.C;
  return n > 1 ? n : 1;
}

// Linear piece index x -> (query tile, piece within it, its piece count),
// walking query tiles from the last.
template <bool kPaged>
__device__ __forceinline__ void locate(const Params& p, int x, int& qt,
                                       int& j, int& n) {
  int tlo, thi;
  for (qt = p.n_qtiles - 1; qt > 0; --qt) {
    n = pieces_of<kPaged>(p, qt, tlo, thi);
    if (x < n) break;
    x -= n;
  }
  n = pieces_of<kPaged>(p, qt, tlo, thi);
  j = x;
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes (4 for ints) global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2**x on the special-function unit (relative error ~2**-22)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi,
                                                   uint32_t rounded) {
  __nv_bfloat162 r = *reinterpret_cast<__nv_bfloat162*>(&rounded);
  return pack_bf16(lo - __low2float(r), hi - __high2float(r));
}

// Allow a kernel its dynamic shared memory, once per device: the attribute
// persists, and setting it on every launch costs host time.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes,
                              unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

// head dims past 128 keep Q in shared memory (see the header)
__host__ __device__ constexpr bool q_in_smem(int hd) { return hd > 128; }

__host__ __device__ constexpr size_t smem_bytes(int hd, bool quant = false) {
  // a K and a V tile (and at q_in_smem a Q tile of kRows = kTK rows),
  // then K's key positions and the rows' lanes and heads; kQuant: the
  // int8 staging of a K and a V tile and their scales
  return (size_t)(q_in_smem(hd) ? 3 : 2) * kTK * (hd + kPad) * sizeof(bf16) +
         (kTK + 2 * kRows) * sizeof(int) +
         (quant ? (size_t)2 * kTK * (hd + sizeof(float)) : 0);
}

// ------------------------------------------------------------ the tile

// Max (kMax) or sum of the thread's values of its row i (elements 2i and
// 2i + 1 of each 8-key block), as a tree: 2 log2(NB) + 1 dependent steps
// instead of 2 NB.
template <int NB, bool kMax>
__device__ __forceinline__ float row_reduce(const float (&s)[NB][4], int i) {
  float t[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n)
    t[n] = kMax ? fmaxf(s[n][2 * i], s[n][2 * i + 1])
                : s[n][2 * i] + s[n][2 * i + 1];
#pragma unroll
  for (int w = NB / 2; w >= 1; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n)
      t[n] = kMax ? fmaxf(t[n], t[n + w]) : t[n] + t[n + w];
  return t[0];
}

// Attend one piece of one query tile: blockIdx.x = (piece, KV head,
// batch row), piece slowest.  kPaged: key and query positions come from
// p.kpos / p.qpos and tiles no query of the CTA can see are skipped;
// otherwise they are the key and query indices.
template <int HD, bool kPaged, bool kCausal, bool kSplitP, bool kWarpKeys,
          bool kQuant = false>
__device__ __forceinline__ void attend_piece(const Params& p) {
  static_assert(!kQuant || kPaged, "an int8 prefix is the paged kernel's");
  static_assert(HD % 16 == 0 && HD <= 256, "head_dim: a multiple of 16");
  static_assert(kRows == kTK, "a Q tile is laid out as a K tile");
  constexpr bool kQSmem = q_in_smem(HD);
  constexpr int kPitch = HD + kPad;      // bf16 per shared-memory row
  constexpr int kChunks = HD / 8;        // 16-byte chunks per row
  constexpr int NB = kWarpKeys ? 2 : 8;  // 8-key score blocks per warp
  constexpr int ND = HD / 8;             // 8-dim output blocks
  extern __shared__ __align__(16) unsigned char mma_smem[];
  // one K tile, one V tile (Q is staged where V goes, or at kQSmem in a
  // tile of its own after it), K's positions
  bf16* const sK = reinterpret_cast<bf16*>(mma_smem);
  bf16* const sV = sK + kTK * kPitch;
  bf16* const sQ = kQSmem ? sV + kTK * kPitch : sV;
  int* const sPos = reinterpret_cast<int*>(sV + (kQSmem ? 2 : 1) * kTK *
                                                     kPitch);
  int* const sRowS = sPos + kTK;     // row r -> its query lane, or -1
  int* const sRowH = sRowS + kRows;  // row r -> its query head
  // kQuant: int8 staging of a K and a V tile, then their scales
  int8_t* const sK8 = reinterpret_cast<int8_t*>(sRowH + kRows);
  int8_t* const sV8 = sK8 + kTK * HD;
  float* const sKs = reinterpret_cast<float*>(sV8 + kTK * HD);
  float* const sVs = sKs + kTK;

  const int bkv = p.B * p.KV;
  const int x = blockIdx.x / bkv;
  const int b = (blockIdx.x % bkv) / p.KV, kvh = blockIdx.x % p.KV;
  const int g = p.g;
  int qt, piece, npieces;
  locate<kPaged>(p, x, qt, piece, npieces);
  const int s0 = qt * p.TQ, s_end = min(s0 + p.TQ, p.Sq);
  const int R = p.TQ * g;
  int klo, khi, tlo, thi;
  key_range<kPaged>(p, qt, klo, khi);
  pieces_of<kPaged>(p, qt, tlo, thi);
  const int ta = tlo + piece * p.C, tb = min(ta + p.C, thi);
  const int key_lo = max(klo, ta * kTK), key_hi = min(khi, tb * kTK);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rbase = kWarpKeys ? 0 : warp * 16;  // the warp's first row
  const int kw = kWarpKeys ? warp * 16 : 0;     // the warp's first key

  auto query_pos = [&](int s) -> int {
    return kPaged ? __ldg(p.qpos + (size_t)b * p.Sq + s) : s;
  };
  // where key `key`'s position lives: the int8 prefix's or the chunk's
  const int lp = kQuant ? p.Lp : 0;
  auto key_pos_ptr = [&](int key) -> const int* {
    if (kQuant && key < lp) return p.kpos8 + (size_t)b * lp + key;
    return p.kpos + (size_t)b * (p.Sk - lp) + (key - lp);
  };
  // row r = (query lane s0 + r / g, head kvh * g + r % g); real rows: r < R
  // and the lane < s_end.  One division per row, into a table.
  if (tid < kRows) {
    const int s = s0 + tid / g;
    sRowS[tid] = (tid < R && s < s_end) ? s : -1;
    sRowH[tid] = kvh * g + tid % g;
  }
  __syncthreads();
  auto row_query = [&](int r) -> int { return sRowS[r]; };

  // stage Q (zeros past the real rows) first: its copy overlaps the
  // position reads below
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const int s = row_query(r);
    const bf16* src = p.q;
    if (s >= 0) src += b * p.qs.b + sRowH[r] * p.qs.h + s * p.qs.s + ch * 8;
    cp_async16(sQ + r * kPitch + ch * 8, src, s >= 0);
  }

  // query positions: the thread's two rows, the warp's rows' range, the
  // CTA's range (paged tile skipping)
  int qp[2];
  for (int i = 0; i < 2; ++i) {
    const int s = row_query(rbase + lane / 4 + 8 * i);
    qp[i] = s >= 0 ? query_pos(s) : -1;
  }
  int wlo, whi;
  {
    const int s = lane < 16 ? row_query(rbase + lane) : -1;
    const int pos = s >= 0 ? query_pos(s) : 0;
    wlo = __reduce_min_sync(0xffffffffu, s >= 0 ? pos : 0x7fffffff);
    whi = __reduce_max_sync(0xffffffffu, s >= 0 ? pos : -1);
  }
  int clo = 0x7fffffff, chi = -1;
  if (kPaged) {
    for (int s = s0 + lane; s < s0 + 64; s += 32) {
      const bool ok = s < s_end;
      const int pos = ok ? query_pos(s) : 0;
      clo = min(clo, ok ? pos : 0x7fffffff);
      chi = max(chi, ok ? pos : -1);
    }
    clo = __reduce_min_sync(0xffffffffu, clo);
    chi = __reduce_max_sync(0xffffffffu, chi);
  }

  // paged: bit i of vis = tile mask_base + i has a key some query of the
  // CTA can see (a superset test); every warp computes the same mask
  unsigned vis = 0;
  int mask_base = ta - 32;
  auto next_tile = [&](int t) -> int {
    if (!kPaged) return t;
    while (t < tb) {
      if (t >= mask_base + 32) {
        // the next 32 tiles' kpos lanes: coalesced, independent loads,
        // lane l takes keys l, l + 32, ...; key t*64 + 32i + l is in tile
        // t + i/2
        mask_base = t;
        const int k0 = t * kTK;
        const int k_begin = max(key_lo, k0);
        const int k_end = min(key_hi, min(tb, t + 32) * kTK);
        unsigned bits = 0;
#pragma unroll 16
        for (int i = 0; i < 2 * 32; ++i) {
          const int key = k0 + 32 * i + lane;
          if (key >= k_begin && key < k_end) {
            const int pos = __ldg(key_pos_ptr(key));
            if (pos >= 0 && pos <= chi &&
                (p.window == 0 || clo - pos < p.window))
              bits |= 1u << (i / 2);
          }
        }
        vis = __reduce_or_sync(0xffffffffu, bits);
      }
      const unsigned m = vis >> (t - mask_base);
      if (m) return t + __ffs(m) - 1;
      t = mask_base + 32;
    }
    return tb;
  };

  // the thread's 16-byte chunk of K or V rows kr0, kr0 + kStep, ...
  constexpr int kStep = kThreads / kChunks;
  const int kr0 = tid / kChunks, kch = tid % kChunks;
  const bf16* const kbase = p.k + b * p.ks.b + kvh * p.ks.h + kch * 8;
  const bf16* const vbase = p.v + b * p.vs.b + kvh * p.vs.h + kch * 8;
  // the thread's rows of tile t, from base (rows `stride` apart) to dst;
  // kQuant: the chunk's rows only (row key - Lp of base), the prefix's
  // int8 rows go through load_rows8
  auto load_rows = [&](bf16* dst, const bf16* base, long long stride,
                       int t) {
    const int k0 = t * kTK;
#pragma unroll
    for (int i = 0; i < kTK / kStep; ++i) {
      const int r = kr0 + i * kStep, key = k0 + r;
      if (kQuant && key < lp) continue;
      const bool ok = key >= key_lo && key < key_hi;
      cp_async16(dst + r * kPitch + kch * 8,
                 ok ? base + (key - lp) * stride : base, ok);
    }
  };
  // kQuant: tile t's int8 prefix rows, 16 elements a copy, into the
  // staging dst8, and their scales into dscale
  constexpr int kChunks8 = HD / 16;
  auto load_rows8 = [&](int8_t* dst8, float* dscale, const int8_t* src8,
                        const float* scale, int t) {
    const int k0 = t * kTK;
    const int8_t* const base8 = src8 + ((size_t)b * lp * p.KV + kvh) * HD;
    for (int c = tid; c < kTK * kChunks8; c += kThreads) {
      const int r = c / kChunks8, key = k0 + r;
      if (key >= lp) continue;
      const bool ok = key >= key_lo && key < key_hi;
      cp_async16(dst8 + r * HD + (c % kChunks8) * 16,
                 ok ? base8 + (size_t)key * p.KV * HD + (c % kChunks8) * 16
                    : base8,
                 ok);
    }
    if (tid < kTK && k0 + tid < lp) {
      const int key = k0 + tid;
      const bool ok = key >= key_lo && key < key_hi;
      const float* const sb = scale + (size_t)b * lp * p.KV + kvh;
      cp_async4(dscale + tid, ok ? sb + (size_t)key * p.KV : sb, ok);
    }
  };
  // kQuant, once tile t's staged rows are in: dst's prefix rows = int8 x
  // scale in float32, rounded to bf16 (16 elements a thread a pass)
  auto convert8 = [&](bf16* dst, const int8_t* src8, const float* scale,
                      int t) {
    const int k0 = t * kTK;
    for (int c = tid; c < kTK * kChunks8; c += kThreads) {
      const int r = c / kChunks8, ch = c % kChunks8;
      if (k0 + r >= lp) continue;
      const float sc = scale[r];
      const uint4 raw = *reinterpret_cast<const uint4*>(src8 + r * HD +
                                                        ch * 16);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t x = w[i / 2] >> (16 * (i % 2));
        const int8_t lo = static_cast<int8_t>(static_cast<uint8_t>(x));
        const int8_t hi = static_cast<int8_t>(static_cast<uint8_t>(x >> 8));
        o[i] = pack_bf16(static_cast<float>(lo) * sc,
                         static_cast<float>(hi) * sc);
      }
      uint4* const out = reinterpret_cast<uint4*>(dst + r * kPitch + ch * 16);
      out[0] = make_uint4(o[0], o[1], o[2], o[3]);
      out[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  };
  auto load_k = [&](int t) {
    load_rows(sK, kbase, p.ks.s, t);
    if constexpr (kQuant) load_rows8(sK8, sKs, p.k8, p.k8_scale, t);
    if (kPaged && tid < kTK) {
      const int key = t * kTK + tid;
      const bool ok = key >= key_lo && key < key_hi;
      cp_async4(sPos + tid, ok ? key_pos_ptr(key) : p.qpos, ok);
    }
  };
  auto load_v = [&](int t) {
    load_rows(sV, vbase, p.vs.s, t);
    if constexpr (kQuant) load_rows8(sV8, sVs, p.v8, p.v8_scale, t);
  };

  // the first K tile (it joins Q's copy group)
  int t = next_tile(ta);
  if (t < tb) load_k(t);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // (the barrier after Q's fragments below publishes the converted tile)
  if constexpr (kQuant)
    if (t < tb) convert8(sK, sK8, sKs, t);

  // Q's A fragment of dims [16 kk, 16 kk + 16) for the warp's rows
  auto q_frag = [&](uint32_t (&r)[4], int kk) {
    const int m = lane / 8;
    ldmatrix_x4(r, sQ + (rbase + (m % 2) * 8 + lane % 8) * kPitch +
                       kk * 16 + (m / 2) * 8);
  };
  uint32_t qf[kQSmem ? 1 : HD / 16][4];
  if constexpr (!kQSmem) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) q_frag(qf[kk], kk);
  }
  __syncthreads();  // the V tile is free now

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  // K(t) is in shared memory at the top of each pass; V(t) loads while
  // S = Q K(t) and the softmax run, K(next) while P V(t) runs
  while (t < tb) {
    load_v(t);
    cp_async_commit();
    const int k0 = t * kTK;

    // S = Q K^T over the warp's keys [kw, kw + 8 NB)
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (kQSmem) {
        q_frag(qa, kk);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      }
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        const int m = lane / 8;
        uint32_t kb[4];
        ldmatrix_x4(kb, sK + (kw + np * 16 + (m / 2) * 8 + lane % 8) *
                                 kPitch +
                             kk * 16 + (m % 2) * 8);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // is every key of the warp's slice visible to every real row of it?
    const int ka = k0 + kw, kb_end = ka + 8 * NB;
    bool full = ka >= key_lo && kb_end <= key_hi;
    if (kPaged) {
      int lo = 0x7fffffff, hi = (int)0x80000000;
      for (int c = lane; c < 8 * NB; c += 32) {
        const int pos = sPos[kw + c];
        lo = min(lo, pos);
        hi = max(hi, pos);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      full = full && lo >= 0 && hi <= wlo &&
             (p.window == 0 || whi - lo < p.window);
    } else {
      full = full && (!kCausal || kb_end - 1 <= wlo) &&
             (p.window == 0 || whi - ka < p.window);
    }

    // masked online softmax, base 2; row i of the thread: elements 2i, 2i+1
    if (!full) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = kw + n * 8 + (lane % 4) * 2 + (e & 1);
          const int key = k0 + c;
          const int pos = kPaged ? sPos[c] : key;
          const bool ok = key >= key_lo && key < key_hi &&
                          visible<kCausal>(pos, qp[e / 2], p.window);
          s[n][e] = ok ? s[n][e] : kNegInf;
        }
      }
    }
    float mx[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[i] = row_reduce<NB, true>(s, i);
    // the scale is positive, so the raw row max scales to the scaled one;
    // p = 2**(s * scale_log2 - m) is one FFMA and one ex2
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new =
          fmaxf(m_run[i], mx[i] == kNegInf ? kNegInf : mx[i] * p.scale_log2);
      alpha[i] = fast_exp2(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = s[n][e];
        s[n][e] = v == kNegInf
                      ? 0.f
                      : fast_exp2(fmaf(v, p.scale_log2, -m_run[e / 2]));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l_run[i] = l_run[i] * alpha[i] + row_reduce<NB, false>(s, i);
    // rescale only where some row's max moved
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

    const int tn = next_tile(t + 1);
    cp_async_wait<0>();
    __syncthreads();  // V(t) is in; every warp is done with K(t)
    if (tn < tb) load_k(tn);
    cp_async_commit();
    if constexpr (kQuant) {
      convert8(sV, sV8, sVs, t);
      __syncthreads();  // V(t) is whole in bf16
    }

    // acc += P V: P's C fragments of keys 16kk.. are the A fragment
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      uint32_t ph[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      uint32_t pl[4];
      if (kSplitP) {
        pl[0] = pack_bf16_rest(s[2 * kk][0], s[2 * kk][1], ph[0]);
        pl[1] = pack_bf16_rest(s[2 * kk][2], s[2 * kk][3], ph[1]);
        pl[2] = pack_bf16_rest(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2]);
        pl[3] = pack_bf16_rest(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3]);
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        const int m = lane / 8;
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sV + (kw + kk * 16 + (m % 2) * 8 + lane % 8) *
                                       kPitch +
                                   dp * 16 + (m / 2) * 8);
        mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
        if (kSplitP) {
          mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // K(tn) is in; every warp is done with V(t)
    if constexpr (kQuant) {
      if (tn < tb) convert8(sK, sK8, sKs, tn);
      __syncthreads();  // K(tn) is whole in bf16
    }
    t = tn;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  // a piece of a split query tile writes (m, l, acc) partials
  const long long part = ((long long)(blockIdx.x % bkv) * p.n_pieces + x) * R;

  if (!kWarpKeys) {
    // each thread writes its two rows from registers
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rbase + lane / 4 + 8 * i;
      const int s = row_query(r);
      if (s < 0) continue;
      const int d = (lane % 4) * 2;
      if (npieces == 1) {
        const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
        bf16* const o = p.out + b * p.os.b + sRowH[r] * p.os.h +
                        s * p.os.s + d;
#pragma unroll
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<__nv_bfloat162*>(o + n * 8) =
              __floats2bfloat162_rn(acc[n][2 * i] * inv,
                                    acc[n][2 * i + 1] * inv);
      } else {
        float* const a = p.part_acc + (part + r) * HD + d;
#pragma unroll
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<float2*>(a + n * 8) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
        if (lane % 4 == 0)
          p.part_ml[part + r] = make_float2(m_run[i], l_run[i]);
      }
    }
    return;
  }

  // kWarpKeys: the four warps' states of rows 0-15 merge through shared
  // memory; entry w * 16 + r holds warp w's (m, l, acc) of row r
  float* const eacc = reinterpret_cast<float*>(mma_smem);
  float* const em = eacc + kRows * HD;
  float* const el = em + kRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = warp * 16 + lane / 4 + 8 * i;
    if (lane % 4 == 0) {
      em[e] = m_run[i];
      el[e] = l_run[i];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = n * 8 + (lane % 4) * 2;
      *reinterpret_cast<float2*>(eacc + e * HD + d) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < 16 * (HD / 2); idx += kThreads) {
    const int r = idx / (HD / 2), d = (idx % (HD / 2)) * 2;
    const int s = row_query(r);
    if (s < 0) continue;
    float M = em[r];
    for (int w = 1; w < 4; ++w) M = fmaxf(M, em[w * 16 + r]);
    float L = 0.f, a0 = 0.f, a1 = 0.f;
    for (int w = 0; w < 4; ++w) {
      const int e = w * 16 + r;
      const float f = fast_exp2(em[e] - M);
      L += el[e] * f;
      a0 += eacc[e * HD + d] * f;
      a1 += eacc[e * HD + d + 1] * f;
    }
    if (npieces == 1) {
      const float inv = 1.f / fmaxf(L, 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(
          p.out + b * p.os.b + sRowH[r] * p.os.h + s * p.os.s + d) =
          __floats2bfloat162_rn(a0 * inv, a1 * inv);
    } else {
      *reinterpret_cast<float2*>(p.part_acc + (part + r) * HD + d) =
          make_float2(a0, a1);
      if (d == 0) p.part_ml[part + r] = make_float2(M, L);
    }
  }
}

// Merge the pieces of every split query tile: grid (query tile from
// combine_lo x combine_blocks, batch row x KV head); a thread takes 8 dims
// of one row, so it writes one 16-byte chunk of the output.
constexpr int kCombineThreads = 256;
__host__ __device__ constexpr int combine_blocks(int hd) {
  return (kRows * (hd / 8) + kCombineThreads - 1) / kCombineThreads;
}

// [lo, hi): the query tiles with several pieces (lo = hi: none)
template <bool kPaged>
inline void split_tiles(const Params& p, int& lo, int& hi) {
  lo = hi = 0;
  for (int i = 0, tlo, thi; i < p.n_qtiles; ++i)
    if (pieces_of<kPaged>(p, i, tlo, thi) > 1) {
      if (lo == hi) lo = i;
      hi = i + 1;
    }
}

template <int HD, bool kPaged>
__device__ __forceinline__ void combine_pieces(const Params& p) {
  constexpr int kBlocks = combine_blocks(HD);
  const int qt = p.combine_lo + blockIdx.x / kBlocks, bk = blockIdx.y;
  const int b = bk / p.KV, kvh = bk % p.KV, g = p.g;
  int tlo, thi, first = 0;
  const int n = pieces_of<kPaged>(p, qt, tlo, thi);
  if (n == 1) return;
  for (int i = p.n_qtiles - 1; i > qt; --i)
    first += pieces_of<kPaged>(p, i, tlo, thi);
  const int R = p.TQ * g, s0 = qt * p.TQ;
  const int idx = (blockIdx.x % kBlocks) * kCombineThreads + threadIdx.x;
  const int r = idx / (HD / 8), d = (idx % (HD / 8)) * 8;
  const int s = s0 + r / g;
  if (r >= R || s >= p.Sq) return;
  const long long base = ((long long)bk * p.n_pieces + first) * R + r;
  float M = kNegInf;
  for (int j = 0; j < n; ++j) M = fmaxf(M, p.part_ml[base + j * R].x);
  float L = 0.f, a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < n; ++j) {
    const float2 ml = p.part_ml[base + j * R];
    const float4* const src =
        reinterpret_cast<const float4*>(p.part_acc + (base + j * R) * HD + d);
    const float4 x0 = src[0], x1 = src[1];
    const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float f = fast_exp2(ml.x - M);
    L += ml.y * f;
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] += xs[k] * f;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  uint4 o;
  o.x = pack_bf16(a[0] * inv, a[1] * inv);
  o.y = pack_bf16(a[2] * inv, a[3] * inv);
  o.z = pack_bf16(a[4] * inv, a[5] * inv);
  o.w = pack_bf16(a[6] * inv, a[7] * inv);
  *reinterpret_cast<uint4*>(p.out + b * p.os.b + (kvh * g + r % g) * p.os.h +
                            s * p.os.s + d) = o;
}

}  // namespace mma
}  // namespace repro_torch
