// Online-softmax attention over bf16 operands on Hopper's tensor cores:
// the whole-prompt kernel's tile (flash_attention.cu), and the PTX pieces
// (mbarriers, wgmma and its descriptors, the swizzles) the ragged
// prefill's Hopper tile shares (attention_paged_wgmma.cuh: rows copied
// through the block table, where this tile copies by TMA).  The ragged
// prefill's decode shapes keep the mma.sync tile (attention_mma.cuh) and
// float32 keeps the CUDA-core tile (attention_tile.cuh).
//
// A CTA of two warpgroups serves up to 64 query rows, each row one (query
// position, group head) pair: row r = (query s0 + r / g, head kvh * g +
// r % g), so every K/V tile is read once per head group and query tile.
// It walks one piece of its query tile's key range in tiles of 64 keys:
//
//   * warpgroup 1 is the producer: after giving up its registers
//     (setmaxnreg) one of its threads issues every copy, by TMA, from
//     tensor maps over the strided (B, heads, S, hd) views.  Q arrives
//     once, as a box of (64 dims, g heads, TQ positions) per 64-dim
//     column block, so its rows land in shared memory in row order; K
//     and V tiles of 64 keys go into a ring of stages(hd) slots, each
//     with a K and a V buffer and four mbarriers (K full, V full, K free,
//     V free).  Keys past Sk and queries past Sq are zero-filled by the
//     copy, never read;
//   * warpgroup 0 is the consumer (its registers raised; three CTAs an
//     SM up to head_dim 64, two above): S = Q.K^T is a
//     run of wgmma m64n64k16 with Q and K straight from shared memory
//     (K-major, 128-, 64- or 32-byte swizzled rows, the swizzle the
//     copies wrote), float32 sums in registers; K's slot is freed as soon
//     as S is in registers, so the next K copy overlaps the softmax and
//     P.V;
//   * the masked online softmax runs in registers (row max and sum over
//     the 4 threads of a quad), in base 2 with the scale folded in; a
//     masked p is exactly 0, NEG_INF = -2**30, rows that see no key come
//     out 0, and a tile is masked only where some key in it can be
//     invisible to the warp's 16 rows;
//   * P.V is wgmma m64nHDk16 with P as the register A operand and V read
//     transposed (MN-major) from its slot, as a bf16 hi + lo pair: two
//     products a 16-key step (~16 bits of p; P rounded once to bf16 moves
//     outputs past the 2e-3 limit against the float32 plain version);
//     then V's slot is freed;
//   * at head_dim 128 S(t) is issued before P(t-1).V(t-1), and the
//     softmax of tile t runs under that product (FlashAttention-3's
//     order: P(t) is packed once the product is done, so no register an
//     open product reads is written);
//   * each thread writes its two rows' outputs straight from registers.
//
// Key-range split.  The host planner (kernels/attention_split.py) cuts
// each query tile's key tiles [tlo, thi) into pieces of C tiles; the 1-D
// grid is (piece, KV head, batch row), pieces of the last query tile
// (the heaviest causal one) first.  A query tile with one piece writes
// its output; otherwise each piece writes its rows' float32 (m, l, acc)
// to scratch and combine_pieces merges them by log-sum-exp.
//
// Prefix-LM (kPrefix: paligemma's image patches): every query sees the
// first p.prefix keys as well as its causal ones.  Query i's causal bound
// becomes max(i, prefix - 1), through query_pos, so the key ranges, the
// full-tile test and the mask are the causal ones over those positions.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace repro_torch {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kTK = 64;            // keys per tile (and per piece boundary)
constexpr int kRows = 64;          // query rows per CTA: one wgmma M
constexpr int kThreads = 256;      // a consumer and a producer warpgroup
constexpr int kProducerRegs = 24;  // setmaxnreg: the producer's registers
constexpr float kLog2e = 1.4426950408889634f;

// CTAs an SM (the kernel's launch bounds: 65,536 / (256 x this)
// registers a thread at launch) and the consumer's registers once the
// producer's 24 are given to it
__host__ __device__ constexpr int min_blocks(int hd) {
  return hd <= 64 ? 3 : 2;
}
__host__ __device__ constexpr int consumer_regs(int hd) {
  return 2 * (65536 / (kThreads * min_blocks(hd)) / 8 * 8) - kProducerRegs;
}

// Slots of the K/V ring: four below head_dim 128, two at 128, one at 256,
// where K and V each have their own (K(t+1) copies under the softmax and
// P.V of tile t, V(t+1) under S(t+1)): a second slot would leave room for
// one CTA an SM, and a sliding-window layer's equal CTAs need two resident
// (gemma3-4b's S=2048 window 1,024 ran 38 % slower so, PERF.md)
__host__ __device__ constexpr int stages(int hd) {
  return hd >= 256 ? 1 : hd >= 128 ? 2 : 4;
}
// dims of a column block (a swizzle atom's width: 128 bytes at most)
__host__ __device__ constexpr int col_dims(int hd) { return hd < 64 ? hd : 64; }
__host__ __device__ constexpr size_t tile_bytes(int hd) {
  return (size_t)kTK * hd * sizeof(bf16);
}
// Q, then the ring's K and V tiles, then 1 + 4 * stages mbarriers; 1 KB
// of slack to align the tiles to the swizzle's 1,024 bytes
__host__ __device__ constexpr size_t smem_bytes(int hd) {
  return (1 + 2 * (size_t)stages(hd)) * tile_bytes(hd) +
         (1 + 4 * (size_t)stages(hd)) * 8 + 1024;
}

// element strides over (batch, head, sequence); head_dim's is 1
struct Strides {
  long long b, h, s;
};

struct Params {
  bf16* out;
  Strides os;
  int B, KV, g, Sq, Sk, TQ, window, causal;
  int n_qtiles;      // ceil(Sq / TQ)
  int C;             // key tiles per piece
  int n_pieces;      // pieces of all query tiles, one (batch, KV head)
  int combine_lo;    // first query tile with several pieces
  float scale_log2;  // softmax scale * log2(e)
  float* part_acc;   // [B*KV][n_pieces][TQ*g][hd] when split
  float2* part_ml;   // [B*KV][n_pieces][TQ*g] (m, l) when split
  int prefix;        // kPrefix: keys [0, prefix) seen by every query
};

// Keys query tile i can see, [lo, hi): the causal and window bounds
// (kPrefix: a causal tile's end at least the prefix).  attention_split.py
// mirrors this.
template <bool kPrefix>
__host__ __device__ __forceinline__ void key_range(const Params& p, int i,
                                                   int& lo, int& hi) {
  const int s0 = i * p.TQ;
  int s_end = s0 + p.TQ < p.Sq ? s0 + p.TQ : p.Sq;
  if (kPrefix && p.prefix > s_end) s_end = p.prefix;
  lo = p.window && s0 - p.window + 1 > 0 ? s0 - p.window + 1 : 0;
  hi = p.causal && s_end < p.Sk ? s_end : p.Sk;
}

template <bool kPrefix>
__host__ __device__ __forceinline__ int pieces_of(const Params& p, int i,
                                                  int& tlo, int& thi) {
  int lo, hi;
  key_range<kPrefix>(p, i, lo, hi);
  tlo = lo / kTK;
  thi = hi > lo ? (hi + kTK - 1) / kTK : tlo;
  const int n = (thi - tlo + p.C - 1) / p.C;
  return n > 1 ? n : 1;
}

// Linear piece index x -> (query tile, piece within it, its piece count),
// walking query tiles from the last.
template <bool kPrefix>
__device__ __forceinline__ void locate(const Params& p, int x, int& qt,
                                       int& j, int& n) {
  int tlo, thi;
  for (qt = p.n_qtiles - 1; qt > 0; --qt) {
    n = pieces_of<kPrefix>(p, qt, tlo, thi);
    if (x < n) break;
    x -= n;
  }
  n = pieces_of<kPrefix>(p, qt, tlo, thi);
  j = x;
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// arrive and expect `bytes` of copies to land before the phase completes
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait for the completion of the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// box (c0, c1, c2, c3) of a 4-D tensor map -> shared memory, reported to
// mbarrier `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving register reads or writes of an
// accumulator across the asynchronous product that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle (1 = 128 B, 2 = 64 B, 3 = 32 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)swz << 62;
}
__host__ __device__ constexpr uint32_t swizzle_mode(int row_bytes) {
  return row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
}

// d (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major);
// scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A (64 x 16, bf16 pairs in registers) * B (16 x N, shared,
// MN-major: read transposed)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma N");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
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
// what rounding to `rounded` left of (lo, hi), as bf16x2
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

// ------------------------------------------------------------ the tile

// Max (kMax) or sum of the thread's values of its row i (elements 4n + 2i
// and 4n + 2i + 1 of each 8-key block n of a 64-key score tile), as a
// tree: 7 dependent steps instead of 16.
template <bool kMax>
__device__ __forceinline__ float row_reduce(const float (&s)[32], int i) {
  float t[8];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    t[n] = kMax ? fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1])
                : s[4 * n + 2 * i] + s[4 * n + 2 * i + 1];
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n)
      t[n] = kMax ? fmaxf(t[n], t[n + w]) : t[n] + t[n + w];
  return t[0];
}

// Attend one piece of one query tile: blockIdx.x = (piece, KV head, batch
// row), piece slowest.  tmq, tmk, tmv: the tensor maps of q (hd, H, Sq,
// B) with box (col_dims, g, TQ, 1) and of k and v (hd, Sk, KV, B) with
// box (col_dims, 64, 1, 1).
template <int HD, bool kCausal, bool kPrefix>
__device__ __forceinline__ void attend_piece(const CUtensorMap* tmq,
                                             const CUtensorMap* tmk,
                                             const CUtensorMap* tmv,
                                             const Params& p) {
  static_assert(!kPrefix || kCausal, "a prefix-LM prefix is causal");
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128 || HD == 256,
                "head_dim");
  constexpr int kS = stages(HD);
  constexpr int kCol = col_dims(HD);
  constexpr uint32_t kRowB = kCol * sizeof(bf16);  // a swizzled row
  constexpr uint32_t kBlockB = kTK * kRowB;        // a column block
  constexpr uint32_t kTileB = (uint32_t)tile_bytes(HD);
  constexpr uint32_t kSwz = swizzle_mode(kRowB);
  constexpr uint32_t kGroupB = 8 * kRowB;          // 8 rows: a swizzle atom
  constexpr int ND = HD / 8;                       // 8-dim output blocks
  // the softmax of tile t under P(t-1).V(t-1) at head_dim 128 (on an
  // H100 it beat the plain order there; at 256 the accumulator, S and P
  // pass the consumer's registers and spill, and below, three CTAs an SM
  // without it beat two with it: PERF.md)
  constexpr bool kOverlap = HD == 128;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // Q, then K and V of each slot, then the mbarriers
  const uint32_t sQ = (smem_addr(wg_smem) + 1023) & ~1023u;
  auto sK = [&](int st) { return sQ + (1 + 2 * st) * kTileB; };
  auto sV = [&](int st) { return sQ + (2 + 2 * st) * kTileB; };
  const uint32_t bars = sQ + (1 + 2 * kS) * kTileB;
  const uint32_t fullQ = bars;
  auto fullK = [&](int st) { return bars + 8 * (1 + st); };
  auto fullV = [&](int st) { return bars + 8 * (1 + kS + st); };
  auto freeK = [&](int st) { return bars + 8 * (1 + 2 * kS + st); };
  auto freeV = [&](int st) { return bars + 8 * (1 + 3 * kS + st); };

  const int bkv = p.B * p.KV;
  const int x = blockIdx.x / bkv;
  const int b = (blockIdx.x % bkv) / p.KV, kvh = blockIdx.x % p.KV;
  const int g = p.g;
  int qt, piece, npieces;
  locate<kPrefix>(p, x, qt, piece, npieces);
  const int s0 = qt * p.TQ, s_end = min(s0 + p.TQ, p.Sq);
  const int R = p.TQ * g;
  int klo, khi, tlo, thi;
  key_range<kPrefix>(p, qt, klo, khi);
  pieces_of<kPrefix>(p, qt, tlo, thi);
  const int ta = tlo + piece * p.C, tb = min(ta + p.C, thi);
  const int key_lo = max(klo, ta * kTK), key_hi = min(khi, tb * kTK);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(fullQ, 1);
#pragma unroll
    for (int st = 0; st < kS; ++st) {
      mbar_init(fullK(st), 1);
      mbar_init(fullV(st), 1);
      mbar_init(freeK(st), kRows * 2);   // every consumer thread
      mbar_init(freeV(st), kRows * 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 128) {
      mbar_expect(fullQ, (uint32_t)(R * HD * sizeof(bf16)));
#pragma unroll
      for (int cb = 0; cb < HD / kCol; ++cb)
        tma_load_4d(sQ + cb * kBlockB, tmq, cb * kCol, kvh * g, s0, b, fullQ);
      int st = 0;
      uint32_t par = 0;
      for (int t = ta; t < tb; ++t) {
        // a slot's first use passes at once (the parity before phase 0)
        mbar_wait(freeK(st), par ^ 1);
        mbar_expect(fullK(st), kTileB);
#pragma unroll
        for (int cb = 0; cb < HD / kCol; ++cb)
          tma_load_4d(sK(st) + cb * kBlockB, tmk, cb * kCol, t * kTK, kvh, b,
                      fullK(st));
        mbar_wait(freeV(st), par ^ 1);
        mbar_expect(fullV(st), kTileB);
#pragma unroll
        for (int cb = 0; cb < HD / kCol; ++cb)
          tma_load_4d(sV(st) + cb * kBlockB, tmv, cb * kCol, t * kTK, kvh, b,
                      fullV(st));
        if (++st == kS) {
          st = 0;
          par ^= 1;
        }
      }
    }
    return;
  }
  constexpr int kConsumerRegs = consumer_regs(HD);
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // the consumer warpgroup: warp w owns rows [16 w, 16 w + 16)
  const int warp = tid / 32, lane = tid % 32;
  const int rbase = warp * 16;
  // kPrefix: a query before the prefix's end sees keys [0, prefix)
  auto query_pos = [&](int s) -> int {
    return kPrefix ? max(s, p.prefix - 1) : s;
  };
  // row r = (query s0 + r / g, head kvh * g + r % g); real rows: r < R and
  // the query < s_end
  auto row_query = [&](int r) -> int {
    const int s = s0 + r / g;
    return r < R && s < s_end ? s : -1;
  };
  // the thread's two rows' query positions, the warp's rows' range
  int qp[2];
#pragma unroll
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

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  // K-major descriptors of Q and of a K slot; k-step kk reads dims [16 kk,
  // 16 kk + 16): column block 16 kk / kCol, 32 bytes a step within it
  const uint64_t dq = make_desc(sQ, 16, kGroupB, kSwz);
  auto dim_off = [](int kk) -> uint32_t {
    return ((kk * 16 / kCol) * kBlockB + (kk * 16 % kCol) * sizeof(bf16)) >> 4;
  };

  // issue S = Q K^T over slot st's 64 keys into s (not committed)
  auto issue_qk = [&](float (&s)[32], int st) {
    const uint64_t dk = make_desc(sK(st), 16, kGroupB, kSwz);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(s, dq + dim_off(kk), dk + dim_off(kk), kk > 0);
  };
  // issue acc += P V from slot st (not committed): V read MN-major, 16 keys
  // a step, P as a hi + lo pair; leading offset the next 64-dim column
  // block, stride offset the next 8 keys
  auto issue_pv = [&](const uint32_t (&ph)[4][4], const uint32_t (&pl)[4][4],
                      int st) {
    const uint64_t dv = make_desc(sV(st), kBlockB, kGroupB, kSwz);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = dv + ((kk * 16 * kRowB) >> 4);
      if constexpr (HD <= 128) {
        wgmma_rs<HD>(acc, ph[kk], d, 1);
        wgmma_rs<HD>(acc, pl[kk], d, 1);
      } else {
        // two products of 128 dims each
        const uint64_t d2 = d + ((2 * kBlockB) >> 4);
        wgmma_rs<128>(acc, ph[kk], d, 1);
        wgmma_rs<128>(acc + 64, ph[kk], d2, 1);
        wgmma_rs<128>(acc, pl[kk], d, 1);
        wgmma_rs<128>(acc + 64, pl[kk], d2, 1);
      }
    }
  };
  // Fold the scores s of the tile at key k0 into the running max and sum:
  // mask, s = p = 2**(s * scale_log2 - m) in place, alpha = the old rows'
  // rescale.
  auto softmax = [&](float (&s)[32], int k0, float (&alpha)[2]) {
    // is every key of the tile visible to every real row of the warp?
    const bool full = k0 >= key_lo && k0 + kTK <= key_hi &&
                      (!kCausal || k0 + kTK - 1 <= wlo) &&
                      (p.window == 0 || whi - k0 < p.window);
    // row i of the thread: elements 4n + 2i and 4n + 2i + 1 of 8-key
    // block n
    if (!full) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int key = k0 + (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
        const bool ok = key >= key_lo && key < key_hi &&
                        visible<kCausal>(key, qp[(j / 2) % 2], p.window);
        s[j] = ok ? s[j] : kNegInf;
      }
    }
    float mx[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[i] = row_reduce<true>(s, i);
    // the scale is positive, so the raw row max scales to the scaled one;
    // p = 2**(s * scale_log2 - m) is one FFMA and one ex2
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
    for (int j = 0; j < 32; ++j) {
      const float v = s[j];
      s[j] = v == kNegInf ? 0.f
                          : fast_exp2(fmaf(v, p.scale_log2, -m_run[(j / 2) % 2]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l_run[i] = l_run[i] * alpha[i] + row_reduce<false>(s, i);
  };
  // P's accumulator fragments of keys [16 kk, 16 kk + 16) are the A
  // fragment of k-step kk: p rounded to bf16 (ph) and what that left (pl)
  auto pack = [&](const float (&s)[32], uint32_t (&ph)[4][4],
                  uint32_t (&pl)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = s[8 * kk + 2 * e], c = s[8 * kk + 2 * e + 1];
        ph[kk][e] = pack_bf16(a, c);
        pl[kk][e] = pack_bf16_rest(a, c, ph[kk][e]);
      }
    }
  };
  // rescale only where some row's max moved
  auto rescale = [&](const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[4 * n] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }
    }
  };

  mbar_wait(fullQ, 0);
  float s[32];
  uint32_t ph[4][4], pl[4][4];
  float alpha[2];
  if constexpr (kOverlap) {
    // S(t) is issued before P(t-1).V(t-1), and the softmax of tile t runs
    // in S's registers while that product does; P(t) is packed once it is
    // done (FlashAttention-3's order: no register an open product reads
    // is written)
    if (ta < tb) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      mbar_wait(fullK(0), 0);
      fence_regs(s);
      wgmma_fence();
      issue_qk(s, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(freeK(0));
      softmax(s, ta * kTK, alpha);
      pack(s, ph, pl);
    }
    int st = 0;             // tile t - 1's slot
    uint32_t par = 0;
    for (int t = ta + 1; t < tb; ++t) {
      const int sn = st + 1 == kS ? 0 : st + 1;
      const uint32_t pn = sn == 0 ? par ^ 1 : par;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      // two batches of products, each opened by its own fence
      mbar_wait(fullK(sn), pn);
      fence_regs(s);
      wgmma_fence();
      issue_qk(s, sn);
      wgmma_commit();
      mbar_wait(fullV(st), par);
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
      issue_pv(ph, pl, st);
      wgmma_commit();
      wgmma_wait<1>();      // S(t) is in, P(t-1).V(t-1) may still run
      fence_regs(s);
      mbar_arrive(freeK(sn));
      softmax(s, t * kTK, alpha);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      mbar_arrive(freeV(st));
      rescale(alpha);
      pack(s, ph, pl);
      st = sn;
      par = pn;
    }
    if (ta < tb) {
      mbar_wait(fullV(st), par);
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
      issue_pv(ph, pl, st);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      mbar_arrive(freeV(st));
    }
  } else {
    int st = 0;
    uint32_t par = 0;
    for (int t = ta; t < tb; ++t) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      mbar_wait(fullK(st), par);
      fence_regs(s);
      wgmma_fence();
      issue_qk(s, st);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(freeK(st));   // the next K copy overlaps what follows
      softmax(s, t * kTK, alpha);
      rescale(alpha);
      pack(s, ph, pl);
      mbar_wait(fullV(st), par);
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
      issue_pv(ph, pl, st);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      mbar_arrive(freeV(st));
      if (++st == kS) {
        st = 0;
        par ^= 1;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  // a piece of a split query tile writes (m, l, acc) partials; each thread
  // writes its two rows from registers
  const long long part = ((long long)(blockIdx.x % bkv) * p.n_pieces + x) * R;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rbase + lane / 4 + 8 * i;
    const int s = row_query(r);
    if (s < 0) continue;
    const int d = (lane % 4) * 2;
    if (npieces == 1) {
      const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
      bf16* const o =
          p.out + b * p.os.b + (kvh * g + r % g) * p.os.h + s * p.os.s + d;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + n * 8) = __floats2bfloat162_rn(
            acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    } else {
      float* const a = p.part_acc + (part + r) * HD + d;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(a + n * 8) =
            make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
      if (lane % 4 == 0) p.part_ml[part + r] = make_float2(m_run[i], l_run[i]);
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
template <bool kPrefix>
inline void split_tiles(const Params& p, int& lo, int& hi) {
  lo = hi = 0;
  for (int i = 0, tlo, thi; i < p.n_qtiles; ++i)
    if (pieces_of<kPrefix>(p, i, tlo, thi) > 1) {
      if (lo == hi) lo = i;
      hi = i + 1;
    }
}

template <int HD, bool kPrefix>
__device__ __forceinline__ void combine_pieces(const Params& p) {
  constexpr int kBlocks = combine_blocks(HD);
  const int qt = p.combine_lo + blockIdx.x / kBlocks, bk = blockIdx.y;
  const int b = bk / p.KV, kvh = bk % p.KV, g = p.g;
  int tlo, thi, first = 0;
  const int n = pieces_of<kPrefix>(p, qt, tlo, thi);
  if (n == 1) return;
  for (int i = p.n_qtiles - 1; i > qt; --i)
    first += pieces_of<kPrefix>(p, i, tlo, thi);
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

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled, looked up at run time with
// cudaGetDriverEntryPoint, so the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A tensor map over a (B, heads, S, hd) bf16 view with element strides st
// (head_dim contiguous), as dims (hd, d1, d2, B) whose strides are
// st.h / st.s (in the order `heads_first` says): box (col_dims(hd), box1,
// box2, 1), swizzled as the tile reads it; elements outside are
// zero-filled.  Returns a cudaError_t.
inline int encode_map(CUtensorMap* map, const void* base, int hd, int heads,
                      int seq, int batch, Strides st, bool heads_first,
                      int box1, int box2) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const long long d1 = heads_first ? heads : seq, d2 = heads_first ? seq : heads;
  const long long s1 = heads_first ? st.h : st.s, s2 = heads_first ? st.s : st.h;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)d1, (cuuint64_t)d2,
                              (cuuint64_t)batch};
  // a dim of size 1 is never stepped: any legal stride will do
  const long long row = (long long)hd * sizeof(bf16);
  const cuuint64_t strides[3] = {
      (cuuint64_t)(d1 > 1 ? s1 * (long long)sizeof(bf16) : row),
      (cuuint64_t)(d2 > 1 ? s2 * (long long)sizeof(bf16) : row),
      (cuuint64_t)(batch > 1 ? st.b * (long long)sizeof(bf16) : row)};
  const cuuint32_t box[4] = {(cuuint32_t)col_dims(hd), (cuuint32_t)box1,
                             (cuuint32_t)box2, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const int row_b = col_dims(hd) * (int)sizeof(bf16);
  const CUtensorMapSwizzle swz =
      row_b == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : row_b == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
         dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace repro_torch
