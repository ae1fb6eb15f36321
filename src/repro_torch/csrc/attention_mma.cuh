// Online-softmax attention over bf16 operands on the tensor cores
// (mma.sync): the ragged prefill's tile for launches of 16 query rows or
// fewer (kWarpKeys in paged_prefill.cuh: one query lane of a decode step,
// the fused decode dispatch and the slot decode).  Launches of more rows
// (chunks, verify windows) run the Hopper tile of
// attention_paged_wgmma.cuh, the whole-prompt kernel its own
// (attention_wgmma.cuh); float32 operands keep the CUDA-core tile of
// attention_tile.cuh.  The planner arithmetic (key_range, pieces_of,
// locate) and the combine pass below serve both paged tiles.
//
// A CTA of 4 warps serves up to 16 query rows, each row one (query
// position, group head) pair: row r = (query s0 + r / g, head kvh * g +
// r % g), so every K/V tile is read once per head group and query tile.
// It walks one piece of its query tile's key range in tiles of 64 keys,
// each warp taking its own 16 keys of every tile for the same 16 rows
// (a wgmma M of 64 would waste 48 of its rows here), the four partial
// softmax states merged through shared memory at the end:
//
//   * Q is staged once through shared memory into mma.sync.m16n8k16 A
//     fragments (ldmatrix) and stays in registers; at head_dim 256
//     (kQSmem) it stays in shared memory instead, each fragment read by
//     ldmatrix where Q.K^T needs it;
//   * K and V tiles stay bf16 in shared memory, rows padded by 16 bytes
//     so that the 8 rows one ldmatrix phase reads fall in distinct banks;
//     one buffer each: V(t) is copied with cp.async (16 bytes a thread)
//     while Q.K(t)^T and the softmax run, K(t+1) while P.V(t) runs;
//   * S = Q.K^T is summed in float32 registers; the masked online
//     softmax runs in registers (row max and sum over the 4 threads of a
//     quad), in base 2 with the scale folded in; a masked p is exactly 0;
//   * P is rounded to bf16 in registers and is the A operand of P.V;
//     the float32 accumulator stays in registers;
//   * a warp's keys are masked only where some key in them can be
//     invisible to the rows.
//
// Key-range split.  The host planner (kernels/attention_split.py) cuts
// each query tile's key tiles [tlo, thi) into pieces of C tiles; the 1-D
// grid is (piece, KV head, batch row), pieces of the last query tile
// first.  A query tile with one piece writes its output; otherwise each
// piece writes its rows' float32 (m, l, acc) to scratch and
// combine_pieces merges them by log-sum-exp.  Rows that see no key come
// out 0.
//
// Paged prefix: keys [0, Lp) are rows of the block pool, read through
// the block table (PagedPrefix below), keys [Lp, Sk) the chunk's own
// rows; a tile may straddle blocks and Lp (a multiple of the block size,
// not of 64), and the tiles stay those of the concatenated keys.  Threads
// 0-63 look a tile's 64 pool rows up once, a pass ahead of its loads, into
// shared memory (sPre), so a row's address is one shared load.  Tiles no
// query of the CTA can see are skipped before they are loaded, from a
// ballot over their guarded positions.
//
// int8 prefix (kQuant): a tile's int8 rows and float32 scales are copied
// 16 elements a cp.async into a staging buffer of their own,
// double-buffered, and each prefix row is converted once into the bf16
// tile (int8 times its scale in float32, rounded to bf16; the int8 ->
// float32 step exact through the exponent bits of 2^23, a byte permute
// and a subtraction), V(t)'s while Q.K(t)^T runs and K(t+1)'s while
// P.V(t) runs, so a launch equals, bit for bit, the bf16 launch over the
// concatenated dequantized keys.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"

namespace repro_torch {

// The prefix segment of a ragged prefill, keys [0, Lp): rows of a block
// pool (NB, bs, KV, hd) read through a block table (B, nb), Lp = nb * bs.
// Key j of batch row b is pool row bt[b][j / bs] * bs + j % bs; without a
// table (bt null), row b * Lp + j: a contiguous (B, Lp, KV, hd) prefix.
// Its position is pos[that row], read as -1 unless below the row's cursor
// start[b] (start null: start_all for every row), the guard that hides a
// copy-on-write block's diverged donor tail and the chunk's own lanes a
// later chunk will write.  k / v hold rows in the model dtype, or int8
// rows with float32 scales k_scale / v_scale (NB, bs, KV) in the int8
// launches.
struct PagedPrefix {
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* pos;
  const int* bt;
  const int* start;
  int start_all;
  int nb, bs;
  unsigned bs_mul, bs_shift;  // j / bs = umulhi(j, bs_mul) >> bs_shift
  int Lp;
};

// bs_mul and bs_shift of a block size (CUTLASS's FastDivmod: exact for
// every j below 2^31; bs 1 divides by itself)
inline void set_block_size(PagedPrefix& pre, int bs) {
  pre.bs = bs;
  pre.bs_mul = pre.bs_shift = 0;
  if (bs <= 1) return;
  int l = 0;
  while ((1 << l) < bs) ++l;
  const unsigned p = 31 + l;
  pre.bs_mul = (unsigned)(((1ull << p) + bs - 1) / bs);
  pre.bs_shift = p - 32;
}

// the pool row of prefix key j of batch row b
__device__ __forceinline__ long long prefix_row(const PagedPrefix& pre,
                                                int b, int j) {
  if (pre.bt == nullptr) return (long long)b * pre.Lp + j;
  const int blk =
      pre.bs == 1 ? j : (int)(__umulhi((unsigned)j, pre.bs_mul) >> pre.bs_shift);
  return (long long)__ldg(pre.bt + (long long)b * pre.nb + blk) * pre.bs +
         (j - blk * pre.bs);
}

__device__ __forceinline__ int row_start(const PagedPrefix& pre, int b) {
  return pre.start ? __ldg(pre.start + b) : pre.start_all;
}

// a prefix key's position under its row's cursor guard
__device__ __forceinline__ int guard_pos(int pos, int start) {
  return pos < start ? pos : -1;
}

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
  const int* kpos;   // (B, Sk - pre.Lp) the chunk's key positions
  const int* qpos;   // (B, Sq) query positions
  // the prefix, keys [0, pre.Lp) (bf16 rows, or int8 rows under kQuant);
  // k / v / kpos are the chunk's keys [pre.Lp, Sk)
  PagedPrefix pre;
  int B, KV, g, Sq, Sk, TQ, window;
  int n_qtiles;      // ceil(Sq / TQ)
  int C;             // key tiles per piece
  int n_pieces;      // pieces of all query tiles, one (batch, KV head)
  int combine_lo;    // first query tile with several pieces
  float scale_log2;  // softmax scale * log2(e)
  float* part_acc;   // [B*KV][n_pieces][TQ*g][hd] when split
  float2* part_ml;   // [B*KV][n_pieces][TQ*g] (m, l) when split
};

// Keys query tile i can see, [lo, hi): every lane (which ones a query sees
// depends on the positions, known only in the tile).  attention_split.py
// mirrors this.
__host__ __device__ __forceinline__ void key_range(const Params& p, int i,
                                                   int& lo, int& hi) {
  lo = 0;
  hi = p.Sk;
}

__host__ __device__ __forceinline__ int pieces_of(const Params& p, int i,
                                                  int& tlo, int& thi) {
  int lo, hi;
  key_range(p, i, lo, hi);
  tlo = lo / kTK;
  thi = hi > lo ? (hi + kTK - 1) / kTK : tlo;
  const int n = (thi - tlo + p.C - 1) / p.C;
  return n > 1 ? n : 1;
}

// Linear piece index x -> (query tile, piece within it, its piece count),
// walking query tiles from the last.
__device__ __forceinline__ void locate(const Params& p, int x, int& qt,
                                       int& j, int& n) {
  int tlo, thi;
  for (qt = p.n_qtiles - 1; qt > 0; --qt) {
    n = pieces_of(p, qt, tlo, thi);
    if (x < n) break;
    x -= n;
  }
  n = pieces_of(p, qt, tlo, thi);
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

// bytes lo, lo + 1 of u (int8 already offset by 128: x ^ 0x80 a byte),
// times their scales, -> bf16x2 (byte lo in the low half); int8 ->
// float32 is exact: the byte as the low mantissa bits of 2^23, less 2^23 +
// 128
template <int lo>
__device__ __forceinline__ uint32_t dequant_pair_u(uint32_t u, float s0,
                                                   float s1) {
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + lo));
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651 + lo));
  return pack_bf16((f0 - 8388736.f) * s0, (f1 - 8388736.f) * s1);
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

// kQuant: one int8 staging buffer, a K and a V tile's rows (pitch hd +
// 16 bytes, so a warp's fragment reads fall in distinct banks) and their
// scales
__host__ __device__ constexpr int int8_pitch(int hd) { return hd + 16; }
__host__ __device__ constexpr size_t int8_buffer_bytes(int hd) {
  return (size_t)2 * kTK * int8_pitch(hd) + 2 * kTK * sizeof(float);
}

__host__ __device__ constexpr size_t smem_bytes(int hd, bool quant = false) {
  // a K and a V tile (and at q_in_smem a Q tile of kRows = kTK rows),
  // then K's key positions, the rows' lanes and heads, and two tiles'
  // prefix pool rows and K and V row addresses; kQuant: two int8 staging
  // buffers
  return (size_t)(q_in_smem(hd) ? 3 : 2) * kTK * (hd + kPad) * sizeof(bf16) +
         (3 * kTK + 2 * kRows) * sizeof(int) + 4 * kTK * sizeof(void*) +
         (quant ? 2 * int8_buffer_bytes(hd) : 0);
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
// batch row), piece slowest.  Key and query positions come from p.kpos /
// p.qpos (and the prefix's pool), and tiles no query of the CTA can see
// are skipped.
template <int HD, bool kQuant = false>
__device__ __forceinline__ void attend_piece(const Params& p) {
  static_assert(HD % 16 == 0 && HD <= 256, "head_dim: a multiple of 16");
  static_assert(kRows == kTK, "a Q tile is laid out as a K tile");
  constexpr bool kQSmem = q_in_smem(HD);
  constexpr int kPitch = HD + kPad;      // bf16 per shared-memory row
  constexpr int kChunks = HD / 8;        // 16-byte chunks per row
  constexpr int NB = 2;                  // 8-key score blocks per warp
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
  // paged: [2][kTK], the pool row of each prefix key of a tile, for this
  // pass's tile and the next one's; then [2][kTK] the address of each
  // key's K row and of its V row (the pool's, int8 under kQuant, or the
  // chunk's)
  int* const sPre = sRowH + kRows;
  const void** const sKPtr = reinterpret_cast<const void**>(sPre + 2 * kTK);
  const void** const sVPtr = sKPtr + 2 * kTK;
  // kQuant: two int8 staging buffers, each a K and a V tile's rows and
  // their scales
  constexpr int kP8 = int8_pitch(HD);
  int8_t* const s8 = reinterpret_cast<int8_t*>(sVPtr + 2 * kTK);
  auto sK8 = [&](int buf) { return s8 + buf * int8_buffer_bytes(HD); };
  auto sV8 = [&](int buf) { return sK8(buf) + kTK * kP8; };
  auto sKs = [&](int buf) {
    return reinterpret_cast<float*>(sK8(buf) + 2 * kTK * kP8);
  };
  auto sVs = [&](int buf) { return sKs(buf) + kTK; };

  const int bkv = p.B * p.KV;
  const int x = blockIdx.x / bkv;
  const int b = (blockIdx.x % bkv) / p.KV, kvh = blockIdx.x % p.KV;
  const int g = p.g;
  int qt, piece, npieces;
  locate(p, x, qt, piece, npieces);
  const int s0 = qt * p.TQ, s_end = min(s0 + p.TQ, p.Sq);
  const int R = p.TQ * g;
  int klo, khi, tlo, thi;
  key_range(p, qt, klo, khi);
  pieces_of(p, qt, tlo, thi);
  const int ta = tlo + piece * p.C, tb = min(ta + p.C, thi);
  const int key_lo = max(klo, ta * kTK), key_hi = min(khi, tb * kTK);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rbase = 0;          // the warp's first row: every warp's rows
  const int kw = warp * 16;     // the warp's first key

  auto query_pos = [&](int s) -> int {
    return __ldg(p.qpos + (size_t)b * p.Sq + s);
  };
  // where key `key`'s raw position lives: the prefix pool's or the
  // chunk's; a prefix key's counts only below the row's cursor
  const int lp = p.pre.Lp;
  const int start_b = row_start(p.pre, b);
  auto key_pos_ptr = [&](int key) -> const int* {
    if (key < lp) return p.pre.pos + prefix_row(p.pre, b, key);
    return p.kpos + (size_t)b * (p.Sk - lp) + (key - lp);
  };
  auto key_pos = [&](int key) -> int {
    const int pos = __ldg(key_pos_ptr(key));
    return key < lp ? guard_pos(pos, start_b) : pos;
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
  // CTA's range (tile skipping)
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
  for (int s = s0 + lane; s < s0 + 64; s += 32) {
    const bool ok = s < s_end;
    const int pos = ok ? query_pos(s) : 0;
    clo = min(clo, ok ? pos : 0x7fffffff);
    chi = max(chi, ok ? pos : -1);
  }
  clo = __reduce_min_sync(0xffffffffu, clo);
  chi = __reduce_max_sync(0xffffffffu, chi);

  // bit i of vis = tile mask_base + i has a key some query of the
  // CTA can see (a superset test); every warp computes the same mask
  unsigned vis = 0;
  int mask_base = ta - 32;
  auto next_tile = [&](int t) -> int {
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
            const int pos = key_pos(key);
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
  // The rows of tile t's keys, found once a tile.  Thread tid <
  // 64 looks key t * 64 + tid's pool row up (row_of, at the top of the
  // pass before the tile's, held in a register) and, after that pass's
  // middle barrier, writes it and the key's K and V row addresses into
  // sPre / sKPtr / sVPtr[buf] (set_rows), so a row's address is one
  // shared load where each thread would divide and read the table per
  // row.
  auto row_of = [&](int t) -> int {
    const int key = t * kTK + tid;
    return tid < kTK && t < tb && key < lp
               ? (int)prefix_row(p.pre, b, key) : 0;
  };
  auto set_rows = [&](int buf, int t, int row) {
    if (tid >= kTK) return;
    const int key = t * kTK + tid, i = buf * kTK + tid;
    sPre[i] = row;
    if (key < lp) {
      const long long e = ((long long)row * p.KV + kvh) * HD;
      using Row = std::conditional_t<kQuant, int8_t, bf16>;
      sKPtr[i] = static_cast<const Row*>(p.pre.k) + e;
      sVPtr[i] = static_cast<const Row*>(p.pre.v) + e;
    } else {
      sKPtr[i] = p.k + b * p.ks.b + kvh * p.ks.h + (key - lp) * p.ks.s;
      sVPtr[i] = p.v + b * p.vs.b + kvh * p.vs.h + (key - lp) * p.vs.s;
    }
  };
  // (pool row, KV head) of prefix key k0 + r of a tile whose rows are in
  // sPre[buf]: its scale's index
  auto prefix_head = [&](int buf, int r) -> long long {
    return (long long)sPre[buf * kTK + r] * p.KV + kvh;
  };
  // the thread's rows of tile t to dst, from the addresses in `rows`
  // (sKPtr or sVPtr[buf]; kQuant: the chunk's only, the prefix's int8
  // rows go through load_int8); base: a valid address for a skipped row
  auto load_rows = [&](bf16* dst, const bf16* base, const void* const* rows,
                       int t) {
    const int k0 = t * kTK;
#pragma unroll
    for (int i = 0; i < kTK / kStep; ++i) {
      const int r = kr0 + i * kStep, key = k0 + r;
      if (kQuant && key < lp) continue;
      const bool ok = key >= key_lo && key < key_hi;
      const bf16* src = base;
      if (ok) src = static_cast<const bf16*>(rows[r]) + kch * 8;
      cp_async16(dst + r * kPitch + kch * 8, src, ok);
    }
  };
  // kQuant: tile t's int8 prefix rows of K and V (pool rows in
  // sPre[buf]), 16 elements a copy, and their scales into staging buffer
  // buf
  constexpr int kChunks8 = HD / 16;
  auto load_int8 = [&](int buf, int t) {
    const int k0 = t * kTK;
    for (int c = tid; c < 2 * kTK * kChunks8; c += kThreads) {
      const int kv = c / (kTK * kChunks8), cc = c % (kTK * kChunks8);
      const int r = cc / kChunks8, key = k0 + r;
      if (key >= lp) continue;
      const bool ok = key >= key_lo && key < key_hi;
      const int8_t* const base8 =
          static_cast<const int8_t*>(kv ? p.pre.v : p.pre.k);
      const void* const row = (kv ? sVPtr : sKPtr)[buf * kTK + r];
      cp_async16((kv ? sV8(buf) : sK8(buf)) + r * kP8 + (cc % kChunks8) * 16,
                 ok ? static_cast<const int8_t*>(row) + (cc % kChunks8) * 16
                    : base8,
                 ok);
    }
    if (tid < 2 * kTK) {
      const int kv = tid / kTK, r = tid % kTK, key = k0 + r;
      if (key < lp) {
        const bool ok = key >= key_lo && key < key_hi;
        const float* const sb = kv ? p.pre.v_scale : p.pre.k_scale;
        cp_async4((kv ? sVs(buf) : sKs(buf)) + r,
                  ok ? sb + prefix_head(buf, r) : sb, ok);
      }
    }
  };
  // kQuant, once tile t's staged rows are visible: dst's
  // prefix rows = int8 x scale in float32, rounded to bf16, 16 elements a
  // thread a pass
  auto convert8 = [&](bf16* dst, const int8_t* src8, const float* scale,
                      int t) {
    const int k0 = t * kTK;
#pragma unroll
    for (int it = 0; it < (kTK * kChunks8 + kThreads - 1) / kThreads; ++it) {
      const int c = tid + it * kThreads;
      const int r = c / kChunks8, ch = c % kChunks8;
      if (c >= kTK * kChunks8 || k0 + r >= lp) continue;
      const float sc = scale[r];
      const uint4 raw = *reinterpret_cast<const uint4*>(src8 + r * kP8 +
                                                        ch * 16);
      const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                             raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = dequant_pair_u<0>(w[i], sc, sc);
        o[2 * i + 1] = dequant_pair_u<2>(w[i], sc, sc);
      }
      uint4* const out = reinterpret_cast<uint4*>(dst + r * kPitch + ch * 16);
      out[0] = make_uint4(o[0], o[1], o[2], o[3]);
      out[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  };
  // sPos holds the raw positions: staged_pos applies the cursor guard
  auto load_k = [&](int buf, int t) {
    load_rows(sK, kbase, sKPtr + buf * kTK, t);
    if (tid < kTK) {
      const int key = t * kTK + tid;
      const bool ok = key >= key_lo && key < key_hi;
      const int* src = p.qpos;
      if (ok)
        src = key < lp ? p.pre.pos + sPre[buf * kTK + tid]
                       : key_pos_ptr(key);
      cp_async4(sPos + tid, src, ok);
    }
  };
  auto load_v = [&](int buf, int t) {
    load_rows(sV, vbase, sVPtr + buf * kTK, t);
  };
  auto staged_pos = [&](int c, int key) -> int {
    const int pos = sPos[c];
    return key < lp ? guard_pos(pos, start_b) : pos;
  };

  // the first K tile (it joins Q's copy group), and kQuant its int8 K
  // and V rows into staging buffer 0; the first two tiles' rows
  int t = next_tile(ta);
  int tn = t < tb ? next_tile(t + 1) : tb;   // the next tile, a pass ahead
  int buf = 0;   // tile t's rows and kQuant staging buffer
  set_rows(0, t, row_of(t));
  set_rows(1, tn, row_of(tn));
  __syncthreads();
  if (t < tb) {
    load_k(0, t);
    if constexpr (kQuant) load_int8(0, t);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // (the barrier after Q's fragments below publishes the converted tile)
  if constexpr (kQuant)
    if (t < tb) convert8(sK, sK8(0), sKs(0), t);

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
    // the tile after tn and its pool row (set after the middle barrier,
    // when buffer buf's loads are all issued)
    const int tnn = tn < tb ? next_tile(tn + 1) : tb;
    const int row_nn = row_of(tnn);
    load_v(buf, t);
    cp_async_commit();
    const int k0 = t * kTK;
    if constexpr (kQuant) {
      // tile tn's int8 rows into the other buffer, in by the middle barrier
      if (tn < tb) load_int8(buf ^ 1, tn);
      cp_async_commit();
      // V(t)'s prefix rows: sV is free since the last barrier, V(t)'s
      // staging visible since then
      convert8(sV, sV8(buf), sVs(buf), t);
    }

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
    {
      int lo = 0x7fffffff, hi = (int)0x80000000;
      for (int c = lane; c < 8 * NB; c += 32) {
        const int pos = staged_pos(kw + c, ka + c);
        lo = min(lo, pos);
        hi = max(hi, pos);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      full = full && lo >= 0 && hi <= wlo &&
             (p.window == 0 || whi - lo < p.window);
    }

    // masked online softmax, base 2; row i of the thread: elements 2i, 2i+1
    if (!full) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = kw + n * 8 + (lane % 4) * 2 + (e & 1);
          const int key = k0 + c;
          const int pos = staged_pos(c, key);
          const bool ok = key >= key_lo && key < key_hi &&
                          visible(pos, qp[e / 2], p.window);
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

    cp_async_wait<0>();
    __syncthreads();  // V(t) is in; every warp is done with K(t)
    if (tn < tb) load_k(buf ^ 1, tn);
    cp_async_commit();
    set_rows(buf, tnn, row_nn);   // read from the next pass's top on
    // K(tn)'s prefix rows, visible since the barrier, into the free sK
    if constexpr (kQuant)
      if (tn < tb) convert8(sK, sK8(buf ^ 1), sKs(buf ^ 1), tn);

    // acc += P V: P's C fragments of keys 16kk.. are the A fragment
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      uint32_t ph[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        const int m = lane / 8;
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sV + (kw + kk * 16 + (m % 2) * 8 + lane % 8) *
                                       kPitch +
                                   dp * 16 + (m / 2) * 8);
        mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
      }
    }
    // K(tn) is in (and its prefix rows converted); every warp is done
    // with V(t)
    cp_async_wait<0>();
    __syncthreads();
    t = tn;
    tn = tnn;
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  // a piece of a split query tile writes (m, l, acc) partials
  const long long part = ((long long)(blockIdx.x % bkv) * p.n_pieces + x) * R;

  // the four warps' states of rows 0-15 merge through shared
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
inline void split_tiles(const Params& p, int& lo, int& hi) {
  lo = hi = 0;
  for (int i = 0, tlo, thi; i < p.n_qtiles; ++i)
    if (pieces_of(p, i, tlo, thi) > 1) {
      if (lo == hi) lo = i;
      hi = i + 1;
    }
}

template <int HD>
__device__ __forceinline__ void combine_pieces(const Params& p) {
  constexpr int kBlocks = combine_blocks(HD);
  const int qt = p.combine_lo + blockIdx.x / kBlocks, bk = blockIdx.y;
  const int b = bk / p.KV, kvh = bk % p.KV, g = p.g;
  int tlo, thi, first = 0;
  const int n = pieces_of(p, qt, tlo, thi);
  if (n == 1) return;
  for (int i = p.n_qtiles - 1; i > qt; --i)
    first += pieces_of(p, i, tlo, thi);
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
