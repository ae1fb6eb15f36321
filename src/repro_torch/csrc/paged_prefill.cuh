// Ragged chunked-prefill attention: the attention of every default
// serving-engine step, and of every slot-engine decode step (one query
// lane). The launcher, shared by paged_prefill.cu (the float keys'
// entries) and paged_prefill_int8.cu (the int8 prefix's), each compiled
// on its own.
//
// Replaces repro/kernels/ops.py paged_prefill, which has no Pallas kernel
// (both of its arms run the reference). Semantics:
// repro_torch/kernels/ref.py paged_prefill_ref.
//
// Layout: q (B, S, H, hd) chunk queries; the keys in two segments, the
// prefix (PagedPrefix, attention_mma.cuh) then the chunk's k/v (B, Lc, KV,
// hd) with kpos (B, Lc) int32 absolute key positions (-1 = invalid lane);
// qpos (B, S) int32 absolute query positions; out (B, S, H, hd).  The
// engine's prefix is its block pool (NB, bs, KV, hd) with positions (NB,
// bs), read through the dispatch's block table (B, nb): Lp = nb * bs keys,
// key j of row b at pool row (bt[b][j / bs], j % bs), its position -1
// unless below the row's cursor start[b].  So no gathered copy of the
// prefix and no concatenation with the chunk is made (the reference's
// attn_prefill_paged builds both before its op).  Contiguous callers (the
// slot decode, whose strip is the whole key set) pass Lp = 0 and their
// keys as the chunk (paged_prefill_launch), or, for an int8 strip, the
// strip as a prefix without a table: row b is block b of Lp rows, with no
// cursor guard.
//
// Bound on an H100: bytes at decode and small-chunk sizes. The kernel
// reads q, the chunk's k, v and kpos, qpos, every table lane's position
// and the K/V rows of the prefix tiles some query sees once, and writes
// out once; at S * g query
// rows per key it does 4 * hd * S * g flops per key byte pair, which stays
// under the ~295 flops per byte line until chunks reach a few hundred
// tokens.
//
// Design, bfloat16: one CTA per (row, KV head, tile of TQ = 64 / g query
// lanes, piece of the key lanes) serves the R = TQ * g query vectors of
// that head group, so each key is read once per group and tile, and walks
// 64-key tiles with the online softmax in registers; P goes into P.V
// rounded to bf16, as the plain version rounds its probabilities. Tiles
// no query of the CTA can see (null-block padding of the table, keys past
// the tile's last query) are skipped before they are loaded. Two tiles:
//   * more than 16 rows (chunks, verify windows: the engine's chunk and
//     verify dispatches): attention_paged_wgmma.cuh, Hopper's tile. A
//     producer warpgroup looks the keys up through the table, tests the
//     tiles' positions and copies live tiles' rows (16-byte cp.async, int8
//     rows converted there) into a ring of swizzled K/V slots with
//     mbarriers; a consumer warpgroup runs Q.K^T and P.V on wgmma.
//   * 16 rows or fewer (S = 1: fused decode, slot decode): the kWarpKeys
//     mma.sync tile of attention_mma.cuh, the four warps on different
//     16-key slices of each tile, merged at the end (a wgmma M of 64
//     would waste 48 of its rows).
// Small grids (8 rows x 8 KV heads at fused decode, 4 slots x 8 at slot
// decode) leave most of the 132 SMs idle, so the wrapper's planner
// (kernels/attention_split.py, each tile its constants) cuts the key
// lanes into pieces of whole tiles, each a CTA, and a combine pass merges
// them.
//
// float32 keeps the CUDA-core tile below (attention_tile.cuh): on the
// tensor cores float32 means TF32, ~3 decimal digits, which breaks the
// 1e-4 float32 limits the 2-layer token-identity checks rest on. It
// stages each tile of TK keys in shared memory as float32 and folds it
// into a float32 online softmax.
//
// Query lanes with no visible key write zeros, where the reference
// writes the uniform average of all keys; the engine discards those
// lanes (padding lanes and padding rows).
//
// The int8 KV cache (paged_prefill_pool_int8_launch and, for an int8
// strip, paged_prefill_int8_launch; plain versions
// ref.paged_prefill_pool_int8_ref / paged_prefill_int8_ref): the prefix's
// rows are int8 with a float32 scale (NB, bs, KV), the chunk's own K/V
// in the model dtype (Lc = 0: a slot decode, whose whole strip is the
// prefix). Key j < Lp is a prefix row, key j >= Lp chunk row j - Lp, as
// in concat(dequant(gather(prefix)), chunk), which is never built. A
// prefix key or value is dequantized as it is loaded: int8 times its
// scale in float32, rounded to the model dtype (the reference's
// _dequantize_kv), then used as a float key is. So an int8 launch equals,
// bit for bit, the float launch over the concatenated dequantized keys
// (same shape, plan and dtype). bfloat16: the Hopper tile's producer
// converts each prefix chunk in place in its bf16 slot before it arrives;
// the kWarpKeys tile stages int8 rows double-buffered and converts each
// row once inside its own barriers; float32: the tile below converts as
// it loads.
//
// Tile skipping reads positions only: a tile whose guarded positions no
// query of the CTA can see is skipped before its K/V rows are loaded,
// the same ballot as over gathered keys, so a pool launch equals, bit for
// bit, the launch over the gathered and concatenated keys. A tile is not
// skipped from its table entries alone: the null block's lanes are read
// like any other (the engine scrubs them to -1 after every dispatch).
#pragma once

#include "attention_mma.cuh"
#include "attention_paged_wgmma.cuh"
#include "attention_tile.cuh"

namespace repro_torch {

constexpr int kTK = 32;       // keys per tile
constexpr int kThreads = 256;
// bf16 launches of up to this many query rows a CTA take the kWarpKeys
// mma.sync tile (kernels/paged_prefill.py WARP_KEYS_ROWS)
constexpr int kWarpKeysRows = 16;

// A pool prefix: Lp = nb * bs keys read through block_table (B, nb)
// from the pool's k / v rows (NB, bs, KV, hd), scales (int8 launches) and
// positions pos (NB, bs); start (B,) the rows' cursors, or null for
// start_all
inline PagedPrefix pool_prefix(const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* pos, const void* block_table,
                               const void* start, int start_all, int nb,
                               int bs) {
  PagedPrefix pre{};
  pre.k = k;
  pre.v = v;
  pre.k_scale = static_cast<const float*>(k_scale);
  pre.v_scale = static_cast<const float*>(v_scale);
  pre.pos = static_cast<const int*>(pos);
  pre.bt = static_cast<const int*>(block_table);
  pre.start = static_cast<const int*>(start);
  pre.start_all = start_all;
  pre.nb = nb;
  set_block_size(pre, bs);
  pre.Lp = nb * bs;
  return pre;
}

// A contiguous prefix (B, Lp, ...), no cursor guard: row b is block b of
// Lp rows
inline PagedPrefix contiguous_prefix(const void* k, const void* v,
                                     const void* k_scale,
                                     const void* v_scale, const void* pos,
                                     int Lp) {
  PagedPrefix pre = pool_prefix(k, v, k_scale, v_scale, pos, nullptr,
                                nullptr, 0x7fffffff, 1, 1);
  pre.Lp = Lp;
  return pre;
}

// keys [0, pre.Lp) from the prefix (int8 rows under kQuant, else T
// rows), then the L keys of k / v / kpos
template <typename T, bool kQuant>
__global__ void paged_prefill_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const int* __restrict__ kpos,
                                     const int* __restrict__ qpos,
                                     T* __restrict__ out, int S, int L, int H,
                                     int KV, int hd, int TQ, int window,
                                     float scale, const PagedPrefix pre) {
  const int Lp = pre.Lp, Lc = L;
  extern __shared__ float smem[];
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = H / KV;
  const int R = TQ * g, TK = kTK;
  const int s0 = tile * TQ;
  TileSmem t = carve_tile_smem(smem, R, TK, hd);
  __shared__ int q_lo, q_hi;
  __shared__ int rows[kTK];   // a tile's prefix pool rows

  // row r = (query lane s0 + r / g, head kvh * g + r % g)
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const int s = s0 + r / g, h = kvh * g + r % g;
    t.q[i] = s < S ? to_float(q[(((size_t)b * S + s) * H + h) * hd + d]) : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int s = s0 + r / g;
    t.qpos[r] = s < S ? qpos[(size_t)b * S + s] : -1;
  }
  if (threadIdx.x == 0) {
    int lo = 0x7fffffff, hi = -1;
    for (int s = s0; s < min(s0 + TQ, S); ++s) {
      const int p = qpos[(size_t)b * S + s];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    q_lo = lo;
    q_hi = hi;
  }
  init_rows(t, R, hd);
  __syncthreads();
  const int lo = q_lo, hi = q_hi;
  const int start_b = row_start(pre, b);

  for (int k0 = 0; k0 < Lp + Lc; k0 += TK) {
    const int nk = min(TK, Lp + Lc - k0);
    int any = 0;
    for (int c = threadIdx.x; c < TK; c += blockDim.x) {
      const int j = k0 + c;
      const int row = c < nk && j < Lp ? (int)prefix_row(pre, b, j) : 0;
      rows[c] = row;
      const int kp = c >= nk  ? -1
                     : j < Lp ? guard_pos(pre.pos[row], start_b)
                              : kpos[(size_t)b * Lc + j - Lp];
      t.kpos[c] = kp;
      // visible to some query of the tile: a superset test, exact enough
      // to skip padding and future keys
      any |= kp >= 0 && kp <= hi && (window == 0 || lo - kp < window);
    }
    if (!__syncthreads_or(any)) continue;
    for (int i = threadIdx.x; i < nk * hd; i += blockDim.x) {
      const int c = i / hd, d = i % hd, j = k0 + c;
      float kf, vf;
      if (j < Lp) {
        const size_t row = (size_t)rows[c] * KV + kvh;
        if (kQuant) {
          const int8_t* const k8 = static_cast<const int8_t*>(pre.k);
          const int8_t* const v8 = static_cast<const int8_t*>(pre.v);
          kf = to_float(from_float<T>(static_cast<float>(k8[row * hd + d]) *
                                      pre.k_scale[row]));
          vf = to_float(from_float<T>(static_cast<float>(v8[row * hd + d]) *
                                      pre.v_scale[row]));
        } else {
          kf = to_float(static_cast<const T*>(pre.k)[row * hd + d]);
          vf = to_float(static_cast<const T*>(pre.v)[row * hd + d]);
        }
      } else {
        const size_t src = (((size_t)b * Lc + j - Lp) * KV + kvh) * hd + d;
        kf = to_float(k[src]);
        vf = to_float(v[src]);
      }
      t.k[(size_t)c * (hd + 1) + d] = kf;
      t.v[i] = vf;
    }
    __syncthreads();
    attend_tile(t, R, TK, nk, hd, scale, window);
  }

  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const int s = s0 + r / g, h = kvh * g + r % g;
    if (s >= S) continue;
    const float l = fmaxf(t.l[r], 1e-30f);
    out[(((size_t)b * S + s) * H + h) * hd + d] = from_float<T>(t.acc[i] / l);
  }
}

template <typename T, bool kQuant>
static int launch(const void* q, const void* k, const void* v,
                  const void* kpos, const void* qpos, void* out, int B, int S,
                  int L, int H, int KV, int hd, int TQ, int window,
                  float scale, const PagedPrefix& pre, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(TQ * (H / KV), kTK, hd);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, kQuant>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + TQ - 1) / TQ, KV, B);
  paged_prefill_kernel<T, kQuant><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kpos),
      static_cast<const int*>(qpos), static_cast<T*>(out), S, L, H, KV, hd,
      TQ, window, scale, pre);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bfloat16

// The kWarpKeys tile (16 query rows or fewer) at head_dim 128 or less
// fits three CTAs an SM (the key-range split's pieces are many small
// CTAs): held to 170 registers, as without the pool's row addresses.
template <int HD, bool kQuant>
__global__ void __launch_bounds__(mma::kThreads,
                                  !kQuant && HD <= 128 ? 3 : 1)
    paged_prefill_mma_kernel(const mma::Params p) {
  mma::attend_piece<HD, kQuant>(p);
}

// The Hopper tile (more than 16 query rows): two CTAs an SM, the
// producer's registers given to the consumer by setmaxnreg.
template <int HD, bool kQuant>
__global__ void __launch_bounds__(wg::kThreads, wg::kPagedMinBlocks)
    paged_prefill_wgmma_kernel(const mma::Params p) {
  wg::attend_paged<HD, kQuant>(p);
}

template <int HD>
__global__ void __launch_bounds__(mma::kCombineThreads)
    paged_prefill_combine_kernel(const mma::Params p) {
  mma::combine_pieces<HD>(p);
}

// the combine pass of a split launch, after either tile
template <int HD>
static int launch_combine(const mma::Params& p, cudaStream_t stream) {
  int lo, hi;
  mma::split_tiles(p, lo, hi);
  if (lo == hi) return 0;
  mma::Params pc = p;
  pc.combine_lo = lo;
  paged_prefill_combine_kernel<HD>
      <<<dim3((hi - lo) * mma::combine_blocks(HD), p.B * p.KV),
         mma::kCombineThreads, 0, stream>>>(pc);
  return (int)cudaGetLastError();
}

template <int HD, bool kQuant>
static int launch_mma(const mma::Params& p, cudaStream_t stream) {
  const size_t smem = mma::smem_bytes(HD, kQuant);
  static unsigned long long allowed = 0;   // a bit per device
  cudaError_t err = mma::allow_smem(paged_prefill_mma_kernel<HD, kQuant>,
                                    smem, allowed);
  if (err != cudaSuccess) return (int)err;
  paged_prefill_mma_kernel<HD, kQuant>
      <<<p.n_pieces * p.B * p.KV, mma::kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<HD>(p, stream);
}

template <int HD, bool kQuant>
static int launch_wgmma(const mma::Params& p, cudaStream_t stream) {
  const size_t smem = wg::paged_smem_bytes(HD);
  static unsigned long long allowed = 0;   // a bit per device
  cudaError_t err = wg::allow_smem(paged_prefill_wgmma_kernel<HD, kQuant>,
                                   smem, allowed);
  if (err != cudaSuccess) return (int)err;
  paged_prefill_wgmma_kernel<HD, kQuant>
      <<<p.n_pieces * p.B * p.KV, wg::kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<HD>(p, stream);
}

template <bool kQuant>
static int launch_mma_hd(int hd, const mma::Params& p, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_mma<16, kQuant>(p, stream);
    case 32: return launch_mma<32, kQuant>(p, stream);
    case 64: return launch_mma<64, kQuant>(p, stream);
    case 128: return launch_mma<128, kQuant>(p, stream);
    case 256: return launch_mma<256, kQuant>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kQuant>
static int launch_wgmma_hd(int hd, const mma::Params& p,
                           cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_wgmma<16, kQuant>(p, stream);
    case 32: return launch_wgmma<32, kQuant>(p, stream);
    case 64: return launch_wgmma<64, kQuant>(p, stream);
    case 128: return launch_wgmma<128, kQuant>(p, stream);
    case 256: return launch_wgmma<256, kQuant>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// the bf16 tile of a launch of R = TQ * g query rows a CTA: the kWarpKeys
// mma.sync tile up to 16, the Hopper tile above
inline bool warp_keys_tile(int TQ, int g) { return TQ * g <= kWarpKeysRows; }

// dynamic shared memory of a bf16 launch's tile
inline size_t bf16_smem_bytes(int hd, int TQ, int g, bool quant) {
  return warp_keys_tile(TQ, g) ? mma::smem_bytes(hd, quant)
                               : wg::paged_smem_bytes(hd);
}

// Every entry: keys [0, pre.Lp) of the prefix (int8 rows under kQuant),
// then the Lc keys of k / v / kpos
template <bool kQuant>
static int launch_entry(int dtype, const void* q, const void* k,
                        const void* v, const void* kpos, const void* qpos,
                        void* out, int B, int S, int Lc, int H, int KV,
                        int hd, int TQ, int window, float scale,
                        int tiles_per_piece, int n_pieces, void* part_acc,
                        void* part_ml, const PagedPrefix& pre,
                        cudaStream_t s) {
  if (dtype == 0)
    return launch<float, kQuant>(q, k, v, kpos, qpos, out, B, S, Lc, H, KV,
                                 hd, TQ, window, scale, pre, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  mma::Params p{};
  p.q = static_cast<const mma::bf16*>(q);
  p.k = static_cast<const mma::bf16*>(k);
  p.v = static_cast<const mma::bf16*>(v);
  p.out = static_cast<mma::bf16*>(out);
  // (B, S, H, hd) and (B, Lc, KV, hd), dense
  p.qs = {(long long)S * H * hd, hd, (long long)H * hd};
  p.os = p.qs;
  p.ks = {(long long)Lc * KV * hd, hd, (long long)KV * hd};
  p.vs = p.ks;
  p.kpos = static_cast<const int*>(kpos);
  p.qpos = static_cast<const int*>(qpos);
  p.pre = pre;
  p.B = B;
  p.KV = KV;
  p.g = H / KV;
  p.Sq = S;
  p.Sk = pre.Lp + Lc;
  p.TQ = TQ;
  p.window = window;
  p.n_qtiles = (S + TQ - 1) / TQ;
  p.C = tiles_per_piece;
  p.n_pieces = n_pieces;
  p.scale_log2 = scale * mma::kLog2e;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float2*>(part_ml);
  return warp_keys_tile(TQ, p.g) ? launch_mma_hd<kQuant>(hd, p, s)
                                 : launch_wgmma_hd<kQuant>(hd, p, s);
}

}  // namespace repro_torch

