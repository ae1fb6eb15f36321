// One-token decode attention over a block-paged KV pool, split over the
// key range: the kernel, shared by paged_attention.cu (the float pools'
// entries) and paged_attention_int8.cu (the int8 pools'), each compiled
// on its own.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention, body _kernel). Semantics: repro_torch/kernels/ref.py
// paged_attention_ref: NEG_INF masking, a key visible iff its lane's kpos
// is >= 0, <= pos and inside the window, zeros for rows that see no key,
// probabilities and the value product in float32.
//
// Layout: q (B, H, hd); k/v pools (NB, bs, KV, hd); kpos pool (NB, bs)
// int32 absolute positions (-1 = invalid lane); block table (B, nb) int32,
// 0-padded (block 0 is the null block, every lane -1); pos (B,) int32;
// out (B, H, hd).
//
// Bound on an H100: bytes. Each key costs about one float32 FMA per bf16
// byte read (g x hd for Q.K and g x hd for P.V against 2 x hd x 2 bytes),
// far below the card's ~295 operations per byte, so the least time is the
// live K/V bytes over 3.35 TB/s. What stands between a decode step and
// that bound is latency: a few MB spread over many small blocks, each
// reached through the block table and its kpos lanes. An mma tile would
// leave 7/8 of its rows empty at qwen3's group of 2 and would round the
// probabilities to bf16, so the design spends the card on moving bytes:
//
//   * Split over the key range: a CTA takes (request, KV head, piece of
//     the block table); the host planner (kernels/paged_attention.py
//     plan) cuts the table where (request, KV head) pairs alone would
//     leave SMs idle. An unsplit launch writes its output. A split one
//     runs the pieces of a (request, KV head) as one thread-block
//     cluster (at most 8 CTAs): each keeps its float32 (m, l, acc)
//     partial state in shared memory, and the cluster merges them by
//     log-sum-exp over distributed shared memory
//     (ref.attention_combine_ref), with no second launch and no partial
//     state in device memory.
//   * Visibility first: the CTA reads its piece's table entries and every
//     kpos lane (16 threads a 16-key chunk, a ballot each) into a
//     bitmask per chunk, so chunks with no visible lane are never
//     fetched; each warp takes every 4th visible chunk.
//   * Loads: a warp copies its chunk's K and V rows straight from the
//     pool with cp.async, 16 bytes a lane, coalesced along hd and
//     zero-filled where a key is invisible, into its own two-stage ring,
//     so the next chunk is in flight while the current one is reduced
//     (one stage at float32 head_dim 256, where two would not fit four
//     warps' rings in shared memory). No CTA-wide barrier inside the loop.
//   * Math in float32 registers: each lane holds a 16-byte slice of the g
//     query rows (pre-scaled into base 2; at float32 head_dim 256 two
//     slices, so a key spans no more than a warp's 32 lanes); a key's
//     score is a dot product over hd / (16 / sizeof(T)) lanes (at most
//     32), and the chunk's partial products
//     are summed by one reduce-scatter over those lanes (at qwen3's shape
//     15 shuffles for 32 scores); the chunk's online-softmax update is one
//     max and one sum over 16 lanes; each lane accumulates p x V for its
//     slice of its keys.
//   * One merge per CTA: the key groups of a warp by shuffles, the four
//     warps by log-sum-exp through shared memory.
//
// head_dim 16, 32, 64, 128 or 256, groups up to 8 query heads per KV head
// (compiled for 1, 2, 4 and 8 rows), any block size; the wrapper refuses
// the rest before launching.
//
// The int8 KV cache (paged_attention_int8_launch in paged_attention_int8.cu;
// plain version ref.paged_attention_int8_ref): the pools hold int8 values
// with a float32 scale per (block, lane, KV head). The same kernel with
// the storage type S = int8_t: a warp's ring holds a chunk's int8 K and V
// rows, copied 16 int8 elements a cp.async (so head_dim 16 is one copy a
// key), and the chunk's 16 K and 16 V scales beside them (a 4-byte copy a
// lane). Where the float kernel unpacks a key or value slice from the
// ring, load_deq reads the lane's int8 slice in one 8-byte (4-byte) load
// and dequantizes it as the reference's _dequantize_kv does, exactly, with
// no I2F or F2F conversion instruction (the first design's two a
// element, each at a fraction of the FMA rate): int8 -> float32 by
// a byte permute and one subtraction, times the key's scale in float32,
// rounded to T two at a time (cvt.rn.bf16x2.f32) and widened back by a
// shift or a mask, as the float kernel unpacks bf16. From there the value
// is used exactly as the float kernel uses a pool element, in the same
// order, so an int8 launch equals, bit for bit, the float launch over the
// dequantized pools. (Converting each chunk's rows once into a bf16 copy
// in the warp's ring with 16-byte reads, the other placement, measured
// slower: PERF.md.) It reads half the bytes of a bf16 pool (plus 8 bytes
// of scales a key and KV head), and a decode step is bound by those
// bytes.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace cg = cooperative_groups;

namespace repro_torch {
namespace paged {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 16;         // keys a warp fetches and reduces at once
constexpr int kWindowItems = 256;  // chunks whose visibility is read at once
constexpr int kMaxGroup = 8;
constexpr int kMaxPieces = 8;      // CTAs of a portable cluster

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;   // int8 pools: the scales (NB, bs, KV); else unused
  const float* vs;
  const int* kpos;
  const int* bt;
  const int* pos;
  void* out;
  int H, KV, g, bs, nb, window;
  int blocks_per_piece, n_pieces;
  float scale_log2;
};

// 16 bytes of T as floats
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Sum N values over the lanes that differ in the bits below 2 * OFF,
// halving them at each level while two or more are left: afterwards
// v[x] holds the sum of value x + (N / n) * (those lane bits, top first,
// as far as N lasts), n = what is left (>= 1).
template <int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (OFF >= 1) {
    if constexpr (N >= 2) {
      const bool upper = lane & OFF;
#pragma unroll
      for (int x = 0; x < N / 2; ++x) {
        const float send = upper ? v[x] : v[x + N / 2];
        const float keep = upper ? v[x + N / 2] : v[x];
        v[x] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      reduce_scatter<N / 2, OFF / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      reduce_scatter<1, OFF / 2>(v, lane);
    }
  }
}

// Four int8 elements (one word) of a key, each times the key's scale in
// float32, as T: the reference's dequantization, exactly. int8 -> float32
// by a byte permute: the byte, offset by 128, as the low mantissa bits of
// 2^23, less 2^23 + 128; then the scale, and bf16 rounds two at a time
// (cvt.rn.bf16x2.f32). -> the four as T bits, packed: bf16 two a word,
// float32 one.
template <typename T>
__device__ __forceinline__ void deq4_bits(uint32_t w, float scale,
                                          uint32_t (&o)[16 / Vec<T>::N]) {
  const uint32_t u = w ^ 0x80808080u;
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) -
            8388736.f) *
           scale;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __float_as_uint(v[e]);
  } else {
    o[0] = mma::pack_bf16(v[0], v[1]);
    o[1] = mma::pack_bf16(v[2], v[3]);
  }
}

// E int8 elements (4 or 8) of one key as floats, dequantized to T and
// widened back, as the float kernel unpacks T: one 4- or 8-byte load
template <typename T, int E>
__device__ __forceinline__ void load_deq(const int8_t* src, float scale,
                                         float (&f)[E]) {
  static_assert(E == 4 || E == 8, "a lane's slice of a key");
  uint32_t w[E / 4];
  if constexpr (E == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
  }
#pragma unroll
  for (int u = 0; u < E / 4; ++u) {
    uint32_t o[16 / Vec<T>::N];
    deq4_bits<T>(w[u], scale, o);
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[4 * u + e] = __uint_as_float(o[e]);
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        f[4 * u + 2 * i] = __uint_as_float(o[i] << 16);
        f[4 * u + 2 * i + 1] = __uint_as_float(o[i] & 0xffff0000u);
      }
    }
  }
}

// Elements of 16 bytes of T, unpacked to floats: E / Vec<T>::N loads
template <typename T, int E>
__device__ __forceinline__ void load_f(const T* src, float (&f)[E]) {
  constexpr int N = Vec<T>::N;
#pragma unroll
  for (int u = 0; u < E / N; ++u) {
    float t[N];
    unpack(*reinterpret_cast<const uint4*>(src + u * N), t);
#pragma unroll
    for (int e = 0; e < N; ++e) f[u * N + e] = t[e];
  }
}

// T: the model type (q, out, the arithmetic's slices); S: the pools'
// element type, T or int8_t
template <typename T, typename S, int HD>
struct Layout {
  static constexpr bool kQuant = sizeof(S) == 1;
  static constexpr int kVec = Vec<T>::N;   // elements of one 16-byte load
  // elements of one key a lane holds: one load, or as many as keep a key
  // within 32 lanes (float32 at head_dim 256: two)
  static constexpr int kElems = HD / kVec > 32 ? HD / 32 : kVec;
  static constexpr int kLanesPerKey = HD / kElems;  // lanes over one key
  static constexpr int kKeysPerRound = 32 / kLanesPerKey;
  static constexpr int kRounds = kChunk / kKeysPerRound;
  static_assert(kLanesPerKey >= 1 && kLanesPerKey <= 32 &&
                    kElems % kVec == 0 && kLanesPerKey * kElems == HD,
                "head_dim");
  // a warp's ring of K and V chunks (int8 ones followed by their 16 K and
  // 16 V scales): two stages, or one where two would not fit four warps'
  // rings in shared memory (float32 at head_dim 256)
  static constexpr size_t kTensorBytes = (size_t)kChunk * HD * sizeof(S);
  static constexpr size_t kStageBytes =
      2 * kTensorBytes + (kQuant ? (size_t)2 * kChunk * 4 : 0);
  static constexpr int kStages = kStageBytes > 16384 ? 1 : 2;
  static constexpr size_t kWarpBytes = kStages * kStageBytes;
};

__host__ __device__ constexpr int chunks_per_block(int bs) {
  return (bs + kChunk - 1) / kChunk;
}

template <typename T, typename S, int HD, int G>
__host__ __device__ constexpr size_t smem_bytes() {
  return kWarps * Layout<T, S, HD>::kWarpBytes   // the rings
         + (size_t)kWarps * kChunk * G * 4       // scores, probabilities
         + (size_t)kWindowItems * 4 * 3          // blocks, masks, lists
         + (size_t)(G * HD + 2 * G) * 4;         // the CTA's merged state
}

template <typename T, typename S, int HD, int G>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const Args a) {
  using L = Layout<T, S, HD>;
  // the ring takes the warp's merged state at the end
  static_assert(L::kWarpBytes >= (size_t)(G * HD + 2 * G) * 4, "ring");
  constexpr int kVec = L::kVec, kE = L::kElems, kLPK = L::kLanesPerKey;
  constexpr int kKPR = L::kKeysPerRound, kRounds = L::kRounds;
  // partial scores a lane sums per chunk, whole ones it keeps after the
  // reduce-scatter, and lanes that share each
  constexpr int kV = kRounds * G;
  constexpr int kF = kV > kLPK ? kV / kLPK : 1;
  constexpr int kDup = kLPK / (kV / kF);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int piece = blockIdx.x % a.n_pieces;
  const int bk = blockIdx.x / a.n_pieces;           // b * KV + kvh
  const int b = bk / a.KV, kvh = bk % a.KV, g = a.g;

  unsigned char* ring = smem + warp * L::kWarpBytes;
  float* ps = reinterpret_cast<float*>(smem + kWarps * L::kWarpBytes) +
              warp * kChunk * G;
  int* sblk = reinterpret_cast<int*>(smem + kWarps * L::kWarpBytes +
                                     (size_t)kWarps * kChunk * G * 4);
  uint32_t* smask = reinterpret_cast<uint32_t*>(sblk + kWindowItems);
  int* mine = reinterpret_cast<int*>(smask + kWindowItems) +
              warp * (kWindowItems / kWarps);
  // acc [G][HD], m [G], l [G] of the whole CTA, for a cluster's merge
  float* cst = reinterpret_cast<float*>(smask + 2 * kWindowItems);

  const S* __restrict__ kp_ = static_cast<const S*>(a.k);
  const S* __restrict__ vp_ = static_cast<const S*>(a.v);
  const int qp = a.pos[b];

  // the lane's slice of every query row, scaled into base 2
  const int x0 = (lane % kLPK) * kE;
  float q[G][kE];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r < g) {
      load_f<T, kE>(static_cast<const T*>(a.q) +
                        ((size_t)b * a.H + kvh * g + r) * HD + x0,
                    q[r]);
#pragma unroll
      for (int e = 0; e < kE; ++e) q[r][e] *= a.scale_log2;
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) q[r][e] = 0.f;
    }
  }
  float m_run[G], l_run[G], acc[G][kE];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[r][e] = 0.f;
  }

  const int nch = chunks_per_block(a.bs);
  const int window_blocks = kWindowItems / nch;
  const int p_lo = piece * a.blocks_per_piece;
  const int p_hi = min(p_lo + a.blocks_per_piece, a.nb);
  const int* __restrict__ bt_row = a.bt + (size_t)b * a.nb;

  for (int w0 = p_lo; w0 < p_hi; w0 += window_blocks) {
    const int n_blocks = min(window_blocks, p_hi - w0);
    const int n_items = n_blocks * nch;
    // every warp is done with the previous window's lists
    if (w0 > p_lo) __syncthreads();
    // visibility: 16 threads a chunk read its block's table entry, then
    // its kpos lanes together
    const int passes = (n_items + kThreads / 16 - 1) / (kThreads / 16);
    for (int p0 = 0; p0 < passes; p0 += 4) {
      int kp[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = (p0 + u) * (kThreads / 16) + tid / 16;
        const int c = (it % nch) * kChunk + (tid & 15);
        const bool ok = p0 + u < passes && it < n_items;
        const int blk = ok ? bt_row[w0 + it / nch] : 0;
        if (ok && c == 0) sblk[it / nch] = blk;
        kp[u] = ok && c < a.bs ? a.kpos[(size_t)blk * a.bs + c] : -1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int it = (p0 + u) * (kThreads / 16) + tid / 16;
        const uint32_t bal =
            __ballot_sync(0xffffffffu, visible(kp[u], qp, a.window));
        if ((tid & 15) == 0 && p0 + u < passes && it < n_items)
          smask[it] = (bal >> (lane & 16)) & 0xffffu;
      }
    }
    __syncthreads();
    // this warp's chunks: every kWarps-th visible one, in order
    int count = 0;
    for (int base = 0; base < n_items; base += 32) {
      const uint32_t m = base + lane < n_items ? smask[base + lane] : 0u;
      const uint32_t bal = __ballot_sync(0xffffffffu, m != 0);
      const int rank = count + __popc(bal & ((1u << lane) - 1u));
      if (m != 0 && rank % kWarps == warp) mine[rank / kWarps] = base + lane;
      count += __popc(bal);
    }
    __syncwarp();
    const int n_mine = count > warp ? (count - warp + kWarps - 1) / kWarps : 0;

    // copy chunk idx of this warp's list into stage st: K and V rows,
    // zero-filled where the key is invisible; always one commit group
    auto fetch = [&](int idx, int st) {
      if (idx < n_mine) {
        const int it = mine[idx];
        const uint32_t msk = smask[it];
        const size_t row0 =
            (size_t)sblk[it / nch] * a.bs + (it % nch) * kChunk;
        S* dk = reinterpret_cast<S*>(ring + st * L::kStageBytes);
        S* dv = dk + kChunk * HD;
        if constexpr (L::kQuant) {
          // 16 int8 elements a copy, HD / 16 a key; then the chunk's
          // scales, K's by lanes 0-15 and V's by lanes 16-31
          constexpr int kPer = HD / 16;
#pragma unroll
          for (int e = lane; e < kChunk * kPer; e += 32) {
            const int c = e / kPer;
            const bool ok = (msk >> c) & 1u;
            const size_t src =
                ((row0 + (ok ? c : 0)) * a.KV + kvh) * HD + (e % kPer) * 16;
            mma::cp_async16(dk + e * 16, kp_ + src, ok);
            mma::cp_async16(dv + e * 16, vp_ + src, ok);
          }
          const int c = lane % kChunk;
          const bool ok = (msk >> c) & 1u;
          float* dst = reinterpret_cast<float*>(dv + kChunk * HD) +
                       (lane < kChunk ? 0 : kChunk) + c;
          mma::cp_async4(dst,
                         (lane < kChunk ? a.ks : a.vs) +
                             (row0 + (ok ? c : 0)) * a.KV + kvh,
                         ok);
        } else {
#pragma unroll
          for (int i = 0; i < kRounds; ++i) {   // kChunk * kLPK = 32 kRounds
            const int e = i * 32 + lane, c = e / kLPK;
            const bool ok = (msk >> c) & 1u;
            const size_t src =
                ((row0 + (ok ? c : 0)) * a.KV + kvh) * HD + (e % kLPK) * kE;
#pragma unroll
            for (int u = 0; u < kE; u += kVec) {
              mma::cp_async16(dk + e * kE + u, kp_ + src + u, ok);
              mma::cp_async16(dv + e * kE + u, vp_ + src + u, ok);
            }
          }
        }
      }
      mma::cp_async_commit();
    };

#pragma unroll
    for (int st = 0; st < L::kStages; ++st) fetch(st, st);
    for (int idx = 0; idx < n_mine; ++idx) {
      const int st = idx % L::kStages;
      mma::cp_async_wait<L::kStages - 1>();
      __syncwarp();
      const S* sk = reinterpret_cast<const S*>(ring + st * L::kStageBytes);
      const S* sv = sk + kChunk * HD;
      // int8: the chunk's K and V scales follow its V rows
      const float* sks = reinterpret_cast<const float*>(sv + kChunk * HD);
      const float* svs = sks + kChunk;
      // slice of key ck's row (kv 0: K, 1: V) as floats
      auto slice = [&](int kv, int ck, float (&f)[kE]) {
        if constexpr (L::kQuant)
          load_deq<T, kE>(reinterpret_cast<const int8_t*>(kv ? sv : sk) +
                              ck * HD + x0,
                          (kv ? svs : sks)[ck], f);
        else
          load_f<T, kE>(reinterpret_cast<const T*>(kv ? sv : sk) + ck * HD +
                            x0,
                        f);
      };
      const uint32_t msk = smask[mine[idx]];
      // scores of the chunk's keys: kKPR keys a round, kLPK lanes each;
      // the lane's partial dot products, then one reduce-scatter over the
      // key's lanes leaves each lane kF whole scores
      float s[kV];
#pragma unroll
      for (int i = 0; i < kRounds; ++i) {
        float kf[kE];
        slice(0, i * kKPR + lane / kLPK, kf);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          float t = 0.f;
#pragma unroll
          for (int e = 0; e < kE; ++e) t = fmaf(q[r][e], kf[e], t);
          s[i * G + r] = t;
        }
      }
      reduce_scatter<kV, kLPK / 2>(s, lane);
      if (lane % kDup == 0)
#pragma unroll
        for (int x = 0; x < kF; ++x) {
          const int v = x + kF * ((lane % kLPK) / kDup);   // i * G + r
          ps[((v / G) * kKPR + lane / kLPK) * G + v % G] = s[x];
        }
      __syncwarp();
      // the chunk's online-softmax update: lanes c and c + 16 hold key c
      const int c = lane % kChunk;
      const bool vis = (msk >> c) & 1u;
      float p[G], alpha[G];
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float sc = vis ? ps[c * G + r] : kNegInf;
        float mx = sc;
#pragma unroll
        for (int o = kChunk / 2; o >= 1; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_run[r], mx);
        p[r] = vis ? mma::fast_exp2(sc - m_new) : 0.f;
        float sum = p[r];
#pragma unroll
        for (int o = kChunk / 2; o >= 1; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        alpha[r] = mma::fast_exp2(m_run[r] - m_new);
        l_run[r] = l_run[r] * alpha[r] + sum;
        m_run[r] = m_new;
      }
      __syncwarp();
      if (lane < kChunk)
#pragma unroll
        for (int r = 0; r < G; ++r) ps[c * G + r] = p[r];
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[r][e] *= alpha[r];
      __syncwarp();
      // p x V over the lane's keys and slice of hd
#pragma unroll
      for (int i = 0; i < kRounds; ++i) {
        const int ck = i * kKPR + lane / kLPK;
        float vf[kE];
        slice(1, ck, vf);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const float pr = ps[ck * G + r];
#pragma unroll
          for (int e = 0; e < kE; ++e)
            acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
        }
      }
      __syncwarp();           // the stage and ps are free for reuse
      fetch(idx + L::kStages, st);
    }
    mma::cp_async_wait<0>();
  }

  // merge the warp's key groups (one softmax state: m, l are warp-wide)
#pragma unroll
  for (int o = kLPK; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int e = 0; e < kE; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  // each warp's state into its own ring, then the CTA merges the four
  float* wst = reinterpret_cast<float*>(ring);     // [G][HD] acc, m, l
  __syncwarp();
  if (lane < kLPK)
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int e = 0; e < kE; ++e) wst[r * HD + x0 + e] = acc[r][e];
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < G; ++r) {
      wst[G * HD + r] = m_run[r];
      wst[G * HD + G + r] = l_run[r];
    }
  __syncthreads();
  for (int i = tid; i < g * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, reinterpret_cast<const float*>(
                       smem + w * L::kWarpBytes)[G * HD + r]);
    float Lsum = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* o =
          reinterpret_cast<const float*>(smem + w * L::kWarpBytes);
      const float f = mma::fast_exp2(o[G * HD + r] - M);
      Lsum += o[G * HD + G + r] * f;
      A += o[r * HD + d] * f;
    }
    if (a.n_pieces == 1) {
      static_cast<T*>(a.out)[((size_t)b * a.H + kvh * g + r) * HD + d] =
          from_float<T>(A / fmaxf(Lsum, 1e-30f));
    } else {
      cst[r * HD + d] = A;
      if (d == 0) {
        cst[G * HD + r] = M;
        cst[G * HD + G + r] = Lsum;
      }
    }
  }
  if (a.n_pieces == 1) return;

  // A split launch is one thread-block cluster per (request, KV head),
  // a CTA per piece: once every piece's state is in its shared memory,
  // the cluster's threads merge them by log-sum-exp
  // (ref.attention_combine_ref), reading the other CTAs' states over
  // distributed shared memory; the second barrier keeps each CTA's
  // shared memory alive until the others have read it.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  for (int i = rank * kThreads + tid; i < g * HD;
       i += a.n_pieces * kThreads) {
    const int r = i / HD, d = i % HD;
    float M = kNegInf;
    for (int j = 0; j < a.n_pieces; ++j)
      M = fmaxf(M, cluster.map_shared_rank(cst, j)[G * HD + r]);
    float Lsum = 0.f, A = 0.f;
    for (int j = 0; j < a.n_pieces; ++j) {
      const float* o = cluster.map_shared_rank(cst, j);
      const float f = mma::fast_exp2(o[G * HD + r] - M);
      Lsum += o[G * HD + G + r] * f;
      A += o[r * HD + d] * f;
    }
    static_cast<T*>(a.out)[((size_t)b * a.H + kvh * g + r) * HD + d] =
        from_float<T>(A / fmaxf(Lsum, 1e-30f));
  }
  cluster.sync();
}

template <typename T, typename S, int HD, int G>
static int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, S, HD, G>();
  static unsigned long long allowed = 0;   // a bit per device
  cudaError_t err =
      mma::allow_smem(paged_attention_kernel<T, S, HD, G>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  if (a.n_pieces == 1) {
    paged_attention_kernel<T, S, HD, G>
        <<<B * a.KV, kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  // the pieces of one (request, KV head) are consecutive CTAs: a cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_pieces * B * a.KV);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_pieces;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_attention_kernel<T, S, HD, G>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename S, int HD>
static int launch_g(const Args& a, int B, cudaStream_t stream) {
  if (a.g <= 1) return launch<T, S, HD, 1>(a, B, stream);
  if (a.g <= 2) return launch<T, S, HD, 2>(a, B, stream);
  if (a.g <= 4) return launch<T, S, HD, 4>(a, B, stream);
  if (a.g <= kMaxGroup) return launch<T, S, HD, 8>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename S>
static int launch_hd(int hd, const Args& a, int B, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_g<T, S, 16>(a, B, stream);
    case 32: return launch_g<T, S, 32>(a, B, stream);
    case 64: return launch_g<T, S, 64>(a, B, stream);
    case 128: return launch_g<T, S, 128>(a, B, stream);
    case 256: return launch_g<T, S, 256>(a, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename S>
static size_t smem_hd(int hd, int g) {
  const int G = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
  switch (hd * 16 + G) {
#define REPRO_PA_CASE(HD, GG) \
  case HD * 16 + GG: return smem_bytes<T, S, HD, GG>();
    REPRO_PA_CASE(16, 1) REPRO_PA_CASE(16, 2) REPRO_PA_CASE(16, 4)
    REPRO_PA_CASE(16, 8) REPRO_PA_CASE(32, 1) REPRO_PA_CASE(32, 2)
    REPRO_PA_CASE(32, 4) REPRO_PA_CASE(32, 8) REPRO_PA_CASE(64, 1)
    REPRO_PA_CASE(64, 2) REPRO_PA_CASE(64, 4) REPRO_PA_CASE(64, 8)
    REPRO_PA_CASE(128, 1) REPRO_PA_CASE(128, 2) REPRO_PA_CASE(128, 4)
    REPRO_PA_CASE(128, 8) REPRO_PA_CASE(256, 1) REPRO_PA_CASE(256, 2)
    REPRO_PA_CASE(256, 4) REPRO_PA_CASE(256, 8)
#undef REPRO_PA_CASE
  }
  return 0;
}

// the pools' element type of an entry: the model type, or int8
template <typename T, bool kQuant>
using Pool = std::conditional_t<kQuant, int8_t, T>;

template <bool kQuant>
static int launch_entry(int dtype, const Args& a, int hd, int B,
                        cudaStream_t s) {
  if (dtype == 0) return launch_hd<float, Pool<float, kQuant>>(hd, a, B, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16, Pool<__nv_bfloat16, kQuant>>(hd, a, B,
                                                                  s);
  return (int)cudaErrorInvalidValue;
}

template <bool kQuant>
static size_t smem_entry(int dtype, int H, int KV, int hd) {
  if (KV < 1 || H % KV != 0 || H / KV > kMaxGroup) return 0;
  if (dtype == 0) return smem_hd<float, Pool<float, kQuant>>(hd, H / KV);
  return smem_hd<__nv_bfloat16, Pool<__nv_bfloat16, kQuant>>(hd, H / KV);
}

static int make_args(Args& a, const void* q, const void* k_pool,
                     const void* v_pool, const void* kpos_pool,
                     const void* block_table, const void* pos, void* out,
                     int B, int H, int KV, int bs, int nb, int window,
                     float scale, int blocks_per_piece, int n_pieces) {
  if (B < 1 || KV < 1 || H % KV != 0 || bs < 1 || nb < 1 || n_pieces < 1 ||
      n_pieces > kMaxPieces || blocks_per_piece < 1 ||
      (long long)blocks_per_piece * n_pieces < nb)
    return (int)cudaErrorInvalidValue;
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.kpos = static_cast<const int*>(kpos_pool);
  a.bt = static_cast<const int*>(block_table);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.H = H;
  a.KV = KV;
  a.g = H / KV;
  a.bs = bs;
  a.nb = nb;
  a.window = window;
  a.blocks_per_piece = blocks_per_piece;
  a.n_pieces = n_pieces;
  a.scale_log2 = scale * mma::kLog2e;
  return 0;
}

}  // namespace paged
}  // namespace repro_torch

