// Blockwise online-softmax attention over a whole prompt: the slot
// engine's prefill.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, body _kernel). Semantics: repro_torch/kernels/ref.py
// flash_attention_ref.
//
// Layout: q (B, H, Sq, hd), k/v (B, KV, Sk, hd), out (B, H, Sq, hd), each
// given by element strides over (B, H or KV, S) with head_dim contiguous,
// so the model's (B, S, H, hd) projections go in as transposed views
// without copies. Query i sees key j iff (not causal or j <= i or j <
// prefix) and (window == 0 or i - j < window), and j < Sk. A prefix (the
// prefix-LM's image patches; causal, no window) runs an instantiation of
// its own (kPrefix): query i's causal bound becomes max(i, prefix - 1),
// so its keys are the causal ones below that bound and every existing
// instantiation compiles as it did.
//
// Bound on an H100: operations for prompts of a few hundred tokens and
// up. One row's causal prefill reads q, k, v once and writes out once
// (bytes ~ S), but does 4 * hd flops per visible (query head, key) --
// 6 * hd on the tensor cores here, P.V taking P as a hi + lo pair --
// (flops ~ S^2 / 2), past the ~295 flops per byte line from a few
// hundred tokens on: the tensor cores' rate decides.
//
// Design, bfloat16 (attention_wgmma.cuh): Hopper's path to that rate.
// One CTA of two warpgroups per (batch row, KV head, tile of TQ = 64 / g
// queries, piece of its key range) serves the R = TQ * g query vectors
// of that head group, so each K/V tile is read once per group and query
// tile. The TPU kernel's sequential key-block grid axis becomes a loop
// inside the CTA over 64-key tiles. A producer warpgroup gives up its
// registers (setmaxnreg) and one of its threads copies Q once and each K
// and V tile by TMA, from tensor maps encoded for each launch over the
// strided views, into a ring of shared-memory slots (four up to head_dim
// 64, three CTAs an SM; two at 128 and one at 256, two CTAs an SM) with
// mbarriers, so no
// thread spends registers or issue slots on addresses. The consumer
// warpgroup runs Q.K^T on wgmma (Q and K straight from the swizzled
// slots) and P.V on wgmma with P as the register operand, as a bf16 hi
// + lo pair (two products: rounded once to bf16 P would move outputs
// past the 2e-3 limit against the float32 plain version), float32 sums
// in registers and the online softmax in registers; at head_dim 128 the
// softmax of one tile runs while the previous tile's P.V does. The
// CTA walks only the key range some query of the tile can see (causal:
// keys <= the tile's last query; window: keys past the tile's first
// query minus the window), so fully masked tiles are never read, and
// keys past Sk are zero-filled by the copy, not read. Query tiles are
// launched heaviest first (the last causal tile has the longest range);
// where the grid would leave SMs idle, a partial last wave, or one
// range several times the mean, the wrapper's planner
// (kernels/attention_split.py) cuts the ranges into pieces of whole
// tiles and a combine pass merges them.
//
// float32 keeps the CUDA-core tile below (attention_tile.cuh): on the
// tensor cores float32 means TF32, ~3 decimal digits, which breaks the
// 1e-4 float32 limits the 2-layer token-identity checks rest on. Each
// tile of TK keys is staged in shared memory as float32 and folded into
// a float32 online softmax; the key positions are the key indices, the
// query positions the query indices.
#include "attention_tile.cuh"
#include "attention_wgmma.cuh"

namespace repro_torch {

constexpr int kTK = 32;       // keys per tile
constexpr int kThreads = 256;

// element strides of a (B, heads, S, hd) operand; head_dim's is 1
struct Strides {
  long long b, h, s;
};

template <typename T, bool kCausal, bool kPrefix>
__global__ void flash_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, Strides qs,
                                       Strides ks, Strides vs, Strides os,
                                       int H, int KV, int Sq, int Sk, int hd,
                                       int TQ, int window, int prefix,
                                       float scale) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = H / KV;
  const int R = TQ * g, TK = kTK;
  const int s0 = tile * TQ;
  const int s_end = min(s0 + TQ, Sq);
  TileSmem t = carve_tile_smem(smem, R, TK, hd);

  // row r = (query s0 + r / g, head kvh * g + r % g)
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const int s = s0 + r / g, h = kvh * g + r % g;
    t.q[i] = s < Sq ? to_float(q[b * qs.b + h * qs.h + s * qs.s + d]) : 0.f;
  }
  // a row's causal bound (kPrefix: at least prefix - 1); rows past Sq are
  // never written
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int s = s0 + r / g;
    t.qpos[r] = s < Sq ? (kPrefix ? max(s, prefix - 1) : s) : -1;
  }
  init_rows(t, R, hd);

  // keys some query of [s0, s_end) can see
  const int k_lo = window ? max(0, s0 - window + 1) : 0;
  const int k_hi =
      kCausal ? min(Sk, kPrefix ? max(s_end, prefix) : s_end) : Sk;
  for (int k0 = k_lo; k0 < k_hi; k0 += TK) {
    const int nk = min(TK, k_hi - k0);
    // every thread is past init_rows / the previous attend_tile's
    // closing barrier before the tile buffers are overwritten
    __syncthreads();
    for (int c = threadIdx.x; c < TK; c += blockDim.x) t.kpos[c] = k0 + c;
    for (int i = threadIdx.x; i < nk * hd; i += blockDim.x) {
      const int c = i / hd, d = i % hd;
      const long long key = k0 + c;
      t.k[(size_t)c * (hd + 1) + d] =
          to_float(k[b * ks.b + kvh * ks.h + key * ks.s + d]);
      t.v[i] = to_float(v[b * vs.b + kvh * vs.h + key * vs.s + d]);
    }
    __syncthreads();
    attend_tile<kCausal>(t, R, TK, nk, hd, scale, window);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const int s = s0 + r / g, h = kvh * g + r % g;
    if (s >= s_end) continue;
    const float l = fmaxf(t.l[r], 1e-30f);
    out[b * os.b + h * os.h + s * os.s + d] = from_float<T>(t.acc[i] / l);
  }
}

template <typename T, bool kCausal, bool kPrefix>
static int launch(const void* q, const void* k, const void* v, void* out,
                  const long long* st, int B, int H, int KV, int Sq, int Sk,
                  int hd, int TQ, int window, int prefix, float scale,
                  cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(TQ * (H / KV), kTK, hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, kCausal, kPrefix>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((Sq + TQ - 1) / TQ, KV, B);
  flash_attention_kernel<T, kCausal, kPrefix>
      <<<grid, kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, H,
          KV, Sq, Sk, hd, TQ, window, prefix, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_causal(int causal, const void* q, const void* k,
                         const void* v, void* out, const long long* st,
                         int B, int H, int KV, int Sq, int Sk, int hd,
                         int TQ, int window, int prefix, float scale,
                         cudaStream_t stream) {
  if (causal && prefix)
    return launch<T, true, true>(q, k, v, out, st, B, H, KV, Sq, Sk, hd, TQ,
                                 window, prefix, scale, stream);
  if (causal)
    return launch<T, true, false>(q, k, v, out, st, B, H, KV, Sq, Sk, hd, TQ,
                                  window, 0, scale, stream);
  return launch<T, false, false>(q, k, v, out, st, B, H, KV, Sq, Sk, hd, TQ,
                                 window, 0, scale, stream);
}

// ------------------------------------------------------------ bfloat16

// wg::min_blocks(HD) CTAs an SM; the producer's registers are given to
// the consumer by setmaxnreg.
template <int HD, bool kCausal, bool kPrefix>
__global__ void __launch_bounds__(wg::kThreads, wg::min_blocks(HD))
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                                 const __grid_constant__ CUtensorMap tmk,
                                 const __grid_constant__ CUtensorMap tmv,
                                 const wg::Params p) {
  wg::attend_piece<HD, kCausal, kPrefix>(&tmq, &tmk, &tmv, p);
}

template <int HD, bool kPrefix>
__global__ void __launch_bounds__(wg::kCombineThreads)
    flash_attention_combine_kernel(const wg::Params p) {
  wg::combine_pieces<HD, kPrefix>(p);
}

struct Maps {
  CUtensorMap q, k, v;
};

template <int HD, bool kCausal, bool kPrefix>
static int launch_wgmma(const Maps& m, const wg::Params& p,
                        cudaStream_t stream) {
  const size_t smem = wg::smem_bytes(HD);
  static unsigned long long allowed = 0;   // a bit per device
  cudaError_t err = wg::allow_smem(
      flash_attention_wgmma_kernel<HD, kCausal, kPrefix>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  flash_attention_wgmma_kernel<HD, kCausal, kPrefix>
      <<<p.n_pieces * p.B * p.KV, wg::kThreads, smem, stream>>>(m.q, m.k,
                                                                 m.v, p);
  err = cudaGetLastError();
  int lo, hi;
  wg::split_tiles<kPrefix>(p, lo, hi);
  if (err != cudaSuccess || lo == hi) return (int)err;
  wg::Params pc = p;
  pc.combine_lo = lo;
  flash_attention_combine_kernel<HD, kPrefix>
      <<<dim3((hi - lo) * wg::combine_blocks(HD), p.B * p.KV),
         wg::kCombineThreads, 0, stream>>>(pc);
  return (int)cudaGetLastError();
}

template <bool kCausal, bool kPrefix>
static int launch_wgmma_hd(int hd, const Maps& m, const wg::Params& p,
                           cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_wgmma<16, kCausal, kPrefix>(m, p, stream);
    case 32: return launch_wgmma<32, kCausal, kPrefix>(m, p, stream);
    case 64: return launch_wgmma<64, kCausal, kPrefix>(m, p, stream);
    case 128: return launch_wgmma<128, kCausal, kPrefix>(m, p, stream);
    case 256: return launch_wgmma<256, kCausal, kPrefix>(m, p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (b, head,
// seq) of q, k, v and out in that order. TQ: queries per CTA. prefix: keys
// [0, prefix) seen by every query (causal, window 0; 0 = none). bfloat16
// only: tiles_per_piece and n_pieces from the wrapper's planner (n_pieces
// = the query tiles' piece counts summed; equal to ceil(Sq / TQ) when no
// range is split), part_acc (float32, B*KV*n_pieces*TQ*(H/KV)*hd) and
// part_ml (float32 pairs, B*KV*n_pieces*TQ*(H/KV)) scratch when split.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(int dtype, int causal, const void* q,
                                      const void* k, const void* v,
                                      void* out, const long long* strides,
                                      int B, int H, int KV, int Sq, int Sk,
                                      int hd, int TQ, int window, int prefix,
                                      float scale, int tiles_per_piece,
                                      int n_pieces, void* part_acc,
                                      void* part_ml, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prefix < 0 || (prefix && (!causal || window)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_causal<float>(causal, q, k, v, out, strides, B, H, KV, Sq,
                                Sk, hd, TQ, window, prefix, scale, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const wg::Strides qs{strides[0], strides[1], strides[2]},
      ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]};
  wg::Params p{};
  p.out = static_cast<wg::bf16*>(out);
  p.os = {strides[9], strides[10], strides[11]};
  p.B = B;
  p.KV = KV;
  p.g = H / KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.TQ = TQ;
  p.window = window;
  p.causal = causal;
  p.n_qtiles = (Sq + TQ - 1) / TQ;
  p.C = tiles_per_piece;
  p.n_pieces = n_pieces;
  p.scale_log2 = scale * wg::kLog2e;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float2*>(part_ml);
  p.prefix = prefix;
  // Q's box: (64 dims, the g heads of a group, TQ positions), row r =
  // (position r / g, head r % g); K's and V's: (64 dims, 64 keys)
  Maps m;
  int err = wg::encode_map(&m.q, q, hd, H, Sq, B, qs, true, p.g, TQ);
  if (!err) err = wg::encode_map(&m.k, k, hd, KV, Sk, B, ks, false, wg::kTK, 1);
  if (!err) err = wg::encode_map(&m.v, v, hd, KV, Sk, B, vs, false, wg::kTK, 1);
  if (err) return err;
  if (prefix) return launch_wgmma_hd<true, true>(hd, m, p, s);
  return causal ? launch_wgmma_hd<true, false>(hd, m, p, s)
                : launch_wgmma_hd<false, false>(hd, m, p, s);
}

// Shared memory a launch needs, so the wrapper can refuse shapes the card
// cannot hold before launching.
extern "C" size_t flash_attention_smem_bytes(int dtype, int H, int KV, int hd,
                                             int TQ) {
  if (dtype == 1) return repro_torch::wg::smem_bytes(hd);
  return repro_torch::tile_smem_bytes(TQ * (H / KV), repro_torch::kTK, hd);
}
