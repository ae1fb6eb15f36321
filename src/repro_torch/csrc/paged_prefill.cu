// Ragged chunked-prefill attention: the attention of every default
// serving-engine step, and of every slot-engine decode step (one query
// lane).
//
// Replaces repro/kernels/ops.py paged_prefill, which has no Pallas kernel
// (both of its arms run the reference). Semantics:
// repro_torch/kernels/ref.py paged_prefill_ref.
//
// Layout: q (B, S, H, hd) chunk queries; k/v (B, L, KV, hd) keys = each
// row's gathered prefix followed by the chunk; kpos (B, L) int32 absolute
// key positions (-1 = invalid lane); qpos (B, S) int32 absolute query
// positions; out (B, S, H, hd).
//
// Bound on an H100: bytes at decode and small-chunk sizes. The kernel
// reads q, k, v, kpos and qpos once and writes out once; at S * g query
// rows per key it does 4 * hd * S * g flops per key byte pair, which stays
// under the ~295 flops per byte line until chunks reach a few hundred
// tokens.
//
// Design, bfloat16 (attention_mma.cuh): one CTA of 4 warps per (row, KV
// head, tile of TQ = 64 / g query lanes, piece of the key lanes) serves
// the R = TQ * g query vectors of that head group, so each key is read
// once per group and tile. The CTA walks 64-key tiles in bf16 shared
// memory, each copy (cp.async) overlapping the other operand's math,
// Q.K^T and P.V on mma.sync.m16n8k16 with float32 sums and the online
// softmax in registers; P goes into P.V rounded to bf16, as the plain version
// rounds its probabilities. Tiles no query of the CTA can see (null-block
// padding of the gathered prefix, keys past the tile's last query) are
// skipped before they are loaded, from a ballot over their kpos lanes.
// With 16 rows or fewer (S = 1: fused decode, slot decode) the four
// warps take different 16-key slices of each tile and merge at the end.
// Small grids (8 rows x 8 KV heads at fused decode, 4 slots x 8 at slot
// decode) leave most of the 132 SMs idle, so the wrapper's planner
// (kernels/attention_split.py) cuts the key lanes into pieces of whole
// tiles, each a CTA, and a combine pass merges them by log-sum-exp.
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
// The int8 KV cache (paged_prefill_int8_launch; plain version
// ref.paged_prefill_int8_ref): the keys come in two segments, the
// gathered int8 prefix k8 / v8 (B, Lp, KV, hd) with float32 scales (B, Lp,
// KV) and positions (B, Lp), then the chunk's own K/V (B, Lc, KV, hd) in
// the model dtype with positions (B, Lc) (Lc = 0: a slot decode, whose
// whole strip is the prefix). Key j < Lp is prefix row j, key j >= Lp
// chunk row j - Lp, as in concat(dequant(prefix), chunk), which is never
// built. A prefix key or value is dequantized as it is loaded: int8 times
// its scale in float32, rounded to the model dtype (the reference's
// _dequantize_kv), then used as a float key is. So an int8 launch equals,
// bit for bit, the float launch over the concatenated dequantized keys
// (same shape, plan and dtype). bfloat16: attention_mma.cuh's kQuant
// tile (int8 rows double-buffered in shared memory, each row converted
// once into the bf16 tile inside that tile's own barriers); float32: the
// tile below converts as it loads.
#include "attention_mma.cuh"
#include "attention_tile.cuh"

namespace repro_torch {

constexpr int kTK = 32;       // keys per tile
constexpr int kThreads = 256;

// The int8 prefix segment of an int8 launch: keys [0, Lp)
struct Int8Prefix {
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  const int* kpos;
  int Lp;
};

// kQuant: keys [0, pre.Lp) from the int8 prefix, then the L keys of k / v
// / kpos; otherwise the L keys alone
template <typename T, bool kQuant>
__global__ void paged_prefill_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const int* __restrict__ kpos,
                                     const int* __restrict__ qpos,
                                     T* __restrict__ out, int S, int L, int H,
                                     int KV, int hd, int TQ, int window,
                                     float scale, const Int8Prefix pre) {
  const int Lp = kQuant ? pre.Lp : 0, Lc = L;
  extern __shared__ float smem[];
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g = H / KV;
  const int R = TQ * g, TK = kTK;
  const int s0 = tile * TQ;
  TileSmem t = carve_tile_smem(smem, R, TK, hd);
  __shared__ int q_lo, q_hi;

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

  for (int k0 = 0; k0 < Lp + Lc; k0 += TK) {
    const int nk = min(TK, Lp + Lc - k0);
    int any = 0;
    for (int c = threadIdx.x; c < TK; c += blockDim.x) {
      const int j = k0 + c;
      const int kp = c >= nk       ? -1
                     : j < Lp      ? pre.kpos[(size_t)b * Lp + j]
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
      if (kQuant && j < Lp) {
        const size_t row = ((size_t)b * Lp + j) * KV + kvh;
        kf = to_float(from_float<T>(static_cast<float>(pre.k[row * hd + d]) *
                                    pre.k_scale[row]));
        vf = to_float(from_float<T>(static_cast<float>(pre.v[row * hd + d]) *
                                    pre.v_scale[row]));
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
                  float scale, const Int8Prefix& pre, cudaStream_t stream) {
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

template <int HD, bool kWarpKeys, bool kQuant>
__global__ void __launch_bounds__(mma::kThreads)
    paged_prefill_mma_kernel(const mma::Params p) {
  mma::attend_piece<HD, true, true, false, kWarpKeys, kQuant>(p);
}

template <int HD>
__global__ void __launch_bounds__(mma::kCombineThreads)
    paged_prefill_combine_kernel(const mma::Params p) {
  mma::combine_pieces<HD, true>(p);
}

template <int HD, bool kWarpKeys, bool kQuant>
static int launch_mma(const mma::Params& p, cudaStream_t stream) {
  const size_t smem = mma::smem_bytes(HD, kQuant);
  static unsigned long long allowed = 0;   // a bit per device
  cudaError_t err = mma::allow_smem(
      paged_prefill_mma_kernel<HD, kWarpKeys, kQuant>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  paged_prefill_mma_kernel<HD, kWarpKeys, kQuant>
      <<<p.n_pieces * p.B * p.KV, mma::kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  int lo, hi;
  mma::split_tiles<true>(p, lo, hi);
  if (err != cudaSuccess || lo == hi) return (int)err;
  mma::Params pc = p;
  pc.combine_lo = lo;
  paged_prefill_combine_kernel<HD>
      <<<dim3((hi - lo) * mma::combine_blocks(HD), p.B * p.KV),
         mma::kCombineThreads, 0, stream>>>(pc);
  return (int)cudaGetLastError();
}

template <bool kWarpKeys, bool kQuant>
static int launch_mma_hd(int hd, const mma::Params& p, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_mma<16, kWarpKeys, kQuant>(p, stream);
    case 32: return launch_mma<32, kWarpKeys, kQuant>(p, stream);
    case 64: return launch_mma<64, kWarpKeys, kQuant>(p, stream);
    case 128: return launch_mma<128, kWarpKeys, kQuant>(p, stream);
    case 256: return launch_mma<256, kWarpKeys, kQuant>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Either entry: keys [0, pre.Lp) of the int8 prefix (kQuant), then the
// Lc keys of k / v / kpos
template <bool kQuant>
static int launch_entry(int dtype, const void* q, const void* k,
                        const void* v, const void* kpos, const void* qpos,
                        void* out, int B, int S, int Lc, int H, int KV,
                        int hd, int TQ, int window, float scale,
                        int tiles_per_piece, int n_pieces, void* part_acc,
                        void* part_ml, const Int8Prefix& pre,
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
  p.k8 = pre.k;
  p.v8 = pre.v;
  p.k8_scale = pre.k_scale;
  p.v8_scale = pre.v_scale;
  p.kpos8 = pre.kpos;
  p.Lp = kQuant ? pre.Lp : 0;
  p.B = B;
  p.KV = KV;
  p.g = H / KV;
  p.Sq = S;
  p.Sk = p.Lp + Lc;
  p.TQ = TQ;
  p.window = window;
  p.causal = 1;
  p.n_qtiles = (S + TQ - 1) / TQ;
  p.C = tiles_per_piece;
  p.n_pieces = n_pieces;
  p.scale_log2 = scale * mma::kLog2e;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float2*>(part_ml);
  return TQ * p.g <= 16 ? launch_mma_hd<true, kQuant>(hd, p, s)
                        : launch_mma_hd<false, kQuant>(hd, p, s);
}

}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16. TQ: query lanes per CTA. bfloat16
// only: tiles_per_piece and n_pieces from the wrapper's planner (n_pieces
// = the query tiles' piece counts summed; equal to ceil(S / TQ) when no
// range is split), part_acc (float32, B*KV*n_pieces*TQ*(H/KV)*hd) and
// part_ml (float32 pairs, B*KV*n_pieces*TQ*(H/KV)) scratch when split.
// Returns a cudaError_t (0 = launched).
extern "C" int paged_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, const void* kpos,
                                    const void* qpos, void* out, int B, int S,
                                    int L, int H, int KV, int hd, int TQ,
                                    int window, float scale,
                                    int tiles_per_piece, int n_pieces,
                                    void* part_acc, void* part_ml,
                                    void* stream) {
  using namespace repro_torch;
  return launch_entry<false>(dtype, q, k, v, kpos, qpos, out, B, S, L, H, KV,
                             hd, TQ, window, scale, tiles_per_piece,
                             n_pieces, part_acc, part_ml, Int8Prefix{},
                             static_cast<cudaStream_t>(stream));
}

// The int8 KV cache's entry: the prefix k8 / v8 int8 (B, Lp, KV, hd), its
// scales float32 (B, Lp, KV) and positions (B, Lp), then the chunk's k / v
// (B, Lc, KV, hd) in the dtype of q and its positions (B, Lc); the rest as
// paged_prefill_launch, the split planned over Lp + Lc keys.
extern "C" int paged_prefill_int8_launch(
    int dtype, const void* q, const void* k8, const void* v8,
    const void* k_scale, const void* v_scale, const void* kpos8,
    const void* k, const void* v, const void* kpos, const void* qpos,
    void* out, int B, int S, int Lp, int Lc, int H, int KV, int hd, int TQ,
    int window, float scale, int tiles_per_piece, int n_pieces,
    void* part_acc, void* part_ml, void* stream) {
  using namespace repro_torch;
  if (Lp < 0 || Lc < 0) return (int)cudaErrorInvalidValue;
  const Int8Prefix pre{static_cast<const int8_t*>(k8),
                       static_cast<const int8_t*>(v8),
                       static_cast<const float*>(k_scale),
                       static_cast<const float*>(v_scale),
                       static_cast<const int*>(kpos8), Lp};
  return launch_entry<true>(dtype, q, k, v, kpos, qpos, out, B, S, Lc, H, KV,
                            hd, TQ, window, scale, tiles_per_piece, n_pieces,
                            part_acc, part_ml, pre,
                            static_cast<cudaStream_t>(stream));
}

extern "C" size_t paged_prefill_smem_bytes(int dtype, int H, int KV, int hd,
                                           int TQ) {
  if (dtype == 1) return repro_torch::mma::smem_bytes(hd);
  return repro_torch::tile_smem_bytes(TQ * (H / KV), repro_torch::kTK, hd);
}

extern "C" size_t paged_prefill_int8_smem_bytes(int dtype, int H, int KV,
                                                int hd, int TQ) {
  if (dtype == 1) return repro_torch::mma::smem_bytes(hd, true);
  return repro_torch::tile_smem_bytes(TQ * (H / KV), repro_torch::kTK, hd);
}
