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
// without copies. Query i sees key j iff (not causal or j <= i) and
// (window == 0 or i - j < window), and j < Sk.
//
// Bound on an H100: operations for prompts of a few hundred tokens and
// up. One row's causal prefill reads q, k, v once and writes out once
// (bytes ~ S), but does 4 * hd flops per visible (query head, key)
// (flops ~ S^2 / 2), past the ~295 flops per byte line from a few
// hundred tokens on.
//
// Design: one CTA per (batch row, KV head, tile of TQ queries) serves
// the R = TQ * g query vectors of that head group, so each K/V tile is
// read once per group and query tile. The TPU kernel's sequential
// key-block grid axis becomes a loop inside the CTA: it walks only the
// key range some query of the tile can see (causal: keys <= the tile's
// last query; window: keys past the tile's first query minus the
// window), so fully masked tiles are never read, and keys past Sk are
// cut by the loop bound rather than padded. Each tile of TK keys is
// staged in shared memory as float32 and folded into a float32 online
// softmax (attention_tile.cuh); the key positions are the key indices,
// the query positions the query indices.
#include "attention_tile.cuh"

namespace repro_torch {

constexpr int kTK = 32;       // keys per tile
constexpr int kThreads = 256;

// element strides of a (B, heads, S, hd) operand; head_dim's is 1
struct Strides {
  long long b, h, s;
};

template <typename T, bool kCausal>
__global__ void flash_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, Strides qs,
                                       Strides ks, Strides vs, Strides os,
                                       int H, int KV, int Sq, int Sk, int hd,
                                       int TQ, int window, float scale) {
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
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int s = s0 + r / g;
    t.qpos[r] = s < Sq ? s : -1;   // rows past Sq are never written
  }
  init_rows(t, R, hd);

  // keys some query of [s0, s_end) can see
  const int k_lo = window ? max(0, s0 - window + 1) : 0;
  const int k_hi = kCausal ? min(Sk, s_end) : Sk;
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

template <typename T, bool kCausal>
static int launch(const void* q, const void* k, const void* v, void* out,
                  const long long* st, int B, int H, int KV, int Sq, int Sk,
                  int hd, int TQ, int window, float scale,
                  cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(TQ * (H / KV), kTK, hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((Sq + TQ - 1) / TQ, KV, B);
  flash_attention_kernel<T, kCausal><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qs, ks, vs, os, H, KV,
      Sq, Sk, hd, TQ, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_causal(int causal, const void* q, const void* k,
                         const void* v, void* out, const long long* st,
                         int B, int H, int KV, int Sq, int Sk, int hd,
                         int TQ, int window, float scale,
                         cudaStream_t stream) {
  if (causal)
    return launch<T, true>(q, k, v, out, st, B, H, KV, Sq, Sk, hd, TQ,
                           window, scale, stream);
  return launch<T, false>(q, k, v, out, st, B, H, KV, Sq, Sk, hd, TQ, window,
                          scale, stream);
}

}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (b, head,
// seq) of q, k, v and out in that order. TQ: queries per CTA. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_launch(int dtype, int causal, const void* q,
                                      const void* k, const void* v,
                                      void* out, const long long* strides,
                                      int B, int H, int KV, int Sq, int Sk,
                                      int hd, int TQ, int window, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch_causal<float>(causal, q, k, v, out, strides, B,
                                             H, KV, Sq, Sk, hd, TQ, window,
                                             scale, s);
  if (dtype == 1)
    return repro_torch::launch_causal<__nv_bfloat16>(
        causal, q, k, v, out, strides, B, H, KV, Sq, Sk, hd, TQ, window,
        scale, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory a launch needs, so the wrapper can refuse shapes the card
// cannot hold before launching.
extern "C" size_t flash_attention_smem_bytes(int H, int KV, int hd, int TQ) {
  return repro_torch::tile_smem_bytes(TQ * (H / KV), repro_torch::kTK, hd);
}
