// Ragged chunked-prefill attention: the attention of every default
// serving-engine step.
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
// Design: one CTA per (row, KV head, tile of TQ query lanes) serves the
// R = TQ * g query vectors of that head group, so each key is read once
// per group and tile. The CTA walks key tiles of TK keys: per tile it
// reads the kpos lanes and skips the tile when no key can be visible to
// any of its queries (null-block padding of the gathered prefix, keys
// past the tile's last query), else stages K and V in shared memory as
// float32 and folds them into a float32 online softmax
// (attention_tile.cuh). Query lanes with no visible key write zeros,
// where the reference writes the uniform average of all keys; the engine
// discards those lanes (padding lanes and padding rows).
#include "attention_tile.cuh"

namespace repro_torch {

constexpr int kTK = 32;       // keys per tile
constexpr int kThreads = 256;

template <typename T>
__global__ void paged_prefill_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const int* __restrict__ kpos,
                                     const int* __restrict__ qpos,
                                     T* __restrict__ out, int S, int L, int H,
                                     int KV, int hd, int TQ, int window,
                                     float scale) {
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

  for (int k0 = 0; k0 < L; k0 += TK) {
    const int nk = min(TK, L - k0);
    int any = 0;
    for (int c = threadIdx.x; c < TK; c += blockDim.x) {
      const int kp = c < nk ? kpos[(size_t)b * L + k0 + c] : -1;
      t.kpos[c] = kp;
      // visible to some query of the tile: a superset test, exact enough
      // to skip padding and future keys
      any |= kp >= 0 && kp <= hi && (window == 0 || lo - kp < window);
    }
    if (!__syncthreads_or(any)) continue;
    for (int i = threadIdx.x; i < nk * hd; i += blockDim.x) {
      const int c = i / hd, d = i % hd;
      const size_t src = (((size_t)b * L + k0 + c) * KV + kvh) * hd + d;
      t.k[(size_t)c * (hd + 1) + d] = to_float(k[src]);
      t.v[i] = to_float(v[src]);
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

template <typename T>
static int launch(const void* q, const void* k, const void* v,
                  const void* kpos, const void* qpos, void* out, int B, int S,
                  int L, int H, int KV, int hd, int TQ, int window,
                  float scale, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(TQ * (H / KV), kTK, hd);
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + TQ - 1) / TQ, KV, B);
  paged_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kpos),
      static_cast<const int*>(qpos), static_cast<T*>(out), S, L, H, KV, hd,
      TQ, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16. TQ: query lanes per CTA. Returns a
// cudaError_t (0 = launched).
extern "C" int paged_prefill_launch(int dtype, const void* q, const void* k,
                                    const void* v, const void* kpos,
                                    const void* qpos, void* out, int B, int S,
                                    int L, int H, int KV, int hd, int TQ,
                                    int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch<float>(q, k, v, kpos, qpos, out, B, S, L, H,
                                      KV, hd, TQ, window, scale, s);
  if (dtype == 1)
    return repro_torch::launch<__nv_bfloat16>(q, k, v, kpos, qpos, out, B, S,
                                              L, H, KV, hd, TQ, window, scale,
                                              s);
  return (int)cudaErrorInvalidValue;
}

extern "C" size_t paged_prefill_smem_bytes(int H, int KV, int hd, int TQ) {
  return repro_torch::tile_smem_bytes(TQ * (H / KV), repro_torch::kTK, hd);
}
