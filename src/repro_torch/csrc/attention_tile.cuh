// Online-softmax attention over one tile of keys, shared by the paged
// decode and ragged prefill kernels.
//
// A CTA holds R query rows (query vectors of one KV head's group) and
// walks tiles of up to TK keys. For each tile the caller stages K, V and
// the keys' absolute positions in shared memory (float32), then calls
// attend_tile, which folds the tile into the running max m, denominator l
// and weighted value sum acc of every row, exactly as the reference's
// online softmax does:
//
//   s      = q.k * scale, masked to NEG_INF unless the key is visible
//   m_new  = max(m, max_s)         alpha = exp(m - m_new)
//   p      = visible ? exp(s - m_new) : 0
//   l      = l * alpha + sum(p)    acc = acc * alpha + p @ V
//
// A key at lane c is visible to row r iff kpos[c] >= 0, kpos[c] <=
// qpos[r] (the causal term, dropped when kCausal is false), and (window
// == 0 or qpos[r] - kpos[c] < window). Rows with no visible key keep
// acc = 0 and l = 0, so the final acc / max(l, 1e-30) writes zeros for
// them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr float kNegInf = -1073741824.0f;  // -2**30, as in the reference

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kCausal = true>
__device__ __forceinline__ bool visible(int kp, int qp, int window) {
  return kp >= 0 && (!kCausal || kp <= qp) &&
         (window == 0 || qp - kp < window);
}

// Shared-memory working set of one CTA. k rows are padded to hd + 1
// floats so that threads reading one column of K across rows hit
// distinct banks.
struct TileSmem {
  float* q;      // [R][hd]
  float* k;      // [TK][hd + 1]
  float* v;      // [TK][hd]
  float* s;      // [R][TK] scores, then probabilities
  float* acc;    // [R][hd]
  float* m;      // [R]
  float* l;      // [R]
  float* alpha;  // [R]
  int* kpos;     // [TK]
  int* qpos;     // [R]
};

__host__ __device__ inline size_t tile_smem_bytes(int R, int TK, int hd) {
  size_t floats = (size_t)R * hd + (size_t)TK * (hd + 1) + (size_t)TK * hd +
                  (size_t)R * TK + (size_t)R * hd + 3 * (size_t)R;
  return floats * sizeof(float) + ((size_t)TK + R) * sizeof(int);
}

__device__ inline TileSmem carve_tile_smem(void* base, int R, int TK, int hd) {
  TileSmem t;
  float* f = reinterpret_cast<float*>(base);
  t.q = f;       f += (size_t)R * hd;
  t.k = f;       f += (size_t)TK * (hd + 1);
  t.v = f;       f += (size_t)TK * hd;
  t.s = f;       f += (size_t)R * TK;
  t.acc = f;     f += (size_t)R * hd;
  t.m = f;       f += R;
  t.l = f;       f += R;
  t.alpha = f;   f += R;
  int* i = reinterpret_cast<int*>(f);
  t.kpos = i;    i += TK;
  t.qpos = i;
  return t;
}

// Zero the accumulators; the caller has written t.q and t.qpos.
__device__ inline void init_rows(const TileSmem& t, int R, int hd) {
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) t.acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    t.m[r] = kNegInf;
    t.l[r] = 0.f;
  }
}

// Fold keys [0, nk) of the staged tile into every row. Entry and exit
// are CTA-wide barriers' responsibility: the caller syncs after staging,
// this routine syncs before returning.
template <bool kCausal = true>
__device__ inline void attend_tile(const TileSmem& t, int R, int TK, int nk,
                                   int hd, float scale, int window) {
  // scores: consecutive threads take consecutive keys of one row
  for (int i = threadIdx.x; i < R * TK; i += blockDim.x) {
    const int r = i / TK, c = i % TK;
    float dot = 0.f;
    if (c < nk) {
      const float* qr = t.q + (size_t)r * hd;
      const float* kc = t.k + (size_t)c * (hd + 1);
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kc[d], dot);
    }
    t.s[i] = dot * scale;
  }
  __syncthreads();

  // masked online-softmax update: one warp per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < R; r += nwarps) {
    const int qp = t.qpos[r];
    float* sr = t.s + (size_t)r * TK;
    float mx = kNegInf;
    for (int c = lane; c < TK; c += 32) {
      const bool ok = c < nk && visible<kCausal>(t.kpos[c], qp, window);
      mx = fmaxf(mx, ok ? sr[c] : kNegInf);
    }
    mx = warp_max(mx);
    const float m_prev = t.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int c = lane; c < TK; c += 32) {
      const bool ok = c < nk && visible<kCausal>(t.kpos[c], qp, window);
      const float p = ok ? expf(sr[c] - m_new) : 0.f;
      sr[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      t.alpha[r] = a;
      t.l[r] = t.l[r] * a + sum;
      t.m[r] = m_new;
    }
  }
  __syncthreads();

  // acc = acc * alpha + p @ V: consecutive threads take consecutive dims
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const float* pr = t.s + (size_t)r * TK;
    float a = t.acc[i] * t.alpha[r];
    for (int c = 0; c < nk; ++c) a = fmaf(pr[c], t.v[(size_t)c * hd + d], a);
    t.acc[i] = a;
  }
  __syncthreads();
}

}  // namespace repro_torch
