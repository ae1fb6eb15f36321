// One-token decode attention over a block-paged KV pool.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (paged_attention, body _kernel). Semantics: repro_torch/kernels/ref.py
// paged_attention_ref.
//
// Layout: q (B, H, hd); k/v pools (NB, bs, KV, hd); kpos pool (NB, bs)
// int32 absolute positions (-1 = invalid lane); block table (B, nb) int32,
// 0-padded (block 0 is the null block, every lane -1); pos (B,) int32;
// out (B, H, hd).
//
// Bound on an H100: bytes. Each step reads every live K/V block of every
// request once and does 4 * hd flops per (query head, key) on it, far
// below the card's ~295 flops per byte, so the least time is the live
// K/V bytes over 3.35 TB/s.
//
// Design: one CTA per (request, KV head) serves that head's g = H / KV
// query heads, so each K/V block is read from device memory once per
// group. The CTA loads its own block-table row and walks the logical
// blocks in a loop (the loop replaces the Pallas grid's sequential block
// axis): per block it reads the kpos lanes, skips the block when no lane
// is visible (null padding, all-future lanes), else stages K and V in
// shared memory as float32 and folds them into a float32 online softmax
// (attention_tile.cuh). Rows with no visible key write zeros.
#include "attention_tile.cuh"

namespace repro_torch {

template <typename T>
__global__ void paged_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k_pool,
                                       const T* __restrict__ v_pool,
                                       const int* __restrict__ kpos_pool,
                                       const int* __restrict__ block_table,
                                       const int* __restrict__ pos,
                                       T* __restrict__ out, int H, int KV,
                                       int hd, int bs, int nb, int window,
                                       float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int g = H / KV;
  const int R = g, TK = bs;
  TileSmem t = carve_tile_smem(smem, R, TK, hd);
  const int qp = pos[b];

  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    t.q[i] = to_float(q[((size_t)b * H + kvh * g + r) * hd + d]);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) t.qpos[r] = qp;
  init_rows(t, R, hd);
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    const size_t blk = (size_t)block_table[(size_t)b * nb + j];
    int any = 0;
    for (int c = threadIdx.x; c < TK; c += blockDim.x) {
      const int kp = kpos_pool[blk * bs + c];
      t.kpos[c] = kp;
      any |= visible(kp, qp, window);
    }
    if (!__syncthreads_or(any)) continue;
    for (int i = threadIdx.x; i < TK * hd; i += blockDim.x) {
      const int c = i / hd, d = i % hd;
      const size_t src = ((blk * bs + c) * KV + kvh) * hd + d;
      t.k[(size_t)c * (hd + 1) + d] = to_float(k_pool[src]);
      t.v[i] = to_float(v_pool[src]);
    }
    __syncthreads();
    attend_tile(t, R, TK, TK, hd, scale, window);
  }

  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const float l = fmaxf(t.l[r], 1e-30f);
    out[((size_t)b * H + kvh * g + r) * hd + d] = from_float<T>(t.acc[i] / l);
  }
}

template <typename T>
static int launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* kpos_pool, const void* block_table,
                  const void* pos, void* out, int B, int H, int KV, int hd,
                  int bs, int nb, int window, float scale,
                  cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(H / KV, bs, hd);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, KV);
  paged_attention_kernel<T><<<grid, 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(kpos_pool),
      static_cast<const int*>(block_table), static_cast<const int*>(pos),
      static_cast<T*>(out), H, KV, hd, bs, nb, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const void* kpos_pool,
                                      const void* block_table,
                                      const void* pos, void* out, int B,
                                      int H, int KV, int hd, int bs, int nb,
                                      int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro_torch::launch<float>(q, k_pool, v_pool, kpos_pool,
                                      block_table, pos, out, B, H, KV, hd, bs,
                                      nb, window, scale, s);
  if (dtype == 1)
    return repro_torch::launch<__nv_bfloat16>(q, k_pool, v_pool, kpos_pool,
                                              block_table, pos, out, B, H, KV,
                                              hd, bs, nb, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory a launch needs, so the wrapper can refuse shapes the card
// cannot hold before launching.
extern "C" size_t paged_attention_smem_bytes(int H, int KV, int hd, int bs) {
  return repro_torch::tile_smem_bytes(H / KV, bs, hd);
}
