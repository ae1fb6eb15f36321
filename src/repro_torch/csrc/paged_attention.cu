// paged_attention over float pools (the model dtype): the C entries of the
// kernel in paged_attention.cuh, which holds its design note. The int8
// pools' entries are paged_attention_int8.cu, compiled on their own.
#include "paged_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16. blocks_per_piece and n_pieces from the
// wrapper's planner (n_pieces = ceil(nb / blocks_per_piece), 1 = unsplit,
// at most kMaxPieces: a portable cluster). Returns a cudaError_t (0 =
// launched).
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const void* kpos_pool,
                                      const void* block_table,
                                      const void* pos, void* out, int B,
                                      int H, int KV, int hd, int bs, int nb,
                                      int window, float scale,
                                      int blocks_per_piece, int n_pieces,
                                      void* stream) {
  using namespace repro_torch;
  paged::Args a{};
  const int err = paged::make_args(a, q, k_pool, v_pool, kpos_pool,
                                   block_table, pos, out, B, H, KV, bs, nb,
                                   window, scale, blocks_per_piece, n_pieces);
  if (err) return err;
  return paged::launch_entry<false>(dtype, a, hd, B,
                                    static_cast<cudaStream_t>(stream));
}

// Shared memory a launch needs (0: a head_dim or group it does not take),
// so the wrapper can refuse shapes before launching.
extern "C" size_t paged_attention_smem_bytes(int dtype, int H, int KV, int hd,
                                             int bs) {
  (void)bs;   // a chunk holds kChunk keys whatever the block size
  return repro_torch::paged::smem_entry<false>(dtype, H, KV, hd);
}
