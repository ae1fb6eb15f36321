// paged_attention over the int8 KV cache's pools: the C entries of the
// kernel in paged_attention.cuh (S = int8_t), which holds its design note.
// A source of its own, so the float and int8 instantiations compile in
// parallel.
#include "paged_attention.cuh"

// The int8 pools' entry: k_pool / v_pool int8 (NB, bs, KV, hd), k_scale /
// v_scale float32 (NB, bs, KV); q and out in the model dtype.
extern "C" int paged_attention_int8_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* kpos_pool,
    const void* block_table, const void* pos, void* out, int B, int H,
    int KV, int hd, int bs, int nb, int window, float scale,
    int blocks_per_piece, int n_pieces, void* stream) {
  using namespace repro_torch;
  paged::Args a{};
  const int err = paged::make_args(a, q, k_pool, v_pool, kpos_pool,
                                   block_table, pos, out, B, H, KV, bs, nb,
                                   window, scale, blocks_per_piece, n_pieces);
  if (err) return err;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  return paged::launch_entry<true>(dtype, a, hd, B,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" size_t paged_attention_int8_smem_bytes(int dtype, int H, int KV,
                                                  int hd, int bs) {
  (void)bs;
  return repro_torch::paged::smem_entry<true>(dtype, H, KV, hd);
}
