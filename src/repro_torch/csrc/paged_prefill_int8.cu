// paged_prefill over the int8 KV cache's prefix: the C entries of the
// launcher in paged_prefill.cuh (kQuant), which holds its design note. A
// source of its own, so the float and int8 instantiations compile in
// parallel.
#include "paged_prefill.cuh"

// An int8 strip (the slot decode's, tests): the prefix k8 / v8 int8 (B,
// Lp, KV, hd), its scales float32 (B, Lp, KV) and positions (B, Lp), no
// cursor guard, then the chunk's k / v (B, Lc, KV, hd) in the dtype of q
// and its positions (B, Lc); the rest as paged_prefill_launch, the split
// planned over Lp + Lc keys.
extern "C" int paged_prefill_int8_launch(
    int dtype, const void* q, const void* k8, const void* v8,
    const void* k_scale, const void* v_scale, const void* kpos8,
    const void* k, const void* v, const void* kpos, const void* qpos,
    void* out, int B, int S, int Lp, int Lc, int H, int KV, int hd, int TQ,
    int window, float scale, int tiles_per_piece, int n_pieces,
    void* part_acc, void* part_ml, void* stream) {
  using namespace repro_torch;
  if (Lp < 0 || Lc < 0) return (int)cudaErrorInvalidValue;
  const PagedPrefix pre =
      contiguous_prefix(k8, v8, k_scale, v_scale, kpos8, Lp);
  return launch_entry<true>(dtype, q, k, v, kpos, qpos, out, B, S, Lc, H, KV,
                            hd, TQ, window, scale, tiles_per_piece, n_pieces,
                            part_acc, part_ml, pre,
                            static_cast<cudaStream_t>(stream));
}

// The engine's int8 entry: keys [0, nb * bs) read from the int8 block pool
// k_pool / v_pool (NB, bs, KV, hd) with float32 scales (NB, bs, KV) and
// positions pos_pool (NB, bs), through block_table (B, nb), under the
// cursor guard of paged_prefill_pool_launch; then the chunk's k / v (B,
// Lc, KV, hd) in the dtype of q and kpos (B, Lc).
extern "C" int paged_prefill_pool_int8_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale_pool, const void* v_scale_pool, const void* pos_pool,
    const void* block_table, const void* start, int start_all, int nb,
    int bs, const void* k, const void* v, const void* kpos, const void* qpos,
    void* out, int B, int S, int Lc, int H, int KV, int hd, int TQ,
    int window, float scale, int tiles_per_piece, int n_pieces,
    void* part_acc, void* part_ml, void* stream) {
  using namespace repro_torch;
  if (nb < 0 || bs < 1 || Lc < 0) return (int)cudaErrorInvalidValue;
  const PagedPrefix pre = pool_prefix(k_pool, v_pool, k_scale_pool,
                                      v_scale_pool, pos_pool, block_table,
                                      start, start_all, nb, bs);
  return launch_entry<true>(dtype, q, k, v, kpos, qpos, out, B, S, Lc, H, KV,
                            hd, TQ, window, scale, tiles_per_piece, n_pieces,
                            part_acc, part_ml, pre,
                            static_cast<cudaStream_t>(stream));
}

extern "C" size_t paged_prefill_int8_smem_bytes(int dtype, int H, int KV,
                                                int hd, int TQ) {
  if (dtype == 1) return repro_torch::mma::smem_bytes(hd, true);
  return repro_torch::tile_smem_bytes(TQ * (H / KV), repro_torch::kTK, hd);
}
