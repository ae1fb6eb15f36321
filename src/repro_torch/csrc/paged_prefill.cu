// paged_prefill over keys in the model dtype: the C entries of the
// launcher in paged_prefill.cuh, which holds its design note. The int8
// prefix's entries are paged_prefill_int8.cu, compiled on their own.
#include "paged_prefill.cuh"

// Contiguous keys (the slot decode's strip, tests): dtype: 0 = float32, 1
// = bfloat16. k / v (B, L, KV, hd), kpos (B, L). TQ: query lanes per CTA.
// bfloat16 only: tiles_per_piece and n_pieces from the wrapper's planner
// (n_pieces = the query tiles' piece counts summed; equal to ceil(S / TQ)
// when no range is split), part_acc (float32,
// B*KV*n_pieces*TQ*(H/KV)*hd) and part_ml (float32 pairs,
// B*KV*n_pieces*TQ*(H/KV)) scratch when split. Returns a cudaError_t (0
// = launched).
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
                             n_pieces, part_acc, part_ml, PagedPrefix{},
                             static_cast<cudaStream_t>(stream));
}

// The engine's entry: keys [0, nb * bs) read from the block pool k_pool /
// v_pool (NB, bs, KV, hd) in the dtype of q, positions pos_pool (NB, bs),
// through block_table (B, nb) int32, each position counted only below its
// row's cursor start[b] ((B,) int32; null: start_all for every row); then
// the chunk's k / v (B, Lc, KV, hd) and kpos (B, Lc); the rest as
// paged_prefill_launch, the split planned over nb * bs + Lc keys.
extern "C" int paged_prefill_pool_launch(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* pos_pool, const void* block_table, const void* start,
    int start_all, int nb, int bs, const void* k, const void* v,
    const void* kpos, const void* qpos, void* out, int B, int S, int Lc,
    int H, int KV, int hd, int TQ, int window, float scale,
    int tiles_per_piece, int n_pieces, void* part_acc, void* part_ml,
    void* stream) {
  using namespace repro_torch;
  if (nb < 0 || bs < 1 || Lc < 0) return (int)cudaErrorInvalidValue;
  const PagedPrefix pre = pool_prefix(k_pool, v_pool, nullptr, nullptr,
                                      pos_pool, block_table, start,
                                      start_all, nb, bs);
  return launch_entry<false>(dtype, q, k, v, kpos, qpos, out, B, S, Lc, H,
                             KV, hd, TQ, window, scale, tiles_per_piece,
                             n_pieces, part_acc, part_ml, pre,
                             static_cast<cudaStream_t>(stream));
}

extern "C" size_t paged_prefill_smem_bytes(int dtype, int H, int KV, int hd,
                                           int TQ) {
  if (dtype == 1)
    return repro_torch::bf16_smem_bytes(hd, TQ, H / KV, false);
  return repro_torch::tile_smem_bytes(TQ * (H / KV), repro_torch::kTK, hd);
}
