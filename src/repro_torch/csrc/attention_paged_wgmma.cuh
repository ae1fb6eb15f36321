// The ragged prefill's bf16 tile on Hopper's tensor cores, for launches
// of more than 16 query rows (chunks, verify windows): paged_prefill.cuh
// sends TQ * g > 16 here and the decode shapes (16 rows or fewer) to the
// mma.sync tile's kWarpKeys path (attention_mma.cuh).
//
// A CTA of two warpgroups serves up to 64 query rows, each row one (query
// lane, group head) pair: row r = (lane s0 + r / g, head kvh * g + r % g),
// so every K/V tile is read once per head group and query tile.  It walks
// one piece of its query tile's key lanes in tiles of 64 keys over the
// concatenated keys: the prefix [0, Lp) (block-pool rows read through the
// table, int8 rows under kQuant) then the chunk's [Lp, Sk).
//
//   * warpgroup 1 is the producer (setmaxnreg down to
//     paged_producer_regs, its registers given to the consumer).  A
//     pool key's row is found through the block table one row at a time
//     (engines use blocks of 16, and a tile may straddle Lp, a multiple of
//     the block size and not of 64), so no tensor map describes a tile:
//     each of its warps looks up all 64 keys of a tile (two a lane), their
//     pool rows and guarded positions two tiles and one tile ahead of the
//     copies, decides from the positions whether some query of the CTA
//     can see the tile (the superset test of the mma.sync tile), and
//     copies its 16 rows of a live tile with 16-byte cp.async straight
//     into the swizzled layout the wgmma descriptors read (128-, 64- or
//     32-byte rows, as flash's TMA writes them), a row's address taken
//     from the lane that looked it up (a shuffle).  Copies complete on the
//     slot's full barrier (cp.async.mbarrier.arrive.noinc), beside an
//     ordinary arrival that publishes the tile's positions and index.  A
//     tile no query can see is never copied, and a query tile of padding
//     lanes alone copies no key;
//   * the ring holds stages(hd) slots (four below head_dim 128, two at
//     128, one at 256), each a K and a V buffer with full and free
//     mbarriers (K full, V full, K free, V free), and beside K the tile's
//     64 guarded positions and its index; a last slot with index -1 ends
//     the walk, so the consumer walks the producer's live tiles;
//   * warpgroup 0 is the consumer: S = Q.K^T is wgmma m64n64k16 with Q
//     and K straight from shared memory, float32 sums in registers; the
//     masked online softmax runs in registers from the staged positions
//     (a tile is masked only where some key can be invisible to the warp's
//     16 rows), base 2 with the scale folded in, NEG_INF = -2**30, a
//     masked p exactly 0; K's slot is freed once S is masked; P.V is
//     wgmma m64nHDk16 with P rounded once to bf16 as the register A
//     operand (one product a 16-key step: the plain version contracts
//     values in v's dtype) and V read transposed (MN-major) from its slot;
//   * int8 (kQuant): the producer copies a prefix key's int8 16-byte chunk
//     into the second of the two bf16 chunks it will fill (so a lane stages
//     in place what only it converts) and its float32 scale beside the
//     positions; once its copies land (cp.async.wait_group, a tile behind
//     the next tile's copies where the ring has two slots or more) the lane
//     converts its chunks into the bf16 slot, int8 times the scale in
//     float32 rounded to bf16 (the reference's _dequantize_kv; int8 ->
//     float32 by a byte permute), fences them for the async proxy and
//     arrives.  The conversion leaves the consumer's critical path, and
//     the launch equals the bf16 launch over the dequantized keys bit for
//     bit;
//   * each consumer thread writes its two rows' outputs (or a split
//     piece's float32 (m, l, acc)) from registers; rows that see no key
//     come out 0.
//
// Key-range split: the host planner (kernels/attention_split.py, with this
// tile's constants) cuts each query tile's key tiles into pieces of C
// tiles; the grid, the piece arithmetic (mma::key_range, pieces_of,
// locate) and the combine pass (mma::combine_pieces) are the mma.sync
// tile's, so a pool launch equals, bit for bit, the launch over the
// gathered and concatenated keys: the tiles, the skipped tiles and the
// arithmetic are the same.
#pragma once

#include "attention_mma.cuh"
#include "attention_wgmma.cuh"

namespace repro_torch {
namespace wg {

// The paged producer's registers (setmaxnreg): it keeps two tiles'
// lookups and the rows' addresses, where flash's producer issues TMA from
// one thread with 24; 40 at head_dim 256, whose consumer needs 216 for
// its accumulator of 128 (with its copy loops not unrolled, no instance
// spills: ptxas on an H100, PERF.md)
__host__ __device__ constexpr int paged_producer_regs(int hd) {
  return hd >= 256 ? 40 : 56;
}
// two CTAs an SM at every head dim: 128 registers a thread at launch, the
// consumer raised to what the producer gives up
constexpr int kPagedMinBlocks = 2;
__host__ __device__ constexpr int paged_consumer_regs(int hd) {
  return 2 * (65536 / (kThreads * kPagedMinBlocks) / 8 * 8) -
         paged_producer_regs(hd);
}

// Beside each slot's K buffer: the tile's 64 guarded key positions (-1:
// not a key of the piece), kQuant the prefix keys' K and V scales, and the
// tile's index (-1: the walk ends)
struct PagedAux {
  int pos[kTK];
  float k_scale[kTK];
  float v_scale[kTK];
  int tile;
  int pad;
};

// Q, the ring's K and V tiles, the slots' PagedAux, 1 + 4 * stages
// mbarriers; 1 KB of slack to align the tiles to the swizzle's 1,024 bytes
__host__ __device__ constexpr size_t paged_smem_bytes(int hd) {
  return (1 + 2 * (size_t)stages(hd)) * tile_bytes(hd) +
         (size_t)stages(hd) * sizeof(PagedAux) +
         (1 + 4 * (size_t)stages(hd)) * 8 + 1024;
}

__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src,
                                              bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4_to(uint32_t dst, const void* src,
                                             bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// the barrier's phase waits for every cp.async this thread issued so far
// (the arrival is counted in the barrier's init count)
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
// order this thread's generic-proxy shared-memory writes (and those it
// has observed) before the async proxy's reads: wgmma reads its operands
// through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Attend one piece of one query tile of the ragged prefill: blockIdx.x =
// (piece, KV head, batch row), piece slowest, as mma::attend_piece.
template <int HD, bool kQuant>
__device__ __forceinline__ void attend_paged(const mma::Params& p) {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128 || HD == 256,
                "head_dim");
  constexpr int kS = stages(HD);
  constexpr int kCol = col_dims(HD);
  constexpr uint32_t kRowB = kCol * sizeof(bf16);  // a swizzled row
  constexpr uint32_t kBlockB = kTK * kRowB;        // a column block
  constexpr uint32_t kTileB = (uint32_t)tile_bytes(HD);
  constexpr uint32_t kSwz = swizzle_mode(kRowB);
  constexpr uint32_t kSwzMask = kRowB == 128 ? 7 : kRowB == 64 ? 3 : 1;
  constexpr uint32_t kGroupB = 8 * kRowB;          // 8 rows: a swizzle atom
  constexpr int ND = HD / 8;                       // 8-dim output blocks
  constexpr int kChunks = HD / 8;                  // bf16 16-byte chunks a row
  constexpr int kNB = (16 * kChunks + 31) / 32;    // a lane's, 16 rows a warp
  constexpr int kC8 = HD / 16;                     // int8 16-byte chunks a row
  constexpr int kN8 = (16 * kC8 + 31) / 32;
  // full barriers: the producer's 128 threads arrive once each, and for
  // bf16 once more when their copies land
  constexpr int kFull = kQuant ? 128 : 256;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t sQ = (smem_addr(wg_smem) + 1023) & ~1023u;
  unsigned char* const gQ = wg_smem + (sQ - smem_addr(wg_smem));
  auto sK = [&](int st) { return sQ + (1 + 2 * st) * kTileB; };
  auto sV = [&](int st) { return sQ + (2 + 2 * st) * kTileB; };
  PagedAux* const aux =
      reinterpret_cast<PagedAux*>(gQ + (1 + 2 * kS) * kTileB);
  const uint32_t bars = smem_addr(aux + kS);
  const uint32_t fullQ = bars;
  auto fullK = [&](int st) { return bars + 8 * (1 + st); };
  auto fullV = [&](int st) { return bars + 8 * (1 + kS + st); };
  auto freeK = [&](int st) { return bars + 8 * (1 + 2 * kS + st); };
  auto freeV = [&](int st) { return bars + 8 * (1 + 3 * kS + st); };
  // byte offset of 16-byte chunk `ch` (8 dims) of row `row` in a tile, as
  // the swizzle the descriptors read lays it out
  auto swz = [](int row, int ch) -> uint32_t {
    const uint32_t off = (uint32_t)(ch / (kCol / 8)) * kBlockB +
                         (uint32_t)row * kRowB + (uint32_t)(ch % (kCol / 8)) * 16;
    return off ^ (((off >> 7) & kSwzMask) << 4);
  };

  const int bkv = p.B * p.KV;
  const int x = blockIdx.x / bkv;
  const int b = (blockIdx.x % bkv) / p.KV, kvh = blockIdx.x % p.KV;
  const int g = p.g;
  int qt, piece, npieces;
  mma::locate(p, x, qt, piece, npieces);
  const int s0 = qt * p.TQ, s_end = min(s0 + p.TQ, p.Sq);
  const int R = p.TQ * g;
  int klo, khi, tlo, thi;
  mma::key_range(p, qt, klo, khi);
  mma::pieces_of(p, qt, tlo, thi);
  const int ta = tlo + piece * p.C, tb = min(ta + p.C, thi);
  const int key_lo = max(klo, ta * kTK), key_hi = min(khi, tb * kTK);
  const int lp = p.pre.Lp, lc = p.Sk - p.pre.Lp;
  const int tid = threadIdx.x, lane = tid % 32;

  if (tid == 0) {
    mbar_init(fullQ, 128);
#pragma unroll
    for (int st = 0; st < kS; ++st) {
      mbar_init(fullK(st), kFull);
      mbar_init(fullV(st), kFull);
      mbar_init(freeK(st), kRows * 2);   // every consumer thread
      mbar_init(freeV(st), kRows * 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ------------------------------------------------------ the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        paged_producer_regs(HD)));
    const int w = (tid - 128) / 32;
    // Q's rows, zeros past the real ones
    for (int c = tid - 128; c < kRows * kChunks; c += 128) {
      const int r = c / kChunks, ch = c % kChunks;
      const int s = s0 + r / g;
      const bool ok = r < R && s < s_end;
      const bf16* src = p.q;
      if (ok)
        src += b * p.qs.b + (kvh * g + r % g) * p.qs.h + s * p.qs.s + ch * 8;
      cp_async16_to(sQ + swz(r, ch), src, ok);
    }
    cp_async_arrive_noinc(fullQ);
    // the CTA's query positions (every warp the same)
    int clo = 0x7fffffff, chi = -1;
    for (int s = s0 + lane; s < s_end; s += 32) {
      const int pos = __ldg(p.qpos + (size_t)b * p.Sq + s);
      clo = min(clo, pos);
      chi = max(chi, pos);
    }
    clo = __reduce_min_sync(0xffffffffu, clo);
    chi = __reduce_max_sync(0xffffffffu, chi);
    const int start_b = row_start(p.pre, b);

    // a lane's keys of tile t: t * 64 + lane and t * 64 + 32 + lane; the
    // pool rows (prefix keys of the piece, else 0), then the raw
    // positions (-1 outside the piece), each a load issued a tile before
    // its use
    auto rows_of = [&](int t, int (&rw)[2]) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = t * kTK + 32 * i + lane;
        rw[i] = t < tb && j >= key_lo && j < key_hi && j < lp
                    ? (int)prefix_row(p.pre, b, j)
                    : 0;
      }
    };
    auto raw_pos = [&](int t, const int (&rw)[2], int (&ps)[2]) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = t * kTK + 32 * i + lane;
        const int* src = j < lp ? p.pre.pos + rw[i]
                                : p.kpos + (size_t)b * lc + (j - lp);
        ps[i] = t < tb && j >= key_lo && j < key_hi ? __ldg(src) : -1;
      }
    };
    // bf16 rows kk = 16 w + rr of tile t into `dst`: the pool's (prefix
    // keys) or the chunk's; a row's pool row from the lane holding it;
    // keys outside the piece zero-filled
    const bf16* const pk = static_cast<const bf16*>(p.pre.k);
    const bf16* const pv = static_cast<const bf16*>(p.pre.v);
    auto copy_rows = [&](uint32_t dst, const bf16* pool, const bf16* chunk,
                         const mma::Strides& cs, int t, int rrow) {
#pragma unroll 1
      for (int i = 0; i < kNB; ++i) {
        const int c = lane + 32 * i;
        const int rr = c / kChunks, ch = c % kChunks;
        const int kk = w * 16 + rr, j = t * kTK + kk;
        const int row = __shfl_sync(0xffffffffu, rrow, (w & 1) * 16 + rr);
        const bool ok = j >= key_lo && j < key_hi;
        const bf16* src = p.q;
        if (ok)
          src = j < lp ? pool + ((long long)row * p.KV + kvh) * HD + ch * 8
                       : chunk + b * cs.b + kvh * cs.h +
                             (long long)(j - lp) * cs.s + ch * 8;
        cp_async16_to(dst + swz(kk, ch), src, ok);
      }
    };
    // kQuant: a prefix key's int8 chunk c8 lands where its second bf16
    // chunk goes (2 c8 + 1); chunk keys' bf16 rows and keys outside the
    // piece (zeros) are copied as copy_rows does
    const int8_t* const pk8 = static_cast<const int8_t*>(p.pre.k);
    const int8_t* const pv8 = static_cast<const int8_t*>(p.pre.v);
    auto copy_rows8 = [&](uint32_t dst, const int8_t* pool, const bf16* chunk,
                          const mma::Strides& cs, int t, int rrow) {
#pragma unroll 1
      for (int i = 0; i < kN8; ++i) {
        const int c = lane + 32 * i;
        const int rr = min(c / kC8, 15), c8 = c % kC8;
        const int kk = w * 16 + rr, j = t * kTK + kk;
        const int row = __shfl_sync(0xffffffffu, rrow, (w & 1) * 16 + rr);
        if (c >= 16 * kC8) continue;     // head_dim 16: half the lanes
        const bool ok = j >= key_lo && j < key_hi;
        if (ok && j < lp) {
          cp_async16_to(dst + swz(kk, 2 * c8 + 1),
                        pool + ((long long)row * p.KV + kvh) * HD + c8 * 16,
                        true);
          continue;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bf16* src = p.q;
          if (ok)
            src = chunk + b * cs.b + kvh * cs.h + (long long)(j - lp) * cs.s +
                  (2 * c8 + h) * 8;
          cp_async16_to(dst + swz(kk, 2 * c8 + h), src, ok);
        }
      }
    };
    // kQuant, once tile t's copies in slot st have landed: each lane's
    // prefix chunks, int8 x scale in float32 rounded to bf16, in place
    auto convert = [&](uint32_t dst, const float* scales, int t) {
#pragma unroll 1
      for (int i = 0; i < kN8; ++i) {
        const int c = lane + 32 * i;
        const int rr = c / kC8, c8 = c % kC8;
        const int kk = w * 16 + rr, j = t * kTK + kk;
        if (c >= 16 * kC8 || j < key_lo || j >= key_hi || j >= lp) continue;
        const float sc = scales[kk];
        uint4* const hi =
            reinterpret_cast<uint4*>(gQ + (dst - sQ) + swz(kk, 2 * c8 + 1));
        uint4* const lo =
            reinterpret_cast<uint4*>(gQ + (dst - sQ) + swz(kk, 2 * c8));
        const uint4 raw = *hi;
        const uint32_t u[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                               raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
        uint32_t o[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[2 * e] = mma::dequant_pair_u<0>(u[e], sc, sc);
          o[2 * e + 1] = mma::dequant_pair_u<2>(u[e], sc, sc);
        }
        *lo = make_uint4(o[0], o[1], o[2], o[3]);
        *hi = make_uint4(o[4], o[5], o[6], o[7]);
      }
    };
    // kQuant: the scales of the warp's 16 keys, K's by lanes 0-15 and
    // V's by lanes 16-31, beside the positions
    auto copy_scales = [&](int st, int t, int rrow) {
      const int rr = lane % 16, kk = w * 16 + rr, j = t * kTK + kk;
      const int row = __shfl_sync(0xffffffffu, rrow, (w & 1) * 16 + rr);
      const bool ok = j >= key_lo && j < key_hi && j < lp;
      const float* const sb = lane < 16 ? p.pre.k_scale : p.pre.v_scale;
      float* const d = lane < 16 ? aux[st].k_scale : aux[st].v_scale;
      cp_async4_to(smem_addr(d + kk),
                   ok ? sb + (long long)row * p.KV + kvh : p.pre.k_scale, ok);
    };
    auto finish8 = [&](int st, int t) {
      __syncwarp();                      // the warp's scales are visible
      convert(sK(st), aux[st].k_scale, t);
      fence_proxy_async();
      mbar_arrive(fullK(st));
      convert(sV(st), aux[st].v_scale, t);
      fence_proxy_async();
      mbar_arrive(fullV(st));
    };

    int rw[2], nrw[2], nnrw[2], ps[2], nps[2];
    rows_of(ta, rw);
    raw_pos(ta, rw, ps);
    rows_of(ta + 1, nrw);
    int st = 0, pend = -1, pend_st = 0;
    uint32_t par = 0;
    // a query tile of padding lanes alone sees no key
    const int t_end = chi >= 0 ? tb : ta;
    for (int t = ta; t < t_end; ++t) {
      raw_pos(t + 1, nrw, nps);
      rows_of(t + 2, nnrw);
      int pos[2];
      bool any = false;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = t * kTK + 32 * i + lane;
        pos[i] = j < lp ? guard_pos(ps[i], start_b) : ps[i];
        // visible to some query of the CTA: a superset test
        any |= pos[i] >= 0 && pos[i] <= chi &&
               (p.window == 0 || clo - pos[i] < p.window);
      }
      if (__any_sync(0xffffffffu, any)) {
        const int rrow = w < 2 ? rw[0] : rw[1];
        mbar_wait(freeK(st), par ^ 1);
        if (w == 0) {
          aux[st].pos[lane] = pos[0];
          aux[st].pos[32 + lane] = pos[1];
          if (lane == 0) aux[st].tile = t;
        }
        if constexpr (kQuant) {
          copy_rows8(sK(st), pk8, p.k, p.ks, t, rrow);
          copy_scales(st, t, rrow);
          mma::cp_async_commit();
          if (kS > 1 && pend >= 0) {
            // the tile before lands while this one's K copies are in
            // flight, and is converted before this one waits for its V
            // buffer
            mma::cp_async_wait<1>();
            finish8(pend_st, pend);
          }
          mbar_wait(freeV(st), par ^ 1);
          copy_rows8(sV(st), pv8, p.v, p.vs, t, rrow);
          mma::cp_async_commit();
          if (kS == 1) {
            mma::cp_async_wait<0>();
            finish8(st, t);
          }
          pend = t;
          pend_st = st;
        } else {
          copy_rows(sK(st), pk, p.k, p.ks, t, rrow);
          cp_async_arrive_noinc(fullK(st));
          mbar_arrive(fullK(st));
          mbar_wait(freeV(st), par ^ 1);
          copy_rows(sV(st), pv, p.v, p.vs, t, rrow);
          cp_async_arrive_noinc(fullV(st));
          mbar_arrive(fullV(st));
        }
        if (++st == kS) {
          st = 0;
          par ^= 1;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rw[i] = nrw[i];
        ps[i] = nps[i];
        nrw[i] = nnrw[i];
      }
    }
    if constexpr (kQuant) {
      if (kS > 1 && pend >= 0) {
        mma::cp_async_wait<0>();
        finish8(pend_st, pend);
      }
    }
    // the end of the walk
    mbar_wait(freeK(st), par ^ 1);
    if (tid == 128) aux[st].tile = -1;
    if constexpr (!kQuant) cp_async_arrive_noinc(fullK(st));
    mbar_arrive(fullK(st));
    return;
  }
  constexpr int kConsumerRegs = paged_consumer_regs(HD);
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // ------------------------------------------------------- the consumer
  // warp w owns rows [16 w, 16 w + 16)
  const int warp = tid / 32;
  const int rbase = warp * 16;
  auto row_query = [&](int r) -> int {
    const int s = s0 + r / g;
    return r < R && s < s_end ? s : -1;
  };
  auto query_pos = [&](int s) -> int {
    return __ldg(p.qpos + (size_t)b * p.Sq + s);
  };
  // the thread's two rows' query positions, the warp's rows' range
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = row_query(rbase + lane / 4 + 8 * i);
    qp[i] = s >= 0 ? query_pos(s) : -1;
  }
  int wlo, whi;
  {
    const int s = lane < 16 ? row_query(rbase + lane) : -1;
    const int pos = s >= 0 ? query_pos(s) : 0;
    wlo = __reduce_min_sync(0xffffffffu, s >= 0 ? pos : 0x7fffffff);
    whi = __reduce_max_sync(0xffffffffu, s >= 0 ? pos : -1);
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  // K-major descriptors of Q and of a K slot; k-step kk reads dims [16 kk,
  // 16 kk + 16): column block 16 kk / kCol, 32 bytes a step within it
  const uint64_t dq = make_desc(sQ, 16, kGroupB, kSwz);
  auto dim_off = [](int kk) -> uint32_t {
    return ((kk * 16 / kCol) * kBlockB + (kk * 16 % kCol) * sizeof(bf16)) >> 4;
  };
  auto issue_qk = [&](float (&s)[32], int st) {
    const uint64_t dk = make_desc(sK(st), 16, kGroupB, kSwz);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(s, dq + dim_off(kk), dk + dim_off(kk), kk > 0);
  };
  // acc += P V from slot st: V read MN-major, 16 keys a step, P rounded
  // once to bf16; leading offset the next 64-dim column block, stride
  // offset the next 8 keys
  auto issue_pv = [&](const uint32_t (&ph)[4][4], int st) {
    const uint64_t dv = make_desc(sV(st), kBlockB, kGroupB, kSwz);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = dv + ((kk * 16 * kRowB) >> 4);
      if constexpr (HD <= 128) {
        wgmma_rs<HD>(acc, ph[kk], d, 1);
      } else {
        wgmma_rs<128>(acc, ph[kk], d, 1);
        wgmma_rs<128>(acc + 64, ph[kk], d + ((2 * kBlockB) >> 4), 1);
      }
    }
  };

  // S = Q K^T over slot st's 64 keys into s (committed, not waited for)
  auto start_qk = [&](float (&s)[32], int st) {
    fence_proxy_async();
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
    issue_qk(s, st);
    wgmma_commit();
  };
  // mask the scores of slot st from its staged positions (-1: outside the
  // piece), then free its K buffer: is every key of the tile visible to
  // every real row of the warp?
  auto mask = [&](float (&s)[32], int st) {
    const int* const kp = aux[st].pos;
    bool full;
    {
      const int a = kp[lane], c = kp[32 + lane];
      const int lo = __reduce_min_sync(0xffffffffu, min(a, c));
      const int hi = __reduce_max_sync(0xffffffffu, max(a, c));
      full = lo >= 0 && hi <= wlo && (p.window == 0 || whi - lo < p.window);
    }
    // row i of the thread: elements 4n + 2i and 4n + 2i + 1 of 8-key
    // block n
    if (!full) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = (j / 4) * 8 + (lane % 4) * 2 + (j & 1);
        s[j] = visible(kp[c], qp[(j / 2) % 2], p.window) ? s[j] : kNegInf;
      }
    }
    mbar_arrive(freeK(st));   // the next K copy overlaps what follows
  };
  // fold the masked scores into the running max and sum: s = p =
  // 2**(s * scale_log2 - m) in place, alpha = the old rows' rescale
  auto softmax = [&](float (&s)[32], float (&alpha)[2]) {
    float mx[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[i] = row_reduce<true>(s, i);
    // the scale is positive, so the raw row max scales to the scaled one;
    // p = 2**(s * scale_log2 - m) is one FFMA and one ex2
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new =
          fmaxf(m_run[i], mx[i] == kNegInf ? kNegInf : mx[i] * p.scale_log2);
      alpha[i] = fast_exp2(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float v = s[j];
      s[j] = v == kNegInf
                 ? 0.f
                 : fast_exp2(fmaf(v, p.scale_log2, -m_run[(j / 2) % 2]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l_run[i] = l_run[i] * alpha[i] + row_reduce<false>(s, i);
  };
  // rescale only where some row's max moved
  auto rescale = [&](const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[4 * n] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }
    }
  };
  // P's accumulator fragments of keys [16 kk, 16 kk + 16) are the A
  // fragment of k-step kk, rounded once to bf16
  auto pack = [&](const float (&s)[32], uint32_t (&ph)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ph[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  };
  // acc += P V from slot st (committed, not waited for)
  auto start_pv = [&](uint32_t (&ph)[4][4], int st) {
    fence_proxy_async();
    fence_regs(acc);
    fence_regs(ph);
    wgmma_fence();
    issue_pv(ph, st);
    wgmma_commit();
  };

  mbar_wait(fullQ, 0);
  fence_proxy_async();
  float s[32];
  uint32_t ph[4][4];
  float alpha[2];
  int st = 0;
  uint32_t par = 0;
  // the producer's live tiles, slot by slot, to its closing index -1
  for (;;) {
    mbar_wait(fullK(st), par);
    if (aux[st].tile < 0) break;
    start_qk(s, st);
    wgmma_wait<0>();
    fence_regs(s);
    mask(s, st);
    softmax(s, alpha);
    rescale(alpha);
    pack(s, ph);
    mbar_wait(fullV(st), par);
    start_pv(ph, st);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ph);
    mbar_arrive(freeV(st));
    if (++st == kS) {
      st = 0;
      par ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  // a piece of a split query tile writes (m, l, acc) partials; each thread
  // writes its two rows from registers
  const long long part = ((long long)(blockIdx.x % bkv) * p.n_pieces + x) * R;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rbase + lane / 4 + 8 * i;
    const int s = row_query(r);
    if (s < 0) continue;
    const int d = (lane % 4) * 2;
    if (npieces == 1) {
      const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
      bf16* const o =
          p.out + b * p.os.b + (kvh * g + r % g) * p.os.h + s * p.os.s + d;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + n * 8) = __floats2bfloat162_rn(
            acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    } else {
      float* const a = p.part_acc + (part + r) * HD + d;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(a + n * 8) =
            make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
      if (lane % 4 == 0) p.part_ml[part + r] = make_float2(m_run[i], l_run[i]);
    }
  }
}

}  // namespace wg
}  // namespace repro_torch
