"""The key-range split and operand checks shared by the bf16 attention
kernels.

``flash_attention`` and ``paged_prefill`` in bfloat16 run one CTA per
(batch row, KV head, query tile, piece of that tile's key range).  A
piece is a run of whole 64-key tiles; the kernel walks its tiles, and
where a query tile has several pieces each writes a partial softmax
state that one combine pass merges (``ref.attention_combine_ref`` is its
plain version).  This module is the planner: pure Python over the shape
and the card's SM count, so it runs (and is tested) without a card.  The
tile arithmetic mirrors ``csrc/attention_wgmma.cuh`` and
``csrc/attention_mma.cuh`` (``key_range``, ``pieces_of``, ``locate``;
the ragged prefill's Hopper tile, ``csrc/attention_paged_wgmma.cuh``,
uses the latter's).

It splits where the grid would otherwise leave SMs idle (fewer CTAs
than SMs: decode steps, short prompts) or where one query tile's range
is several times the mean (a long causal prompt whose last tiles see
every key), and, for the flash tile (``waves``), where a grid of at
least one CTA an SM leaves a partial last wave (whisper's 144 encoder
CTAs on 132 SMs).  The number of tiles a piece takes is then the one
that minimises a makespan model of the launch: a CTA costs its tiles
plus a fixed set-up and write-out, SMs run ``CTAS_PER_SM`` CTAs at full
speed (with ``waves``, the busiest SM holds ceil(CTAs / SMs) of the mean
CTA), and a split launch pays for the combine pass.  Its constants are
in 64-key tile times, read off an H100's kernel timings (PERF.md): the
ragged prefill's decode tile (mma.sync) has the defaults, its Hopper
tile ``PAGED_*`` and the flash tile ``FLASH_*``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import torch

MMA_HEAD_DIMS = (16, 32, 64, 128, 256)   # head dims the bf16 tile compiles
TILE_KEYS = 64          # keys per tile; piece boundaries fall on multiples
SKEW = 4                # split when a range exceeds this many times the mean
FIXED_TILES = 2.0       # a CTA's set-up and write-out, in tile times
COMBINE_TILES = 2.5     # the combine pass of a split launch, in tile times
CTAS_PER_SM = 1.25      # CTAs an SM runs at the speed of one alone
# the flash tile's (wgmma from a TMA ring, two CTAs an SM), fit by
# ``conv2d_compare.py --kernel flash_attention`` to an H100's times of
# forced piece lengths (PERF.md)
FLASH_FIXED_TILES = 1.5
FLASH_COMBINE_TILES = 6.0
FLASH_CTAS_PER_SM = 1.25
# the ragged prefill's Hopper tile (wgmma from a producer warpgroup's
# ring, two CTAs an SM; launches of more than 16 query rows), fit by
# ``conv2d_compare.py --kernel paged_prefill_pool``'s forced-piece sweep
# to an H100's times (PERF.md); the decode shapes keep the defaults above
PAGED_FIXED_TILES = 6.0
PAGED_COMBINE_TILES = 1.0
PAGED_CTAS_PER_SM = 1.75


def flash_key_ranges(sq: int, sk: int, tq: int, causal: bool,
                     window: int, prefix: int = 0) -> List[Tuple[int, int]]:
    """Keys [lo, hi) some query of each query tile of ``tq`` positions can
    see (``lo >= hi``: none); a causal ``prefix`` is seen by every query,
    so a tile before its end reads [0, prefix)."""
    out = []
    for s0 in range(0, sq, tq):
        s_end = min(s0 + tq, sq)
        lo = max(0, s0 - window + 1) if window else 0
        hi = min(sk, max(s_end, prefix)) if causal else sk
        out.append((lo, hi))
    return out


def paged_key_ranges(s: int, l: int, tq: int) -> List[Tuple[int, int]]:
    """Every query tile of the ragged prefill walks all ``l`` key lanes
    (which it can see depends on the positions, known only on the card)."""
    return [(0, l)] * -(-s // tq)


def tile_span(lo: int, hi: int) -> Tuple[int, int]:
    """The 64-key tiles [tlo, thi) holding keys [lo, hi)."""
    tlo = lo // TILE_KEYS
    return tlo, (-(-hi // TILE_KEYS) if hi > lo else tlo)


def pieces_of(lo: int, hi: int, tiles_per_piece: int) -> int:
    """Pieces of a query tile's range: one at least (an empty range still
    writes its zeros)."""
    tlo, thi = tile_span(lo, hi)
    return max(1, -(-(thi - tlo) // tiles_per_piece))


def piece_keys(lo: int, hi: int, tiles_per_piece: int,
               j: int) -> Tuple[int, int]:
    """Keys [a, b) piece ``j`` of range [lo, hi) reads (a >= b: none)."""
    tlo, thi = tile_span(lo, hi)
    ta = tlo + j * tiles_per_piece
    tb = min(ta + tiles_per_piece, thi)
    return max(lo, ta * TILE_KEYS), min(hi, tb * TILE_KEYS)


@dataclasses.dataclass(frozen=True)
class Plan:
    tiles_per_piece: int
    pieces: Tuple[int, ...]       # per query tile, in query-tile order

    @property
    def n_pieces(self) -> int:
        return sum(self.pieces)

    @property
    def split(self) -> bool:
        return self.n_pieces > len(self.pieces)

    def ctas(self, ctas_per_piece: int) -> int:
        return self.n_pieces * ctas_per_piece


def makespan(tiles: Sequence[int], tiles_per_piece: int,
             ctas_per_qtile: int, sms: int, *, fixed: float = FIXED_TILES,
             combine: float = COMBINE_TILES,
             ctas_per_sm: float = CTAS_PER_SM, waves: bool = False) -> float:
    """Modelled time of a launch, in tile times: the longest CTA, or the
    grid's work spread over the card, whichever is longer, plus the
    combine pass when a range is split.  ``waves``: the busiest SM holds
    ceil(CTAs / SMs) CTAs of the mean length, so a partial last wave
    costs a whole one.  The constants default to the ragged prefill's
    tile; the flash planner and ``paged_attention.plan`` pass their own
    (the latter in block times)."""
    pieces = [max(1, -(-t // tiles_per_piece)) for t in tiles]
    work = (sum(tiles) + fixed * sum(pieces)) * ctas_per_qtile
    if waves:
        n = sum(pieces) * ctas_per_qtile
        work *= -(-n // sms) * sms / n
    longest = min(tiles_per_piece, max(tiles)) + fixed
    split = combine if sum(pieces) > len(pieces) else 0.0
    return max(longest, work / (ctas_per_sm * sms)) + split


def plan(ranges: Sequence[Tuple[int, int]], ctas_per_qtile: int,
         sms: int, *, fixed: float = FIXED_TILES,
         combine: float = COMBINE_TILES, ctas_per_sm: float = CTAS_PER_SM,
         waves: bool = False) -> Plan:
    """Tiles per piece for key ranges ``ranges`` (one per query tile),
    each query tile launched ``ctas_per_qtile`` times (batch rows x KV
    heads), on a card of ``sms`` SMs, under ``makespan``'s model with the
    constants given (defaults: the ragged prefill's tile)."""
    tiles = [max(0, t[1] - t[0]) for t in (tile_span(*r) for r in ranges)]
    longest = max(tiles)
    mean = sum(tiles) / len(tiles)
    ctas = len(tiles) * ctas_per_qtile
    small = ctas < sms
    skewed = longest > SKEW * mean
    partial = waves and ctas % sms != 0
    c = max(longest, 1)
    if longest > 1 and (small or skewed or partial):
        # whole tiles per piece: 1, 2, 3, 4, 6, 8, 12, ... up to no split
        cands = sorted({longest} | {m << k for k in range(longest.bit_length())
                                    for m in (2, 3) if m << k < longest}
                       | {1})
        c = min(cands, key=lambda n: (makespan(
            tiles, n, ctas_per_qtile, sms, fixed=fixed, combine=combine,
            ctas_per_sm=ctas_per_sm, waves=waves), -n))
    return Plan(c, tuple(pieces_of(lo, hi, c) for lo, hi in ranges))

@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count(torch.device(device).index or 0)


def scratch(pl: Plan, bkv: int, rows: int, hd: int, device):
    """float32 partial-state buffers of a split launch, for ``bkv`` (batch
    row, KV head) pairs of ``rows`` query rows per query tile: (acc, (m,
    l) pairs), or () when nothing is split.  The caller keeps them until
    the launch is enqueued; the caching allocator orders their reuse
    after it on the stream."""
    if not pl.split:
        return ()
    n = bkv * pl.n_pieces * rows
    return (torch.empty(n * hd, dtype=torch.float32, device=device),
            torch.empty(n * 2, dtype=torch.float32, device=device))


def pointers(bufs) -> Tuple:
    """Data pointers of ``scratch``'s buffers, None for none."""
    return tuple(t.data_ptr() for t in bufs) if bufs else (None, None)


def check_mma_operands(check, hd: int, **tensors) -> None:
    """What the bf16 tiles take, else ``check`` raises: a compiled
    head_dim, 16-byte aligned base pointers and strides that keep every
    row 16-byte aligned (a dim of size 1 is never stepped): what the
    ragged prefill's 16-byte cp.async copies and the flash tile's tensor
    maps need."""
    check(hd in MMA_HEAD_DIMS,
          f"bfloat16 head_dim {hd} (the tensor-core tile takes "
          f"{', '.join(map(str, MMA_HEAD_DIMS))})")
    for name, t in tensors.items():
        check(t.data_ptr() % 16 == 0,
              f"{name} must start on a 16-byte boundary")
        check(all(t.stride(i) % 8 == 0 for i in range(t.dim() - 1)
                  if t.shape[i] > 1),
              f"{name}'s strides {tuple(t.stride())} must be multiples of "
              "8 elements")


def check_int8_operands(check, **tensors) -> None:
    """What the bf16 tile's int8 key segment takes, else ``check``
    raises: 16-byte aligned base pointers and rows (cp.async copies 16
    int8 elements)."""
    for name, t in tensors.items():
        check(t.data_ptr() % 16 == 0,
              f"{name} must start on a 16-byte boundary")
        check(all(t.stride(i) % 16 == 0 for i in range(t.dim() - 1)
                  if t.shape[i] > 1),
              f"{name}'s strides {tuple(t.stride())} must be multiples of "
              "16 elements")
