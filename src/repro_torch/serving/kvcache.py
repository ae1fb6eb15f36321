"""KV-cache management on the serving side: slots and block pools.

The slot engine's cache is batched (leading batch axis = slots):
``SlotManager`` tracks which slots are live and ``write_slot`` splices a
request's prefill cache (attention strips, or mamba and rwkv6 states)
into its slot.  Freed slots are not zeroed: the
next admission's splice overwrites the whole strip, ``pos`` -1 lanes
included, so stale keys can never win the attention mask.

For the paged engine, ``BlockAllocator`` owns the physical-block free
list and refcounts, and the functions after it are the host-side pool
edits the engine makes.  Pools follow the stack layout
(``transformer.stack_pool_init``): "periods" leaves lead with
``n_periods`` then (num_blocks, block_size, ...), "rem" leaves start at
(num_blocks, block_size, ...).

``SlotManager`` and ``BlockAllocator`` are copies of the reference's
(which live in a module that imports JAX).  Every edit writes the cache
or pool tensors in place where the reference rebuilds them with
``dynamic_update_slice`` or ``.at[].set``, and returns them so call
sites read as in the reference.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

import torch


class SlotManager:
    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self._free: List[int] = list(range(num_slots))
        self._live: set = set()

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        s = self._free.pop(0)
        self._live.add(s)
        return s

    def free(self, slot: int) -> None:
        self._live.discard(slot)
        self._free.append(slot)
        self._free.sort()

    @property
    def live(self) -> List[int]:
        return sorted(self._live)

    @property
    def num_free(self) -> int:
        return len(self._free)


def write_slot(batched_cache: Any, single_cache: Any, slot: int) -> Any:
    """Splice a batch-1 cache (``Model.prefill``'s) into slot ``slot`` of
    the batched cache, in place.  The whole strip is written, ``pos`` -1
    lanes included: that is what kills the previous occupant's lanes
    (dead slots decode at position 0 and write lane 0 every step).
    "periods" leaves carry the batch on axis 1 behind the leading
    ``n_periods`` axis, "rem" leaves on axis 0."""
    for group, lead in (("periods", (slice(None),)), ("rem", ())):
        for name, node in batched_cache[group].items():
            for key, big in node.items():
                big[lead + (slot,)] = single_cache[group][name][key][
                    lead + (0,)]
    return batched_cache


class BlockAllocator:
    """Free-list + reference counts over physical KV blocks.  Block 0 is
    the reserved NULL block (block tables pad with it; its pos lanes stay
    -1 forever), so allocatable ids are ``1..num_blocks-1``.

    A block may be held by several owners at once — N requests sharing a
    prompt prefix plus the prefix cache.  ``alloc`` hands out blocks at
    refcount 1, ``incref`` adds a holder, ``free`` drops one hold per
    listed block and returns a block to the free list only when the last
    holder lets go.

    The free list is a FIFO deque: ``free`` appends, ``alloc`` pops from
    the left — O(1) per block and deterministic (blocks are reused in the
    order they were released).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 1 allocatable block + the null block")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: deque = deque(range(1, num_blocks))
        self._ref: Dict[int, int] = {}

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache entries (>= 1)."""
        return max(1, -(-n_tokens // self.block_size))

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks at refcount 1, or None (all-or-nothing) if
        the pool can't cover the request."""
        if n > len(self._free):
            return None
        blocks = [self._free.popleft() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        return blocks

    def incref(self, block: int) -> None:
        """Add a holder to a live block (sharing a cached prefix)."""
        assert block in self._ref, f"incref of free block {block}"
        self._ref[block] += 1

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def free(self, blocks: List[int]) -> List[int]:
        """Drop one hold per listed block.  Returns the blocks whose last
        holder just released them (the ones that went back to the free
        list and need their pool lanes invalidated)."""
        released = []
        for b in blocks:
            assert b in self._ref, f"double free of block {b}"
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)
                released.append(b)
        return released

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return len(self._ref)

    @property
    def num_usable(self) -> int:
        return self.num_blocks - 1          # null block is never usable


# trailing (non-block) axes per pool-leaf name: leaves are shaped
# (..., num_blocks, block_size, *tail), so the block axis is located
# from the right.
_POOL_LEAF_TAIL = {"pos": 0, "k_s": 1, "v_s": 1, "k": 2, "v": 2}


def _ids(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.long, device=device)


# recurrent-state pool leaves (mamba: h, conv; rwkv6: s, x_tm, x_cm): one
# slot per engine row on the leaf's batch axis, not token blocks
_STATE_LEAVES = frozenset({"h", "conv", "s", "x_tm", "x_cm"})


def write_chunk_tokens(pools: Any, caches: Any, src_rows: Any,
                       src_lanes: Any, dst_blocks: Any,
                       dst_lanes: Any, state_rows: Any = None) -> Any:
    """Batched ragged-chunk writeback: scatter every listed token of a
    chunk-batch prefill cache (``Model.prefill_paged``) into its
    (physical block, lane) pool home — one gather and one scatter per
    pool leaf for the whole batch.

    ``src_rows[t], src_lanes[t]`` address token ``t`` on the cache's
    (batch, seq) axes; ``dst_blocks[t], dst_lanes[t]`` its pool home.
    Only the listed lanes are touched.  Callers route padding lanes to
    the null block (and scrub it after): duplicate (block, lane) pairs
    there race, harmlessly.  In place (the reference rebuilds the pools
    with ``.at[].set``).

    Recurrent-state leaves hold per-request slots instead of token
    blocks: the cache carries one chunk-exit state per dispatch row and
    ``state_rows`` (B,) maps row i to its slot.  The engine routes padded
    dispatch rows to the pool's trash slot (its last row), so duplicate
    writes land only there, in no defined order, and are never read.

    "periods" leaves have batch at axis 1 behind the leading
    ``n_periods`` axis, "rem" leaves at axis 0; pool leaves put
    (num_blocks, block_size) at those same axes.

    An int8 pool leaf takes int8 values only: a floating-point chunk
    cache (one not quantized by ``Model.prefill_paged``) raises rather
    than being truncated by the cast.
    """
    def walk(pnode, cnode, lead):
        for name, pleaf in pnode.items():
            if isinstance(pleaf, dict):
                walk(pleaf, cnode[name], lead)
                continue
            dev = pleaf.device
            if name in _STATE_LEAVES:
                assert state_rows is not None, "state pools need state_rows"
                pleaf[lead + (_ids(state_rows, dev),)] = \
                    cnode[name].to(pleaf.dtype)
                continue
            if pleaf.dtype == torch.int8 and cnode[name].dtype != torch.int8:
                raise TypeError(
                    f"write_chunk_tokens: pool leaf {name!r} is int8 but "
                    f"the chunk cache's is {cnode[name].dtype}; an int8 "
                    "pool takes the quantized chunk cache")
            sr, sl = _ids(src_rows, dev), _ids(src_lanes, dev)
            db, dl = _ids(dst_blocks, dev), _ids(dst_lanes, dev)
            vals = cnode[name][lead + (sr, sl)].to(pleaf.dtype)
            pleaf[lead + (db, dl)] = vals

    walk(pools.get("periods", {}), caches.get("periods", {}),
         (slice(None),))
    walk(pools.get("rem", {}), caches.get("rem", {}), ())
    return pools


def _walk_leaves(node, fn) -> None:
    for name, leaf in node.items():
        if isinstance(leaf, dict):
            _walk_leaves(leaf, fn)
        else:
            fn(name, leaf)


def copy_blocks(pools: Any, src_ids: List[int], dst_ids: List[int]) -> Any:
    """Copy whole physical blocks ``src -> dst`` in every layer pool, in
    place — the copy-on-write mechanism: before a request writes into a
    block it shares with the prefix cache, the engine copies the donor
    block into a private one.  Diverged tail lanes copied along are
    masked by reads (``pos >= start``) until overwritten.  An int8
    pool's scale leaves (``k_s``, ``v_s``) travel with their blocks."""
    def copy(name, leaf):
        ax = leaf.dim() - 2 - _POOL_LEAF_TAIL[name]
        pre = (slice(None),) * ax
        src, dst = _ids(src_ids, leaf.device), _ids(dst_ids, leaf.device)
        leaf[pre + (dst,)] = leaf[pre + (src,)]

    _walk_leaves(pools, copy)
    return pools


def invalidate_blocks(pools: Any, block_ids: List[int]) -> Any:
    """Kill freed blocks' attention validity (pos lanes -> -1), in place,
    so a block handed to a growing request mid-decode can't leak its
    previous owner's positions."""
    def kill(name, leaf):
        if name == "pos":
            leaf[..., _ids(block_ids, leaf.device), :] = -1

    _walk_leaves(pools, kill)
    return pools


def invalidate_lanes(pools: Any, block_ids: Any, lanes: Any) -> Any:
    """Kill individual (block, lane) pairs' attention validity (pos ->
    -1), in place.  Only ``pos`` leaves are touched: k/v payload lanes
    are inert once ``pos`` is -1."""
    def kill(name, leaf):
        if name == "pos":
            leaf[..., _ids(block_ids, leaf.device),
                 _ids(lanes, leaf.device)] = -1

    _walk_leaves(pools, kill)
    return pools


def scrub_null_block(pools: Any) -> Any:
    """Reset the null block's validity lanes (``pos[..., 0, :] -> -1``),
    in place.  Block 0 is the engine's garbage sink: padded block-table
    entries point at it and the ragged dispatch's writeback routes every
    padding lane there, so its ``pos`` lanes must be restored to -1 in
    the same dispatch."""
    def scrub(name, leaf):
        if name == "pos":
            leaf[..., 0, :] = -1

    _walk_leaves(pools, scrub)
    return pools
