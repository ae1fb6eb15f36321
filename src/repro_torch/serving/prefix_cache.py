"""Prefix-sharing KV cache: radix-tree block reuse over the paged pool.

Multi-tenant serving traffic is dominated by shared prompt prefixes —
system prompts, few-shot headers, the paper's repeated canvas
preprocessing requests.  Recomputing that prefix KV per request wastes
the dominant share of prefill FLOPs, so the tree below remembers, per
*full block* of ``block_size`` tokens, which physical block of the paged
pool already holds that KV:

    root ──(tok[0:bs])──> node{block 7} ──(tok[bs:2bs])──> node{block 3}
                                        └─(tok'[bs:2bs])─> node{block 9}

* **Keys are exact token tuples**, not lossy hashes — a hash collision
  would silently serve another request's KV, breaking token identity.
  (Python interns the tuple hash for the dict lookup, which is the
  "per-block token hash" in practice; equality still compares tokens.)
* **Sharing is refcounted in ``BlockAllocator``**: the tree holds one
  reference on each published block, every request that maps the block
  into its table holds another.  A request finishing decrefs; the block
  only returns to the free list when the tree lets go too (eviction).
* **Partial matches are served by copy-on-write**: when a request
  diverges *inside* the next block (shares ``j < block_size`` leading
  tokens with a cached block), the engine copies the donor block into a
  private one (``kvcache.copy_blocks``) and prefills only the diverged
  tail at in-block offset ``j``.
* **Eviction is LRU over leaves no request holds** (refcount 1 — the
  tree is the sole holder).  Interior nodes are never evicted before
  their children: a child block's KV is only valid underneath its full
  prefix, so eviction cascades leaf-first.

The engine-facing protocol (``PagedLLMEngine``):

    match(tokens)   -> MatchResult          (admit path: LRU + stats)
    probe(tokens)   -> MatchResult          (admission check: read-only)
    insert(tokens, blocks, allocator)       (publish full prefix blocks)
    evict(n, allocator) -> released blocks  (before any preemption)
    evictable(allocator, exclude) -> int    (admission headroom)

Gauges ``hit_rate`` / ``cached_blocks`` / ``evictions`` surface through
``engine.stats()`` -> balancer -> serve CLI (see the stats schema note
in ``serving/server.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple


def chain_hashes(tokens: Sequence[int], block_size: int) -> List[int]:
    """Rolling per-block prefix keys: ``out[m] = hash((out[m-1],
    tokens[m*bs:(m+1)*bs]))`` over the *full* blocks of ``tokens`` —
    the hashed form of exactly the per-block token tuples the radix
    tree keys on, with the chain making each hash identify the whole
    prefix up to that block (two different prefixes sharing one block's
    tokens get different chain values).

    This is the cluster routing tier's affinity key: hashes are cheap
    to index fleet-wide, and because routing only *picks a replica*
    (the replica's own radix tree still compares exact token tuples),
    a hash collision can at worst misroute one request to a colder
    replica — it can never serve wrong KV.  Python's int-tuple hash is
    deterministic across processes (``PYTHONHASHSEED`` only perturbs
    str/bytes), so two brokers compute identical chains."""
    bs = int(block_size)
    out: List[int] = []
    h = 0
    for m in range(len(tokens) // bs):
        h = hash((h, tuple(int(t) for t in tokens[m * bs:(m + 1) * bs])))
        out.append(h)
    return out


@dataclasses.dataclass
class MatchResult:
    """Longest cached prefix of a token sequence.

    ``blocks``: physical blocks covering matched *full* blocks, in
    prefix order.  ``partial_block``/``partial_len``: the best
    continuation inside the next block — a cached block sharing
    ``partial_len`` (``1 <= partial_len < block_size``) leading tokens
    with the remainder; ``partial_len == 0`` means no partial match.
    """

    blocks: List[int]
    partial_block: Optional[int] = None
    partial_len: int = 0


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key: Optional[Tuple[int, ...]], block: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class PrefixCache:
    def __init__(self, block_size: int):
        assert block_size >= 1
        self.block_size = block_size
        self._root = _Node(None, None, None)
        self._clock = 0
        self._nodes = 0
        self.hit_tokens = 0      # prompt tokens served from the tree
        self.miss_tokens = 0     # prompt tokens actually prefilled
        self.evictions = 0       # blocks evicted over the cache lifetime

    # ------------------------------------------------------------ gauges
    @property
    def cached_blocks(self) -> int:
        return self._nodes

    @property
    def hit_rate(self) -> float:
        total = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / total if total else 0.0

    def blocks(self) -> List[int]:
        """All physical blocks currently held by the tree (test hook and
        accounting aid; order unspecified)."""
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                out.append(child.block)
                stack.append(child)
        return out

    # ------------------------------------------------------------ match
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _walk(self, tokens: Sequence[int], touch: bool) -> MatchResult:
        bs = self.block_size
        tokens = [int(t) for t in tokens]
        now = self._tick() if touch else 0
        node, blocks, i = self._root, [], 0
        while i + bs <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + bs]))
            if child is None:
                break
            if touch:
                child.last_used = now
            blocks.append(child.block)
            node = child
            i += bs
        # best continuation inside the next block: the child sharing the
        # longest leading run with the remaining tokens (COW donor).
        rem = tokens[i:]
        best, best_len = None, 0
        if rem:
            for key, child in node.children.items():
                n = 0
                for a, b in zip(rem, key):
                    if a != b:
                        break
                    n += 1
                if n > best_len:
                    best, best_len = child, n
        if best is not None and touch:
            best.last_used = now            # keep the COW donor warm
        return MatchResult(blocks, best.block if best else None, best_len)

    def match(self, tokens: Sequence[int]) -> MatchResult:
        """Longest cached prefix for an admit: refreshes LRU stamps and
        records hit/miss token counts.  Callers must pass ``tokens``
        with whatever tail they need recomputed already trimmed (the
        engine reserves the last prompt token so the uncached suffix —
        whose logits produce the first output token — is never empty)."""
        m = self._walk(tokens, touch=True)
        matched = len(m.blocks) * self.block_size + m.partial_len
        self.hit_tokens += matched
        self.miss_tokens += len(tokens) - matched
        return m

    def probe(self, tokens: Sequence[int]) -> MatchResult:
        """``match`` without side effects (admission checks probe every
        scheduler step; only the actual admit should shift LRU order or
        the hit-rate gauges)."""
        return self._walk(tokens, touch=False)

    # ------------------------------------------------------------ insert
    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               allocator) -> int:
        """Publish a request's prefix blocks after prefill: ``blocks[m]``
        holds the KV of ``tokens[m*bs:(m+1)*bs]``; only whole blocks are
        inserted (a partial tail block keeps growing during decode and
        is never shared).  The tree takes one hold (``incref``) on each
        newly published block.  A key that already exists keeps its
        existing physical block — the caller's duplicate stays private
        to its request and is freed normally.  Returns the number of new
        nodes."""
        bs = self.block_size
        node = self._root
        now = self._tick()
        added = 0
        for m in range(min(len(tokens) // bs, len(blocks))):
            key = tuple(int(t) for t in tokens[m * bs:(m + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, blocks[m], node)
                node.children[key] = child
                allocator.incref(blocks[m])
                self._nodes += 1
                added += 1
            child.last_used = now
            node = child
        return added

    # ------------------------------------------------------------ evict
    def _lru_evictable_leaf(self, allocator) -> Optional[_Node]:
        victim, stack = None, [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                elif allocator.refcount(child.block) == 1:
                    if victim is None or child.last_used < victim.last_used:
                        victim = child
        return victim

    def evict(self, n: int, allocator) -> List[int]:
        """Evict up to ``n`` blocks, least-recently-used leaves first,
        touching only blocks no request holds (allocator refcount 1 —
        the tree is the sole holder).  Removing a leaf may expose its
        parent as the next candidate (cascade).  Returns the physical
        blocks released to the free list — the engine must invalidate
        their pool lanes before reuse."""
        released: List[int] = []
        while len(released) < n:
            victim = self._lru_evictable_leaf(allocator)
            if victim is None:
                break
            del victim.parent.children[victim.key]
            self._nodes -= 1
            self.evictions += 1
            released.extend(allocator.free([victim.block]))
        return released

    def evictable(self, allocator,
                  exclude: FrozenSet[int] = frozenset()) -> int:
        """Blocks eviction could reclaim right now: nodes whose block has
        no holder besides the tree AND whose whole subtree is likewise
        reclaimable (an unevictable child pins its ancestors).
        ``exclude`` marks blocks the caller is about to take a hold on
        (a request's own matched prefix + COW donor must not be counted
        as reclaimable headroom for that same request)."""

        def count(node: _Node) -> Tuple[int, bool]:
            total, subtree_ok = 0, True
            for child in node.children.values():
                c_total, c_ok = count(child)
                total += c_total
                subtree_ok = subtree_ok and c_ok
            if node is self._root:
                return total, subtree_ok
            if subtree_ok and node.block not in exclude and \
                    allocator.refcount(node.block) == 1:
                return total + 1, True
            return total, False

        return count(self._root)[0]
