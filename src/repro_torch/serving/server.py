"""The Stratus digit-serving pipeline, and continuous-batching LLM
serving over fixed slots and a block-paged pool.

``StratusApp`` is the port of the reference's paper pipeline (Fig. 1/2)
under virtual time: client -> LoadBalancer (NGINX x3) -> Flask service
time -> Broker (Kafka x3 partitions) -> consumer (the real model, its
wall time charged to the clock) -> ResultStore (CouchDB) -> Flask poll.
Outcomes follow the paper's failure modes: 429 when the balancer or
Flask is saturated, 503 when a partition is full, 504 on a timeout.

The rest is the port of ``repro.serving.server``'s two engines for
decoder-only attention stacks.  ``LLMEngine`` is the slot baseline: one whole-prompt
prefill per admission (``Model.prefill``, the ``flash_attention``
kernel) or one decode step over every slot.  ``PagedLLMEngine`` is the
production path, with the reference's scheduler, block accounting,
prefix cache and bucketing.  On the same weights and prompts each emits
the tokens of its reference counterpart.  Each engine step is eager
PyTorch work on ``model.device``; greedy tokens come back to the host
as integers only.

The slot engine also serves recurrent rwkv6 stacks: their caches are
the layers' states, spliced into a slot at admission like a strip.  Not
ported yet, and refused at construction: speculative decoding, the
serial scheduler, the observability hooks, stacks with window layers
(``Model`` refuses those), and recurrent stacks on the paged engine
(their state slots).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.serving.balancer import LoadBalancer, Overloaded
from repro_torch.serving.broker import Broker, PartitionFull
from repro_torch.serving.kvcache import (BlockAllocator, SlotManager,
                                         copy_blocks, invalidate_blocks,
                                         scrub_null_block,
                                         write_chunk_tokens, write_slot)
from repro_torch.serving.prefix_cache import MatchResult, PrefixCache
from repro_torch.serving.sim import Clock, QueuedResource
from repro_torch.serving.store import ResultStore


# ---------------------------------------------------------------- Stratus


@dataclasses.dataclass
class AppConfig:
    """Calibrated to the paper's testbed (two small Chameleon VMs): 3 NGINX
    replicas serving a slow static bundle (~2.5 s), a single-message
    consumer (the paper-faithful default, ``max_batch=1``) behind 3 Kafka
    partitions.  The micro-batched configuration flips ``max_batch``/policy."""

    # NGINX tier (GET path, paper §III.B)
    nginx_replicas: int = 3
    nginx_concurrency: int = 3         # worker_connections per replica
    nginx_queue: int = 8               # listen backlog
    balancer_policy: str = "round_robin"
    static_service: float = 2.5        # paper: ~2.95 s GET at 10 users
    reject_latency: float = 0.3        # paper: ~306 ms mean at 98% fail
    # flask tier (POST path goes straight to Flask:30005 in the paper)
    flask_concurrency: int = 8
    flask_queue: int = 64
    flask_service: float = 0.05
    # kafka tier
    partitions: int = 3
    partition_depth: int = 256
    # consumer tier
    num_consumers: int = 1
    poll_interval: float = 0.05
    max_batch: int = 1                 # paper: one message at a time
    batch_wait: float = 0.02
    consume_base: float = 0.35         # per-call overhead (consumer job)
    consume_jitter: float = 0.5        # +- fraction of consume_base
    # client behaviour
    poll_store_every: float = 0.25
    client_timeout: float = 30.0


@dataclasses.dataclass
class Outcome:
    ok: bool
    status: int
    latency: float
    kind: str


class StratusApp:
    """The full pipeline under virtual time with real model execution.

    ``predict_fn`` maps a stacked (B, 28, 28, 1) float32 numpy batch to
    (B, 10) probabilities on the host; its wall time is charged to the
    clock, so it must return only once the device has finished
    (``StratusPipeline.predict_fn`` returns numpy through ``.cpu()``).
    ``obs``: anything with a ``metrics`` registry (``obs/metrics.py``)."""

    def __init__(self, clock: Clock,
                 predict_fn: Callable[[np.ndarray], np.ndarray],
                 cfg: AppConfig = AppConfig(), seed: int = 0, obs=None):
        self.clock = clock
        self.cfg = cfg
        self.predict_fn = predict_fn
        self.obs = obs
        metrics = obs.metrics if obs is not None else None
        self.balancer = LoadBalancer(cfg.nginx_replicas, cfg.nginx_concurrency,
                                     cfg.nginx_queue, cfg.balancer_policy,
                                     seed, metrics=metrics)
        self._nginx = [QueuedResource(clock, cfg.nginx_concurrency,
                                      cfg.nginx_queue, metrics=metrics,
                                      name=f"nginx-{i}")
                       for i in range(cfg.nginx_replicas)]
        self._flask = QueuedResource(clock, cfg.flask_concurrency,
                                     cfg.flask_queue, metrics=metrics,
                                     name="flask")
        self.broker = Broker(cfg.partitions, cfg.partition_depth, seed,
                             metrics=metrics)
        self.store = ResultStore()
        self._rng = np.random.default_rng(seed)
        self._req_id = 0
        for c in range(cfg.num_consumers):
            self._schedule_consumer(c)

    # ------------------------------------------------------------ client
    def get_page(self, done: Callable[[Outcome], None]) -> None:
        """GET / — static page through an NGINX replica (paper §III.B).
        The balancer policy picks the replica; the replica's worker pool +
        listen backlog decide accept vs 429."""
        t0 = self.clock.now
        try:
            replica = self.balancer.pick()
        except Overloaded:
            self.clock.schedule(self.cfg.reject_latency, lambda: done(
                Outcome(False, 429, self.cfg.reject_latency, "GET")))
            return
        res = self._nginx[replica.rid]

        def finish():
            self.balancer.release(replica)
            done(Outcome(True, 200, self.clock.now - t0, "GET"))

        if not res.submit(self.cfg.static_service, finish):
            self.balancer.release(replica)
            self.clock.schedule(self.cfg.reject_latency, lambda: done(
                Outcome(False, 429, self.cfg.reject_latency, "GET")))

    def post_predict(self, image: np.ndarray,
                     done: Callable[[Outcome], None]) -> None:
        """POST /predict — straight to the Flask backend (port 30005 in the
        paper; the front-end bypasses NGINX for API calls), then the Fig. 1
        pipeline: Kafka -> consumer -> CouchDB -> poll.  Keys are
        ``req-N`` in order of submission."""
        t0 = self.clock.now
        self._req_id += 1
        key = f"req-{self._req_id}"

        def after_flask():
            try:
                self.broker.produce({"key": key, "image": image},
                                    timestamp=self.clock.now)
            except PartitionFull:
                done(Outcome(False, 503, self.clock.now - t0, "POST"))
                return
            poll_result()

        def poll_result():
            if self.clock.now - t0 > self.cfg.client_timeout:
                done(Outcome(False, 504, self.clock.now - t0, "POST"))
                return
            doc = self.store.poll(key)
            if doc is not None:
                done(Outcome(True, 200, self.clock.now - t0, "POST"))
            else:
                self.clock.schedule(self.cfg.poll_store_every, poll_result)

        if not self._flask.submit(self.cfg.flask_service, after_flask):
            self.clock.schedule(self.cfg.reject_latency, lambda: done(
                Outcome(False, 429, self.cfg.reject_latency, "POST")))

    # ------------------------------------------------------------ consumer
    def _schedule_consumer(self, cid: int) -> None:
        self.clock.schedule(self.cfg.poll_interval,
                            lambda: self._consume(cid))

    def _consume(self, cid: int) -> None:
        """One consumer pass: drain up to ``max_batch`` records per owned
        partition, run the REAL model, write results, commit.  The next
        poll is scheduled after the virtual busy time (real inference wall
        time + per-call overhead with jitter)."""
        cfg = self.cfg
        busy = 0.0
        for p in range(cfg.partitions):
            if p % cfg.num_consumers != cid:
                continue
            records = self.broker.poll("stratus", p, cfg.max_batch)
            if not records:
                continue
            images = np.stack([r.value["image"] for r in records])
            t0 = time.perf_counter()
            probs = np.asarray(self.predict_fn(images))
            elapsed = time.perf_counter() - t0
            for r, pr in zip(records, probs):
                self.store.upsert_idempotent(
                    r.value["key"],
                    {"probs": pr, "digit": int(np.argmax(pr))})
            self.broker.commit("stratus", p, records[-1].offset + 1)
            jitter = 1.0 + cfg.consume_jitter * self._rng.uniform(-1, 1)
            busy += cfg.consume_base * jitter + elapsed
        self.clock.schedule(max(cfg.poll_interval, busy),
                            lambda: self._consume(cid))


# ---------------------------------------------------------------- LLM


@dataclasses.dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    submitted: float = 0.0
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    finished_at: Optional[float] = None


def _note_token(req: GenRequest, now: float) -> None:
    """One output token emitted for ``req`` at ``now``: track the first
    and last token timestamps."""
    if req.first_token_at is None:
        req.first_token_at = now
    req.last_token_at = now


class LLMEngine:
    """Continuous-batching decode over fixed cache slots.

    Every ``step()`` either admits the queue's head into a free slot (one
    whole-prompt ``Model.prefill``, its cache or recurrent state spliced
    into the slot) or, with no admission possible, advances every slot
    by one token through ``Model.decode_step``; dead slots ride along at
    position 0 and their outputs are discarded.  A request finishes at
    ``max_new`` tokens, ``eos_id`` or a full strip (``pos + 1 >=
    cache_max``, as in the reference, also for a recurrent stack whose
    state does not grow).
    """

    def __init__(self, model, params, num_slots: int = 4,
                 cache_max: int = 512, eos_id: Optional[int] = None,
                 obs=None):
        if obs is not None:
            raise NotImplementedError("the observability hooks (obs=) are "
                                      "not ported to repro_torch yet")
        self.model = model
        self.params = params
        self.device = model.device
        self.slots = SlotManager(num_slots)
        self.cache_max = cache_max
        self.eos_id = eos_id
        self.num_slots = num_slots
        self.cache = model.cache_init(num_slots, cache_max)
        self.pos = np.full((num_slots,), -1, np.int64)
        self.active: Dict[int, GenRequest] = {}      # slot -> request
        self.queue: List[GenRequest] = []
        self._rid = 0
        self.admissions = 0
        self.finished_count = 0
        self._prefill_sigs: set = set()   # prompt lengths prefilled
        self._decode_sigs: set = set()

    def submit(self, prompt: np.ndarray, max_new: int = 16,
               now: float = 0.0) -> int:
        self._rid += 1
        self.queue.append(GenRequest(self._rid, np.asarray(prompt, np.int32),
                                     max_new, submitted=now))
        return self._rid

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active

    def step(self, now: float = 0.0) -> List[GenRequest]:
        """Admit one queued request (prefill) OR advance all live slots by
        one token.  Returns finished requests."""
        if self.queue and self.slots.num_free > 0:
            return self._admit(now)
        if self.active:
            return self._decode_all(now)
        return []

    def _admit(self, now: float) -> List[GenRequest]:
        req = self.queue.pop(0)
        slot = self.slots.alloc()
        tokens = torch.from_numpy(req.prompt[None, :]).to(self.device)
        self._prefill_sigs.add(len(req.prompt))
        logits, cache1 = self.model.prefill(self.params, {"tokens": tokens},
                                            cache_max=self.cache_max)
        write_slot(self.cache, cache1, slot)
        self.pos[slot] = len(req.prompt)
        tok = int(torch.argmax(logits[0, -1]))
        self.admissions += 1
        req.out_tokens.append(tok)
        _note_token(req, now)
        self.active[slot] = req
        return self._collect(now)

    def _decode_all(self, now: float) -> List[GenRequest]:
        live = self.slots.live
        tokens = np.zeros((self.num_slots, 1), np.int32)
        pos = np.maximum(self.pos, 0).astype(np.int32)
        for s in live:
            tokens[s, 0] = self.active[s].out_tokens[-1]
        self._decode_sigs.add(self.num_slots)
        dev = self.device
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos).to(dev))
        arr = torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu().numpy()
        for s in live:
            req = self.active[s]
            req.out_tokens.append(int(arr[s]))
            _note_token(req, now)
            self.pos[s] += 1
        return self._collect(now)

    def _collect(self, now: float) -> List[GenRequest]:
        done = []
        for s in list(self.active):
            req = self.active[s]
            hit_eos = self.eos_id is not None and req.out_tokens and \
                req.out_tokens[-1] == self.eos_id
            if len(req.out_tokens) >= req.max_new or hit_eos or \
                    int(self.pos[s]) + 1 >= self.cache_max:
                req.finished_at = now
                done.append(req)
                del self.active[s]
                self.slots.free(s)
                self.pos[s] = -1
                self.finished_count += 1
        return done

    def stats(self) -> Dict[str, float]:
        """Gauges per ``serving/stats_schema.py`` (slots stand in for
        blocks: one slot == cache_max tokens)."""
        live = len(self.active)
        return {
            "engine": "slot",
            "queue_depth": len(self.queue),
            "active": live,
            "free_blocks": self.slots.num_free,
            "used_blocks": live,
            "total_blocks": self.num_slots,
            "pool_occupancy": live / max(self.num_slots, 1),
            "preemptions": 0,
            "admissions": self.admissions,
            "finished": self.finished_count,
            "prefill_compiles": len(self._prefill_sigs),
            "decode_compiles": len(self._decode_sigs),
        }


@dataclasses.dataclass
class _PrefillState:
    """Chunk cursor for an admitted request whose prompt is still
    streaming into the KV pool.  ``seq`` is the full sequence to write
    (prompt + generated tokens on a preempt-resume); lanes ``[start,
    done)`` are already written; ``blocks`` are the request's own private
    blocks and ``all_blocks`` prepends the refcount-shared prefix-cache
    blocks.  ``start`` (= matched prefix + COW offset) never moves;
    ``done`` advances one chunk per step."""

    req: GenRequest
    seq: np.ndarray
    blocks: List[int]
    all_blocks: List[int]
    start: int
    done: int


def ragged_dispatch(model, params, pools, tokens, block_table, starts,
                    lens, *, block_size: int, all_logits: bool):
    """One ragged prefill dispatch, as the engine runs it: every row's
    chunk goes through ``Model.prefill_paged`` and its KV is scattered
    into ``pools`` in place.  tokens (R, C) int32 right-padded, row i's
    first token at absolute position ``starts[i]``, ``lens[i]`` valid
    lanes, ``block_table`` (R, nb) int32 covering every written lane.
    -> logits: (R, C, V) when ``all_logits``, else (R, 1, V) from each
    row's last valid lane."""
    r, c = tokens.shape
    logits, caches = model.prefill_paged(
        params, {"tokens": tokens}, pools, block_table, starts,
        seq_len=lens, all_logits=all_logits)
    # lane j of row i holds absolute position start+j, living in block
    # bt[i, (start+j)//bs]; invalid (padding) lanes route to the null
    # block, whose validity lanes are scrubbed right after
    bs = block_size
    lane = torch.arange(c, dtype=torch.int32, device=tokens.device)[None, :]
    pos = starts[:, None] + lane
    valid = lane < lens[:, None]
    col = torch.clamp(pos // bs, max=block_table.shape[1] - 1).long()
    dst = torch.where(valid, torch.gather(block_table, 1, col), 0)
    rows = torch.arange(r, device=tokens.device)[:, None].expand(r, c)
    write_chunk_tokens(pools, caches, rows.reshape(-1),
                       lane.expand(r, c).reshape(-1), dst.reshape(-1),
                       (pos % bs).reshape(-1))
    scrub_null_block(pools)
    return logits


class PagedLLMEngine:
    """Continuous batching over a block-paged KV pool with an
    admission-aware scheduler.

    Every ``step()`` admits all admissible queued requests (scanning an
    ``admission_window``-deep prefix of the queue), advances every
    pending prefill by up to ``prefill_chunk`` tokens under a per-step
    ``step_token_budget``, and advances every decoding request by one
    token:

      * memory is a shared pool of ``num_blocks`` x ``block_size``-token
        blocks; a request holds ``ceil(len/block_size)`` of them;
      * admission waits until the pool covers the request's prefill
        blocks and the running batch's next decode growth;
      * on pool exhaustion the youngest request is preempted — its
        blocks are freed and it is requeued at the front, to resume by
        re-prefilling prompt + generated tokens (greedy decode keeps it
        token-identical);
      * with ``prefix_cache=True`` a radix tree maps previously computed
        full prompt blocks into new requests' block tables (refcounted
        sharing); a divergence inside a matched block is served
        copy-on-write, and unheld cached blocks are LRU-evicted before
        any preemption.

    Every prefill chunk goes through ``Model.prefill_paged`` in one
    ragged dispatch: rows pad to a power-of-two row bucket, tokens to a
    length bucket (``prefill_buckets``: "auto" = powers of two up to
    ``max_len``, "off" = exact, or an ascending list) and tables to a
    power-of-two block bucket; the chunk's KV is scattered into the pool
    in the same dispatch.

    ``decode_fusion=True`` (default) runs decode rows through that same
    ragged dispatch as length-1 windows (``paged_prefill`` attention);
    ``False`` restores the separate decode dispatch, whose attention is
    ``ops.paged_attention`` (the CUDA kernel on the card).
    """

    def __init__(self, model, params, num_blocks: int = 32,
                 block_size: int = 16, max_batch: int = 8,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefill_buckets="auto",
                 prefill_chunk: int = 256,
                 step_token_budget: Optional[int] = None,
                 scheduler: str = "continuous",
                 spec_decode: str = "off",
                 admission_window: int = 4,
                 decode_fusion: bool = True,
                 obs=None):
        if not model.supports_paged:
            raise ValueError(f"{model.cfg.name}: paged engine needs a "
                             "decoder-only token stack")
        model.check_paged()
        if scheduler != "continuous":
            raise NotImplementedError(
                f"scheduler={scheduler!r}: repro_torch ports the continuous "
                "scheduler only so far")
        if spec_decode != "off":
            raise NotImplementedError(
                f"spec_decode={spec_decode!r}: speculative decoding is not "
                "ported to repro_torch yet")
        if obs is not None:
            raise NotImplementedError("the observability hooks (obs=) are "
                                      "not ported to repro_torch yet")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        if admission_window < 1:
            raise ValueError(f"admission_window must be >= 1, "
                             f"got {admission_window}")
        self.model = model
        self.params = params
        self.device = model.device
        self.block_size = block_size
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.pools = model.pool_init(num_blocks, block_size)
        self.prefix_cache: Optional[PrefixCache] = \
            PrefixCache(block_size) if prefix_cache else None
        self.nb_max = -(-max_len // block_size)
        self.block_table = np.zeros((max_batch, self.nb_max), np.int32)
        self.pos = np.zeros((max_batch,), np.int64)
        self.active: Dict[int, GenRequest] = {}      # row -> request
        self.row_blocks: Dict[int, List[int]] = {}   # row -> physical blocks
        self.prefilling: Dict[int, _PrefillState] = {}   # row -> cursor
        self.queue: List[GenRequest] = []
        self._rid = 0
        self.preemptions = 0
        self.admissions = 0
        self.finished_count = 0
        self.peak_active = 0
        self.prefill_tokens = 0
        self.generated_tokens = 0
        self.cow_copies = 0
        self.admission_window = admission_window
        self.admission_skips = 0
        self.decode_fusion = bool(decode_fusion)
        # paged_attention launches made by this engine's decode dispatch:
        # the decode_kernel gauge reports what ran, not what was asked for
        self.decode_kernel_launches = 0
        self.buckets = self._resolve_buckets(prefill_buckets)
        # bucket-align the chunk so chunked dispatches land on the same
        # shape signatures whole-suffix dispatches already use
        self.prefill_chunk = self._bucket_len(min(prefill_chunk, max_len))
        self.step_token_budget = int(step_token_budget) if \
            step_token_budget else self.prefill_chunk
        self._prefill_sigs: set = set()   # _ragged_dispatch shapes
        self._decode_sigs: set = set()

    def _resolve_buckets(self, spec) -> Optional[List[int]]:
        """"auto" / "off" / explicit ascending lengths -> bucket list
        (None = bucketing off).  Auto is powers of two capped by a final
        ``max_len`` bucket; explicit lists are clamped to ``max_len``
        and lengths past the top bucket run at exact shape."""
        if spec is None or spec == "off":
            return None
        if spec == "auto":
            b, out = 8, []
            while b < self.max_len:
                out.append(b)
                b *= 2
            out.append(self.max_len)
            return out
        out = sorted({min(int(b), self.max_len) for b in spec})
        if not out or min(out) < 1:
            raise ValueError(f"bad prefill_buckets: {spec!r}")
        return out

    def _bucket_len(self, n: int) -> int:
        """Smallest bucket >= n (exact length when off / past the top)."""
        if self.buckets is not None:
            for b in self.buckets:
                if b >= n:
                    return b
        return n

    def _bucket_pow2(self, n: int) -> int:
        """Row and prefix-block buckets: next power of two (>= 1, so a
        fresh prompt still carries a fully masked null-block table);
        exact when bucketing is off."""
        if self.buckets is None:
            return max(n, 1)
        m = 1
        while m < n:
            m *= 2
        return m

    # ------------------------------------------------------------ client
    def submit(self, prompt: np.ndarray, max_new: int = 16,
               now: float = 0.0) -> int:
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) + max_new > self.max_len:
            raise ValueError(f"prompt({len(prompt)}) + max_new({max_new}) "
                             f"exceeds max_len={self.max_len}")
        # a request that can never hold its final KV footprint would sit
        # at the queue head forever — fail at submit, not as a stall.
        worst = self.allocator.blocks_for(len(prompt) + max_new - 1)
        if worst > self.allocator.num_usable:
            raise ValueError(
                f"request needs {worst} blocks at completion but the pool "
                f"only has {self.allocator.num_usable}: pool too small")
        self._rid += 1
        self.queue.append(GenRequest(self._rid, prompt, max_new,
                                     submitted=now))
        return self._rid

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active and not self.prefilling

    def stats(self) -> Dict[str, float]:
        """Gauges per ``serving/stats_schema.py``."""
        alloc = self.allocator
        pc = self.prefix_cache
        return {
            "engine": "paged",
            "queue_depth": len(self.queue),
            "active": len(self.active),
            "prefilling": len(self.prefilling),
            "free_blocks": alloc.num_free,
            "used_blocks": alloc.num_live,
            "total_blocks": alloc.num_usable,
            "pool_occupancy": alloc.num_live / max(alloc.num_usable, 1),
            "preemptions": self.preemptions,
            "admissions": self.admissions,
            "finished": self.finished_count,
            "peak_active": self.peak_active,
            "prefill_tokens": self.prefill_tokens,
            "prefix_cache": int(pc is not None),
            "hit_rate": pc.hit_rate if pc else 0.0,
            "cached_blocks": pc.cached_blocks if pc else 0,
            "evictions": pc.evictions if pc else 0,
            "cow_copies": self.cow_copies,
            "prefill_compiles": len(self._prefill_sigs),
            "decode_compiles": len(self._decode_sigs),
            "decode_kernel": int(self.decode_kernel_launches > 0),
            "decode_fusion": int(self.decode_fusion),
            "admission_skips": self.admission_skips,
            "window_blocks_freed": 0,
            "state_slots_used": 0,
            "spec_decode": "off",
            "spec_k": 0,
            "accepted_tokens_per_step": 0.0,
            "draft_hit_rate": 0.0,
            "spec_rollbacks": 0,
        }

    # ------------------------------------------------------------ sched
    def _free_row(self) -> Optional[int]:
        for r in range(self.max_batch):
            if r not in self.active and r not in self.prefilling:
                return r
        return None

    def _next_step_block_need(self) -> int:
        """Blocks the running batch needs for its next decode step (a
        request crossing a block boundary needs one growth block)."""
        need = 0
        for row in self.active:
            if int(self.pos[row]) // self.block_size >= \
                    len(self.row_blocks[row]):
                need += 1
        return need

    def _seq_for(self, req: GenRequest) -> np.ndarray:
        """Prompt + already-generated tokens (a preempted request resumes
        by re-prefilling both; greedy decode keeps it token-identical)."""
        if not req.out_tokens:
            return req.prompt
        return np.concatenate([req.prompt,
                               np.asarray(req.out_tokens, np.int32)])

    def _match_for(self, req: GenRequest, probe: bool) -> MatchResult:
        """Cached-prefix match for a request.  The last sequence token is
        reserved: the uncached suffix must never be empty (its final
        logits produce the next output token)."""
        tokens = self._seq_for(req)[:-1]
        if probe:
            return self.prefix_cache.probe(tokens)
        return self.prefix_cache.match(tokens)

    def _admission_ok(self, req: GenRequest) -> bool:
        seq_len = len(req.prompt) + len(req.out_tokens)
        need = self.allocator.blocks_for(seq_len)
        avail = self.allocator.num_free
        if self.prefix_cache is not None:
            m = self._match_for(req, probe=True)
            need -= len(m.blocks)             # mapped for free
            # unheld cached blocks are evictable headroom — except the
            # ones this very request is about to take a hold on.
            protected = set(m.blocks)
            if m.partial_len:
                protected.add(m.partial_block)
            avail += self.prefix_cache.evictable(self.allocator,
                                                 frozenset(protected))
        if seq_len % self.block_size == 0:
            need += 1      # its own first decode step crosses a boundary
        free_after = avail - need
        if free_after < 0:
            # always keep making progress: force-admit only when nothing
            # else is running OR mid-prefill (their blocks are held)
            return not self.active and not self.prefilling
        if not self.active:
            return True
        return free_after >= self._next_step_block_need()

    def _alloc_or_evict(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, LRU-evicting unheld cached blocks first
        when the free list falls short — eviction precedes preemption."""
        got = self.allocator.alloc(n)
        if got is not None or self.prefix_cache is None:
            return got
        released = self.prefix_cache.evict(n - self.allocator.num_free,
                                           self.allocator)
        if released:
            invalidate_blocks(self.pools, released)
        return self.allocator.alloc(n)

    def _free_blocks(self, blocks: List[int]) -> None:
        """Drop this request's hold; invalidate only the blocks whose
        last holder released them (blocks the prefix cache still holds
        keep their KV readable for future matches)."""
        released = self.allocator.free([b for b in blocks if b])
        if released:
            invalidate_blocks(self.pools, released)

    def step(self, now: float = 0.0) -> List[GenRequest]:
        """One scheduler step: admit every admissible queued request,
        advance pending prefills by one token-budgeted ragged chunk
        dispatch, and advance the decode batch one token.  Returns
        finished requests."""
        self._admit_all(now)
        if self.decode_fusion:
            return self._fused_step(now)
        done: List[GenRequest] = []
        if self.prefilling:
            self._prefill_chunks(now)
            # requests satisfied at prefill (max_new == 1 / max_len edge)
            # must leave before the decode below hands them another token
            done = self._collect(now)
        if self.active:
            return done + self._decode_all(now)
        return done + self._collect(now)

    def _admit_all(self, now: float) -> None:
        """Admit queued requests, scanning an ``admission_window``-deep
        prefix of the queue in FIFO order: a head that can't admit (pool
        too tight, or deferred behind a prefix writer) does not block a
        later request that can."""
        while self.queue and self._free_row() is not None:
            picked = None
            for i, req in enumerate(self.queue[:self.admission_window]):
                if self._defer_for_prefix(req):
                    continue
                if self._admission_ok(req):
                    picked = i
                    break
            if picked is None:
                return
            if picked:
                self.admission_skips += 1
            self._admit_setup(self.queue.pop(picked), now)

    def _defer_for_prefix(self, req: GenRequest) -> bool:
        """Hold a request back while a still-prefilling request is
        writing a prefix it shares: once the writer publishes its blocks,
        the held request admits with cache hits instead of recomputing
        the shared prefix."""
        if self.prefix_cache is None or not self.prefilling:
            return False
        seq = self._seq_for(req)[:-1]         # last token never matchable
        if not len(seq):
            return False
        m = self._match_for(req, probe=True)
        matched = len(m.blocks) * self.block_size + m.partial_len
        for st in self.prefilling.values():
            n = min(len(seq), len(st.seq))
            eq = seq[:n] == st.seq[:n]
            common = int(n if eq.all() else np.argmin(eq))
            if common >= self.block_size and common > matched:
                return True
        return False

    def _admit_setup(self, req: GenRequest, now: float) -> None:
        """Claim a row + physical blocks for a queued request and queue
        its sequence for chunked prefill (no model dispatch here)."""
        seq = self._seq_for(req)
        bs = self.block_size
        nb_total = self.allocator.blocks_for(len(seq))
        match = MatchResult([]) if self.prefix_cache is None else \
            self._match_for(req, probe=False)
        k, j = len(match.blocks), match.partial_len
        # take holds on the shared prefix + COW donor FIRST so eviction
        # inside _alloc_or_evict can never reclaim them out from under us
        for b in match.blocks:
            self.allocator.incref(b)
        if j:
            self.allocator.incref(match.partial_block)
        blocks = self._alloc_or_evict(nb_total - k)
        if blocks is None and j:
            # our hold on the COW donor pins the last block a drained
            # pool needs — forgo the partial match and retry
            self.allocator.free([match.partial_block])
            match, j = MatchResult(match.blocks), 0
            blocks = self._alloc_or_evict(nb_total - k)
        assert blocks is not None, "admission check guarantees capacity"
        row = self._free_row()
        start = k * bs + j
        if j:       # copy-on-write: private copy of the donor block
            copy_blocks(self.pools, [match.partial_block], [blocks[0]])
            self.cow_copies += 1
            self.allocator.free([match.partial_block])       # drop COW hold
        all_blocks = match.blocks + blocks
        # the engine-side block_table row stays null until the prefill
        # completes: decode dispatches route every inactive row's masked
        # write through its table row, which must hit the null block
        self.block_table[row, :] = 0
        self.pos[row] = 0
        self.prefilling[row] = _PrefillState(req, seq, blocks, all_blocks,
                                             start, start)
        self.admissions += 1
        self.peak_active = max(self.peak_active,
                               len(self.active) + len(self.prefilling))

    def _select_chunks(self) -> tuple:
        """Pick this step's prefill chunks: oldest request first, each up
        to ``prefill_chunk`` tokens, total capped by ``step_token_budget``
        (the oldest row always gets at least one token).  Pure.
        -> [(row, take)]."""
        order = sorted(self.prefilling,
                       key=lambda r: self.prefilling[r].req.rid)
        budget = self.step_token_budget
        sel: List[tuple] = []
        for r in order:
            st = self.prefilling[r]
            take = min(self.prefill_chunk, len(st.seq) - st.done, budget)
            if take <= 0:
                break                             # budget exhausted
            budget -= take
            sel.append((r, take))
        if not sel and order:                     # budget < 1: still move
            r = order[0]
            st = self.prefilling[r]
            sel = [(r, min(self.prefill_chunk, len(st.seq) - st.done))]
        return sel

    def _ragged_dispatch(self, rows: List[tuple], *, all_logits: bool):
        """ONE bucketed masked dispatch over a ragged batch of rows.
        Each row is ``(tokens, start, blocks)``: ``tokens`` (take,) land
        at absolute positions ``[start, start+take)`` and are scattered
        into ``blocks`` in the same dispatch (indices derived on the
        device; padding lanes land in the scrubbed null block).  Returns
        greedy tokens on the host: (rows, c_pad) per lane when
        ``all_logits``, else (rows,) from each row's last valid lane."""
        r_pad = self._bucket_pow2(len(rows))
        # decode-only fused steps are all length-1 windows: dispatch at
        # c_pad=1 instead of padding every lane up to the first bucket
        longest = max(len(t) for t, _, _ in rows)
        c_pad = 1 if longest == 1 else self._bucket_len(longest)
        nb_pad = self._bucket_pow2(max(len(b) for _, _, b in rows))
        toks = np.zeros((r_pad, c_pad), np.int32)
        starts = np.zeros((r_pad,), np.int32)
        # pad rows: 1 "valid" garbage token against the null table —
        # shape-legal, masked everywhere, discarded by the caller
        lens = np.ones((r_pad,), np.int32)
        bt = np.zeros((r_pad, nb_pad), np.int32)
        for i, (t, start, blocks) in enumerate(rows):
            toks[i, :len(t)] = t
            starts[i] = start
            lens[i] = len(t)
            bt[i, :len(blocks)] = blocks
        self._prefill_sigs.add((r_pad, c_pad, nb_pad, all_logits))
        dev = self.device
        logits = ragged_dispatch(
            self.model, self.params, self.pools,
            *(torch.from_numpy(a).to(dev) for a in (toks, bt, starts, lens)),
            block_size=self.block_size, all_logits=all_logits)
        greedy = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        return greedy if all_logits else greedy[:, 0]

    def _chunk_rows(self, sel: List[tuple]) -> List[tuple]:
        return [(self.prefilling[r].seq[self.prefilling[r].done:
                                        self.prefilling[r].done + take],
                 self.prefilling[r].done,
                 self.prefilling[r].all_blocks)
                for r, take in sel]

    def _account_chunks(self, sel: List[tuple], tok_at, now: float) -> None:
        """Advance chunk cursors after a dispatch; ``tok_at(i, take)`` is
        row i's final-lane greedy token, the first output token when the
        prefill completes."""
        for i, (r, take) in enumerate(sel):
            st = self.prefilling[r]
            st.done += take
            self.prefill_tokens += take
            if st.done == len(st.seq):
                self._finish_prefill(r, tok_at(i, take), now)

    def _prefill_chunks(self, now: float) -> None:
        """Advance every pending prefill by up to one chunk in one ragged
        dispatch (the unfused path, ``decode_fusion=False``)."""
        sel = self._select_chunks()
        last = self._ragged_dispatch(self._chunk_rows(sel), all_logits=False)
        self._account_chunks(sel, lambda i, take: int(last[i]), now)

    def _fused_step(self, now: float) -> List[GenRequest]:
        """ONE ragged dispatch carries this step's prefill chunks AND one
        length-1 window per decoding request (its last emitted token),
        run through the masked prefill entry at per-lane logits."""
        sel = self._select_chunks()
        decode_rows = self._plan_decode(now)
        # planning may preempt (growth under a dry pool) — drop entries
        # whose row was reclaimed
        sel = [(r, t) for r, t in sel if r in self.prefilling]
        decode_rows = [r for r in decode_rows if r in self.active]
        if not sel and not decode_rows:
            return self._collect(now)
        rows = self._chunk_rows(sel) + [
            (np.asarray([self.active[r].out_tokens[-1]], np.int32),
             int(self.pos[r]), self.row_blocks[r]) for r in decode_rows]
        greedy = self._ragged_dispatch(rows, all_logits=True)
        self._account_chunks(sel, lambda i, take: int(greedy[i, take - 1]),
                             now)
        for j, row in enumerate(decode_rows):
            self._emit(row, int(greedy[len(sel) + j, 0]), now)
            self.pos[row] += 1
        return self._collect(now)

    def _plan_decode(self, now: float) -> List[int]:
        """Rows that decode this step, oldest request first, each with a
        private writable block for lane ``pos`` (growing, evicting or
        preempting as needed)."""
        plan: List[int] = []
        for row in sorted(self.active, key=lambda r: self.active[r].rid):
            if row in self.active and self._prepare_decode_row(row, now):
                plan.append(row)
        return plan

    def _prepare_decode_row(self, row: int, now: float) -> bool:
        """Secure a private, writable KV lane ``pos`` for a decode row:
        grow the block table (evicting cold cached blocks first, then
        preempting the youngest); a write block still shared with the
        radix tree or another request is copied to a private block
        first.  False if the row itself was preempted."""
        bs = self.block_size
        while row in self.active:
            p = int(self.pos[row])
            blocks = self.row_blocks[row]
            need = self.allocator.blocks_for(p + 1)
            if len(blocks) < need:
                got = self._alloc_or_evict(1)
                if got is not None:
                    blocks.append(got[0])
                    self.block_table[row, len(blocks) - 1] = got[0]
                    continue
                self._preempt_or_fail(now)
                continue
            shared = next((i for i in range(p // bs, need)
                           if self.allocator.refcount(blocks[i]) > 1), None)
            if shared is None:
                return True
            got = self._alloc_or_evict(1)
            if got is None:
                self._preempt_or_fail(now)
                continue
            copy_blocks(self.pools, [blocks[shared]], [got[0]])
            self.allocator.free([blocks[shared]])   # refcount>1: not released
            blocks[shared] = got[0]
            self.block_table[row, shared] = got[0]
            self.cow_copies += 1
        return False

    def _preempt_or_fail(self, now: float) -> None:
        if len(self.active) + len(self.prefilling) == 1:
            raise RuntimeError("KV pool too small for a single request: "
                               f"{self.allocator.num_usable} usable blocks")
        self._preempt_youngest(now)

    def _emit(self, row: int, tok: int, now: float) -> None:
        req = self.active[row]
        req.out_tokens.append(tok)
        self.generated_tokens += 1
        _note_token(req, now)

    def _finish_prefill(self, row: int, tok: int, now: float) -> None:
        """Last chunk written: emit the first token and move the row to
        the decode batch."""
        st = self.prefilling.pop(row)
        if self.prefix_cache is not None:
            # publish this request's full blocks (matched ones dedupe)
            self.prefix_cache.insert(st.seq, st.all_blocks, self.allocator)
        self.active[row] = st.req
        self._emit(row, tok, now)
        self.row_blocks[row] = list(st.all_blocks)
        self.block_table[row, :len(st.all_blocks)] = st.all_blocks
        self.pos[row] = len(st.seq)

    def _preempt_youngest(self, now: float = 0.0) -> None:
        """Evict the youngest admitted request — decoding OR mid-prefill
        (a half-prefilled prompt drops its blocks and re-chunks from its
        cursor start on resume)."""
        rows = {r: st.req for r, st in self.prefilling.items()}
        rows.update(self.active)
        row = max(rows, key=lambda r: rows[r].rid)
        req = rows[row]
        if row in self.prefilling:
            self._free_blocks(self.prefilling.pop(row).all_blocks)
        else:
            del self.active[row]
            self._free_blocks(self.row_blocks.pop(row))
        self.block_table[row, :] = 0
        self.pos[row] = 0
        self.queue.insert(0, req)             # resumes as soon as blocks free
        self.preemptions += 1

    def _decode_all(self, now: float) -> List[GenRequest]:
        """The separate decode dispatch (``decode_fusion=False``): grow
        block tables for the next write, oldest request first (evicting,
        then preempting the youngest when the pool is dry), then advance
        every active row one token through ``decode_step_paged``."""
        for row in sorted(self.active, key=lambda r: self.active[r].rid):
            while row in self.active and \
                    int(self.pos[row]) // self.block_size >= \
                    len(self.row_blocks[row]):
                got = self._alloc_or_evict(1)
                if got is not None:
                    self.row_blocks[row].append(got[0])
                    self.block_table[row, len(self.row_blocks[row]) - 1] = \
                        got[0]
                else:
                    self._preempt_or_fail(now)
        if not self.active:
            return []

        tokens = np.zeros((self.max_batch, 1), np.int32)
        pos = np.zeros((self.max_batch,), np.int32)
        active_mask = np.zeros((self.max_batch,), bool)
        for row, req in self.active.items():
            tokens[row, 0] = req.out_tokens[-1]
            pos[row] = self.pos[row]
            active_mask[row] = True
        self._decode_sigs.add((self.max_batch, self.nb_max))
        dev = self.device
        before = kernel_ops.launch_counts()["paged_attention"]
        logits, self.pools = self.model.decode_step_paged(
            self.params, self.pools,
            torch.from_numpy(self.block_table).to(dev),
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos).to(dev),
            torch.from_numpy(active_mask).to(dev))
        greedy = torch.argmax(logits[:, 0], dim=-1)
        self.decode_kernel_launches += \
            kernel_ops.launch_counts()["paged_attention"] - before
        arr = greedy.to(torch.int32).cpu().numpy()
        for row in list(self.active):
            self._emit(row, int(arr[row]), now)
            self.pos[row] += 1
        return self._collect(now)

    def _collect(self, now: float) -> List[GenRequest]:
        done = []
        for row in list(self.active):
            req = self.active[row]
            hit_eos = self.eos_id is not None and req.out_tokens and \
                req.out_tokens[-1] == self.eos_id
            if len(req.out_tokens) >= req.max_new or hit_eos or \
                    int(self.pos[row]) + 1 >= self.max_len:
                req.finished_at = now
                done.append(req)
                del self.active[row]
                blocks = self.row_blocks.pop(row)
                if self.prefix_cache is not None:
                    # publish the generated blocks too: a follow-up whose
                    # prompt embeds this turn's output then hits the tree.
                    # Only KV-valid lanes count: the last emitted token was
                    # never written, so the key stops at ``pos``.
                    kv = int(self.pos[row])
                    self.prefix_cache.insert(self._seq_for(req)[:kv],
                                             blocks, self.allocator)
                self._free_blocks(blocks)
                self.block_table[row, :] = 0
                self.pos[row] = 0
                self.finished_count += 1
        return done
