"""The Stratus digit-serving pipeline, and continuous-batching LLM
serving over fixed slots and a block-paged pool.

``StratusApp`` is the port of the reference's paper pipeline (Fig. 1/2)
under virtual time: client -> LoadBalancer (NGINX x3) -> Flask service
time -> Broker (Kafka x3 partitions) -> consumer (the real model, its
wall time charged to the clock) -> ResultStore (CouchDB) -> Flask poll.
Outcomes follow the paper's failure modes: 429 when the balancer or
Flask is saturated, 503 when a partition is full, 504 on a timeout.

The rest is the port of ``repro.serving.server``'s two engines for
decoder-only token stacks.  ``LLMEngine`` is the slot baseline: one
whole-prompt prefill per admission (``Model.prefill``, the
``flash_attention`` kernel) or one decode step over every slot.
``PagedLLMEngine`` is the production path, with the reference's two
schedulers (continuous and serial), block accounting, prefix cache,
bucketing and speculative decoding (``serving/spec_decode.py``: verify
windows in the ragged ``paged_prefill`` dispatch, draft forwards through
``flash_attention``).  Both engines take the reference's observability
hooks (``obs=``, ``repro_torch.obs``).  On the same weights and prompts
each emits the tokens of its reference counterpart.  Each engine step is
eager PyTorch work on ``model.device``; greedy tokens come back to the
host as integers only.

Recurrent layers (mamba, rwkv6) serve on both engines: in the slot
engine their caches are the layers' states, spliced into a slot at
admission like a strip; the paged engine keeps one state slot per
engine row beside the block pool (plus a trash slot for padded dispatch
rows), with the prefix cache forced off and speculative decoding
refused, as in the reference.  MoE FFNs serve on both.  Sliding-window
(``attn_local``) layers serve on both engines: a ring strip of
``sliding_window`` lanes in a slot, full blocks in the pool with the
window kept by the mask, and the paged engine's window accounting frees
blocks that slide out of the window where no layer is global (a pure
recurrent stack holds at most two blocks a request).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.obs.engine import EngineObs
from repro_torch.serving.balancer import LoadBalancer, Overloaded
from repro_torch.serving.broker import Broker, PartitionFull
from repro_torch.serving.kvcache import (BlockAllocator, SlotManager,
                                         copy_blocks, invalidate_blocks,
                                         invalidate_lanes, scrub_null_block,
                                         write_chunk_tokens, write_slot)
from repro_torch.serving.prefix_cache import MatchResult, PrefixCache
from repro_torch.serving.spec_decode import make_drafter
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


class _EngineObsMixin:
    """Instrumentation shared by both engines: an optional ``EngineObs``
    facade plus the per-token timestamps that feed the TTFT and
    inter-token histograms.  Each engine provides ``_step(now)`` and
    ``_occupancy()`` -> (active requests, free slots or blocks, pool
    occupancy)."""

    obs: Optional[EngineObs] = None
    _engine_kind = "slot"

    def attach_obs(self, obs, replica=None) -> None:
        """Bind (or re-bind) an ``Observability`` bundle; ``None``
        detaches.  ``replica`` adds a per-replica label to the engine
        metrics; the request latency histograms stay unlabeled."""
        self.obs = EngineObs(obs, self._engine_kind, replica) \
            if obs is not None else None

    def _note_token(self, req: GenRequest, now: float) -> None:
        """One output token emitted for ``req`` at ``now``: track the
        first and last token timestamps and feed the TTFT and
        inter-token histograms."""
        if req.first_token_at is None:
            req.first_token_at = now
            if self.obs:
                self.obs.first_token(req.rid, now, now - req.submitted)
        elif self.obs:
            gap = None if req.last_token_at is None \
                else now - req.last_token_at
            self.obs.token(req.rid, now, gap)
        req.last_token_at = now

    def step(self, now: float = 0.0) -> List[GenRequest]:
        """One scheduler step (the engine's ``_step``), reported to the
        attached ``EngineObs`` when there is one.  Returns finished
        requests."""
        if self.obs is None:
            return self._step(now)
        t0 = time.perf_counter()
        pre = (self.admissions, self.prefill_tokens, self.generated_tokens,
               len(self._prefill_sigs) + len(self._decode_sigs))
        self._decode_batch_last = 0
        done = self._step(now)
        active, free_blocks, occupancy = self._occupancy()
        self.obs.step(
            now, time.perf_counter() - t0,
            admitted=self.admissions - pre[0],
            chunk_tokens=self.prefill_tokens - pre[1],
            decode_batch=self._decode_batch_last,
            tokens=self.generated_tokens - pre[2],
            retraced=len(self._prefill_sigs) + len(self._decode_sigs)
            > pre[3],
            queue_depth=len(self.queue), active=active,
            free_blocks=free_blocks, pool_occupancy=occupancy)
        return done


class LLMEngine(_EngineObsMixin):
    """Continuous-batching decode over fixed cache slots.

    Every ``step()`` either admits the queue's head into a free slot (one
    whole-prompt ``Model.prefill``, its cache or recurrent state spliced
    into the slot) or, with no admission possible, advances every slot
    by one token through ``Model.decode_step``; dead slots ride along at
    position 0 and their outputs are discarded.  A request finishes at
    ``max_new`` tokens, ``eos_id`` or a full strip (``pos + 1 >=
    cache_max``, as in the reference, also for a recurrent stack whose
    state does not grow).  Token stacks only: a frontend config
    (whisper-tiny, paligemma-3b) is refused at construction, where the
    reference's engine fails at its first admission (it prefills
    ``{"tokens"}`` alone, and these models need ``"embeds"``).
    """

    _engine_kind = "slot"

    def __init__(self, model, params, num_slots: int = 4,
                 cache_max: int = 512, eos_id: Optional[int] = None,
                 obs=None):
        cfg = model.cfg
        if cfg.frontend != "none" or cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name}: slot engine needs a token stack "
                             "(its prefill takes no frontend embeddings)")
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
        self.prefill_tokens = 0
        self.generated_tokens = 0
        self._decode_batch_last = 0
        self._prefill_sigs: set = set()   # prompt lengths prefilled
        self._decode_sigs: set = set()
        self.attach_obs(obs)

    def submit(self, prompt: np.ndarray, max_new: int = 16,
               now: float = 0.0) -> int:
        self._rid += 1
        self.queue.append(GenRequest(self._rid, np.asarray(prompt, np.int32),
                                     max_new, submitted=now))
        if self.obs:
            self.obs.request_queued(self._rid, now, len(prompt), max_new)
        return self._rid

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active

    def _occupancy(self) -> tuple:
        return (len(self.active), self.slots.num_free,
                len(self.active) / max(self.num_slots, 1))

    def _step(self, now: float) -> List[GenRequest]:
        """Admit one queued request (prefill) OR advance all live slots by
        one token."""
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
        self.prefill_tokens += len(req.prompt)
        self.generated_tokens += 1
        if self.obs:
            self.obs.admitted(req.rid, now, resume=False, cached_blocks=0,
                              cow=False)
            self.obs.prefill_chunk(req.rid, now, 0, len(req.prompt))
        req.out_tokens.append(tok)
        self._note_token(req, now)
        self.active[slot] = req
        return self._collect(now)

    def _decode_all(self, now: float) -> List[GenRequest]:
        live = self.slots.live
        tokens = np.zeros((self.num_slots, 1), np.int32)
        pos = np.maximum(self.pos, 0).astype(np.int32)
        for s in live:
            tokens[s, 0] = self.active[s].out_tokens[-1]
        self._decode_sigs.add(self.num_slots)
        self._decode_batch_last = len(live)
        dev = self.device
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos).to(dev))
        arr = torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu().numpy()
        for s in live:
            req = self.active[s]
            req.out_tokens.append(int(arr[s]))
            self.generated_tokens += 1
            self._note_token(req, now)
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
                if self.obs:
                    self.obs.finished(req.rid, now, now - req.submitted,
                                      len(req.out_tokens))
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
                    lens, *, block_size: int, all_logits: bool,
                    state_rows=None):
    """One ragged prefill dispatch, as the engine runs it: every row's
    chunk goes through ``Model.prefill_paged`` and its KV is scattered
    into ``pools`` in place.  tokens (R, C) int32 right-padded, row i's
    first token at absolute position ``starts[i]``, ``lens[i]`` valid
    lanes, ``block_table`` (R, nb) int32 covering every written lane;
    ``state_rows`` (R,) maps each row to its recurrent-state slot, where
    its chunk-exit state is written (None: row i is slot i).
    -> logits: (R, C, V) when ``all_logits``, else (R, 1, V) from each
    row's last valid lane."""
    r, c = tokens.shape
    if state_rows is None:
        state_rows = torch.arange(r, dtype=torch.int32, device=tokens.device)
    logits, caches = model.prefill_paged(
        params, {"tokens": tokens}, pools, block_table, starts,
        seq_len=lens, all_logits=all_logits, state_rows=state_rows)
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
                       (pos % bs).reshape(-1), state_rows=state_rows)
    scrub_null_block(pools)
    return logits


def _decode_launches() -> int:
    """Launches of the paged decode kernel, either pool type."""
    counts = kernel_ops.launch_counts()
    return counts["paged_attention"] + counts["paged_attention_int8"]


class PagedLLMEngine(_EngineObsMixin):
    """Continuous batching over a block-paged KV pool with an
    admission-aware scheduler.

    ``scheduler="continuous"`` (default): every ``step()`` admits all
    admissible queued requests (scanning an ``admission_window``-deep
    prefix of the queue), advances every pending prefill by up to
    ``prefill_chunk`` tokens under a per-step ``step_token_budget``, and
    advances every decoding request.  ``scheduler="serial"``: admit at
    most the queue's head per step, prefill its whole prompt in one
    chunk, and decode only on steps that prefilled nothing (the
    reference's baseline).

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
        any preemption;
      * with ``window_accounting=True`` (default) and every layer's
        reach bounded (``Model.paged_live_window``: no global layer), a
        request's blocks that slide wholly out of the window are freed
        as its cursor passes them, so it never holds more than
        ceil(W/block_size)+1; the prefix cache is then forced off (a
        freed block must never be published).  Inert on stacks with a
        global layer, gemma3-4b's among them;
      * recurrent layers (mamba, rwkv6) keep one state slot per engine
        row beside the pool (``max_batch + 1`` slots, the last a trash
        slot for padded dispatch rows; ``state_rows`` maps each dispatch
        row to its slot).  A resumed request re-prefills from position
        0, where the slot reads as zeros.  State cannot be rebuilt from
        cached blocks or rolled back, so for such stacks the prefix cache
        is forced off and speculative decoding refused.

    Every prefill chunk goes through ``Model.prefill_paged`` in one
    ragged dispatch: rows pad to a power-of-two row bucket, tokens to a
    length bucket (``prefill_buckets``: "auto" = powers of two up to
    ``max_len``, "off" = exact, or an ascending list) and tables to a
    power-of-two block bucket; the chunk's KV is scattered into the pool
    in the same dispatch.

    The continuous scheduler with ``decode_fusion=True`` (default) or a
    drafter runs decode rows through that same ragged dispatch as verify
    windows (``paged_prefill`` attention): the last emitted token plus up
    to ``spec_k`` drafted tokens (``spec_decode="ngram"`` or ``"draft"``
    with ``draft_model``/``draft_params``; none with speculation off).
    Greedy acceptance keeps the longest matching drafted prefix plus a
    bonus token, so the output is token-identical to plain greedy
    decode; rejected lanes roll back.  The serial scheduler and
    ``decode_fusion=False`` run the separate decode dispatch, whose
    attention is ``ops.paged_attention`` (the CUDA kernel on the card).
    """

    _engine_kind = "paged"

    def __init__(self, model, params, num_blocks: int = 32,
                 block_size: int = 16, max_batch: int = 8,
                 max_len: int = 256, eos_id: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefill_buckets="auto",
                 prefill_chunk: int = 256,
                 step_token_budget: Optional[int] = None,
                 scheduler: str = "continuous",
                 spec_decode: str = "off", spec_k: int = 4,
                 draft_model=None, draft_params=None,
                 admission_window: int = 4,
                 decode_fusion: bool = True,
                 window_accounting: bool = True,
                 obs=None):
        if not model.supports_paged:
            raise ValueError(f"{model.cfg.name}: paged engine needs a "
                             "decoder-only token stack")
        if scheduler not in ("continuous", "serial"):
            raise ValueError(f"scheduler must be 'continuous' or 'serial', "
                             f"got {scheduler!r}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        if spec_decode not in ("off", "ngram", "draft"):
            raise ValueError(f"spec_decode must be 'off', 'ngram' or "
                             f"'draft', got {spec_decode!r}")
        if spec_decode != "off" and scheduler != "continuous":
            raise ValueError("spec_decode needs scheduler='continuous' "
                             "(verify rows ride the ragged chunk dispatch)")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
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
        self.scheduler = scheduler
        self.allocator = BlockAllocator(num_blocks, block_size)
        # hybrid stacks: recurrent layers get one fixed-size state slot
        # per engine row, plus a trash slot (index max_batch) for padded
        # dispatch rows, beside the block pool
        self.has_state = model.paged_has_state
        self.pools = model.pool_init(num_blocks, block_size,
                                     state_batch=max_batch + 1)
        if self.has_state and spec_decode != "off":
            raise ValueError(
                f"{model.cfg.name}: spec_decode needs roll-backable KV — "
                "recurrent layer state cannot roll back on draft rejection")
        # the sliding-window residency bound: where every layer's reach
        # is bounded, blocks wholly behind the window are freed eagerly
        # (``_window_shrink``); ``window_accounting=False`` keeps the
        # window-blind accounting
        self.window_accounting = bool(window_accounting)
        lw = model.paged_live_window() if self.window_accounting else None
        self.live_window = lw
        self.window_bound = None if lw is None else -(-lw // block_size) + 1
        self.window_blocks_freed = 0
        if self.has_state or lw is not None:
            # recurrent state cannot be rebuilt from cached blocks, and a
            # window-freed block must never be published to the radix
            # tree: prefix reuse is off (the gauge reports prefix_cache=0)
            prefix_cache = False
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
        self._decode_batch_last = 0
        self._preempted_rids: set = set()
        self.admission_window = admission_window
        self.admission_skips = 0
        self.drafter = make_drafter(spec_decode, draft_model=draft_model,
                                    draft_params=draft_params,
                                    max_len=max_len)
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        self.spec_proposed = 0       # drafted tokens sent to verify
        self.spec_accepted = 0       # drafted tokens that matched argmax
        self.spec_emitted = 0        # tokens emitted by verify rows
        self.spec_verify_rows = 0    # verify rows dispatched
        self.spec_rollbacks = 0      # verify rows that rolled back lanes
        # decode rides the ragged dispatch as verify windows; the serial
        # scheduler keeps the separate decode dispatch
        self._fused_decode = scheduler == "continuous" and \
            (self.drafter is not None or bool(decode_fusion))
        # paged_attention launches (int8 pools: paged_attention_int8)
        # made by this engine's decode dispatch: the decode_kernel gauge
        # reports what ran, not what was asked for (the reference's reads
        # 0 for an int8 pool, which its kernel does not read)
        self.decode_kernel_launches = 0
        self.buckets = self._resolve_buckets(prefill_buckets)
        # bucket-align the chunk so chunked dispatches land on the same
        # shape signatures whole-suffix dispatches already use
        self.prefill_chunk = self._bucket_len(min(prefill_chunk, max_len))
        self.step_token_budget = int(step_token_budget) if \
            step_token_budget else self.prefill_chunk
        self._prefill_sigs: set = set()   # _ragged_dispatch shapes
        self._decode_sigs: set = set()
        self.attach_obs(obs)

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
        if self.obs:
            self.obs.request_queued(self._rid, now, len(prompt), max_new)
        return self._rid

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active and not self.prefilling

    def prefix_probe(self, prompt) -> int:
        """How many leading tokens of ``prompt`` the radix cache could
        serve now, admitting nothing: no LRU touch, no hit/miss count.
        The cluster tier's cold-map routing probes each replica with it.
        0 with the prefix cache off.  The last token is reserved as
        admission reserves it (its logits produce the first output
        token), so it is never served from the cache."""
        if self.prefix_cache is None:
            return 0
        m = self.prefix_cache.probe(np.asarray(prompt, np.int32)[:-1])
        return len(m.blocks) * self.block_size + m.partial_len

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
            "decode_fusion": int(self._fused_decode),
            "admission_skips": self.admission_skips,
            "window_blocks_freed": self.window_blocks_freed,
            "state_slots_used": (len(self.active) + len(self.prefilling))
            if self.has_state else 0,
            "spec_decode": self.spec_decode,
            "spec_k": self.spec_k if self.drafter is not None else 0,
            "accepted_tokens_per_step":
                self.spec_emitted / max(self.spec_verify_rows, 1),
            "draft_hit_rate":
                self.spec_accepted / max(self.spec_proposed, 1),
            "spec_rollbacks": self.spec_rollbacks,
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
        keep their KV readable for future matches).  0 entries are
        window-freed logical slots, already released: skipped."""
        released = self.allocator.free([b for b in blocks if b])
        if released:
            invalidate_blocks(self.pools, released)

    def _window_shrink(self, blocks: List[int], next_pos: int,
                       table=None) -> None:
        """Free the blocks that have slid wholly out of the live window
        before the query at ``next_pos``.  ``blocks`` keeps its length:
        logical slot l stays at table column l, and a freed entry
        becomes 0 (the null block, masked by every read), in the list
        and in ``table`` (the row of ``block_table``; None while
        prefilling, whose dispatches build their own tables).  The write
        block ``next_pos // block_size`` is always kept, so a request's
        live blocks never exceed ``window_bound``."""
        if self.window_bound is None:
            return
        bs = self.block_size
        dead = min(max(0, (next_pos - self.live_window + 1) // bs),
                   next_pos // bs)
        freed = []
        for l in range(min(dead, len(blocks))):
            if blocks[l]:
                freed.append(blocks[l])
                blocks[l] = 0
                if table is not None:
                    table[l] = 0
        if freed:
            self._free_blocks(freed)
            self.window_blocks_freed += len(freed)

    def _occupancy(self) -> tuple:
        alloc = self.allocator
        return (len(self.active) + len(self.prefilling), alloc.num_free,
                alloc.num_live / max(alloc.num_usable, 1))

    def _step(self, now: float) -> List[GenRequest]:
        """Continuous: admit every admissible queued request, advance
        pending prefills by one token-budgeted ragged chunk dispatch that
        also carries every decoding row's verify window (or, unfused,
        decode in the separate dispatch after it).  Serial: admit at most
        the head, prefill its whole prompt, decode only on steps that
        prefilled nothing."""
        self._admit_all(now)
        if self._fused_decode:
            return self._spec_step(now)
        done: List[GenRequest] = []
        prefilled = bool(self.prefilling)
        if self.prefilling:
            self._prefill_chunks(now)
            # requests satisfied at prefill (max_new == 1 / max_len edge)
            # must leave before the decode below hands them another token
            done = self._collect(now)
        if self.scheduler == "serial" and prefilled:
            return done
        if self.active:
            return done + self._decode_all(now)
        return done + self._collect(now)

    def _admit_all(self, now: float) -> None:
        """Admit queued requests.  The continuous scheduler scans an
        ``admission_window``-deep prefix of the queue in FIFO order: a
        head that can't admit (pool too tight, or deferred behind a
        prefix writer) does not block a later request that can.  The
        serial scheduler admits at most the head, once a step."""
        window = 1 if self.scheduler == "serial" else self.admission_window
        while self.queue and self._free_row() is not None:
            picked = None
            for i, req in enumerate(self.queue[:window]):
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
            if self.scheduler == "serial":
                return

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
        resume = req.rid in self._preempted_rids
        self._preempted_rids.discard(req.rid)
        if self.obs:
            self.obs.admitted(req.rid, now, resume=resume,
                              cached_blocks=k, cow=bool(j))

    def _select_chunks(self) -> tuple:
        """Pick this step's prefill chunks: oldest request first, each up
        to ``prefill_chunk`` tokens, total capped by ``step_token_budget``
        (the oldest row always gets at least one token).  The serial
        scheduler takes each request's whole remaining sequence instead.
        Pure.  -> ([(row, take)], budget left)."""
        order = sorted(self.prefilling,
                       key=lambda r: self.prefilling[r].req.rid)
        budget = self.step_token_budget
        sel: List[tuple] = []
        for r in order:
            st = self.prefilling[r]
            remaining = len(st.seq) - st.done
            take = remaining if self.scheduler == "serial" else \
                min(self.prefill_chunk, remaining, budget)
            if take <= 0:
                break                             # budget exhausted
            budget -= take
            sel.append((r, take))
        if not sel and order:                     # budget < 1: still move
            r = order[0]
            st = self.prefilling[r]
            sel = [(r, min(self.prefill_chunk, len(st.seq) - st.done))]
            budget = 0
        return sel, max(budget, 0)

    def _ragged_dispatch(self, rows: List[tuple], state_rows=None, *,
                         all_logits: bool):
        """ONE bucketed masked dispatch over a ragged batch of rows.
        Each row is ``(tokens, start, blocks)``: ``tokens`` (take,) land
        at absolute positions ``[start, start+take)`` and are scattered
        into ``blocks`` in the same dispatch (indices derived on the
        device; padding lanes land in the scrubbed null block).
        ``state_rows`` (one engine row per dispatch row) maps rows to
        their recurrent-state slots; padding rows go to the trash slot
        (index ``max_batch``).  Returns greedy tokens on the host:
        (rows, c_pad) per lane when ``all_logits``, else (rows,) from
        each row's last valid lane."""
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
        srows = np.full((r_pad,), self.max_batch, np.int32)   # trash slot
        if state_rows is not None:
            srows[:len(state_rows)] = state_rows
        self._prefill_sigs.add((r_pad, c_pad, nb_pad, all_logits))
        dev = self.device
        logits = ragged_dispatch(
            self.model, self.params, self.pools,
            *(torch.from_numpy(a).to(dev) for a in (toks, bt, starts, lens)),
            block_size=self.block_size, all_logits=all_logits,
            state_rows=torch.from_numpy(srows).to(dev))
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
            if self.obs:
                self.obs.prefill_chunk(st.req.rid, now, st.done, take)
            st.done += take
            self.prefill_tokens += take
            # blocks the chunk slid out of the live window are freed now
            # (the next query position is st.done)
            self._window_shrink(st.all_blocks, st.done)
            if st.done == len(st.seq):
                self._finish_prefill(r, tok_at(i, take), now)

    def _prefill_chunks(self, now: float) -> None:
        """Advance every pending prefill by up to one chunk in one ragged
        dispatch (the unfused path: the serial scheduler or
        ``decode_fusion=False``)."""
        sel, _ = self._select_chunks()
        last = self._ragged_dispatch(self._chunk_rows(sel),
                                     [r for r, _ in sel], all_logits=False)
        self._account_chunks(sel, lambda i, take: int(last[i]), now)

    def _spec_step(self, now: float) -> List[GenRequest]:
        """ONE ragged dispatch carries this step's prefill chunks AND one
        verify window per decoding request: its last emitted token plus
        up to ``spec_k`` drafted tokens (none without a drafter: plain
        decode as a length-1 window), at per-lane greedy tokens.  Drafted
        tokens are charged to what the chunks left of the step token
        budget; every decoding row verifies at least its one-token
        window.  Acceptance then keeps the longest drafted prefix that
        matches the target's argmax plus the bonus token, and rejected
        lanes roll back."""
        sel, budget_left = self._select_chunks()
        verify = self._plan_verify(budget_left, now)
        # planning may preempt (growth under a dry pool) — drop entries
        # whose row was reclaimed
        sel = [(r, t) for r, t in sel if r in self.prefilling]
        verify = [(r, w) for r, w in verify if r in self.active]
        if not sel and not verify:
            return self._collect(now)
        rows = self._chunk_rows(sel) + [
            (np.asarray(w, np.int32), int(self.pos[r]), self.row_blocks[r])
            for r, w in verify]
        self._decode_batch_last = len(verify)
        srows = [r for r, _ in sel] + [r for r, _ in verify]
        greedy = self._ragged_dispatch(rows, srows, all_logits=True)
        nchunk = len(sel)
        self._account_chunks(sel, lambda i, take: int(greedy[i, take - 1]),
                             now)
        stale_b, stale_l = [], []
        for j, (row, window) in enumerate(verify):
            self._accept_verify(row, window, greedy[nchunk + j], now,
                                stale_b, stale_l)
        if stale_b:
            # one batched kill of the rolled-back lanes in kept blocks
            invalidate_lanes(self.pools, np.concatenate(stale_b),
                             np.concatenate(stale_l))
        return self._collect(now)

    def _plan_verify(self, budget: int, now: float) -> List[tuple]:
        """This step's verify windows, oldest request first: the last
        emitted token plus up to ``spec_k`` drafted tokens, capped by the
        request's remaining ``max_new`` (acceptance may emit the whole
        window) and by the budget left; ``_prepare_verify_row`` secures
        private writable lanes for each, shrinking the window, evicting
        or preempting as needed.  -> [(row, window)]."""
        plan: List[tuple] = []
        for row in sorted(self.active, key=lambda r: self.active[r].rid):
            if row not in self.active:
                continue        # preempted while preparing an earlier row
            req = self.active[row]
            remaining = req.max_new - len(req.out_tokens)
            cap = 0 if self.drafter is None else \
                min(self.spec_k, remaining - 1, budget)
            drafts = self.drafter.propose(self._seq_for(req), cap) \
                if cap > 0 else []
            take = self._prepare_verify_row(row, 1 + len(drafts), now)
            if take is None:
                continue        # the row itself got preempted
            budget -= take - 1
            plan.append((row, [req.out_tokens[-1]] + drafts[:take - 1]))
        return plan

    def _prepare_verify_row(self, row: int, take: int,
                            now: float) -> Optional[int]:
        """Secure private, writable KV lanes ``[pos, pos+take)`` for a
        verify row: grow the block table (evicting cold cached blocks
        first, then preempting the youngest); when the pool cannot cover
        the drafted lanes the window shrinks instead, so speculation never
        preempts anyone plain decode would not; a write-range block
        still shared with the radix tree or another request is copied to
        a private block first (a speculative write must never touch a
        block with refcount > 1).  -> the window length, or None if the
        row itself was preempted."""
        bs = self.block_size
        while row in self.active:
            p = int(self.pos[row])
            blocks = self.row_blocks[row]
            need = self.allocator.blocks_for(p + take)
            if len(blocks) < need:
                got = self._alloc_or_evict(1)
                if got is not None:
                    blocks.append(got[0])
                    self.block_table[row, len(blocks) - 1] = got[0]
                    continue
                fit = len(blocks) * bs - p       # lanes already covered
                if fit >= 1:
                    take = min(take, fit)        # sacrifice drafts
                    continue
                self._preempt_or_fail(now)
                continue
            shared = next((i for i in range(p // bs, need)
                           if self.allocator.refcount(blocks[i]) > 1), None)
            if shared is None:
                return take
            got = self._alloc_or_evict(1)
            if got is None:
                self._preempt_or_fail(now)
                continue
            copy_blocks(self.pools, [blocks[shared]], [got[0]])
            self.allocator.free([blocks[shared]])   # refcount>1: not released
            blocks[shared] = got[0]
            self.block_table[row, shared] = got[0]
            self.cow_copies += 1
        return None

    def _accept_verify(self, row: int, window: List[int], row_greedy,
                       now: float, stale_b: List, stale_l: List) -> None:
        """Greedy acceptance and rollback for one verify row.
        ``window[0]`` is the last emitted token (its KV lands at lane
        ``pos``), drafts follow; ``row_greedy`` (c_pad,) holds the
        target's greedy token at every window lane.  Accept drafts while
        they equal the argmax, emit the bonus token from the first
        mismatch, truncate at EOS.  Lanes past the accepted cursor roll
        back: whole tail blocks are freed (invalidated on release), the
        stale lanes of the last kept block go to ``stale_b``/``stale_l``
        for the step's one batched ``invalidate_lanes``."""
        req = self.active[row]
        take = len(window)
        p = int(self.pos[row])
        g = row_greedy[:take]
        a = 0
        while a < take - 1 and window[a + 1] == int(g[a]):
            a += 1
        newly = [int(t) for t in window[1:a + 1]] + [int(g[a])]
        if self.eos_id is not None and self.eos_id in newly:
            newly = newly[:newly.index(self.eos_id) + 1]
        m = len(newly)
        rolled = take - m
        if self.drafter is not None:
            # length-1 windows without a drafter (plain fused decode)
            # would only dilute the spec ratios: not counted
            self.spec_verify_rows += 1
            self.spec_proposed += take - 1
            self.spec_accepted += a
            self.spec_emitted += m
            if rolled > 0:
                self.spec_rollbacks += 1
        for t in newly:
            self._emit(row, t, now)
        self.pos[row] = p + m
        blocks = self.row_blocks[row]
        keep = self.allocator.blocks_for(p + m)
        if keep < len(blocks):
            tail = blocks[keep:]
            del blocks[keep:]
            self.block_table[row, keep:] = 0
            self._free_blocks(tail)
        stale_lo = p + m
        stale_hi = min(p + take, keep * self.block_size)
        if stale_hi > stale_lo:
            lanes = np.arange(stale_lo, stale_hi)
            stale_b.append(np.asarray(blocks, np.int32)
                           [lanes // self.block_size])
            stale_l.append((lanes % self.block_size).astype(np.int32))
        self._window_shrink(blocks, p + m, self.block_table[row])
        if self.obs and self.drafter is not None:
            self.obs.spec_verify(req.rid, now, proposed=take - 1,
                                 accepted=a, emitted=m, rolled_back=rolled)

    def _preempt_or_fail(self, now: float) -> None:
        if len(self.active) + len(self.prefilling) == 1:
            raise RuntimeError("KV pool too small for a single request: "
                               f"{self.allocator.num_usable} usable blocks")
        self._preempt_youngest(now)

    def _emit(self, row: int, tok: int, now: float) -> None:
        req = self.active[row]
        req.out_tokens.append(tok)
        self.generated_tokens += 1
        self._note_token(req, now)

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
        where = "prefill" if row in self.prefilling else "decode"
        if row in self.prefilling:
            self._free_blocks(self.prefilling.pop(row).all_blocks)
        else:
            del self.active[row]
            self._free_blocks(self.row_blocks.pop(row))
        self.block_table[row, :] = 0
        self.pos[row] = 0
        self.queue.insert(0, req)             # resumes as soon as blocks free
        self.preemptions += 1
        self._preempted_rids.add(req.rid)
        if self.obs:
            self.obs.preempted(req.rid, now, where)

    def _decode_all(self, now: float) -> List[GenRequest]:
        """The separate decode dispatch (the serial scheduler or
        ``decode_fusion=False``): grow block tables for the next write,
        oldest request first (evicting, then preempting the youngest when
        the pool is dry), then advance every active row one token through
        ``decode_step_paged``."""
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
        self._decode_batch_last = len(self.active)
        dev = self.device
        before = _decode_launches()
        logits, self.pools = self.model.decode_step_paged(
            self.params, self.pools,
            torch.from_numpy(self.block_table).to(dev),
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos).to(dev),
            torch.from_numpy(active_mask).to(dev))
        greedy = torch.argmax(logits[:, 0], dim=-1)
        self.decode_kernel_launches += _decode_launches() - before
        arr = greedy.to(torch.int32).cpu().numpy()
        for row in list(self.active):
            self._emit(row, int(arr[row]), now)
            self.pos[row] += 1
            self._window_shrink(self.row_blocks[row], int(self.pos[row]),
                                self.block_table[row])
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
                if self.obs:
                    self.obs.finished(req.rid, now, now - req.submitted,
                                      len(req.out_tokens))
        return done
