"""Engine-side instrumentation facade.

The port's copy of ``repro.obs.engine`` (the port imports nothing of
``repro``), with the same metric names, labels and bounds.

``EngineObs`` binds an ``Observability`` bundle to one engine instance:
it pre-creates every instrument the step loop touches (no registry
lookups on the hot path) and forwards lifecycle transitions to the
trace recorder when one is attached.  The engines hold
``self.obs: EngineObs | None`` and guard every call with a plain
``if self.obs`` — instrumentation off is one attribute check.

Metric names (the runtime half of the serving schema — the ``stats()``
gauge schema lives in ``serving/stats_schema.py``):

  engine_requests_total / engine_admissions_total /
  engine_preemptions_total / engine_finished_total          counters
  engine_prefill_tokens_total / engine_generated_tokens_total
  engine_steps_total
  engine_queue_depth / engine_active / engine_free_blocks /
  engine_pool_occupancy                                     gauges
  engine_step_seconds                                       histogram
  request_ttft_seconds / request_e2e_seconds /
  request_intertoken_seconds                                histograms
  engine_spec_proposed_total / engine_spec_accepted_total /
  engine_spec_rollbacks_total                               counters
  engine_spec_accepted_tokens                               histogram
    (integer bounds 1..16: tokens emitted per verify row — the
    accepted-tokens-per-step distribution of speculative decoding)

Engine metrics carry an ``engine="slot"|"paged"`` label (two engines
can share one registry without colliding); the ``request_*`` histograms
are unlabeled — they are the fleet-wide latency distributions
``summarize_latencies`` reads.
"""
from __future__ import annotations


class EngineObs:
    __slots__ = ("bundle", "trace",
                 "c_requests", "c_admissions", "c_preemptions",
                 "c_finished", "c_prefill_tokens", "c_generated",
                 "c_steps", "g_queue", "g_active", "g_free_blocks",
                 "g_occupancy", "h_step", "h_ttft", "h_e2e", "h_gap",
                 "c_spec_proposed", "c_spec_accepted", "c_spec_rollbacks",
                 "h_spec_accepted")

    def __init__(self, bundle, kind: str, replica=None):
        self.bundle = bundle
        self.trace = bundle.trace
        m = bundle.metrics
        # engine metrics carry the replica id in the cluster tier so N
        # replicas can share one merged registry without colliding; the
        # request_* histograms stay unlabeled on purpose — they merge
        # into the fleet-wide latency distributions.
        lab = {"engine": kind} if replica is None else \
            {"engine": kind, "replica": str(replica)}
        self.c_requests = m.counter(
            "engine_requests_total", "requests submitted", lab)
        self.c_admissions = m.counter(
            "engine_admissions_total", "requests admitted (incl. resumes)",
            lab)
        self.c_preemptions = m.counter(
            "engine_preemptions_total", "requests preempted", lab)
        self.c_finished = m.counter(
            "engine_finished_total", "requests finished", lab)
        self.c_prefill_tokens = m.counter(
            "engine_prefill_tokens_total", "prompt tokens computed", lab)
        self.c_generated = m.counter(
            "engine_generated_tokens_total", "output tokens emitted", lab)
        self.c_steps = m.counter(
            "engine_steps_total", "engine steps executed", lab)
        self.g_queue = m.gauge(
            "engine_queue_depth", "requests waiting for admission", lab)
        self.g_active = m.gauge(
            "engine_active", "requests currently decoding", lab)
        self.g_free_blocks = m.gauge(
            "engine_free_blocks", "free KV pool blocks", lab)
        self.g_occupancy = m.gauge(
            "engine_pool_occupancy", "used / total KV blocks", lab)
        self.h_step = m.histogram(
            "engine_step_seconds", "engine step dispatch wall time", lab)
        self.h_ttft = m.histogram(
            "request_ttft_seconds", "submit -> first output token")
        self.h_e2e = m.histogram(
            "request_e2e_seconds", "submit -> request finished")
        self.h_gap = m.histogram(
            "request_intertoken_seconds",
            "gap between consecutive output tokens of one request")
        self.c_spec_proposed = m.counter(
            "engine_spec_proposed_total",
            "drafted tokens sent to verification", lab)
        self.c_spec_accepted = m.counter(
            "engine_spec_accepted_total",
            "drafted tokens that matched the target argmax", lab)
        self.c_spec_rollbacks = m.counter(
            "engine_spec_rollbacks_total",
            "verify rows that rolled speculative lanes back", lab)
        self.h_spec_accepted = m.histogram(
            "engine_spec_accepted_tokens",
            "tokens emitted per verify row (accepted drafts + bonus)",
            lab, bounds=tuple(float(b) for b in range(1, 17)))

    # ------------------------------------------------------ lifecycle
    def request_queued(self, rid: int, now: float, prompt_len: int,
                       max_new: int) -> None:
        self.c_requests.inc()
        if self.trace:
            self.trace.open_span(rid, now, prompt_len=prompt_len,
                                 max_new=max_new)
            self.trace.request(rid, "queued", now)

    def admitted(self, rid: int, now: float, resume: bool,
                 cached_blocks: int, cow: bool) -> None:
        self.c_admissions.inc()
        if self.trace:
            self.trace.request(rid, "evicted_resume" if resume
                               else "admitted", now,
                               cached_blocks=cached_blocks, cow=cow)

    def prefill_chunk(self, rid: int, now: float, start: int,
                      take: int) -> None:
        self.c_prefill_tokens.inc(take)
        if self.trace:
            self.trace.request(rid, "prefill_chunk", now, start=start,
                               take=take)

    def first_token(self, rid: int, now: float, ttft: float) -> None:
        self.c_generated.inc()
        self.h_ttft.observe(ttft)
        if self.trace:
            self.trace.request(rid, "first_token", now)

    def token(self, rid: int, now: float, gap) -> None:
        self.c_generated.inc()
        if gap is not None:
            self.h_gap.observe(gap)

    def spec_verify(self, rid: int, now: float, *, proposed: int,
                    accepted: int, emitted: int, rolled_back: int) -> None:
        """One speculative verify window resolved for ``rid``:
        ``proposed`` drafted tokens went in, ``accepted`` matched the
        target argmax, ``emitted`` tokens (accepted + bonus, EOS-
        truncated) came out, ``rolled_back`` written lanes were
        discarded.  Token counters are NOT touched here — the engine
        reports each emitted token through ``first_token``/``token``."""
        self.c_spec_proposed.inc(proposed)
        self.c_spec_accepted.inc(accepted)
        if rolled_back:
            self.c_spec_rollbacks.inc()
        self.h_spec_accepted.observe(emitted)
        if self.trace:
            self.trace.request(rid, "spec_verify", now, proposed=proposed,
                               accepted=accepted, emitted=emitted,
                               rolled_back=rolled_back)

    def preempted(self, rid: int, now: float, where: str) -> None:
        self.c_preemptions.inc()
        if self.trace:
            self.trace.request(rid, "preempted", now, where=where)

    def finished(self, rid: int, now: float, e2e: float,
                 tokens: int) -> None:
        self.c_finished.inc()
        self.h_e2e.observe(e2e)
        if self.trace:
            self.trace.close_span(rid, now, "finished", tokens=tokens)

    # ------------------------------------------------------------ step
    def step(self, now: float, wall_s: float, *, admitted: int,
             chunk_tokens: int, decode_batch: int, tokens: int,
             retraced: bool, queue_depth: int, active: int,
             free_blocks: int, pool_occupancy: float) -> None:
        self.c_steps.inc()
        self.h_step.observe(wall_s)
        self.g_queue.set(queue_depth)
        self.g_active.set(active)
        self.g_free_blocks.set(free_blocks)
        self.g_occupancy.set(pool_occupancy)
        if self.trace:
            self.trace.step(now, wall_s, admitted=admitted,
                            chunk_tokens=chunk_tokens,
                            decode_batch=decode_batch, tokens=tokens,
                            retraced=retraced)
            self.trace.counter(now, "engine_occupancy",
                               queue_depth=queue_depth, active=active,
                               free_blocks=free_blocks)
