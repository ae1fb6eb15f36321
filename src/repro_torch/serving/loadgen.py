"""Closed-loop load generator — the locust analogue (paper §III.B/C,
Appendix B).

Reproduces locust's model: ``users`` concurrent simulated users spawned at
``spawn_rate`` users/second; each user loops {issue request -> wait for
completion -> think}.  Statistics match what locust's web UI reports
(total requests, failure %, mean/median/p95 response time, RPS timeline),
so the benchmark tables line up with the paper's Figures 6-20.

The port of ``repro.serving.loadgen``: ``LoadReport``,
``LoadGenerator`` and the LLM prompt workloads, which draw the
reference's prompts from the same seed (numpy only).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List

import numpy as np

from repro_torch.obs.metrics import Histogram
from repro_torch.serving.server import Outcome
from repro_torch.serving.sim import Clock


@dataclasses.dataclass
class LoadReport:
    kind: str
    users: int
    spawn_rate: float
    duration: float
    total: int
    failures: int
    mean_ms: float
    median_ms: float
    p95_ms: float
    rps: float
    per_status: Dict[int, int]

    @property
    def failure_pct(self) -> float:
        return 100.0 * self.failures / max(self.total, 1)

    def row(self) -> str:
        return (f"{self.kind:4s} users={self.users:3d} total={self.total:5d} "
                f"fail={self.failure_pct:5.1f}% mean={self.mean_ms:8.0f}ms "
                f"median={self.median_ms:8.0f}ms p95={self.p95_ms:8.0f}ms "
                f"rps={self.rps:5.2f}")


class LoadGenerator:
    def __init__(self, clock: Clock, issue: Callable[[Callable[[Outcome], None]], None],
                 *, users: int, spawn_rate: float, duration: float,
                 think_min: float = 0.5, think_max: float = 1.5,
                 seed: int = 0, kind: str = "GET", metrics=None):
        self.clock = clock
        self.issue = issue
        self.users = users
        self.spawn_rate = spawn_rate
        self.duration = duration
        self.think = (think_min, think_max)
        self.kind = kind
        self._rng = random.Random(seed)
        self.outcomes: List[Outcome] = []
        # optional obs feed: per-kind latency histogram + failure counter
        # (the table itself keeps exact percentiles over the outcome list
        # — locust parity — while scrapes see the mergeable histogram)
        self._m_latency = self._m_failures = None
        if metrics is not None:
            lab = {"kind": kind}
            self._m_latency = metrics.histogram(
                "http_request_seconds", "client-observed request latency",
                lab)
            self._m_failures = metrics.counter(
                "http_failures_total", "non-2xx client outcomes", lab)

    def run(self) -> LoadReport:
        for u in range(self.users):
            delay = u / self.spawn_rate
            self.clock.schedule(delay, self._user_loop)
        self.clock.run(until=self.duration)
        return self._report()

    def _user_loop(self) -> None:
        if self.clock.now >= self.duration:
            return

        def done(outcome: Outcome):
            self.outcomes.append(outcome)
            if self._m_latency:
                self._m_latency.observe(outcome.latency)
                if not outcome.ok:
                    self._m_failures.inc()
            think = self._rng.uniform(*self.think)
            self.clock.schedule(think, self._user_loop)

        self.issue(done)

    def _report(self) -> LoadReport:
        # percentiles come from the same fixed-bucket histogram the
        # metrics endpoint would scrape (the mean stays exact — sum and
        # count are tracked exactly), so the locust-style table and the
        # obs layer can never disagree about the run.
        hist = self._m_latency or Histogram()
        if not self._m_latency:
            for o in self.outcomes:
                hist.observe(o.latency)
        fails = sum(1 for o in self.outcomes if not o.ok)
        per_status: Dict[int, int] = {}
        for o in self.outcomes:
            per_status[o.status] = per_status.get(o.status, 0) + 1
        return LoadReport(
            kind=self.kind, users=self.users, spawn_rate=self.spawn_rate,
            duration=self.duration, total=len(self.outcomes),
            failures=fails,
            mean_ms=hist.mean * 1e3,
            median_ms=hist.quantile(0.5) * 1e3,
            p95_ms=hist.quantile(0.95) * 1e3,
            rps=len(self.outcomes) / self.duration,
            per_status=per_status)


# ---------------------------------------------------------------- LLM loads
# Prompt workloads for the token-level engines (LLMEngine /
# PagedLLMEngine drive step() themselves — no virtual clock needed; the
# workload is just the prompt set with known sharing structure).


@dataclasses.dataclass
class SharedPrefixWorkload:
    """``num_prefixes`` tenant "system prompts" of ``prefix_len`` tokens,
    each request appending a unique ``suffix_len``-token user turn —
    the traffic shape the radix prefix cache targets."""

    prompts: List[np.ndarray]
    prefix_len: int
    suffix_len: int
    num_prefixes: int

    @property
    def total_prompt_tokens(self) -> int:
        return sum(len(p) for p in self.prompts)


@dataclasses.dataclass
class MixedLengthWorkload:
    """Long-tail prompt/output lengths — the traffic shape that makes
    per-exact-length prefill retracing hurt and length bucketing pay."""

    prompts: List[np.ndarray]
    max_news: List[int]

    @property
    def total_prompt_tokens(self) -> int:
        return sum(len(p) for p in self.prompts)

    @property
    def distinct_prompt_lens(self) -> int:
        return len({len(p) for p in self.prompts})


def mixed_length_workload(*, num_requests: int, vocab_size: int,
                          min_len: int = 4, max_len: int = 96,
                          median_len: float = 12.0, sigma: float = 0.8,
                          min_new: int = 2, max_new: int = 24,
                          seed: int = 0) -> MixedLengthWorkload:
    """Lognormal prompt and output lengths (clamped to [min_len, max_len]
    / [min_new, max_new]): most requests are short, a heavy tail is long
    — like real chat traffic.  Nearly every request has a distinct raw
    length, so an engine without length-bucketed prefill retraces per
    request while a bucketed one compiles O(#buckets) variants."""
    rng = np.random.default_rng(seed)
    lens = np.clip(np.round(rng.lognormal(np.log(median_len), sigma,
                                          num_requests)).astype(int),
                   min_len, max_len)
    news = np.clip(np.round(rng.lognormal(np.log(8.0), 0.6,
                                          num_requests)).astype(int),
                   min_new, max_new)
    prompts = [rng.integers(1, vocab_size, int(n)).astype(np.int32)
               for n in lens]
    return MixedLengthWorkload(prompts, [int(n) for n in news])


@dataclasses.dataclass
class BurstyMixedWorkload:
    """Mixed-length prompts arriving in bursts — the continuous-batching
    stress shape: each burst lands several requests at once (long tail
    included), so the engine faces a prefill backlog while earlier
    bursts are mid-decode.  A one-admission-per-step scheduler stalls
    every running decode for each whole-prompt prefill; chunked
    continuous admission drains the backlog under a token budget and
    keeps decode latency flat."""

    bursts: List[List[np.ndarray]]       # prompts per burst
    burst_news: List[List[int]]          # max_new per prompt per burst

    @property
    def prompts(self) -> List[np.ndarray]:
        return [p for burst in self.bursts for p in burst]

    @property
    def max_news(self) -> List[int]:
        return [n for burst in self.burst_news for n in burst]

    @property
    def total_prompt_tokens(self) -> int:
        return sum(len(p) for p in self.prompts)


def bursty_mixed_workload(*, num_bursts: int, burst_size: int,
                          vocab_size: int, min_len: int = 4,
                          max_len: int = 96, median_len: float = 12.0,
                          sigma: float = 0.8, min_new: int = 2,
                          max_new: int = 24,
                          seed: int = 0) -> BurstyMixedWorkload:
    """Chunk a lognormal mixed-length workload into arrival bursts, with
    each burst's longest prompt forced to ``max_len`` so every burst
    carries at least one backlog-building long prefill."""
    wl = mixed_length_workload(
        num_requests=num_bursts * burst_size, vocab_size=vocab_size,
        min_len=min_len, max_len=max_len, median_len=median_len,
        sigma=sigma, min_new=min_new, max_new=max_new, seed=seed)
    rng = np.random.default_rng(seed + 1)
    bursts, news = [], []
    for b in range(num_bursts):
        sl = slice(b * burst_size, (b + 1) * burst_size)
        prompts = wl.prompts[sl]
        longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
        prompts[longest] = rng.integers(1, vocab_size,
                                        max_len).astype(np.int32)
        bursts.append(prompts)
        news.append(wl.max_news[sl])
    return BurstyMixedWorkload(bursts, news)


@dataclasses.dataclass
class WindowedLongContextWorkload:
    """Long prompts with long decode runs for a sliding-window stack —
    the traffic shape where eager out-of-window block freeing pays.
    Every context grows far past ``window``, so a window-blind pool
    holds blocks for the whole growing context while window-aware
    accounting caps each request at ceil(window/block)+1 live blocks."""

    prompts: List[np.ndarray]
    max_news: List[int]
    window: int

    @property
    def total_prompt_tokens(self) -> int:
        return sum(len(p) for p in self.prompts)

    @property
    def max_final_len(self) -> int:
        return max(len(p) + n
                   for p, n in zip(self.prompts, self.max_news))


def windowed_long_context_workload(*, num_requests: int, vocab_size: int,
                                   window: int, prompt_len: int = 20,
                                   max_new: int = 24,
                                   seed: int = 0) -> WindowedLongContextWorkload:
    """Uniform-random prompts of ``prompt_len`` tokens (well past the
    attention window) decoding ``max_new`` +- 25% continuation tokens —
    the jitter staggers completions so the engine sees a mix of mid-
    and late-decode requests, like a real long-generation batch."""
    assert prompt_len > window, "long-context means prompts exceed the window"
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab_size, prompt_len).astype(np.int32)
               for _ in range(num_requests)]
    lo = max(1, max_new - max_new // 4)
    news = [int(rng.integers(lo, max_new + 1)) for _ in range(num_requests)]
    return WindowedLongContextWorkload(prompts, news, window)


@dataclasses.dataclass
class RepetitiveWorkload:
    """Repetition-heavy prompts with long continuations — the traffic
    shape where n-gram / prompt-lookup speculative drafting is hot:
    structured text (code, logs, templated chat) keeps re-using short
    token patterns, so the drafted continuation of the current suffix
    n-gram usually matches what greedy decode emits next."""

    prompts: List[np.ndarray]
    max_news: List[int]

    @property
    def total_prompt_tokens(self) -> int:
        return sum(len(p) for p in self.prompts)


def repetitive_workload(*, num_requests: int, vocab_size: int,
                        period_lo: int = 2, period_hi: int = 5,
                        prompt_len: int = 16, max_new: int = 40,
                        seed: int = 0) -> RepetitiveWorkload:
    """Each prompt cycles a random ``period``-token pattern (period
    drawn from [period_lo, period_hi]) out to ``prompt_len`` tokens and
    decodes ``max_new`` continuation tokens.  The prompt itself hands
    the n-gram drafter an immediate lookup table, and greedy decode on
    a repetitive context tends to continue the repetition — both the
    draft-hit mechanism real repetition-heavy traffic exhibits."""
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(num_requests):
        period = int(rng.integers(period_lo, period_hi + 1))
        pat = rng.integers(1, vocab_size, period).astype(np.int32)
        reps = -(-prompt_len // period)
        prompts.append(np.tile(pat, reps)[:prompt_len].astype(np.int32))
    return RepetitiveWorkload(prompts, [max_new] * num_requests)


@dataclasses.dataclass
class MultiTenantWorkload:
    """The cluster-tier traffic shape: ``num_tenants`` tenants with
    shared system prompts, lognormal user-turn and output lengths, and
    bursty arrivals — ``shared_prefix``-style KV reuse layered under
    ``bursty_mixed``-style admission pressure.  Prefix-affinity routing
    is exactly the mechanism this shape rewards: with tenants scattered
    across replicas every engine re-prefills every tenant's prefix (and
    N small LRU caches thrash); with affinity each tenant's KV
    concentrates on one replica."""

    bursts: List[List[np.ndarray]]       # prompts per arrival burst
    burst_news: List[List[int]]          # max_new per prompt per burst
    tenants: List[List[int]]             # tenant id per prompt per burst
    prefix_len: int
    num_tenants: int

    @property
    def prompts(self) -> List[np.ndarray]:
        return [p for burst in self.bursts for p in burst]

    @property
    def max_news(self) -> List[int]:
        return [n for burst in self.burst_news for n in burst]

    @property
    def tenant_ids(self) -> List[int]:
        return [t for burst in self.tenants for t in burst]

    @property
    def total_prompt_tokens(self) -> int:
        return sum(len(p) for p in self.prompts)


def multi_tenant_workload(*, num_tenants: int, num_bursts: int,
                          burst_size: int, prefix_len: int,
                          vocab_size: int, min_suffix: int = 2,
                          max_suffix: int = 24, median_suffix: float = 6.0,
                          sigma: float = 0.8, min_new: int = 2,
                          max_new: int = 16,
                          seed: int = 0) -> MultiTenantWorkload:
    """Each request picks a random tenant, prepends that tenant's
    ``prefix_len``-token system prompt to a lognormal-length user turn,
    and decodes a lognormal number of output tokens; requests arrive in
    ``burst_size`` groups.  User turns are tagged with a per-request
    distinct lead token exactly like ``shared_prefix_workload`` — the
    cache-sharing boundary stays at the tenant prefix, so per-replica
    ``hit_rate`` cleanly measures routing quality, not accidental
    suffix overlap."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, vocab_size, prefix_len).astype(np.int32)
                for _ in range(num_tenants)]
    bursts, news, tenants = [], [], []
    i = 0
    for _ in range(num_bursts):
        bp, bn, bt = [], [], []
        for _ in range(burst_size):
            t = int(rng.integers(num_tenants))
            slen = int(np.clip(round(rng.lognormal(np.log(median_suffix),
                                                   sigma)),
                               min_suffix, max_suffix))
            suffix = rng.integers(1, vocab_size, slen).astype(np.int32)
            suffix[0] = 1 + (i % (vocab_size - 1))
            bp.append(np.concatenate([prefixes[t], suffix]))
            bn.append(int(np.clip(round(rng.lognormal(np.log(6.0), 0.6)),
                                  min_new, max_new)))
            bt.append(t)
            i += 1
        bursts.append(bp)
        news.append(bn)
        tenants.append(bt)
    return MultiTenantWorkload(bursts, news, tenants, prefix_len,
                               num_tenants)


def shared_prefix_workload(*, num_requests: int, prefix_len: int,
                           suffix_len: int, vocab_size: int,
                           num_prefixes: int = 1, seed: int = 0,
                           tag_suffixes: bool = True) -> SharedPrefixWorkload:
    """Round-robins requests over ``num_prefixes`` shared prefixes; with
    the prefix cache on, only the first request per tenant pays the
    prefix prefill.

    ``tag_suffixes`` leads every user turn with a per-request distinct
    token (a user-id token): divergence then always happens at the first
    suffix token, so two users' turns never accidentally share a
    partial-block run (the copy-on-write path has dedicated tests; the
    workload measures pure prefix sharing with stable prefill shapes)."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, vocab_size, prefix_len).astype(np.int32)
                for _ in range(num_prefixes)]
    prompts = []
    for i in range(num_requests):
        suffix = rng.integers(1, vocab_size, suffix_len).astype(np.int32)
        if tag_suffixes:
            suffix[0] = 1 + (i % (vocab_size - 1))
        prompts.append(np.concatenate([prefixes[i % num_prefixes], suffix]))
    return SharedPrefixWorkload(prompts, prefix_len, suffix_len,
                                num_prefixes)
