"""The port's cluster tier (``repro_torch.serving.cluster``) against the
reference's (``repro.serving.cluster``).

Each test of ``tests/test_cluster.py`` is ported: on the CPU, reduced
qwen3-0.6b in float32 with the reference's parameters bridged into the
port, the port's ``ServingCluster`` holds its property (N broker-fed
replicas are a pure routing layer: one vs many vs slot token identity;
affinity keeps a tenant on one replica and raises hit rates;
deterministic replay; 429s at either tier enqueue nothing; the stats
schema; exact merged metrics), and on the same submissions the reference
cluster makes the same routing decisions (``route_log``), emits the same
tokens and reports the same ``stats()``.  Plus ``prefix_probe`` against
the reference's on one pool history, and on the card (marker ``cuda``;
no JAX, run with ``--noconftest``) a 2-replica cluster's exact
``paged_prefill`` launches.
"""
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.obs import summarize_latencies  # noqa: E402
from repro_torch.serving.balancer import LoadBalancer  # noqa: E402
from repro_torch.serving.broker import Broker, PartitionFull  # noqa: E402
from repro_torch.serving.cluster import Rejected, ServingCluster  # noqa: E402
from repro_torch.serving.loadgen import multi_tenant_workload  # noqa: E402
from repro_torch.serving.prefix_cache import chain_hashes  # noqa: E402
from repro_torch.serving.server import LLMEngine, PagedLLMEngine  # noqa: E402
from repro_torch.serving.stats_schema import validate  # noqa: E402

WORKLOAD = dict(num_tenants=3, num_bursts=2, burst_size=4, prefix_len=16,
                max_suffix=12, max_new=5, seed=2)


@pytest.fixture(scope="module")
def ref():
    """The reference's cluster pieces (JAX on the CPU); the card's test
    below needs none of them."""
    pytest.importorskip("jax")
    from repro.obs import summarize_latencies as jsummarize
    from repro.serving import balancer, broker, cluster, server, loadgen
    from repro.serving import stats_schema
    return types.SimpleNamespace(
        ServingCluster=cluster.ServingCluster, Rejected=cluster.Rejected,
        PagedLLMEngine=server.PagedLLMEngine,
        LoadBalancer=balancer.LoadBalancer, Broker=broker.Broker,
        PartitionFull=broker.PartitionFull, validate=stats_schema.validate,
        summarize_latencies=jsummarize,
        multi_tenant_workload=loadgen.multi_tenant_workload)


@pytest.fixture(scope="module")
def models(ref):
    """-> (reference model, its params, port model, bridged params)."""
    import jax

    from conftest import reduced_cfg
    from repro.models.api import Model as JaxModel
    from repro_torch.bridge import params_from_jax

    jm = JaxModel(reduced_cfg("qwen3-0.6b"))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, Model(get_config("qwen3-0.6b").reduced(),
                              device="cpu"), tparams


@pytest.fixture(scope="module")
def workload(ref):
    wl = multi_tenant_workload(vocab_size=512, **WORKLOAD)
    want = ref.multi_tenant_workload(vocab_size=512, **WORKLOAD)
    assert all(np.array_equal(a, b) for a, b in zip(wl.prompts, want.prompts))
    assert wl.max_news == want.max_news and wl.tenant_ids == want.tenant_ids
    return wl


def _make(engine_cls, model, params, **kw):
    kw.setdefault("num_blocks", 48)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 96)
    kw.setdefault("prefix_cache", True)
    return lambda i: engine_cls(model, params, **kw)


def _run(cluster, wl, rejected=Rejected):
    """Submit the whole workload, drain; -> outputs in submission order
    (None for rejected submissions)."""
    cids = []
    for i, (p, n) in enumerate(zip(wl.prompts, wl.max_news)):
        try:
            cids.append(cluster.submit(p, max_new=n, now=float(i)))
        except rejected:
            cids.append(None)
    outs = {r.cid: r.out_tokens for r in cluster.drain(now=100.0)}
    return [outs.get(c) for c in cids]


def _both(ref, models, wl, replicas, engine=None, **kw):
    """The same cluster on both sides, fed the same workload: routing,
    tokens and stats must be equal.  -> (port cluster, its outputs,
    reference cluster)."""
    jm, jparams, tm, tparams = models
    engine = engine or {}
    ours = ServingCluster(_make(PagedLLMEngine, tm, tparams, **engine),
                          replicas, **kw)
    theirs = ref.ServingCluster(_make(ref.PagedLLMEngine, jm, jparams,
                                      **engine), replicas, **kw)
    outs = _run(ours, wl)
    assert outs == _run(theirs, wl, ref.Rejected)
    assert ours.route_log == theirs.route_log
    assert ours.stats() == theirs.stats()
    return ours, outs, theirs


# ------------------------------------------------------- token identity


def test_cluster_token_identity_one_vs_many_vs_slot(ref, models, workload):
    """A bare paged engine, the slot engine, a 1-replica and a 3-replica
    cluster emit the same tokens; the reference's 3-replica cluster
    routes and answers as the port's."""
    _, _, tm, tparams = models
    wl = workload
    bare = _make(PagedLLMEngine, tm, tparams)(0)
    slot = LLMEngine(tm, tparams, num_slots=4, cache_max=96)
    outs = []
    for eng in (bare, slot):
        for p, n in zip(wl.prompts, wl.max_news):
            eng.submit(p, max_new=n)
        got = {}
        while not eng.idle:
            for r in eng.step():
                got[r.rid] = r.out_tokens
        outs.append([got[i + 1] for i in range(len(wl.prompts))])
    assert outs[1] == outs[0]
    one = _run(ServingCluster(_make(PagedLLMEngine, tm, tparams), 1,
                              seed=0), wl)
    assert one == outs[0]
    _, many, _ = _both(ref, models, wl, 3, seed=0)
    assert many == outs[0]


# ----------------------------------------------------- affinity routing


def test_affinity_keeps_tenants_on_one_replica(ref, models, workload):
    """With affinity on every request of a tenant lands on the replica
    that served its first, and the mean per-replica hit rate beats
    policy-only routing; each replica's hit rate is the reference's."""
    wl = workload
    on, outs, ref_on = _both(ref, models, wl, 2, affinity=True, seed=0)
    assert outs.count(None) == 0
    by_tenant = {}
    for (cid, rid, _), t in zip(on.route_log, wl.tenant_ids):
        by_tenant.setdefault(t, set()).add(rid)
    assert all(len(rids) == 1 for rids in by_tenant.values())
    s = validate(on.stats())
    assert s["affinity_misses"] <= wl.num_tenants
    assert s["affinity_hits"] == len(wl.prompts) - s["affinity_misses"]

    off, outs, ref_off = _both(ref, models, wl, 2, affinity=False, seed=0)
    assert outs.count(None) == 0
    assert off.stats()["affinity_hits"] == 0
    rates = {}
    for name, cl, theirs in (("on", on, ref_on), ("off", off, ref_off)):
        rates[name] = [e.stats()["hit_rate"] for e in cl.engines]
        assert rates[name] == [e.stats()["hit_rate"] for e in theirs.engines]
    assert np.mean(rates["on"]) > np.mean(rates["off"])

    # the affinity map is keyed by the radix tree's per-block tuples
    prompt = wl.prompts[0]
    assert len(chain_hashes(prompt[:-1], on.block_size)) == \
        (len(prompt) - 1) // on.block_size


def test_deterministic_replay(ref, models, workload):
    """Two clusters fed the same submissions route and answer alike (and
    as the reference's at the same seed)."""
    _, _, tm, tparams = models
    a, outs_a, _ = _both(ref, models, workload, 2, affinity=True, seed=3)
    b = ServingCluster(_make(PagedLLMEngine, tm, tparams), 2, affinity=True,
                       seed=3)
    assert _run(b, workload) == outs_a
    assert a.route_log == b.route_log


# ------------------------------------------------------- backpressure


def test_429_overload_keeps_accepted_requests_whole(ref, models, workload):
    """A saturated balancer rejects with 429 and never half-accepts:
    rejected submissions leave no broker record, every accepted ticket
    finishes, committed offsets end at produced."""
    cl, outs, theirs = _both(ref, models, workload, 2,
                             engine=dict(max_batch=2), affinity=False,
                             queue_limit=0, seed=0)
    accepted = sum(1 for o in outs if o is not None)
    rejected = outs.count(None)
    assert rejected > 0 and accepted == 4      # 2 replicas x max_batch 2
    s = validate(cl.stats())
    assert s["rejected_429"] == rejected
    assert s["submitted"] == s["finished"] == accepted
    assert cl.broker.produced == theirs.broker.produced == accepted
    for p in range(2):
        assert cl.broker.depth(p, cl.GROUP) == 0
    assert all(len(o) > 0 for o in outs if o is not None)


def test_429_partition_full_cancels_balancer_hold(ref, models, workload):
    """The broker-side 429 (partition full after the balancer said yes)
    rolls the balancer's hold back: no phantom load is left."""
    cl, outs, theirs = _both(ref, models, workload, 2, affinity=False,
                             queue_limit=64, broker_depth=2, seed=0)
    rejected = outs.count(None)
    assert rejected > 0
    assert cl.balancer.cancelled == theirs.balancer.cancelled == rejected
    assert all(r.in_flight == 0 for r in cl.balancer.replicas)
    assert cl.stats()["finished"] == len(outs) - rejected


# --------------------------------------------------------- stats schema


def test_cluster_stats_schema_two_way(ref, models):
    """Both packages' ``validate`` accept the live cluster dict and
    reject drift both ways for the ``cluster`` kind."""
    _, _, tm, tparams = models
    cl = ServingCluster(_make(PagedLLMEngine, tm, tparams), 2, seed=0)
    for check in (validate, ref.validate):
        s = check(cl.stats())
        assert s["engine"] == "cluster" and s["replicas"] == 2
        with pytest.raises(ValueError, match="undeclared"):
            check({**s, "mystery": 1})
        missing = dict(s)
        del missing["affinity_hits"]
        with pytest.raises(ValueError, match="missing"):
            check(missing)
        with pytest.raises(ValueError, match="undeclared"):
            check({**s, "hit_rate": 0.5})


# ------------------------------------------------- balancer scoring hook


def _balancer_story(cls):
    """The reference test's scenario on one balancer class; -> what it
    returned at each point."""
    lb = cls(2, concurrency=4, queue_limit=2, policy="least_loaded", seed=0)
    lb.attach_engine_stats(lambda: {"queue_depth": 5, "free_blocks": 30},
                           rid=0)
    lb.attach_engine_stats(lambda: {"queue_depth": 0, "free_blocks": 10},
                           rid=1)
    seen = [lb.pick().rid, lb._score(lb.replicas[0])]
    r0 = lb.pick(prefer=0)
    seen += [r0.rid, lb.affinity_picks]
    lb.cancel(r0)
    seen += [lb.replicas[0].in_flight, lb.replicas[0].served, lb.stats()]
    for _ in range(6):
        lb.pick(prefer=1)
    seen += [lb.replicas[1].full, lb.pick(prefer=1).rid]
    return seen


def test_balancer_occupancy_aware_scoring_and_cancel(ref):
    """Queue depth adds to load and free blocks break ties; ``prefer``
    overrides the policy unless the replica is full; ``cancel`` releases
    a hold without counting work served; the same story on the
    reference's balancer returns the same values."""
    seen = _balancer_story(LoadBalancer)
    assert seen[:6] == [1, (5, -30), 0, 1, 0, 0]
    st_ = seen[6]
    assert st_["cancelled"] == 1
    assert set(st_["engines"]) == {0, 1}
    assert st_["engines"][0]["queue_depth"] == 5
    assert seen[7:] == [True, 0]
    assert seen == _balancer_story(ref.LoadBalancer)


# -------------------------------------------------------- merged metrics


def test_merged_metrics_exact(ref, models, workload):
    """The fleet registry is an exact fold of the replicas' snapshots:
    replica-labelled counters keep their values, the unlabelled request
    histograms cover every finished request, and the latency summary
    (virtual time) is the reference's."""
    cl, outs, theirs = _both(ref, models, workload, 2, seed=0, obs=True)
    merged = cl.merged_metrics()
    per = [o.metrics.get("engine_finished_total",
                         {"engine": "paged", "replica": str(i)}).value
           for i, o in enumerate(cl.replica_obs)]
    assert sum(per) == len(outs)
    for i, v in enumerate(per):
        assert merged.get("engine_finished_total",
                          {"engine": "paged", "replica": str(i)}).value == v
    lat = summarize_latencies(merged)
    assert lat["requests"] == len(outs)
    assert lat == ref.summarize_latencies(theirs.merged_metrics())
    assert 'replica="1"' in merged.render()


# ------------------------------------------ broker routing property test


@settings(max_examples=50, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 2)),
                min_size=1, max_size=60),
       st.integers(2, 4))
def test_broker_pinned_partition_property(ref, ops_seq, partitions):
    """Over produce(partition=)/poll/commit/reject: a pinned record lands
    where the router said, offsets stay dense and increasing per
    partition, committed never passes produced, a full partition rejects
    without consuming an offset; the reference's broker returns the same
    at every step."""
    b = Broker(num_partitions=partitions, max_depth=4, seed=1)
    rb = ref.Broker(num_partitions=partitions, max_depth=4, seed=1)
    produced = {p: 0 for p in range(partitions)}
    committed = {p: 0 for p in range(partitions)}
    for op, arg in ops_seq:
        p = arg % partitions
        if op == 0:
            try:
                got_p, off = b.produce("v", partition=p)
                assert (got_p, off) == (p, produced[p])
                assert rb.produce("v", partition=p) == (got_p, off)
                produced[p] += 1
            except PartitionFull:
                assert b.depth(p) == b.max_depth
                with pytest.raises(ref.PartitionFull):
                    rb.produce("v", partition=p)
        elif op == 1:
            offs = [r.offset for r in b.poll("g", p, 8)]
            assert offs == list(range(committed[p],
                                      committed[p] + len(offs)))
            assert offs == [r.offset for r in rb.poll("g", p, 8)]
        elif op == 2:
            recs = b.poll("g", p, 8)
            if recs:
                b.commit("g", p, recs[-1].offset + 1)
                rb.commit("g", p, recs[-1].offset + 1)
                committed[p] = recs[-1].offset + 1
        else:
            with pytest.raises(ValueError):
                b.produce("v", partition=partitions)
    for p in range(partitions):
        assert committed[p] <= produced[p]
        assert b.depth(p, "g") == produced[p] - committed[p] == \
            rb.depth(p, "g")


# ---------------------------------------------------------- prefix_probe


def _lru(cache):
    """Every node's (path of keys, last-use stamp), and the clock."""
    out, stack = [], [((), cache._root)]
    while stack:
        path, node = stack.pop()
        for key, child in node.children.items():
            out.append((path + (key,), child.last_used))
            stack.append((path + (key,), child))
    return sorted(out), cache._clock


def test_prefix_probe_matches_reference_and_touches_nothing(ref, models):
    """After one pool history (three prompts sharing a 13-token prefix,
    blocks of 4), ``prefix_probe`` reads the reference's value for a
    cached prompt, a partial block, a diverged prompt, a one-token prompt
    and a stranger; it moves no LRU stamp and no hit/miss gauge, and is 0
    with the prefix cache off."""
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(5)
    head = rng.integers(1, 512, 13).astype(np.int32)
    history = [np.concatenate([head, rng.integers(1, 512, n)
                               .astype(np.int32)]) for n in (3, 6, 9)]
    kw = dict(num_blocks=32, block_size=4, max_batch=4, max_len=40,
              prefix_cache=True)
    ours = PagedLLMEngine(tm, tparams, **kw)
    theirs = ref.PagedLLMEngine(jm, jparams, **kw)
    for eng in (ours, theirs):
        for p in history:
            eng.submit(p, max_new=3)
        while not eng.idle:
            eng.step()
    probes = [history[2], history[0][:15], head,
              np.concatenate([head[:6], [7, 7, 7, 7, 7]]).astype(np.int32),
              head[:1], rng.integers(1, 512, 20).astype(np.int32)]
    before = (_lru(ours.prefix_cache), ours.prefix_cache.hit_tokens,
              ours.prefix_cache.miss_tokens, ours.stats())
    got = [ours.prefix_probe(p) for p in probes]
    assert got == [theirs.prefix_probe(p) for p in probes]
    assert got[0] > 12 and got[-1] == 0 and got[4] == 0
    assert (_lru(ours.prefix_cache), ours.prefix_cache.hit_tokens,
            ours.prefix_cache.miss_tokens, ours.stats()) == before
    off = PagedLLMEngine(tm, tparams, **{**kw, "prefix_cache": False})
    assert off.prefix_probe(history[0]) == 0


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_replica_cluster_launches_paged_prefill_per_step(cuda):
    """Two replicas of reduced qwen3-0.6b (float32, seeded weights) on one
    card, sharing one copy of the weights: every engine step of every
    replica is one fused dispatch, so ``paged_prefill`` launches equal
    layers x engine steps, and ``paged_attention`` never launches."""
    cfg = get_config("qwen3-0.6b").reduced()
    model = Model(cfg, device=cuda)
    params = model.init(seed=0)
    cl = ServingCluster(_make(PagedLLMEngine, model, params), 2, seed=0)
    steps = [0, 0]
    for i, eng in enumerate(cl.engines):
        assert eng.params is params
        def counted(now=0.0, _step=eng.step, _i=i):
            steps[_i] += 1
            return _step(now)
        eng.step = counted
    wl = multi_tenant_workload(vocab_size=cfg.vocab_size, **WORKLOAD)
    ops.reset_launch_counts()
    outs = _run(cl, wl)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert all(o is not None and len(o) > 0 for o in outs)
    assert min(steps) > 0
    assert counts["paged_prefill_pool"] == cfg.num_layers * sum(steps), (
        counts, steps)
    assert counts["paged_attention"] == counts["flash_attention"] == 0
    assert counts["paged_prefill"] == 0
    assert cl.stats()["finished"] == len(outs)
