"""The port's Stratus digit pipeline against the reference, on the CPU.

* Data: the port's copy of the synthetic MNIST makes bit-identical arrays.
* Checkpoints, both ways: the reference's ``StratusPipeline.train`` saves
  (briefly: 1,280 images, 2 rounds), the port's ``CheckpointManager``
  restores it bit for bit; a tree the port saves (with a bfloat16 leaf,
  upcast on disk and named in the manifest) restores bit for bit in the
  reference, and the reverse.
* The pipeline on those trained weights: ``evaluate`` gives the
  reference's accuracies and per-digit dict (an argmax may differ only
  where the reference's top-two logit margin is below 1e-5);
  ``predict_fn`` probabilities within ``atol=rtol=1e-5`` (float32 on
  both sides, probabilities below 1); 20 canvas digits posted through
  each ``StratusApp`` all return 200 and each ``req-N`` holds the same
  digit in both stores.
* The serving substrate, exactly: GET load reports at the paper's three
  regimes equal the reference's string for string (the GET path charges
  no wall time, so both runs are deterministic), and the same operations
  through the port's and the reference's broker, balancer and queued
  resource give the same results and the same metrics page.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core.pipeline import StratusPipeline as JaxPipeline  # noqa: E402
from repro.data import mnist as jmnist  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.serving import balancer as jbalancer  # noqa: E402
from repro.serving import broker as jbroker  # noqa: E402
from repro.serving import loadgen as jloadgen  # noqa: E402
from repro.serving import server as jserver  # noqa: E402
from repro.serving import sim as jsim  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.configs.mnist_cnn import CONFIG  # noqa: E402
from repro_torch.core.pipeline import StratusPipeline  # noqa: E402
from repro_torch.data import mnist as tmnist  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.serving import balancer as tbalancer  # noqa: E402
from repro_torch.serving import broker as tbroker  # noqa: E402
from repro_torch.serving import loadgen as tloadgen  # noqa: E402
from repro_torch.serving import server as tserver  # noqa: E402
from repro_torch.serving import sim as tsim  # noqa: E402

PROB_TOL = dict(atol=1e-5, rtol=1e-5)
TIE_MARGIN = 1e-5


# ------------------------------------------------------------ data


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("fn", ["make_split", "canvas_digits"])
def test_data_bit_identical_to_reference(fn, seed):
    ours = getattr(tmnist, fn)(40, seed)
    want = getattr(jmnist, fn)(40, seed)
    for a, b in zip(ours, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------ checkpoints


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The reference pipeline, briefly trained; its checkpoint directory."""
    root = tmp_path_factory.mktemp("ckpt")
    pipe = JaxPipeline(ckpt_dir=str(root), seed=0)
    pipe.train(train_n=1_280, rounds=2)
    return pipe, str(root)


@pytest.fixture(scope="module")
def port_pipe(trained):
    """The port's pipeline on the CPU with the reference's trained weights,
    restored from the reference's checkpoint."""
    _, root = trained
    pipe = StratusPipeline(seed=0, device="cpu")
    step, tree = tstore.CheckpointManager(root).restore_latest(
        {"params": pipe.params})
    assert step == 2
    pipe.params = tree["params"]
    return pipe


def test_port_restores_the_reference_pipeline_checkpoint(trained, port_pipe):
    jpipe, _ = trained
    assert sorted(port_pipe.params) == sorted(jpipe.params)
    for name, t in port_pipe.params.items():
        want = np.asarray(jpipe.params[name])
        assert t.device.type == "cpu" and t.dtype == torch.float32
        assert t.numpy().tobytes() == want.tobytes(), name


def _mixed_tree(params_np):
    """The trained params, a bfloat16 leaf and an int32 leaf in a list."""
    rng = np.random.default_rng(9)
    bf16 = rng.normal(size=(3, 5)).astype(jnp.bfloat16)
    return {"params": dict(params_np),
            "extra": {"scale": bf16,
                      "steps": [np.arange(4, dtype=np.int32)]}}


def _as_torch(tree):
    from repro_torch.bridge import params_from_jax

    def walk(node):
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return params_from_jax(node, device="cpu")

    return walk(tree)


def _bits(leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16", leaf.view(torch.int16).numpy().tobytes()
        return str(leaf.dtype).removeprefix("torch."), leaf.numpy().tobytes()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.int16).tobytes()
    return a.dtype.name, a.tobytes()


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoint_round_trips_between_packages(trained, tmp_path,
                                                 direction):
    jpipe, _ = trained
    tree_np = _mixed_tree(jax.tree.map(np.asarray, jpipe.params))
    tree_t = _as_torch(tree_np)
    if direction == "port_to_reference":
        tstore.CheckpointManager(str(tmp_path)).save(5, tree_t)
        assert jstore.latest_step(str(tmp_path)) == 5
        got = jstore.restore(str(tmp_path / "step_5"), tree_np)
    else:
        jstore.CheckpointManager(str(tmp_path)).save(5, tree_np)
        assert tstore.latest_step(str(tmp_path)) == 5
        got = tstore.restore(str(tmp_path / "step_5"), tree_t)
    manifest = json.loads((tmp_path / "step_5" / "manifest.json")
                          .read_text())
    assert manifest["dtypes"] == {"extra/scale": "bfloat16"}
    want_leaves = jax.tree_util.tree_leaves(tree_np)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves) == 8
    for g, w in zip(got_leaves, want_leaves):
        assert _bits(g) == _bits(w)


# ------------------------------------------------------------ the pipeline


def _margin(logits):
    top2 = np.sort(logits, -1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def test_evaluate_matches_reference(trained, port_pipe):
    jpipe, _ = trained
    ours = port_pipe.evaluate(test_n=200, canvas_n=100)
    want = jpipe.evaluate(test_n=200, canvas_n=100)
    flips = 0
    for x in (jmnist.make_split(200, 100)[0],
              jmnist.canvas_digits(100, 200)[0]):
        jl = np.asarray(jcnn.cnn_forward(jpipe.params, jpipe.cfg,
                                         jnp.asarray(x)))
        with torch.inference_mode():
            tl = tcnn.cnn_forward(port_pipe.params, CONFIG,
                                  torch.from_numpy(x)).numpy()
        diff = np.argmax(tl, -1) != np.argmax(jl, -1)
        assert np.all(_margin(jl)[diff] < TIE_MARGIN)
        flips += int(diff.sum())
    if flips == 0:
        assert ours == want


def test_predict_fn_matches_reference(trained, port_pipe):
    jpipe, _ = trained
    images = jmnist.canvas_digits(32, 3)[0]
    got = port_pipe.predict_fn()(images)
    want = jpipe.predict_fn()(images)
    assert got.dtype == np.float32 and got.shape == (32, 10)
    np.testing.assert_allclose(got, want, **PROB_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def _post_digits(pipe, sim, server, images):
    clock = sim.Clock()
    app = pipe.deploy(clock, server.AppConfig())
    outcomes = []
    for img in images:
        app.post_predict(img, outcomes.append)
    clock.run(until=30.0)
    return app, outcomes


def test_posted_digits_match_reference(trained, port_pipe):
    """examples/quickstart.py's deploy-and-post, 20 canvas digits."""
    jpipe, _ = trained
    images, _ = jmnist.canvas_digits(20, seed=42)
    ops.reset_launch_counts()
    apps = {}
    for name, pipe, sim, server in (("port", port_pipe, tsim, tserver),
                                    ("reference", jpipe, jsim, jserver)):
        app, outcomes = _post_digits(pipe, sim, server, images)
        assert len(outcomes) == 20, name
        assert {o.status for o in outcomes} == {200}, name
        assert all(o.kind == "POST" for o in outcomes)
        apps[name] = app
    assert ops.launch_counts()["conv2d"] == 0      # the CPU: plain version
    for i in range(20):
        key = f"req-{i + 1}"
        ours = apps["port"].store.poll(key)
        want = apps["reference"].store.poll(key)
        assert ours["digit"] == want["digit"], key
        np.testing.assert_allclose(ours["probs"], want["probs"], **PROB_TOL)


def test_pipeline_refuses_to_train():
    pipe = StratusPipeline(device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        pipe.train(train_n=640, rounds=1)


# ------------------------------------------------------------ substrate


def _uniform(images):
    return np.full((len(images), 10), 0.1, np.float32)


@pytest.mark.parametrize("users,rate", [(10, 1), (25, 3), (50, 5)])
def test_get_load_report_equals_reference(users, rate):
    """The paper's GET regimes (benchmarks/run.py's seeds), 120 s virtual."""
    rows = []
    for sim, server, loadgen, metrics in (
            (tsim, tserver, tloadgen, tmetrics),
            (jsim, jserver, jloadgen, jmetrics)):
        clock = sim.Clock()
        reg = metrics.MetricsRegistry()
        app = server.StratusApp(clock, _uniform, server.AppConfig(),
                                seed=users)
        gen = loadgen.LoadGenerator(clock, app.get_page, users=users,
                                    spawn_rate=rate, duration=120.0,
                                    seed=users, kind="GET", metrics=reg)
        rep = gen.run()
        rows.append((rep.row(), rep.per_status, reg.render()))
    assert rows[0] == rows[1]
    assert rows[0][1].get(200, 0) > 0


def _drive_broker(broker_mod, metrics_mod):
    reg = metrics_mod.MetricsRegistry()
    b = broker_mod.Broker(3, max_depth=4, seed=1, metrics=reg)
    out = []
    for i in range(16):
        key = None if i % 3 else f"k{i % 2}"
        part = 2 if i % 7 == 6 else None
        try:
            out.append(("produce", b.produce(i, key=key, timestamp=i,
                                             partition=part)))
        except broker_mod.PartitionFull as e:
            out.append(("full", str(e)))
        if i == 5:
            for p in range(3):
                recs = b.poll("g", p, max_records=2)
                out.append(("poll", p, [(r.offset, r.value) for r in recs]))
                if recs:
                    b.commit("g", p, recs[-1].offset + 1)
    out.append(("depth", [b.depth(p) for p in range(3)],
                [b.depth(p, "g") for p in range(3)], b.total_depth("g")))
    out.append(("counts", b.produced, b.rejected))
    return out, reg.render()


def _drive_balancer(policy):
    def drive(balancer_mod, metrics_mod):
        reg = metrics_mod.MetricsRegistry()
        lb = balancer_mod.LoadBalancer(3, concurrency=1, queue_limit=1,
                                       policy=policy, seed=2, metrics=reg)
        out, held = [], []
        for i in range(9):
            try:
                r = lb.pick(prefer=1 if i == 4 else None)
                held.append(r)
                out.append(("pick", r.rid))
            except balancer_mod.Overloaded:
                out.append(("overloaded",))
            if i % 3 == 2 and held:
                lb.release(held.pop(0))
        if held:
            lb.cancel(held.pop())
        out.append(("stats", lb.stats(), lb.max_load(), lb.imbalance()))
        return out, reg.render()
    return drive


def _drive_queued_resource(sim_mod, metrics_mod):
    reg = metrics_mod.MetricsRegistry()
    clock = sim_mod.Clock()
    res = sim_mod.QueuedResource(clock, 2, 2, metrics=reg, name="flask")
    out = []
    for i, d in enumerate((1.0, 0.5, 2.0, 0.25, 0.75, 0.1)):
        accepted = res.submit(d, lambda i=i: out.append(("done", i,
                                                         clock.now)))
        out.append(("submit", i, accepted, res.load))
    clock.run(until=1.2)
    out.append(("mid", clock.now, res.busy, res.load))
    clock.run()
    out.append(("end", clock.now, res.served, res.rejected))
    return out, reg.render()


SUBSTRATES = {
    "broker": (_drive_broker, "broker"),
    "queued_resource": (_drive_queued_resource, "sim"),
    **{f"balancer_{p}": (_drive_balancer(p), "balancer")
       for p in ("round_robin", "random", "least_loaded", "power_of_two")},
}


@pytest.mark.parametrize("name", sorted(SUBSTRATES))
def test_substrate_matches_reference(name):
    drive, module = SUBSTRATES[name]
    port_mod = {"broker": tbroker, "sim": tsim, "balancer": tbalancer}
    ref_mod = {"broker": jbroker, "sim": jsim, "balancer": jbalancer}
    ours = drive(port_mod[module], tmetrics)
    want = drive(ref_mod[module], jmetrics)
    assert ours == want
    assert ours[1].strip()            # the metrics page is not empty
