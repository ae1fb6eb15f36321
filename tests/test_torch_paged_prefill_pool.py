"""The pool entries of the ragged prefill, on the CPU.

``ops.paged_prefill_pool`` / ``paged_prefill_pool_int8`` take the block
pool, the table and the rows' cursors, and read the prefix themselves;
``attn_prefill_paged`` hands them the pool leaves as they are.  Three
checks, on seeded numpy pools (``test_torch_kernels.pool_case``: the null
block 0 at pos -1, null-padded tables, copy-on-write blocks whose donor
tails sit past a sharer's cursor, right-padded chunks), block sizes 1, 4
and 16, windows 0 and 5, GQA and MQA heads:

(a) each entry's plain version against the reference's
``paged_prefill_ref`` over keys gathered and concatenated with jnp as the
reference's ``attn_prefill_paged`` builds them (an int8 prefix
dequantized first), on the query lanes that see a key; float32 on both
sides over at most ~100 keys, sums in another order: ``atol=1e-5``;
(b) ``attn_prefill_paged`` equal, bit for bit, to the composition it
replaced (gather, cursor guard, concatenation, then the contiguous entry);
(c) ``attn_prefill_paged`` with the op replaced by a recording stub
issues no aten op over a pool leaf (no gather) and no concatenation along
the key axis, where that composition issues both.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from torch.utils._pytree import tree_flatten  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import _dequantize_kv as jdequant  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.models.transformer import layer_views  # noqa: E402
from test_torch_kernels import _quantized, pool_case  # noqa: E402

ATOL = 1e-5
HEADS = {"gqa": (4, 2), "mqa": (4, 1)}


def _jax_keys(q, k_pool, v_pool, pos_pool, bt, starts, k, v, kpos,
              scales=None):
    """The reference's key assembly (``attn_prefill_paged``): gather
    through the table (dequantize an int8 prefix), guard at the cursors,
    concatenate the chunk."""
    b, nb = bt.shape
    bs, kv, hd = k_pool.shape[1:]
    jbt = jnp.asarray(bt)
    if scales is None:
        pk, pv = jnp.asarray(k_pool)[jbt], jnp.asarray(v_pool)[jbt]
    else:
        pk = jdequant(jnp.asarray(k_pool)[jbt], jnp.asarray(scales[0])[jbt],
                      jnp.float32)
        pv = jdequant(jnp.asarray(v_pool)[jbt], jnp.asarray(scales[1])[jbt],
                      jnp.float32)
    pk, pv = pk.reshape(b, nb * bs, kv, hd), pv.reshape(b, nb * bs, kv, hd)
    ppos = jnp.asarray(pos_pool)[jbt].reshape(b, nb * bs)
    sp = jnp.expand_dims(jnp.asarray(starts, jnp.int32), -1)
    ppos = jnp.where(ppos < sp, ppos, -1)
    return (jnp.concatenate([pk, jnp.asarray(k)], 1),
            jnp.concatenate([pv, jnp.asarray(v)], 1),
            jnp.concatenate([ppos, jnp.asarray(kpos)], 1))


@pytest.mark.parametrize("bs", [1, 4, 16])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("int8", [False, True])
def test_plain_versions_match_the_reference(bs, window, heads, int8):
    h, kv = HEADS[heads]
    rng = np.random.default_rng(bs + 10 * window + 100 * kv + 1000 * int8)
    # a padding row (2) and, at bs 4, one cursor for every row
    same = bs == 4
    q, kp, vp, pp, bt, starts, k, v, kpos, qpos = pool_case(
        rng, 5, 6, h, kv, 16, 23, bs, null_rows=(2,), same_start=same)
    start = int(starts[0]) if same else torch.from_numpy(starts)
    t = torch.from_numpy
    if int8:
        (k8, ks), (v8, vs) = _quantized(t(kp)), _quantized(t(vp))
        ours = ops.paged_prefill_pool_int8(
            t(q), k8, v8, ks, vs, t(pp), t(bt), start, t(k), t(v), t(kpos),
            t(qpos), window=window)
        keys = _jax_keys(q, k8.numpy(), v8.numpy(), pp, bt,
                         starts[0] if same else starts, k, v, kpos,
                         scales=(ks.numpy(), vs.numpy()))
    else:
        ours = ops.paged_prefill_pool(t(q), t(kp), t(vp), t(pp), t(bt), start,
                                      t(k), t(v), t(kpos), t(qpos),
                                      window=window)
        keys = _jax_keys(q, kp, vp, pp, bt, starts[0] if same else starts,
                         k, v, kpos)
    oracle = np.asarray(jref.paged_prefill_ref(
        jnp.asarray(q), *keys, jnp.asarray(qpos), window=window))
    kp_all, qp = np.asarray(keys[2])[:, None, :], qpos[:, :, None]
    vis = (kp_all >= 0) & (kp_all <= qp)
    if window:
        vis &= qp - kp_all < window
    lanes = vis.any(-1)
    # the case reaches what it is drawn for: guarded donor tails, null
    # table columns, padded chunk lanes
    raw = np.concatenate([pp[bt].reshape(5, -1), kpos], 1)
    tails = ((raw >= 0) & (np.asarray(keys[2]) < 0)).any()
    assert tails == (bs > 1 and not same)
    assert (bt == 0).any() and (kpos < 0).any()
    np.testing.assert_allclose(ours.numpy()[lanes], oracle[lanes],
                               atol=ATOL, rtol=ATOL)


def _layer(arch, quant):
    cfg = get_config(arch).reduced()
    if quant:
        cfg = dataclasses.replace(cfg, kv_cache_quant=True)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    return cfg, layer_views(cfg, params["stack"])[0]["mix"]


def _dispatch(cfg, quant, bs, seed):
    """x, positions, one layer's pool, the table, the cursors, seq_len
    for a ragged dispatch of 4 rows (row 3 padding)."""
    rng = np.random.default_rng(seed)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    _, kp, vp, pp, bt, starts, _, _, kpos, _ = pool_case(
        rng, 4, 8, cfg.num_heads, kv, hd, 40, bs, null_rows=(3,))
    t = torch.from_numpy
    pool = {"pos": t(pp)}
    if quant:
        (pool["k"], pool["k_s"]), (pool["v"], pool["v_s"]) = (
            _quantized(t(kp)), _quantized(t(vp)))
    else:
        pool["k"], pool["v"] = t(kp), t(vp)
    seq_len = t((kpos >= 0).sum(1).astype(np.int32))
    positions = t(starts[:, None] + np.arange(8, dtype=np.int32))
    x = t(rng.normal(size=(4, 8, cfg.d_model)).astype(np.float32))
    return x, positions, pool, t(bt), t(starts), seq_len


def _composed(p, cfg, x, positions, pool, block_table, start_pos, *, kind,
              seq_len):
    """``attn_prefill_paged`` as it read the pool before the pool entries:
    the prefix gathered through the table, its positions guarded at the
    cursors, the chunk concatenated after it, then the contiguous entry."""
    rope = cfg.pos_kind == "rope"
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    b, s, _ = x.shape
    window = cfg.sliding_window if kind == "attn_local" else 0
    q, k, v = tattn._project_qkv(p, cfg, x, positions, rope, kind)
    bs = pool["pos"].shape[-1]
    nb = block_table.shape[1]
    bt = block_table.long()
    ppos = pool["pos"][bt].reshape(b, nb * bs)
    sp = torch.as_tensor(start_pos, dtype=torch.int32).reshape(-1, 1)
    ppos = torch.where(ppos < sp, ppos, -1)
    qpos = tattn._bcast_pos(positions, b, s)
    lanes = torch.arange(s, dtype=torch.int32)
    kpos_suffix = torch.where(lanes[None, :] < seq_len[:, None], qpos, -1)
    kpos_suffix = kpos_suffix.to(torch.int32)
    if cfg.kv_cache_quant:
        pk, pv = (pool[n][bt].reshape(b, nb * bs, kv, hd) for n in "kv")
        ps_k, ps_v = (pool[n][bt].reshape(b, nb * bs, kv)
                      for n in ("k_s", "v_s"))
        out = ops.paged_prefill_int8(
            q.contiguous(), pk, pv, ps_k, ps_v, ppos, k.contiguous(),
            v.contiguous(), kpos_suffix, qpos, window=window)
        return tattn._out_proj(out, p["wo"]), {
            **tattn._quantized_entries(k, v), "pos": kpos_suffix}
    pk = pool["k"][bt].to(k.dtype).reshape(b, nb * bs, kv, hd)
    pv = pool["v"][bt].to(v.dtype).reshape(b, nb * bs, kv, hd)
    out = ops.paged_prefill(q.contiguous(), torch.cat([pk, k], dim=1),
                            torch.cat([pv, v], dim=1),
                            torch.cat([ppos, kpos_suffix], 1).to(torch.int32),
                            qpos, window=window)
    return tattn._out_proj(out, p["wo"]), {"k": k, "v": v,
                                           "pos": kpos_suffix}


CASES = [("qwen3-0.6b", "attn"), ("gemma3-4b", "attn_local")]


@pytest.mark.parametrize("arch,kind", CASES)
@pytest.mark.parametrize("bs", [1, 4, 16])
@pytest.mark.parametrize("quant", [False, True])
def test_attn_prefill_paged_equals_the_composition_it_replaced(arch, kind,
                                                               bs, quant):
    cfg, p = _layer(arch, quant)
    x, positions, pool, bt, starts, seq_len = _dispatch(cfg, quant, bs, bs)
    with torch.no_grad():
        y, cache = tattn.attn_prefill_paged(p, cfg, x, positions, pool, bt,
                                            starts, kind=kind,
                                            seq_len=seq_len)
        y0, cache0 = _composed(p, cfg, x, positions, pool, bt, starts,
                               kind=kind, seq_len=seq_len)
    assert torch.equal(y, y0)
    assert cache.keys() == cache0.keys()
    assert all(torch.equal(cache[n], cache0[n]) for n in cache)


class _Record(TorchDispatchMode):
    """Every aten op issued inside, with its arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.calls.append((func, args, kwargs))
        return func(*args, **kwargs)


def _pool_reads_and_key_cats(calls, pool):
    """(ops that read a pool leaf's storage, concatenations along dim 1:
    the key axis of (B, L, ...) operands)."""
    leaves = {t.untyped_storage().data_ptr() for t in pool.values()}
    reads, cats = [], []
    for func, args, kwargs in calls:
        tensors = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        if any(a.untyped_storage().data_ptr() in leaves for a in tensors):
            reads.append(func)
        if func.overloadpacket is torch.ops.aten.cat:
            ts = args[0]
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            if dim % ts[0].dim() == 1:
                cats.append(func)
    return reads, cats


@pytest.mark.parametrize("quant", [False, True])
def test_attn_prefill_paged_gathers_and_concatenates_nothing(quant,
                                                            monkeypatch):
    cfg, p = _layer("qwen3-0.6b", quant)
    x, positions, pool, bt, starts, seq_len = _dispatch(cfg, quant, 4, 9)
    name = "paged_prefill_pool_int8" if quant else "paged_prefill_pool"
    seen = []

    def stub(q, *args, **kwargs):
        seen.append(args)
        return torch.zeros_like(q)

    monkeypatch.setattr(ops, name, stub)
    with torch.no_grad(), _Record() as rec:
        tattn.attn_prefill_paged(p, cfg, x, positions, pool, bt, starts,
                                 kind="attn", seq_len=seq_len)
    assert len(seen) == 1
    # the pool's leaves and the table reach the op as they are
    leaves = ("k", "v", "k_s", "v_s", "pos") if quant else ("k", "v", "pos")
    assert all(a is pool[n] for a, n in zip(seen[0], leaves))
    assert seen[0][len(leaves)] is bt
    assert _pool_reads_and_key_cats(rec.calls, pool) == ([], [])
    # the detector sees the gathers and concatenations of the composition
    with torch.no_grad(), _Record() as rec:
        _composed(p, cfg, x, positions, pool, bt, starts, kind="attn",
                  seq_len=seq_len)
    reads, cats = _pool_reads_and_key_cats(rec.calls, pool)
    assert torch.ops.aten.index.Tensor in reads
    assert len(cats) == 3
