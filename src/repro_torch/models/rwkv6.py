"""RWKV-6 (Finch) block: token-shift time-mix with data-dependent decay.

The port of ``repro.models.rwkv6`` (arXiv:2404.05892, with the
reference's simplifications: one mix LoRA shared by r/k/v/w/g, an RMS
head-norm instead of GroupNorm):

  time-mix:   xx_t = x_{t-1} - x_t           (token shift)
              m_t  = mu + lora_mix(x_t + xx_t * mu)       # data-dep mix
              x^c_t = x_t + xx_t * m^c_t                  # c in {r,k,v,w,g}
              r,k,v,g = W_r x^r, W_k x^k, W_v x^v, silu(W_g x^g)
              w_t  = exp(-exp(w_base + lora_w(x^w_t) - 3))  # per-channel decay
              o_t[v]  = sum_k r[k] (S[k,v] + u[k] k[k] v[v])
              S_t  = diag(w_t) S_{t-1} + k_t (x) v_t      # per head
              y    = W_o (headnorm(o) * g)

  channel-mix: squared-ReLU FFN on the token-shifted input (rwkv6 blocks
  never read ``cfg.mlp_kind``).

The recurrence always goes through ``ops.rwkv6_scan``: the CUDA kernel on
the card, its plain version on the CPU, for a whole prompt, a ragged
chunk and one decode token alike.  The reference's masked per-row scan
(``seq_len``, right-padded ragged paged prefill) takes the same scan:
past a row's valid lanes the decay is 1 and the key 0, so ``S = 1 S +
0 (x) v`` carries the state through exactly where the reference freezes
it.  In training the scan differentiates through ``ops``'s autograd
Function (backward: the ``rwkv6_scan_bwd`` kernel on the card, its plain
version on the CPU), and so do the (B,H,S,hd) views it is given.

The reference's ``shard()`` constraints sit where its own do (no-ops
without sharding rules); under rules the scan runs on each device's
heads (``sharding.local``), its sequence whole.  ``recurrence_cost`` is
the reference's analytic count of the scan, which the dry-run reads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.module import ParamSpec, at_least_f32, fake_mode
from repro_torch.models.sharding import local, shard

LORA_RANK = 64


def num_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def rwkv_schema(cfg: ModelConfig):
    d = cfg.d_model
    h, hd = num_heads(cfg), cfg.rwkv_head_dim
    r = LORA_RANK
    return {
        "mu": ParamSpec((5, d), (None, "d_model"), init="zeros"),
        "mix_a": ParamSpec((d, r), ("d_model", None), scale_dim=-2),
        "mix_b": ParamSpec((r, 5, d), (None, None, "d_model"),
                           init="zeros"),
        "w_base": ParamSpec((d,), ("d_model",), init="zeros"),
        "w_a": ParamSpec((d, r), ("d_model", None), scale_dim=-2),
        "w_b": ParamSpec((r, d), (None, "d_model"), init="zeros"),
        "u": ParamSpec((h, hd), ("heads", "head_dim"), init="zeros"),
        "wr": ParamSpec((d, d), ("d_model", "heads_x_dim"), scale_dim=-2),
        "wk": ParamSpec((d, d), ("d_model", "heads_x_dim"), scale_dim=-2),
        "wv": ParamSpec((d, d), ("d_model", "heads_x_dim"), scale_dim=-2),
        "wg": ParamSpec((d, d), ("d_model", "heads_x_dim"), scale_dim=-2),
        "wo": ParamSpec((d, d), ("heads_x_dim", "d_model"), scale_dim=-2),
        "head_scale": ParamSpec((h, hd), ("heads", "head_dim"),
                                init="ones"),
    }


def channel_mix_schema(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": ParamSpec((d,), ("d_model",), init="zeros"),
        "wk_cm": ParamSpec((d, f), ("d_model", "d_ff"), scale_dim=-2),
        "wv_cm": ParamSpec((f, d), ("d_ff", "d_model"), scale_dim=-2),
    }


def channel_mix(p, cfg: ModelConfig, x, x_prev, seq_len=None):
    """RWKV channel-mix: squared-ReLU FFN on the token-shifted input.
    x (B,S,D), x_prev (B,D) -> (y, new x_prev = x's last valid lane)."""
    prev = _token_shift(x, x_prev)
    xk = x + (prev - x) * p["mu_k"]
    k = shard(torch.square(F.relu(xk @ p["wk_cm"])), "batch", "seq", "d_ff")
    return (shard(k @ p["wv_cm"], "batch", "seq", "d_model"),
            _last_valid(x, seq_len))


def init_state(cfg: ModelConfig, batch: int, dtype, device):
    """Zero recurrent state of one layer: ``s`` (B,H,hd,hd) float32,
    ``x_tm`` / ``x_cm`` (B,D) in the model dtype."""
    h, hd = num_heads(cfg), cfg.rwkv_head_dim
    return {
        "s": torch.zeros(batch, h, hd, hd, dtype=torch.float32,
                         device=device),
        "x_tm": torch.zeros(batch, cfg.d_model, dtype=dtype, device=device),
        "x_cm": torch.zeros(batch, cfg.d_model, dtype=dtype, device=device),
    }


def abstract_state(cfg: ModelConfig, batch: int, dtype):
    """``init_state`` as fake tensors on the CPU (``module.fake_mode``)."""
    with fake_mode():
        return init_state(cfg, batch, dtype, "cpu")


STATE_LOGICAL = {
    "s": ("batch", "heads", "head_dim", "head_dim2"),
    "x_tm": ("batch", "d_model"),
    "x_cm": ("batch", "d_model"),
}

# the scan's operands on each device: its heads, the sequence whole
_HEADS = ("batch", "heads", None, "head_dim")
_SCAN_IN = (_HEADS,) * 4 + (("heads", "head_dim"), STATE_LOGICAL["s"])
_SCAN_OUT = (_HEADS, STATE_LOGICAL["s"])


def _token_shift(x, x_prev):
    """x (B,S,D), x_prev (B,D) -> previous-token tensor (B,S,D)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _last_valid(x, seq_len=None):
    """x (B,S,D) -> lane seq_len-1 of each row (B,D); lane S-1 when
    ``seq_len`` is None (the unpadded full-sequence path)."""
    if seq_len is None:
        return x[:, -1, :]
    idx = (seq_len.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
    return torch.gather(x, 1, idx)[:, 0, :]


def _mix_heads(p, cfg, x, xx):
    """Data-dependent token-shift mixing -> the five mixed streams."""
    b, s, d = x.shape
    mu = p["mu"]                                       # (5, D)
    base = x[:, :, None, :] + xx[:, :, None, :] * mu[None, None]
    lora_in = torch.tanh((x + xx * mu[0]) @ p["mix_a"])           # (B,S,R)
    delta = (lora_in @ p["mix_b"].reshape(LORA_RANK, 5 * d)).reshape(
        b, s, 5, d)
    mixed = base + xx[:, :, None, :] * delta
    return mixed.unbind(dim=2)                         # r,k,v,w,g streams


def _decay(p, xw):
    """Per-channel decay in (0,1): w = exp(-exp(w_base + lora_w(xw) - 3)),
    float32."""
    lo = torch.tanh(xw) @ p["w_a"]
    raw = at_least_f32(p["w_base"]) + at_least_f32(lo @ p["w_b"])
    return torch.exp(-torch.exp(raw - 3.0))            # -3: init near slow decay


def _headnorm(o, scale, eps=1e-6):
    ms = torch.mean(torch.square(o), -1, keepdim=True)
    return o * torch.rsqrt(ms + eps) * scale[None, None]


def rwkv_time_mix(p, cfg: ModelConfig, x, state, seq_len=None):
    """x (B,S,D), state {"s", "x_tm", ...} -> (y (B,S,D), {"s": final
    state, "x_tm": x's last lane}); the caller adds "x_cm" after the
    channel-mix.  The WKV recurrence runs through ``ops.rwkv6_scan`` on
    float32 (B,H,S,hd) views of the (B,S,H,hd) projections.

    ``seq_len`` (B,) marks each row's valid lanes when x is right-padded
    (ragged paged prefill): past them the scan sees decay 1 and key 0,
    so its state stops at lane seq_len, and ``x_tm`` is lane seq_len-1;
    outputs at padded lanes are garbage the caller discards."""
    b, s, d = x.shape
    h, hd = num_heads(cfg), cfg.rwkv_head_dim
    prev = _token_shift(x, state["x_tm"])
    xx = prev - x
    xr, xk, xv, xw, xg = _mix_heads(p, cfg, x, xx)
    r = (xr @ p["wr"]).reshape(b, s, h, hd)
    k = (xk @ p["wk"]).reshape(b, s, h, hd)
    v = (xv @ p["wv"]).reshape(b, s, h, hd)
    g = F.silu(xg @ p["wg"])
    w = _decay(p, xw).reshape(b, s, h, hd)             # float32
    # split by heads as r, k, v are (its gradient gathered back in this
    # layout, not the scan's)
    w = shard(w, "batch", "seq", "heads", "head_dim")
    u = at_least_f32(p["u"])
    if seq_len is not None:
        pad = (torch.arange(s, device=x.device)[None, :]
               >= seq_len.long()[:, None])[:, :, None, None]
        w = torch.where(pad, 1.0, w)
        k = torch.where(pad, 0.0, at_least_f32(k))

    def heads_first(t):                                # (B,H,S,hd) view
        return at_least_f32(t).transpose(1, 2)

    out, s_final = local(kernel_ops.rwkv6_scan, _SCAN_IN, _SCAN_OUT)(
        heads_first(r), heads_first(k), heads_first(v), heads_first(w), u,
        at_least_f32(state["s"]))
    o = out.transpose(1, 2)                            # (B,S,H,hd)
    o = _headnorm(o, at_least_f32(p["head_scale"]))
    o = o.contiguous().reshape(b, s, d).to(x.dtype) * g
    y = shard(o @ p["wo"], "batch", "seq", "d_model")
    return y, {"s": shard(s_final, *STATE_LOGICAL["s"]),
               "x_tm": _last_valid(x, seq_len)}


def recurrence_cost(cfg: ModelConfig, batch: int, seq: int):
    """The reference's analytic (flops, bytes) of the WKV scan core: per
    token and channel pair the kv outer product, the bonus, the r.S
    reduction and the decay update; r, k, v, w streamed in and the state
    read and written each token, float32."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    flops = batch * seq * d * hd * 8.0
    bytes_ = batch * seq * (4 * d * 4.0 + 2 * d * hd * 4.0)
    return flops, bytes_
