"""Mamba-style selective SSM layer (jamba's recurrent half).

The port of ``repro.models.ssm``, per layer:

    (x_in, z) = in_proj(x)                       # each (B, S, d_in)
    x_c       = causal_depthwise_conv(x_in)      # width ``ssm_conv_width``
    (dt, B, C) = x_proj(silu(x_c))               # dt scalar/token + bias
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t     # A = -exp(A_log), (d_in, N)
    y_t = (C_t . h_t) * silu(z_t)
    out = out_proj(y)

The recurrence always goes through ``ops.ssm_scan``: the CUDA kernel on
the card, its plain version on the CPU, for a whole prompt, a ragged
chunk and one decode token alike.  The state is ``{"h": (B, d_in, N)
float32, "conv": (B, W-1, d_in)}`` in the model dtype.

The reference's ``shard()`` constraints sit where its own do (no-ops
without sharding rules); under rules the scan runs on each device's
shards (``sharding.local``), its sequence whole.  ``recurrence_cost`` is
the reference's analytic count of the scan, which the dry-run reads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.module import ParamSpec, at_least_f32, fake_mode
from repro_torch.models.sharding import local, shard


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def ssm_schema(cfg: ModelConfig):
    d, n, w = cfg.d_model, cfg.ssm_state_dim, cfg.ssm_conv_width
    di = d_inner(cfg)
    return {
        "in_proj": ParamSpec((d, 2 * di), ("d_model", "d_ff"), scale_dim=-2),
        "conv": ParamSpec((w, di), ("conv", "d_ff"), init="scaled",
                          scale_dim=-2),
        "x_proj": ParamSpec((di, 2 * n + 1), ("d_ff", "state"),
                            scale_dim=-2),
        "dt_bias": ParamSpec((di,), ("d_ff",), init="zeros"),
        "a_log": ParamSpec((di, n), ("d_ff", "state"), init="ones"),
        "out_proj": ParamSpec((di, d), ("d_ff", "d_model"), scale_dim=-2),
    }


def init_state(cfg: ModelConfig, batch: int, dtype, device):
    """Zero state of one layer: ``h`` (B, d_in, N) float32, ``conv``
    (B, W-1, d_in) in the model dtype."""
    di, n, w = d_inner(cfg), cfg.ssm_state_dim, cfg.ssm_conv_width
    return {
        "h": torch.zeros(batch, di, n, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, w - 1, di, dtype=dtype, device=device),
    }


def abstract_state(cfg: ModelConfig, batch: int, dtype):
    """``init_state`` as fake tensors on the CPU (``module.fake_mode``)."""
    with fake_mode():
        return init_state(cfg, batch, dtype, "cpu")


STATE_LOGICAL = {
    "h": ("batch", "d_ff", "state"),
    "conv": ("batch", "conv", "d_ff"),
}

# the scan's operands on each device: its sequence whole
_SCAN_IN = (("batch", None, "d_ff"), ("batch", None, "state"),
            ("batch", None, "state"), ("batch", None, "d_ff"),
            ("d_ff", "state"), STATE_LOGICAL["h"])
_SCAN_OUT = (("batch", None, "d_ff"), STATE_LOGICAL["h"])


def _causal_conv(p, x_in, prev):
    """Depthwise causal conv over time.  x_in (B,S,di), ``prev``
    (B,W-1,di) the left context.  -> (out (B,S,di), xp = [prev | x_in]
    (B,S+W-1,di))."""
    w, s = p["conv"].shape[0], x_in.shape[1]
    xp = torch.cat([prev.to(x_in.dtype), x_in], dim=1)
    out = xp[:, 0:s] * p["conv"][0]
    for i in range(1, w):
        out = out + xp[:, i:i + s] * p["conv"][i]
    return out, xp


def _selective_terms(p, cfg: ModelConfig, x_c):
    """-> dt (B,S,di), bm (B,S,N), cm (B,S,N) float32, xc = silu(x_c)."""
    n = cfg.ssm_state_dim
    xc = F.silu(x_c)
    proj = at_least_f32(xc) @ at_least_f32(p["x_proj"])
    v = proj[..., :1] + at_least_f32(p["dt_bias"])
    dt = torch.logaddexp(v, torch.zeros_like(v))          # softplus
    return dt, proj[..., 1:1 + n], proj[..., 1 + n:], xc


def ssm_forward(p, cfg: ModelConfig, x, state, seq_len=None):
    """x (B,S,D), state {"h", "conv"} -> (y (B,S,D), new state).

    ``seq_len`` (B,) marks each row's valid lanes when ``x`` is
    right-padded to a bucket (the paged engine's ragged chunks): the
    conv state is taken from the last W-1 valid lanes, and ``dt`` is 0
    past them, where the step carries ``h`` through exactly (exp(0) = 1,
    0 * x = 0), so the returned state is an unpadded run's over the
    first ``seq_len`` tokens.  Outputs at padded lanes are garbage the
    caller discards."""
    s, w = x.shape[1], cfg.ssm_conv_width
    di = d_inner(cfg)
    xz = shard(x @ p["in_proj"], "batch", "seq", "d_ff")
    x_in, z = xz[..., :di], xz[..., di:]
    x_c, xp = _causal_conv(p, x_in, state["conv"])
    dt, bm, cm, xc = _selective_terms(p, cfg, x_c)
    a = -torch.exp(at_least_f32(p["a_log"]))             # (di, N)
    if seq_len is None:
        new_conv = xp[:, -(w - 1):]
    else:
        sl = seq_len.long()
        lanes = torch.arange(s, device=x.device)
        idx = sl[:, None] + torch.arange(w - 1, device=x.device)[None, :]
        new_conv = torch.gather(xp, 1, idx[..., None].expand(-1, -1, di))
        dt = torch.where((lanes[None, :] < sl[:, None])[..., None], dt, 0.0)
    # xc in the model dtype: the scan reads it so and writes y in it.  bm
    # and cm are copied out of the projection: the kernel takes 16-byte
    # aligned operands, and at one row of one step a column slice counts
    # as contiguous but starts mid-row
    y, h_final = local(kernel_ops.ssm_scan, _SCAN_IN, _SCAN_OUT)(
        dt.contiguous(), bm.clone(memory_format=torch.contiguous_format),
        cm.clone(memory_format=torch.contiguous_format), xc.contiguous(),
        a.contiguous(), at_least_f32(state["h"]).contiguous())
    y = y * F.silu(z)
    out = shard(y @ p["out_proj"], "batch", "seq", "d_model")
    new_state = {"h": h_final, "conv": new_conv.contiguous()}
    return out, {k: shard(v, *STATE_LOGICAL[k]) for k, v in new_state.items()}


def ssm_apply(p, cfg: ModelConfig, x):
    """Full-sequence forward from a zero state, no cache: what the
    reference's training block runs.  x (B,S,D) -> y (B,S,D).  The scan
    goes through ``ops.ssm_scan``, whose autograd Function differentiates
    it on both devices (backward: the ``ssm_scan_bwd`` kernel on the card,
    its plain version on the CPU)."""
    st = init_state(cfg, x.shape[0], x.dtype, x.device)
    return ssm_forward(p, cfg, x, st)[0]


def recurrence_cost(cfg: ModelConfig, batch: int, seq: int):
    """The reference's analytic (flops, bytes) of the scan core over
    ``seq`` steps: per token and state element the decay's exp, two
    multiply-adds and the C reduction; dt, B, C and x streamed in and the
    state read and written each token, float32."""
    di, n = d_inner(cfg), cfg.ssm_state_dim
    flops = batch * seq * di * n * 8.0
    bytes_ = batch * seq * ((1 + 2 * n + di) * 4.0 + 2 * di * n * 4.0)
    return flops, bytes_
