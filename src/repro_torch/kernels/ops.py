"""Public kernel entry points, dispatched by the device of the input.

A CUDA tensor goes to the hand-written kernel, which raises if it cannot
be built or launched; a CPU tensor goes to the plain version in
``ref.py``.  There is no other switch: where the data lies decides.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_prefill as _pp
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rwkv6_scan as _rw


def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Whole-prompt attention: q (B,H,Sq,hd), k/v (B,KV,Sk,hd) ->
    (B,H,Sq,hd)."""
    fn = _fa.flash_attention if _on_cuda(q) else _ref.flash_attention_ref
    return fn(q, k, v, causal=causal, window=window)


def paged_attention(q, k_pool, v_pool, kpos_pool, block_table, pos, *,
                    window: int = 0):
    """One-token paged decode: q (B,H,hd) against k/v pools
    (NB,bs,KV,hd) through block_table (B,nb) -> (B,H,hd)."""
    fn = _pa.paged_attention if _on_cuda(q) else _ref.paged_attention_ref
    return fn(q, k_pool, v_pool, kpos_pool, block_table, pos, window=window)


def paged_prefill(q, k, v, kpos, qpos, *, window: int = 0):
    """Ragged-batch chunked-prefill attention: q (B,S,H,hd) against
    assembled keys k/v (B,L,KV,hd) with absolute key/query positions
    kpos (B,L) / qpos (B,S) -> (B,S,H,hd)."""
    fn = _pp.paged_prefill if _on_cuda(q) else _ref.paged_prefill_ref
    return fn(q, k, v, kpos, qpos, window=window)


def rwkv6_scan(r, k, v, w, u, s0=None):
    """WKV6 recurrence: r/k/v/w (B,H,S,hd) float32 (w = decay in (0,1)),
    u (H,hd), s0 (B,H,hd,hd) or None (zeros) -> (out (B,H,S,hd),
    s_final (B,H,hd,hd) float32)."""
    fn = _rw.rwkv6_scan if _on_cuda(r) else _ref.rwkv6_scan_ref
    return fn(r, k, v, w, u, s0)


def launch_counts() -> dict:
    """Launches of each kernel since its count was last set to 0."""
    return {"flash_attention": _fa.KERNEL.launches,
            "paged_attention": _pa.KERNEL.launches,
            "paged_prefill": _pp.KERNEL.launches,
            "rwkv6_scan": _rw.KERNEL.launches}


def reset_launch_counts() -> None:
    for mod in (_fa, _pa, _pp, _rw):
        mod.KERNEL.launches = 0
