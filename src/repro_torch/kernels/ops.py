"""Public kernel entry points, dispatched by the device of the input.

A CUDA tensor goes to the hand-written kernel, which raises if it cannot
be built or launched; a CPU tensor goes to the plain version in
``ref.py``.  There is no other switch: where the data lies decides.

``conv2d`` differentiates, on both devices, through one autograd
Function whose backward is written over these entries: the filter
gradient through ``conv2d_wgrad``, the input gradient (only where the
input needs one) through ``conv2d`` itself, as the full convolution of
the padded output gradient with the flipped filter.  ``rwkv6_scan`` and
``ssm_scan`` differentiate through autograd Functions too, whose
backwards are the hand-written ``rwkv6_scan_bwd`` / ``ssm_scan_bwd``
kernels on the card and ``ref.rwkv6_scan_bwd_ref`` /
``ref.ssm_scan_bwd_ref`` on the CPU, asked only for the gradients that
autograd needs.  The raw kernel wrappers, and the attention entries,
refuse autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import conv2d as _cv
from repro_torch.kernels import conv2d_wgrad as _cw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import paged_prefill as _pp
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rwkv6_scan as _rw
from repro_torch.kernels import rwkv6_scan_bwd as _rwb
from repro_torch.kernels import ssm_scan as _ss
from repro_torch.kernels import ssm_scan_bwd as _ssb


def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    prefix: int = 0):
    """Whole-prompt attention: q (B,H,Sq,hd), k/v (B,KV,Sk,hd) ->
    (B,H,Sq,hd); causal, windowed, non-causal (an encoder,
    cross-attention), or causal with its first ``prefix`` keys seen by
    every query (a prefix-LM)."""
    fn = _fa.flash_attention if _on_cuda(q) else _ref.flash_attention_ref
    return fn(q, k, v, causal=causal, window=window, prefix=prefix)


def _refuse_int8(entry, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype == torch.int8:
            raise ValueError(f"{entry}: {name} is int8; an int8 cache is "
                             f"read by {entry}_int8")


def paged_attention(q, k_pool, v_pool, kpos_pool, block_table, pos, *,
                    window: int = 0):
    """One-token paged decode: q (B,H,hd) against k/v pools
    (NB,bs,KV,hd) through block_table (B,nb) -> (B,H,hd)."""
    _refuse_int8("paged_attention", k_pool=k_pool, v_pool=v_pool)
    fn = _pa.paged_attention if _on_cuda(q) else _ref.paged_attention_ref
    return fn(q, k_pool, v_pool, kpos_pool, block_table, pos, window=window)


def paged_attention_int8(q, k_pool, v_pool, k_scale, v_scale, kpos_pool,
                         block_table, pos, *, window: int = 0):
    """``paged_attention`` over int8 pools (NB,bs,KV,hd) with float32
    scales (NB,bs,KV), dequantized to q's dtype as they are read."""
    fn = (_pa.paged_attention_int8 if _on_cuda(q)
          else _ref.paged_attention_int8_ref)
    return fn(q, k_pool, v_pool, k_scale, v_scale, kpos_pool, block_table,
              pos, window=window)


def paged_prefill(q, k, v, kpos, qpos, *, window: int = 0):
    """Ragged-batch chunked-prefill attention: q (B,S,H,hd) against
    contiguous keys k/v (B,L,KV,hd) with absolute key/query positions
    kpos (B,L) / qpos (B,S) -> (B,S,H,hd) (the slot decode's strip; the
    paged engine reads its pool through ``paged_prefill_pool``)."""
    _refuse_int8("paged_prefill", k=k, v=v)
    fn = _pp.paged_prefill if _on_cuda(q) else _ref.paged_prefill_ref
    return fn(q, k, v, kpos, qpos, window=window)


def paged_prefill_int8(q, k_prefix, v_prefix, k_scale, v_scale, kpos_prefix,
                       k, v, kpos, qpos, *, window: int = 0):
    """``paged_prefill`` over an int8 prefix (B,Lp,KV,hd) with float32
    scales (B,Lp,KV) and positions (B,Lp), then the chunk's K/V
    (B,Lc,KV,hd) in q's dtype with positions (B,Lc), Lc = 0 allowed:
    the prefix is dequantized to q's dtype as it is read."""
    fn = (_pp.paged_prefill_int8 if _on_cuda(q)
          else _ref.paged_prefill_int8_ref)
    return fn(q, k_prefix, v_prefix, k_scale, v_scale, kpos_prefix, k, v,
              kpos, qpos, window=window)


def paged_prefill_pool(q, k_pool, v_pool, pos_pool, block_table, start_pos,
                       k, v, kpos, qpos, *, window: int = 0):
    """The paged engine's attention: q (B,S,H,hd) against the prefix read
    from the pool k/v_pool (NB,bs,KV,hd) with positions pos_pool (NB,bs)
    through block_table (B,nb), each position -1 unless below the row's
    cursor ``start_pos`` (an int or (B,) int32), then the chunk's k/v
    (B,Lc,KV,hd) with positions kpos (B,Lc) -> (B,S,H,hd).  The pool
    holds q's dtype."""
    _refuse_int8("paged_prefill_pool", k_pool=k_pool, v_pool=v_pool)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_prefill_pool: the pool is {k_pool.dtype}, "
                         f"q {q.dtype}; the pool holds the model dtype")
    fn = (_pp.paged_prefill_pool if _on_cuda(q)
          else _ref.paged_prefill_pool_ref)
    return fn(q, k_pool, v_pool, pos_pool, block_table, start_pos, k, v,
              kpos, qpos, window=window)


def paged_prefill_pool_int8(q, k_pool, v_pool, k_scale_pool, v_scale_pool,
                            pos_pool, block_table, start_pos, k, v, kpos,
                            qpos, *, window: int = 0):
    """``paged_prefill_pool`` over an int8 pool (NB,bs,KV,hd) with float32
    scales (NB,bs,KV): the prefix is dequantized to q's dtype as it is
    read."""
    fn = (_pp.paged_prefill_pool_int8 if _on_cuda(q)
          else _ref.paged_prefill_pool_int8_ref)
    return fn(q, k_pool, v_pool, k_scale_pool, v_scale_pool, pos_pool,
              block_table, start_pos, k, v, kpos, qpos, window=window)


def _saves(*tensors) -> bool:
    """Whether a gradient can be asked for: grad mode on and one of the
    inputs requiring one (not under ``torch.no_grad()`` or
    ``torch.inference_mode()``).  Where not, ``conv2d``'s Function keeps
    nothing and the scans skip theirs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _Rwkv6Scan(torch.autograd.Function):
    """``rwkv6_scan`` with its backward (``rwkv6_scan_bwd``): the
    gradients of r, k, v, w, u and s0 from those of out and s_final (a
    gradient autograd does not pass counts as zeros)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        fn = _rw.rwkv6_scan if _on_cuda(r) else _ref.rwkv6_scan_ref
        return fn(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dout, ds_final):
        r, k, v, w, u, s0 = ctx.saved_tensors
        need = ctx.needs_input_grad
        if dout is None:
            dout = torch.zeros_like(r)
        if _on_cuda(r):
            if dout.stride(-1) != 1:
                dout = dout.contiguous()
            if ds_final is not None:
                ds_final = ds_final.contiguous()
            grads = _rwb.rwkv6_scan_bwd(r, k, v, w, u, s0, dout, ds_final,
                                        need=need)
        else:
            grads = _ref.rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dout,
                                            ds_final)
        return tuple(g if n else None for g, n in zip(grads, need))


def rwkv6_scan(r, k, v, w, u, s0=None):
    """WKV6 recurrence: r/k/v/w (B,H,S,hd) float32 (w = decay in (0,1)),
    u (H,hd), s0 (B,H,hd,hd) or None (zeros) -> (out (B,H,S,hd),
    s_final (B,H,hd,hd) float32).  Differentiable in every input; where
    no gradient can be asked for (grad mode off, as in serving, or no
    input requiring one) the kernel or plain version is called alone."""
    if _saves(r, k, v, w, u, s0):
        return _Rwkv6Scan.apply(r, k, v, w, u, s0)
    fn = _rw.rwkv6_scan if _on_cuda(r) else _ref.rwkv6_scan_ref
    return fn(r, k, v, w, u, s0)


class _SsmScan(torch.autograd.Function):
    """``ssm_scan`` with its backward (``ssm_scan_bwd``): the gradients of
    dt, bm, cm, x, a and h0 from those of y and h_final (a gradient
    autograd does not pass counts as zeros).  The forward also keeps the
    state every 16 steps (``checkpoints=True``), from which the backward
    re-runs each chunk instead of the whole recurrence from h0."""

    @staticmethod
    def forward(ctx, dt, bm, cm, x, a, h0):
        ctx.set_materialize_grads(False)
        fn = _ss.ssm_scan if _on_cuda(dt) else _ref.ssm_scan_ref
        y, h_final, ckpt = fn(dt, bm, cm, x, a, h0, checkpoints=True)
        ctx.save_for_backward(dt, bm, cm, x, a, h0, ckpt)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        dt, bm, cm, x, a, h0, ckpt = ctx.saved_tensors
        need = ctx.needs_input_grad
        if dy is None:
            dy = torch.zeros_like(x)
        if _on_cuda(dt):
            grads = _ssb.ssm_scan_bwd(dt, bm, cm, x, a, h0, dy, dh_final,
                                      need=need, ckpt=ckpt)
        else:
            grads = _ref.ssm_scan_bwd_ref(dt, bm, cm, x, a, h0, dy,
                                          dh_final, ckpt=ckpt)
        return tuple(g if n else None for g, n in zip(grads, need))


def ssm_scan(dt, bm, cm, x, a, h0):
    """Mamba's selective scan: dt (B,S,di), bm / cm (B,S,N), a (di,N)
    decays (negative), h0 (B,di,N), float32; x (B,S,di) in the model
    dtype -> (y (B,S,di) in x's dtype, h_final (B,di,N) float32).
    Differentiable in every input; as ``rwkv6_scan``, the kernel or plain
    version alone where no gradient can be asked for."""
    if _saves(dt, bm, cm, x, a, h0):
        return _SsmScan.apply(dt, bm, cm, x, a, h0)
    fn = _ss.ssm_scan if _on_cuda(dt) else _ref.ssm_scan_ref
    return fn(dt, bm, cm, x, a, h0)


class _Conv2d(torch.autograd.Function):
    """``conv2d`` with its backward; ``save`` is False where no gradient
    can be asked for (grad mode off, as under ``torch.inference_mode()``,
    or no input requiring one), and then nothing is kept."""

    @staticmethod
    def forward(ctx, x, w, save):
        if save:
            ctx.save_for_backward(x, w)
        fn = _cv.conv2d if _on_cuda(x) else _ref.conv2d_ref
        return fn(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        kh, kw = w.shape[0], w.shape[1]
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dyp = F.pad(dy, (0, 0, kw - 1, kw - 1, kh - 1, kh - 1))
            dx = conv2d(dyp, w.flip(0, 1).transpose(2, 3).contiguous())
        if ctx.needs_input_grad[1]:
            dw = conv2d_wgrad(x, dy, kh, kw)
        return dx, dw, None


def conv2d(x, w):
    """Valid, stride-1 convolution: x (B,H,W,Cin) NHWC x w (KH,KW,Cin,Cout)
    HWIO -> (B,H-KH+1,W-KW+1,Cout) in x's dtype, summed in float32.
    Differentiable in x and w."""
    return _Conv2d.apply(x, w, _saves(x, w))


def conv2d_wgrad(x, dy, kh: int, kw: int):
    """The filter gradient of ``conv2d``: x (B,H,W,Cin), dy
    (B,H-KH+1,W-KW+1,Cout) -> dw (KH,KW,Cin,Cout) in x's dtype, summed in
    float32."""
    fn = _cw.conv2d_wgrad if _on_cuda(x) else _ref.conv2d_wgrad_ref
    return fn(x, dy, kh, kw)


_KERNELS = {"conv2d": _cv.KERNEL, "conv2d_wgrad": _cw.KERNEL,
            "flash_attention": _fa.KERNEL, "paged_attention": _pa.KERNEL,
            "paged_attention_int8": _pa.KERNEL_INT8,
            "paged_prefill": _pp.KERNEL,
            "paged_prefill_int8": _pp.KERNEL_INT8,
            "paged_prefill_pool": _pp.KERNEL_POOL,
            "paged_prefill_pool_int8": _pp.KERNEL_POOL_INT8,
            "rwkv6_scan": _rw.KERNEL, "rwkv6_scan_bwd": _rwb.KERNEL,
            "ssm_scan": _ss.KERNEL, "ssm_scan_bwd": _ssb.KERNEL}


def launch_counts() -> dict:
    """Launches of each kernel since its count was last set to 0; the
    int8-cache variants of the two paged attention kernels, and the pool
    entries of ``paged_prefill``, count under their own names."""
    return {name: kern.launches for name, kern in _KERNELS.items()}


def reset_launch_counts() -> None:
    for kern in _KERNELS.values():
        kern.launches = 0
