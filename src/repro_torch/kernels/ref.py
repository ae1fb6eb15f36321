"""Plain PyTorch versions of the attention kernels (their int8-cache
variants too, and the split-key combine pass of their bf16 tile), the
WKV6 scan, mamba's selective scan and the backward of both, the
convolution and its filter gradient.

The kernels' plain versions define their semantics, copied from
``repro.kernels.ref`` (the selective scan from the ``lax.scan`` step of
``repro.models.ssm``; the two scans' backwards written out from the
reference's scans, which train through ``jax.grad``): the CUDA kernels
are held to them on the card, and a CPU tensor is served by them
(``kernels/ops.py``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30
SSM_CKPT_STEPS = 16     # steps between the selective scan's checkpoints
LOG2E = 1.4426950408889634


def check_prefix(causal: bool, window: int, prefix: int) -> None:
    """A prefix-LM prefix is a causal mask's, without a window."""
    if prefix < 0 or (prefix and (not causal or window)):
        raise ValueError(f"flash_attention: prefix={prefix} needs "
                         f"causal=True and no window (causal={causal}, "
                         f"window={window})")


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        prefix: int = 0):
    """q (B,H,Sq,hd), k/v (B,KV,Sk,hd) -> (B,H,Sq,hd).  GQA: H % KV == 0.

    Plain softmax attention in fp32 with optional causal (query i sees
    keys j <= i) and sliding-window (``window`` > 0: keys (i-window, i])
    masking.  ``prefix`` > 0 (causal, no window: the prefix-LM) lets
    every query see keys j < prefix too.  Softmax and the value product
    stay in float32; the output is cast to q.dtype once.
    """
    check_prefix(causal, window, prefix)
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, sq, hd).float()
    scores = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / math.sqrt(hd)
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & ((qi >= ki) | (ki < prefix))
    if window:
        mask = mask & (qi - ki < window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.float())
    return out.reshape(b, h, sq, hd).to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, kpos_pool, block_table, pos, *,
                        window: int = 0):
    """One-token decode against a block-paged KV pool, as a plain gather.

    q (B,H,hd), k/v pools (NB,bs,KV,hd), kpos_pool (NB,bs) int32 absolute
    positions (-1 = invalid lane), block_table (B,nb) int32 (0-padded),
    pos (B,) int32 position of the query token -> (B,H,hd).  GQA:
    H % KV == 0.  All-invalid rows return zeros (masked probabilities are
    zeroed after the softmax, like the kernel's online accumulator).
    """
    b, h, hd = q.shape
    nb = block_table.shape[1]
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    g = h // kv
    bt = block_table.long()
    k = k_pool[bt].reshape(b, nb * bs, kv, hd).float()
    v = v_pool[bt].reshape(b, nb * bs, kv, hd).float()
    kpos = kpos_pool[bt].reshape(b, nb * bs)
    qg = q.reshape(b, kv, g, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k) / math.sqrt(hd)
    p = pos.to(kpos.dtype)[:, None]
    valid = (kpos >= 0) & (kpos <= p)
    if window:
        valid = valid & (p - kpos < window)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    probs = torch.where(valid, torch.softmax(s, -1), 0.0)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v)
    return out.reshape(b, h, hd).to(q.dtype)


def paged_prefill_ref(q, k, v, kpos, qpos, *, window: int = 0):
    """Ragged-batch chunked-prefill attention: every row is one request's
    prefill chunk, its raggedness (chunk length, prefix size, position
    offset) encoded in the two position arrays.

    q (B,S,H,hd) chunk queries; k/v (B,L,KV,hd) keys = the row's gathered
    prefix followed by the chunk itself; kpos (B,L) int32 absolute key
    positions (-1 = invalid lane); qpos (B,S) int32 absolute query
    positions.  Key lane s is visible to query lane t iff ``kpos[s] >= 0
    and kpos[s] <= qpos[t]`` (plus ``qpos[t] - kpos[s] < window`` when
    ``window`` > 0).  Scores in fp32; the value contraction runs in
    v.dtype, as in the reference.  A query lane with no visible key gets
    the uniform average of every key (the softmax of an all-``NEG_INF``
    row), as in the reference; callers discard such lanes.
    -> (B,S,H,hd).
    """
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if kv != h:
        k = torch.repeat_interleave(k, h // kv, dim=2)
        v = torch.repeat_interleave(v, h // kv, dim=2)
    sc = torch.einsum("bqhd,bshd->bhqs", q, k) * (1.0 / math.sqrt(hd))
    sc = sc.float()
    kp = kpos[:, None, None, :]
    qp = qpos[:, None, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if window:
        mask = mask & (qp - kp < window)
    sc = torch.where(mask, sc, NEG_INF)
    m = torch.amax(sc, -1, keepdim=True)
    e = torch.exp(sc - m)
    z = torch.sum(e, -1, keepdim=True)
    probs = (e / torch.clamp(z, min=1e-30)).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def dequantize_kv(q, scale, dtype):
    """int8 K or V (..., hd) and its float32 absmax scale (...) -> dtype,
    as the reference's ``_dequantize_kv``: the product in float32,
    rounded to ``dtype`` once, before any product with it."""
    return (q.float() * scale[..., None]).to(dtype)


def paged_attention_int8_ref(q, k_pool, v_pool, k_scale, v_scale,
                             kpos_pool, block_table, pos, *,
                             window: int = 0):
    """``paged_attention_ref`` over int8 pools (NB,bs,KV,hd) with float32
    scales (NB,bs,KV), dequantized to q's dtype first, as the reference
    reads a quantized pool."""
    return paged_attention_ref(q, dequantize_kv(k_pool, k_scale, q.dtype),
                               dequantize_kv(v_pool, v_scale, q.dtype),
                               kpos_pool, block_table, pos, window=window)


def paged_prefill_int8_ref(q, k_prefix, v_prefix, k_scale, v_scale,
                           kpos_prefix, k, v, kpos, qpos, *,
                           window: int = 0):
    """``paged_prefill_ref`` over two key segments: the gathered int8
    prefix (B,Lp,KV,hd) with float32 scales (B,Lp,KV) and positions
    kpos_prefix (B,Lp), then the chunk's own K/V (B,Lc,KV,hd) in q's
    dtype with positions kpos (B,Lc) (Lc = 0 for a slot decode, whose
    whole strip is the int8 prefix).  The prefix is dequantized to q's
    dtype and put before the chunk, as the reference's
    ``concat(dequant(prefix), chunk)``."""
    k_all = torch.cat([dequantize_kv(k_prefix, k_scale, q.dtype), k], 1)
    v_all = torch.cat([dequantize_kv(v_prefix, v_scale, q.dtype), v], 1)
    return paged_prefill_ref(q, k_all, v_all,
                             torch.cat([kpos_prefix, kpos], 1), qpos,
                             window=window)


def attention_partial_ref(q, k, v, visible, scale):
    """One key piece's partial softmax state, as the bf16 attention
    kernels write it when a query tile's keys are split: q (..., Sq, hd),
    k/v (..., Sk, hd) (the piece's keys), visible (..., Sq, Sk) bool ->
    (m (..., Sq), l (..., Sq), acc (..., Sq, hd)), float32, in base 2: m
    the largest visible score times ``scale * log2(e)`` (NEG_INF where the
    row sees no key of the piece), l the sum of ``2 ** (s - m)`` over the
    visible keys, acc the same weights times the values (unnormalised).
    """
    if k.shape[-2] == 0:                # a piece of an empty key range
        m = torch.full(q.shape[:-1], NEG_INF, device=q.device)
        return m, torch.zeros_like(m), torch.zeros(q.shape,
                                                   device=q.device)
    s = (q.float() @ k.float().transpose(-1, -2)) * (scale * LOG2E)
    s = torch.where(visible, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(visible, torch.exp2(s - m[..., None]), 0.0)
    return m, p.sum(-1), p @ v.float()


def attention_combine_ref(m, l, acc):
    """Merge the pieces of ``attention_partial_ref`` (stacked on dim 0) by
    log-sum-exp: m, l (P, ..., Sq), acc (P, ..., Sq, hd) -> the attention
    output (..., Sq, hd), float32.  Rows no piece lets see a key get 0."""
    f = torch.exp2(m - m.amax(0))
    num = (f[..., None] * acc).sum(0)
    return num / torch.clamp((f * l).sum(0), min=1e-30)[..., None]


def rwkv6_scan_ref(r, k, v, w, u, s0=None):
    """WKV6 recurrence, one time step at a time in float32 (float64 for
    float64 inputs).  r/k/v (B,H,S,hd), w (B,H,S,hd) decay in (0,1), u
    (H,hd) bonus, s0 (B,H,hd,hd) or None (zeros).  -> (out (B,H,S,hd) in
    r's dtype, s_final (B,H,hd,hd) float32, or float64).

        o_t[j] = sum_i r_t[i] * (S[i,j] + u[i] k_t[i] v_t[j])
        S      = diag(w_t) S + k_t (x) v_t
    """
    b, h, s, hd = r.shape
    dt = torch.promote_types(r.dtype, torch.float32)
    r32, k32, v32, w32 = (t.to(dt) for t in (r, k, v, w))
    u32 = u.to(dt)[None, :, :, None]
    state = torch.zeros(b, h, hd, hd, dtype=dt,
                        device=r.device) if s0 is None else s0.to(dt)
    outs = []
    for t in range(s):
        kv = k32[:, :, t, :, None] * v32[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r32[:, :, t],
                                 state + u32 * kv))
        state = w32[:, :, t, :, None] * state + kv
    return torch.stack(outs, dim=2).to(r.dtype), state


def rwkv6_scan_bwd_ref(r, k, v, w, u, s0, dout, ds_final=None):
    """The gradients of ``rwkv6_scan_ref``, one time step at a time
    backwards, in float32 (float64 for float64 inputs): the states S_t
    recomputed forward from ``s0`` (None: zeros), then the state's
    adjoint G from ``ds_final`` (None: zeros) back to step 0,

        G_{t-1} = diag(w_t) G_t + r_t (x) do_t
        dr_t[i] = sum_j do_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
        dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
        dk_t[i] = sum_j (G_t[i,j] + r_t[i] u[i] do_t[j]) v_t[j]
        dv_t[j] = sum_i (G_t[i,j] + r_t[i] u[i] do_t[j]) k_t[i]
        du[i]   = sum_{b,t} r_t[i] k_t[i] sum_j do_t[j] v_t[j]

    (G_t the adjoint of the state after step t).  -> (dr, dk, dv, dw in
    r's dtype, du in u's dtype, ds0 float32 or float64)."""
    b, h, s, hd = r.shape
    ft = torch.promote_types(r.dtype, torch.float32)
    r32, k32, v32, w32, do32 = (t.to(ft) for t in (r, k, v, w, dout))
    u32 = u.to(ft)[None, :, :]
    state = torch.zeros(b, h, hd, hd, dtype=ft,
                        device=r.device) if s0 is None else s0.to(ft)
    states = []
    for t in range(s):
        states.append(state)
        state = (w32[:, :, t, :, None] * state
                 + k32[:, :, t, :, None] * v32[:, :, t, None, :])
    g = (torch.zeros_like(state) if ds_final is None
         else ds_final.to(ft))
    grads = [torch.empty_like(t) for t in (r32, k32, v32, w32)]
    du = torch.zeros(h, hd, dtype=ft, device=r.device)
    for t in reversed(range(s)):
        rt, kt, vt, wt, dot = (x[:, :, t] for x in (r32, k32, v32, w32,
                                                    do32))
        prev = states[t]
        kv = kt[..., :, None] * vt[..., None, :]
        grads[0][:, :, t] = torch.einsum("bhij,bhj->bhi",
                                         prev + u32[..., None] * kv, dot)
        grads[3][:, :, t] = (g * prev).sum(-1)
        dkv = g + (rt * u32)[..., :, None] * dot[..., None, :]
        grads[1][:, :, t] = (dkv * vt[..., None, :]).sum(-1)
        grads[2][:, :, t] = (dkv * kt[..., :, None]).sum(-2)
        du = du + (rt * kt * (dot * vt).sum(-1, keepdim=True)).sum(0)
        g = wt[..., :, None] * g + rt[..., :, None] * dot[..., None, :]
    dr, dk, dv, dw = (x.to(r.dtype) for x in grads)
    return dr, dk, dv, dw, du.to(u.dtype), g


def ssm_scan_bwd_ref(dt, bm, cm, x, a, h0, dy, dh_final=None, ckpt=None):
    """The gradients of ``ssm_scan_ref``, one time step at a time
    backwards, in float32 (float64 for float64 inputs): the states h_t
    recomputed forward from ``h0`` (with ``ckpt``, the forward's
    checkpoints, each run of ``SSM_CKPT_STEPS`` steps from its own), then
    the state's adjoint from ``dh_final`` (None: zeros) back to step 0,

        g_t   = C_t dy_t + exp(dt_{t+1} a) g_{t+1}   (g after step t)
        dC_t  = sum_d dy_t[d] h_t[d]
        dB_t  = sum_d g_t[d] dt_t[d] x_t[d]
        dx_t  = dt_t sum_n g_t[n] B_t[n]
        ddt_t = sum_n g_t[n] (a[n] exp(dt_t a[n]) h_{t-1}[n] + x_t B_t[n])
        da    = sum_{b,t} g_t dt_t exp(dt_t a) h_{t-1}
        dh0   = exp(dt_0 a) g_0

    -> (ddt, dbm, dcm float32 or float64, dx in x's dtype, da, dh0
    float32 or float64)."""
    s = dt.shape[1]
    ft = torch.promote_types(dt.dtype, torch.float32)
    x_dtype = x.dtype
    dt, bm, cm, x, a, dy = (t.to(ft) for t in (dt, bm, cm, x, a, dy))
    h = h0.to(ft)
    states = [h]
    for t in range(s):
        if ckpt is not None and t and t % SSM_CKPT_STEPS == 0:
            h = ckpt[:, t // SSM_CKPT_STEPS - 1].to(ft)
        h = (torch.exp(dt[:, t, :, None] * a[None]) * h
             + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :])
        states.append(h)
    g = torch.zeros_like(h) if dh_final is None else dh_final.to(ft)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dbm, dcm = torch.empty_like(bm), torch.empty_like(cm)
    da = torch.zeros_like(a)
    for t in reversed(range(s)):
        g = g + dy[:, t, :, None] * cm[:, t, None, :]
        decay = torch.exp(dt[:, t, :, None] * a[None])
        dcm[:, t] = torch.einsum("bdn,bd->bn", states[t + 1], dy[:, t])
        dbm[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * x[:, t])
        gb = torch.einsum("bdn,bn->bd", g, bm[:, t])
        dx[:, t] = dt[:, t] * gb
        gh = g * decay * states[t]
        ddt[:, t] = (gh * a[None]).sum(-1) + x[:, t] * gb
        da = da + (gh * dt[:, t, :, None]).sum(0)
        g = decay * g
    return ddt, dbm, dcm, dx.to(x_dtype), da, g


def ssm_scan_ref(dt, bm, cm, x, a, h0, checkpoints: bool = False):
    """Mamba's selective scan, one time step at a time in float32
    (float64 for float64 inputs).  dt (B,S,di) step sizes, bm / cm
    (B,S,N) input and output projections, x (B,S,di) the scanned input
    in the model dtype (cast to float32 in the step, as the reference
    does), a (di,N) the negative state decays, h0 (B,di,N) the start
    state.  -> (y (B,S,di) in x's dtype, h_final (B,di,N) float32, or
    float64), and with ``checkpoints`` the state after every
    ``SSM_CKPT_STEPS`` steps short of S, (B, ceil(S/16) - 1, di, N), as
    the kernel's training forward keeps them for its backward.

        h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) B_t
        y_t = h_t . C_t
    """
    s = dt.shape[1]
    ft = torch.promote_types(dt.dtype, torch.float32)
    out_dtype = x.dtype
    dt, bm, cm, x, a = (t.to(ft) for t in (dt, bm, cm, x, a))
    h = h0.to(ft)
    ys, kept = [], []
    for t in range(s):
        decay = torch.exp(dt[:, t, :, None] * a[None])
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cm[:, t]))
        if checkpoints and (t + 1) % SSM_CKPT_STEPS == 0 and t + 1 < s:
            kept.append(h)
    y = torch.stack(ys, dim=1).to(out_dtype)
    if not checkpoints:
        return y, h
    ckpt = (torch.stack(kept, dim=1) if kept
            else h.new_zeros(h.shape[0], 0, *h.shape[1:]))
    return y, h, ckpt


def conv2d_ref(x, w):
    """Valid, stride-1 convolution, x (B,H,W,Cin) NHWC x w (KH,KW,Cin,Cout)
    HWIO -> (B,H-KH+1,W-KW+1,Cout) in x's dtype.

    Written as the TPU kernel's tap decomposition: the float32 sum over
    the KH*KW taps of shifted ``(B*H'*W', Cin) x (Cin, Cout)`` products,
    cast to x.dtype once.  No ``F.conv2d``, so the plain version does not
    depend on cuDNN or its TF32 default for float32.
    """
    b, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    ho, wo = h - kh + 1, wd - kw + 1
    x32, w32 = x.float(), w.float()
    acc = torch.zeros(b * ho * wo, cout, dtype=torch.float32,
                      device=x.device)
    for i in range(kh):
        for j in range(kw):
            tap = x32[:, i:i + ho, j:j + wo, :].reshape(b * ho * wo, cin)
            acc = acc + tap @ w32[i, j]
    return acc.reshape(b, ho, wo, cout).to(x.dtype)


def conv2d_wgrad_ref(x, dy, kh: int, kw: int):
    """The filter gradient of ``conv2d_ref``: x (B,H,W,Cin) NHWC and dy
    (B,H-KH+1,W-KW+1,Cout) -> dw (KH,KW,Cin,Cout) in x's dtype,

        dw[i, j, ci, co] = sum_{b, y, x'} x[b, y+i, x'+j, ci] dy[b, y, x', co]

    Written as the TPU kernel's tap decomposition, transposed: per tap, the
    float32 product ``x_tap(B*H'*W', Cin)^T @ dy(B*H'*W', Cout)``, cast to
    x.dtype once.  No ``F.conv2d`` and no ``torch.nn.grad``.
    """
    b, _, _, cin = x.shape
    _, ho, wo, cout = dy.shape
    x32 = x.float()
    d32 = dy.float().reshape(b * ho * wo, cout)
    dw = torch.empty(kh, kw, cin, cout, dtype=torch.float32, device=x.device)
    for i in range(kh):
        for j in range(kw):
            tap = x32[:, i:i + ho, j:j + wo, :].reshape(b * ho * wo, cin)
            dw[i, j] = tap.T @ d32
    return dw.to(x.dtype)
