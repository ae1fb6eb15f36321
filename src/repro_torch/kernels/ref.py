"""Plain PyTorch versions of the attention kernels, the WKV6 scan and the
convolution.

They define the semantics, copied from ``repro.kernels.ref``: the CUDA
kernels are held to them on the card, and a CPU tensor is served by them
(``kernels/ops.py``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0 ** 30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,H,Sq,hd), k/v (B,KV,Sk,hd) -> (B,H,Sq,hd).  GQA: H % KV == 0.

    Plain softmax attention in fp32 with optional causal (query i sees
    keys j <= i) and sliding-window (``window`` > 0: keys (i-window, i])
    masking.  Softmax and the value product stay in float32; the output
    is cast to q.dtype once.
    """
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, sq, hd).float()
    scores = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / math.sqrt(hd)
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qi >= ki)
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
