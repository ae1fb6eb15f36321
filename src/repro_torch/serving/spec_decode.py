"""Drafters for speculative decoding over the paged pool (the port of
``repro.serving.spec_decode``).

A cheap *drafter* proposes up to ``k`` tokens per decoding request; the
target verifies the whole window (last emitted token + drafts) in the
engine's ragged ``paged_prefill`` dispatch, and the engine keeps the
longest drafted prefix that matches the target's greedy argmax plus one
bonus token.  Greedy acceptance keeps the output token-identical to
non-speculative greedy decode.

  * ``NgramDrafter``: prompt-lookup drafting, numpy only, the
    reference's proposals token for token.
  * ``DraftModelDrafter``: a smaller model greedy-extends the history
    with one cacheless ``Model.forward`` per token (attention through
    ``ops.flash_attention``, the CUDA kernel on the card).
  * ``layer_truncated_draft``: the target's first layers as the draft,
    its parameters views of the target's.

The verify / rollback half lives in ``serving/server.PagedLLMEngine``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


class Drafter:
    """Proposal interface: ``propose(history, k)`` returns up to ``k``
    drafted continuation tokens for a request whose full token history
    (prompt + emitted output) is ``history``.  Fewer than ``k`` (or none)
    is normal: the engine then verifies a shorter window.  Drafters are
    stateless per request: the engine may preempt, roll back or resume a
    request between any two calls."""

    name = "none"

    def propose(self, history: np.ndarray, k: int) -> List[int]:
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Find the longest suffix n-gram (``max_n`` down to ``min_n``) of the
    history that also occurs earlier in it, and propose the tokens that
    followed its most recent earlier occurrence, tiled cyclically with
    the period that match implies (a full ``k``-token draft even when the
    match sits within ``k`` tokens of the end)."""

    name = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, "
                             f"got ({min_n}, {max_n})")
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, history: np.ndarray, k: int) -> List[int]:
        h = np.asarray(history)
        L = len(h)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            tail = h[L - n:]
            # earlier occurrences, most recent first; one must start at
            # or before L - n - 1 to have a continuation
            starts = np.flatnonzero(h[:L - n] == tail[0])
            for s in starts[::-1]:
                if np.array_equal(h[s:s + n], tail):
                    d = (L - n) - s               # the implied period
                    return [int(h[L - d + (i % d)]) for i in range(k)]
        return []


class DraftModelDrafter(Drafter):
    """A smaller model sharing the target's tokenizer proposes by
    greedy-extending the history ``k`` tokens, one cacheless forward per
    token.  Histories are right-padded to power-of-two length buckets of
    at least 8, so the forwards run at O(log max_len) shapes; causal
    attention keeps the padding out of the last valid position.
    ``forwards`` counts the forwards run."""

    name = "draft"

    def __init__(self, model, params, max_len: int = 1024):
        self.model = model
        self.params = params
        self.max_len = max_len
        self._sigs: set = set()
        self.forwards = 0

    def _bucket(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def propose(self, history: np.ndarray, k: int) -> List[int]:
        toks = list(np.asarray(history))
        out: List[int] = []
        for _ in range(k):
            L = len(toks)
            if L >= self.max_len:
                break
            pad = self._bucket(L)
            self._sigs.add(pad)
            row = np.zeros((1, pad), np.int32)
            row[0, :L] = toks
            with torch.inference_mode():
                logits = self.model.forward(
                    self.params,
                    {"tokens": torch.from_numpy(row).to(self.model.device)})
                nxt = int(torch.argmax(logits[0, L - 1]))
            self.forwards += 1
            out.append(nxt)
            toks.append(nxt)
        return out


def layer_truncated_draft(model, params, num_layers: int):
    """Early-exit self-drafting: the draft (model, params) is the first
    ``num_layers`` layers of the target, sharing its embedding, final
    norm and leading layers.  The draft's period-stacked leaves are views
    ``x[:num_layers // P]`` of the target's, so no weight is copied.
    Needs a stack with no remainder layers and ``num_layers`` a multiple
    of the period, strictly between 0 and the target's depth."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.api import Model

    cfg = model.cfg
    p, _, n_rem = tf.layout(cfg)
    if n_rem or num_layers % p or not 0 < num_layers < cfg.num_layers:
        raise ValueError(
            f"cannot truncate {cfg.name} ({cfg.num_layers} layers, "
            f"period {p}, {n_rem} remainder) to {num_layers} layers")
    dcfg = dataclasses.replace(cfg, num_layers=num_layers,
                               name=f"{cfg.name}-draft{num_layers}")

    def head(tree):
        if isinstance(tree, dict):
            return {k: head(v) for k, v in tree.items()}
        return tree[:num_layers // p]

    dparams = dict(params)
    dparams["stack"] = {"periods": head(params["stack"]["periods"]),
                        "rem": {}}
    return Model(dcfg, device=model.device), dparams


def make_drafter(mode: str, *, draft_model=None, draft_params=None,
                 max_len: int = 1024,
                 ngram_max_n: int = 3) -> Optional[Drafter]:
    """``off`` -> None, ``ngram`` -> NgramDrafter, ``draft`` ->
    DraftModelDrafter (requires ``draft_model``/``draft_params``)."""
    if mode in (None, "off"):
        return None
    if mode == "ngram":
        return NgramDrafter(max_n=ngram_max_n)
    if mode == "draft":
        if draft_model is None or draft_params is None:
            raise ValueError("spec_decode='draft' needs draft_model and "
                             "draft_params")
        return DraftModelDrafter(draft_model, draft_params, max_len=max_len)
    raise ValueError(f"spec_decode must be 'off', 'ngram' or 'draft', "
                     f"got {mode!r}")
