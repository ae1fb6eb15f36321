"""Model API (the port of ``repro.models.api.Model``).

``Model(cfg, device)`` carries the schema, a seeded ``init``, the
training entry points:

    forward_train(params, batch)   (logits, router loss), differentiable
    loss(params, batch)            (total, {"loss", "xent", "aux"})

``forward(params, batch)`` (logits at every position, no cache, through
the kernels: the speculative draft's), and the entry points the serving
engines call, the slot engine's:

    cache_init(batch, cache_max)               slot caches (pos lanes -1)
    prefill(params, batch, cache_max=...)      (last logits, caches)
    decode_step(params, caches, tokens, pos)   (logits, caches)

and the paged engine's:

    pool_init(num_blocks, block_size, state_batch)   pools (pos lanes -1)
    prefill_paged(params, batch, pools, ...)   (logits, suffix caches)
    decode_step_paged(params, pools, ...)      (logits, pools)

Parameters are nested dicts of tensors in the reference's tree
(``embed``, ``stack/periods/slot{j}``, ``stack/rem/layer{j}``,
``final_norm``), so weights bridged from the reference
(``repro_torch.bridge``) drop in.  Everything runs on ``device``, which
defaults to the card; the CPU runs only when asked for.

whisper-tiny (encoder-decoder, ``cfg.is_encoder_decoder``) and
paligemma-3b (a prefix-LM over projected image patches, ``cfg.frontend
== "vision"``) take ``batch["embeds"]`` (B, N, W) beside the tokens (the
stubbed frontend's output, ``models/frontend.py``) in ``forward``,
``forward_train``, ``loss`` and ``prefill``; their caches are not token
strips alone (whisper's carry the encoder K/V, paligemma's the patches),
so no engine serves them, as none of the reference's does.

Every decoder-only token stack takes both engines: attention layers
(``"attn"``, ``"attn_local"``; ``paged_live_window`` tells the paged
engine how far back every layer reads) page their KV through the block
pool, recurrent layers (``"mamba"``, ``"rwkv6"``) carry per-request
state slots beside it (``pool_init(..., state_batch)``,
``prefill_paged(..., state_rows=)``), and any layer may take an MoE
FFN.

``cfg.kv_cache_quant`` makes every slot cache and block pool int8: ``k``
and ``v`` int8 with a float32 absmax scale per (lane, KV head) in
``k_s`` and ``v_s``, written quantized and read through the int8
attention kernels (``ops.paged_attention_int8``,
``ops.paged_prefill_int8``), which dequantize as they load.  Whole
prompts and chunks attend their own fresh K/V at full precision, as in
the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import frontend as fe
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (embed_apply, embed_schema, norm_apply,
                                       norm_schema, softmax_xent,
                                       unembed_apply)
from repro_torch.models.module import (abstract_params, fake_mode,
                                       init_params, param_pspecs, torch_dtype)


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False; pass "
                               "device='cpu' to run on the CPU")
        self.cfg = cfg

    # ------------------------------------------------------------ schema
    def schema(self):
        cfg = self.cfg
        s = {"embed": embed_schema(cfg), **fe.frontend_schema(cfg)}
        if cfg.is_encoder_decoder:
            s["encdec"] = tf.encdec_schema(cfg)
        else:
            s["stack"] = tf.stack_schema(cfg)
        s["final_norm"] = norm_schema(cfg)
        return s

    def init(self, seed: int = 0):
        return init_params(self.schema(), seed, self.cfg.dtype, self.device)

    # ------------------------------------------------------------ abstract
    # The dry-run's view (``launch/dryrun.py``): fake tensors of the
    # global shapes (nothing allocated) and their sharding specs under a
    # rules table, the reference's ``abstract_params`` / ``param_pspecs``
    # / ``input_specs`` / ``cache_*``.

    def abstract_params(self, dtype: Optional[str] = None):
        return abstract_params(self.schema(), dtype or self.cfg.dtype)

    def param_pspecs(self, rules):
        return param_pspecs(self.schema(), rules)

    def input_specs(self, shape, dtype: Optional[str] = None):
        """A fake batch of ``shape`` (``configs/shapes.InputShape``):
        train and prefill ``tokens`` (and ``labels``) (B, S) int32 with
        S the shape's length less paligemma's patches, ``embeds`` (B, N,
        W) for a frontend; decode ``tokens`` (B, 1), ``pos`` (B,) and the
        caches of ``seq_len`` lanes."""
        cfg = self.cfg
        dt = torch_dtype(dtype or cfg.dtype)
        b = shape.global_batch
        n_front = fe.frontend_tokens(cfg)
        with fake_mode():
            i32 = dict(dtype=torch.int32)
            if shape.mode == "decode":
                return {"tokens": torch.empty((b, 1), **i32),
                        "pos": torch.empty((b,), **i32),
                        "caches": self.cache_abstract(b, shape.seq_len,
                                                      dtype)}
            s = shape.seq_len - (n_front if cfg.frontend == "vision" else 0)
            specs = {"tokens": torch.empty((b, s), **i32)}
            if shape.mode == "train":
                specs["labels"] = torch.empty((b, s), **i32)
            if n_front:
                specs["embeds"] = torch.empty((b, n_front, fe.embed_dim(cfg)),
                                              dtype=dt)
            return specs

    def cache_abstract(self, batch: int, cache_max: int,
                       dtype: Optional[str] = None):
        """Slot caches of ``batch`` x ``cache_max`` lanes as fake tensors
        (``cache_init``'s layout)."""
        cfg = self.cfg
        dt = torch_dtype(dtype or cfg.dtype)
        with fake_mode():
            if cfg.is_encoder_decoder:
                return tf.decoder_cache_init(cfg, batch, cache_max, dt, "cpu")
            return tf.stack_cache_abstract(cfg, batch, cache_max, dt)

    def cache_logical(self):
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            cross = ("batch", "frames", "kv_heads", "head_dim")
            return {f"layer{i}": {"self": tf.block_cache_logical(cfg, "attn"),
                                  "xk": cross, "xv": cross}
                    for i in range(cfg.num_layers)}
        return tf.stack_cache_logical(cfg)

    def cache_pspecs(self, rules, batch: int, cache_max: int):
        """The caches' sharding specs under ``rules``."""
        abstract = self.cache_abstract(batch, cache_max)

        def walk(lg, ab):
            if isinstance(ab, dict):
                return {k: walk(lg[k], ab[k]) for k in ab}
            return rules.spec(lg, tuple(ab.shape))

        return walk(self.cache_logical(), abstract)

    def layer_signatures(self):
        return tf.signatures(self.cfg)

    def _positions(self, s: int):
        """Positions 0..s-1, clipped at ``max_position - 1`` for learned
        positions (a later position reuses the last row)."""
        pos = torch.arange(s, dtype=torch.int32, device=self.device)
        if self.cfg.pos_kind == "learned":
            pos = torch.clamp(pos, max=self.cfg.max_position - 1)
        return pos

    def _embed(self, params, tokens, positions):
        return embed_apply(params["embed"], self.cfg, tokens, positions)

    def _inputs(self, params, batch):
        """-> (x (B,S',D), positions (S',), prefix length).  vision: the
        projected patches, cast to the tokens' dtype, in front of the
        token embeddings, positions over both, the patches the
        bidirectional prefix (the prompt stays causal)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.frontend == "vision":
            pre = fe.project(params, cfg, batch["embeds"])
            n = pre.shape[1]
            positions = self._positions(n + tokens.shape[1])
            tok_x = self._embed(params, tokens, positions[n:][None])
            return torch.cat([pre.to(tok_x.dtype), tok_x], dim=1), \
                positions, n
        positions = self._positions(tokens.shape[1])
        return self._embed(params, tokens, positions[None]), positions, 0

    def _encode(self, params, batch, train: bool):
        """whisper: the encoder over ``batch["embeds"]`` cast to the
        model dtype, and the decoder's token embeddings.  -> (enc_out, x,
        positions)."""
        cfg = self.cfg
        enc = tf.encoder_apply(params["encdec"], cfg,
                               batch["embeds"].to(torch_dtype(cfg.dtype)),
                               train=train)
        positions = self._positions(batch["tokens"].shape[1])
        return enc, self._embed(params, batch["tokens"], positions[None]), \
            positions

    # ------------------------------------------------------------ train
    def forward_train(self, params, batch, *, remat: bool = True):
        """The reference's ``Model.forward``: the training forward over
        ``batch["tokens"]`` (B,S) at positions 0..S-1, differentiable,
        attention through ``attn_apply``'s q-chunked branch (no kernel,
        as in the reference), mamba and rwkv6 from zero states.  whisper:
        the encoder over ``batch["embeds"]``, then the decoder with
        cross-attention; paligemma: the projected patches in front, a
        bidirectional prefix, their logits dropped.  ``remat`` recomputes
        each period of layers in the backward pass (the stacks; whisper's
        unrolled layers run as they are, as in the reference).
        -> (logits (B,S,V), the MoE router loss summed over layers,
        float32)."""
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            enc, x, positions = self._encode(params, batch, train=True)
            x = tf.decoder_apply(params["encdec"]["decoder"], cfg, x,
                                 positions, enc, train=True)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            x, positions, prefix = self._inputs(params, batch)
            x, aux = tf.stack_apply_train(params["stack"], cfg, x, positions,
                                          bidir_prefix=prefix, remat=remat)
            x = x[:, prefix:]
        x = norm_apply(params["final_norm"], x, cfg.norm_kind)
        return unembed_apply(params["embed"], cfg, x), aux

    def loss(self, params, batch, *, remat: bool = True):
        """Mean next-token cross-entropy against ``batch["labels"]``
        (B,S) (``batch["mask"]`` weights positions where given) plus
        ``cfg.router_aux_coef`` times the router loss.
        -> (total, {"loss": total, "xent", "aux"})."""
        logits, aux = self.forward_train(params, batch, remat=remat)
        xent = softmax_xent(logits, batch["labels"], batch.get("mask"))
        total = xent + self.cfg.router_aux_coef * aux
        return total, {"loss": total, "xent": xent, "aux": aux}

    # ------------------------------------------------------------ forward
    def forward(self, params, batch):
        """Cacheless inference forward over ``batch["tokens"]`` (B,S) at
        positions 0..S-1, attention through ``ops.flash_attention`` (the
        CUDA kernel on the card): what the draft model of speculative
        decoding runs.  -> logits (B,S,V) at every position.  The kernels
        have no backward and the router loss is not returned: training
        runs ``forward_train`` (the reference's ``Model.forward``), whose
        logits these equal within rounding.  whisper and paligemma take
        ``batch["embeds"]`` as ``forward_train`` does, every attention
        (encoder, cross, prefix-LM) through the kernel."""
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            enc, x, positions = self._encode(params, batch, train=False)
            x = tf.decoder_apply(params["encdec"]["decoder"], cfg, x,
                                 positions, enc)
        else:
            x, positions, prefix = self._inputs(params, batch)
            x = tf.stack_apply(params["stack"], cfg, x, positions,
                               bidir_prefix=prefix)[:, prefix:]
        x = norm_apply(params["final_norm"], x, cfg.norm_kind)
        return unembed_apply(params["embed"], cfg, x)

    # ------------------------------------------------------------ slot
    def cache_init(self, batch: int, cache_max: int):
        """Zero slot caches for ``batch`` slots of ``cache_max`` lanes,
        every pos lane -1 (int8 K/V with float32 scales under
        ``kv_cache_quant``); recurrent states start at zero, as the
        reference's ``LLMEngine`` zero-fills its caches (the counterpart
        of ``cache_abstract``); whisper's per decoder layer: ``"self"``
        and the cross K/V ``"xk"``/``"xv"`` (B, F, KV, hd)."""
        init = (tf.decoder_cache_init if self.cfg.is_encoder_decoder
                else tf.stack_cache_init)
        return init(self.cfg, batch, cache_max, torch_dtype(self.cfg.dtype),
                    self.device)

    def prefill(self, params, batch, *, cache_max: int):
        """Whole-prompt prefill: ``batch["tokens"]`` (B,S) at positions
        0..S-1.  Attention runs through ``ops.flash_attention`` and the
        rwkv6 recurrence through ``ops.rwkv6_scan`` (the CUDA kernels on
        the card).  whisper: the encoder over ``batch["embeds"]`` first,
        each decoder layer's cross K/V kept in its cache; paligemma: the
        patches prefixed, so the caches hold N + S positions and decoding
        goes on at position N + S.  -> (last-token logits (B,1,V), caches
        of ``cache_max`` lanes or recurrent states, in the stack
        layout)."""
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            enc, x, positions = self._encode(params, batch, train=False)
            x, caches = tf.decoder_prefill(params["encdec"]["decoder"], cfg,
                                           x, positions, enc, cache_max)
        else:
            x, positions, prefix = self._inputs(params, batch)
            x, caches = tf.stack_prefill(params["stack"], cfg, x, positions,
                                         cache_max=cache_max,
                                         bidir_prefix=prefix)
        x = norm_apply(params["final_norm"], x, cfg.norm_kind)
        return unembed_apply(params["embed"], cfg, x[:, -1:, :]), caches

    def decode_step(self, params, caches, tokens, pos):
        """tokens (B,1) int32, pos (B,) int32 absolute position (learned
        positions: clipped at ``max_position - 1``, as the reference).
        The caches are written in place.  -> (logits (B,1,V), caches)."""
        cfg = self.cfg
        if cfg.pos_kind == "learned":
            pos = torch.clamp(pos, max=cfg.max_position - 1)
        x = self._embed(params, tokens, pos[:, None])
        if cfg.is_encoder_decoder:
            x, caches = tf.decoder_decode(params["encdec"]["decoder"], cfg,
                                          x, caches, pos)
        else:
            x, caches = tf.stack_decode(params["stack"], cfg, x, caches, pos)
        x = norm_apply(params["final_norm"], x, cfg.norm_kind)
        return unembed_apply(params["embed"], cfg, x), caches

    # ------------------------------------------------------------ paged
    @property
    def supports_paged(self) -> bool:
        """The reference's definition: block-paged decode covers
        decoder-only token stacks, attention layers paging their KV
        through the pool and recurrent layers (mamba/rwkv6) carrying
        per-request state slots beside it."""
        cfg = self.cfg
        return (not cfg.is_encoder_decoder and cfg.frontend == "none"
                and all(k in ("attn", "attn_local", "mamba", "rwkv6")
                        for k in cfg.kinds_for_layers))

    def _refuse_unpaged(self, what: str) -> None:
        """The reference's refusal of the paged path for a stack that is
        not decoder-only tokens."""
        if not self.supports_paged:
            raise ValueError(f"{self.cfg.name}: {what} unsupported (needs "
                             "a decoder-only token stack)")

    @property
    def paged_has_state(self) -> bool:
        """Does the paged stack carry recurrent (non-KV) layer state?"""
        return self.supports_paged and any(
            k in ("mamba", "rwkv6") for k in self.cfg.kinds_for_layers)

    def paged_live_window(self) -> Optional[int]:
        """Token window bounding every layer's KV residency, or None when
        some layer reads unboundedly far back (any global-attention
        layer, or a local one with window 0).  When bounded, a request
        only ever needs ceil(W/block_size)+1 live blocks, so the paged
        engine may free blocks that have slid wholly out of the window.
        Recurrent layers keep state, not KV: a pure recurrent stack
        gives 1."""
        cfg = self.cfg
        if not self.supports_paged:
            return None
        w = 1
        for k in cfg.kinds_for_layers:
            if k == "attn":
                return None
            if k == "attn_local":
                if not cfg.sliding_window:
                    return None
                w = max(w, cfg.sliding_window)
        return w

    def pool_init(self, num_blocks: int, block_size: int,
                  state_batch: int = 1):
        """Zero pools for every layer (pos lanes -1; int8 K/V with float32
        scales under ``kv_cache_quant``).  Block 0 is the reserved null
        block — allocators must never hand it out.
        ``state_batch`` sizes the recurrent layers' state-slot axis
        (engine rows plus one trash row); pure attention stacks ignore
        it."""
        self._refuse_unpaged("paged decode")
        return tf.stack_pool_init(self.cfg, num_blocks, block_size,
                                  torch_dtype(self.cfg.dtype), self.device,
                                  state_batch=state_batch)

    def prefill_paged(self, params, batch, pools, block_table, start_pos, *,
                      seq_len=None, all_logits: bool = False,
                      state_rows=None):
        """Padding-masked position-offset prefill: the paged engine's one
        prefill entry (fresh prompts, preempt-resume, prefix-cache
        suffixes, continuous-batching chunks).

        ``batch["tokens"]`` (B,S) holds a ragged batch of uncached suffix
        chunks, right-padded to a length bucket; row i's first token
        sits at absolute position ``start_pos`` (scalar, or (B,) int32
        per-row cursors) and ``seq_len`` (B,) int32 gives each row's
        valid length (None = all S valid).  The cached prefix KV is read
        from ``pools`` through ``block_table`` (0-padded).  -> (last-valid
        logits (B,1,V), the chunk's caches in the pool layout, S lanes
        per row with ``pos`` -1 on padded lanes); ``all_logits=True``
        returns (B,S,V) logits for every lane.

        ``state_rows`` (B,) int32 maps dispatch rows to recurrent-state
        slots (None: row i is slot i); a recurrent layer's returned
        "cache" is its chunk-exit state, to scatter back through those
        rows (``kvcache.write_chunk_tokens``).  Rows starting at
        position 0 read zeros, not their slot."""
        self._refuse_unpaged("paged prefill")
        cfg = self.cfg
        tokens = batch["tokens"]
        s = tokens.shape[1]
        sp = torch.as_tensor(start_pos, dtype=torch.int32, device=self.device)
        lanes = torch.arange(s, dtype=torch.int32, device=self.device)
        # scalar cursor -> (S,); per-row (B,) cursors -> (B,S)
        positions = sp[..., None] + lanes if sp.dim() else sp + lanes
        x = self._embed(params, tokens, positions)
        x, caches = tf.stack_prefill_paged(params["stack"], cfg, x, positions,
                                           pools, block_table, sp,
                                           seq_len=seq_len,
                                           state_rows=state_rows)
        x = norm_apply(params["final_norm"], x, cfg.norm_kind)
        if all_logits:
            return unembed_apply(params["embed"], cfg, x), caches
        if seq_len is None:
            last = x[:, -1:, :]
        else:
            idx = (seq_len.long() - 1)[:, None, None].expand(-1, 1,
                                                             x.shape[-1])
            last = torch.gather(x, 1, idx)
        return unembed_apply(params["embed"], cfg, last), caches

    def decode_step_paged(self, params, pools, block_table, tokens, pos,
                          active):
        """Paged one-token step.  tokens (B,1) int32, pos (B,) absolute
        position, block_table (B, nb) int32, active (B,) bool.  Attention
        reads through ``ops.paged_attention`` (the CUDA kernel on the
        card); recurrent layers read and write state slot i for row i,
        active rows only.  Pools are written in place.
        -> (logits (B,1,V), pools)."""
        cfg = self.cfg
        x = self._embed(params, tokens, pos[:, None])
        x, pools = tf.stack_decode_paged(params["stack"], cfg, x, pools,
                                         block_table, pos, active)
        x = norm_apply(params["final_norm"], x, cfg.norm_kind)
        return unembed_apply(params["embed"], cfg, x), pools
