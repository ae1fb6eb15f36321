"""Config system for the port: a copy of the reference ``ModelConfig``.

The dataclass, its derived properties and ``reduced()`` are copied from
``repro.configs.base`` unchanged, so a config built here describes the
same model as the reference's.  ``get_config`` knows only the
architectures this package carries; any other name raises.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple

_MODULE_FOR = {
    "whisper-tiny": "whisper_tiny",
    "qwen3-0.6b": "qwen3_0_6b",
    "paligemma-3b": "paligemma_3b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "gemma3-4b": "gemma3_4b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok1_314b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One transformer/SSM/hybrid architecture, fully specified.

    ``layer_kinds`` drives heterogeneous stacks (gemma3 local/global,
    jamba attn/mamba interleave): a tuple of per-layer kind strings that is
    tiled over ``num_layers``.  Kinds: "attn", "attn_local", "mamba",
    "rwkv6".
    """

    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str                         # citation for the numbers below

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0               # GQA; == num_heads for MHA, 1 for MQA
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                   # 0 -> d_model // num_heads

    # --- block flavour ---
    mlp_kind: str = "swiglu"            # swiglu | gelu | geglu
    norm_kind: str = "rmsnorm"          # rmsnorm | layernorm
    pos_kind: str = "rope"              # rope | learned | none
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0       # "attn_local" layers (0 = same);
                                        # gemma3: 10k local / 1M global
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    layer_kinds: Tuple[str, ...] = ("attn",)
    sliding_window: int = 0             # window for "attn_local" layers

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_every: int = 1                  # MoE MLP on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25

    # --- SSM (mamba) ---
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2

    # --- RWKV ---
    rwkv_head_dim: int = 64

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_frames: int = 0             # stubbed frontend output length

    # --- modality frontend stub ---
    frontend: str = "none"              # none | audio | vision
    num_prefix_tokens: int = 0          # vision patches prefixed to sequence

    max_position: int = 131072
    dtype: str = "bfloat16"
    # int8 KV cache (beyond-paper, EXPERIMENTS.md §Perf-decode): K/V stored
    # int8 with a per-(position, kv-head) absmax scale; dequantized at use.
    kv_cache_quant: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def kinds_for_layers(self) -> Tuple[str, ...]:
        reps = -(-self.num_layers // len(self.layer_kinds))
        return tuple((self.layer_kinds * reps)[: self.num_layers])

    @property
    def is_attention_free(self) -> bool:
        return all(k in ("rwkv6", "mamba") for k in self.kinds_for_layers)

    @property
    def supports_long_decode(self) -> bool:
        """True if decode memory is sub-linear in context (bounded caches)."""
        if self.is_encoder_decoder:
            return False
        kinds = self.kinds_for_layers
        # every layer must have bounded-or-shardable state; we allow a
        # minority of full-attention layers (gemma3 global, jamba attn).
        full = sum(1 for k in kinds if k == "attn")
        return full * 4 <= len(kinds)

    def layer_is_moe(self, i: int) -> bool:
        return self.num_experts > 0 and i % self.moe_every == self.moe_offset

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant of the same family: 2 layers, d_model<=512,
        <=4 experts, small vocab."""
        kinds = self.kinds_for_layers[:8] or ("attn",)
        # keep family structure: take a representative 2-kind slice
        uniq = []
        for k in kinds:
            if k not in uniq:
                uniq.append(k)
        small_kinds = tuple(uniq[:2]) if uniq else ("attn",)
        d = min(self.d_model, 256)
        heads = 4 if self.num_heads else 0
        kv = min(self.num_kv_heads, heads) or heads
        if self.num_kv_heads == 1:
            kv = 1
        elif kv:
            kv = 2
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64 if self.num_heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            layer_kinds=small_kinds,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_frames=16 if self.is_encoder_decoder else 0,
            num_prefix_tokens=4 if self.num_prefix_tokens else 0,
            max_position=4096,
            dtype="float32",
        )

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer), for roofline
        MODEL_FLOPS."""
        hd = self.resolved_head_dim
        emb = self.vocab_size * self.d_model
        out = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        total = emb + out
        for i, kind in enumerate(self.kinds_for_layers):
            if kind in ("attn", "attn_local"):
                q = self.d_model * self.num_heads * hd
                kv = 2 * self.d_model * self.num_kv_heads * hd
                o = self.num_heads * hd * self.d_model
                total += q + kv + o
            elif kind == "mamba":
                d_in = self.ssm_expand * self.d_model
                total += (
                    2 * self.d_model * d_in          # in_proj (x, z)
                    + d_in * self.ssm_conv_width
                    + d_in * (2 * self.ssm_state_dim + 1)  # B,C,dt proj
                    + d_in * self.d_model            # out proj
                    + d_in * self.ssm_state_dim      # A
                )
            elif kind == "rwkv6":
                total += 4 * self.d_model * self.d_model   # r,k,v,g
                total += self.d_model * self.d_model       # output
                total += 6 * self.d_model * 64             # lora decay/mix
            if self._mlp_params(i):
                total += self._mlp_params(i)
            total += 2 * self.d_model                      # norms
        if self.is_encoder_decoder:
            # encoder self-attn + mlp, decoder cross-attn already not counted:
            # approximate: encoder layer ~ decoder attn layer
            enc = self.encoder_layers * (
                4 * self.d_model * self.num_heads * hd + self._mlp_dense_params()
            )
            dec_cross = self.num_layers * 4 * self.d_model * self.num_heads * hd
            total += enc + dec_cross
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        total = self.param_count()
        for i in range(self.num_layers):
            if self.layer_is_moe(i):
                per_expert = self._mlp_dense_params()
                total -= (self.num_experts - self.num_experts_per_tok) * per_expert
        return total

    def _mlp_dense_params(self) -> int:
        mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        return mult * self.d_model * self.d_ff

    def _mlp_params(self, i: int) -> int:
        if self.layer_is_moe(i):
            return self.num_experts * self._mlp_dense_params() + self.d_model * self.num_experts
        return self._mlp_dense_params()


# ----------------------------------------------------------------------
def get_config(name: str) -> ModelConfig:
    mod_name = _MODULE_FOR.get(name)
    if mod_name is None:
        raise KeyError(f"architecture {name!r} is not carried by repro_torch "
                       f"yet; carried: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
