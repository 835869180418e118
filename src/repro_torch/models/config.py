"""Model configuration dataclass covering every assigned architecture family.

This package's copy of the JAX package's ``models/config.py``: the same
fields and defaults, so a configuration converts field by field
(``repro_torch.interop.model_config_from_dict``);
``compute_dtype`` is a ``torch.dtype``.

A model is a repeating ``pattern`` of layers (scanned as stacked groups, with
an unrolled tail when n_layers % len(pattern) != 0) plus embeddings and the
head.  ``LayerSpec.kind`` selects the token mixer: full/local attention,
RG-LRU recurrence, or RWKV6 time-mix; the channel mixer is a dense MLP or MoE
according to ``n_experts``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"                 # attn | rglru | rwkv
    window: Optional[int] = None       # sliding-window size for local attn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    mlp_kind: str = "swiglu"           # swiglu | geglu | gelu
    norm: str = "rms"                  # rms | layer
    post_norm: bool = False            # gemma2 sandwich norms
    qk_norm: bool = False              # qwen3
    qkv_bias: bool = False             # qwen1.5
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    mrope_sections: Optional[Tuple[int, ...]] = None   # qwen2-vl M-RoPE
    attn_logit_cap: Optional[float] = None
    final_logit_cap: Optional[float] = None
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    embed_scale: bool = False          # gemma multiplies embeds by sqrt(d)
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    # hybrid (RG-LRU) / ssm (RWKV6)
    conv_width: int = 4
    rnn_width: int = 0                 # 0 -> d_model
    rwkv_head_size: int = 64
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    # numerics / training
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    # remat policy: "full" recomputes everything (min memory);
    # "dots" saves matmul outputs (kills the S^2 attention recompute);
    # "none" disables remat.
    remat_policy: str = "full"
    # cast softmax probabilities to bf16 before the PV matmul (flash-attn
    # convention; halves the largest attention intermediate)
    attn_p_bf16: bool = False
    # serving
    max_target_len: int = 8192         # decoder positions for learned-pos models
    # HNTL-KV retrieval attention (paper Mode B as long-context attention)
    kv_kt: int = 16                    # tangent dim of key grains
    kv_cap: int = 4096                 # tokens per grain (sealed chunk size)
    kv_nprobe: int = 8                 # routed grains per query head
    kv_pool: int = 128                 # top-C re-ranked tokens per query head
    kv_tail: int = 1024                # exact-scan hot tail (the "memtable")
    kv_envelope_frac: float = 0.25
    kv_bf16_meta: bool = False         # bf16 grain bases/centroids
    kv_sq8: bool = False               # int8 cold tier (paper §4 SQ8)

    # ------------------------------------------------------------------
    @property
    def compute_dtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_pattern(self) -> Tuple[LayerSpec, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    @property
    def is_attention_free(self) -> bool:
        return all(s.kind != "attn" for s in self.pattern + self.tail_pattern)

    @property
    def full_attention(self) -> bool:
        """True when every attention layer is global full attention."""
        specs = self.pattern + self.tail_pattern
        return all(s.kind == "attn" and s.window is None for s in specs)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers); used for 6ND."""
        d, hd = self.d_model, self.head_dim
        n_emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per = {"attn": 0, "rglru": 0, "rwkv": 0}
        per["attn"] = d * (self.n_heads + 2 * self.n_kv_heads) * hd \
            + self.n_heads * hd * d
        r = self.rnn_dim
        per["rglru"] = 2 * d * r + r * d + self.conv_width * r + 3 * r
        hs = self.rwkv_head_size
        per["rwkv"] = 4 * d * d + d * d + 2 * d * (d // hs) * hs  # rough
        if self.n_experts:
            mlp = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        elif self.mlp_kind in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        specs = list(self.pattern) * self.n_groups + list(self.tail_pattern)
        total = n_emb
        for s in specs:
            total += per[s.kind]
            total += mlp if s.kind != "rwkv" else (
                2 * d * self.d_ff if self.mlp_kind == "rwkv_cm" else mlp)
        if self.n_enc_layers:
            total += self.n_enc_layers * (per["attn"] + mlp)   # encoder stack
            total += self.n_layers * (per["attn"])             # cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        dense_total = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * d * self.d_ff
        moe_active = self.n_layers * self.moe_top_k * 3 * d * self.d_ff
        return int(dense_total - moe_all + moe_active)
