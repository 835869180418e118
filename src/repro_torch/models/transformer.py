"""Decoder-only LM: the serving half, for attention layers.

This package's port of the JAX package's ``models/transformer.py``
(``loss_fn`` comes with training, ROADMAP Queue A item 11b; the RG-LRU and
RWKV6 mixers and the mixture of experts with item 11a).

The model is an ``nn.Module`` (``Transformer``) whose parameters keep the
reference's names and shapes (``wq`` is [d, Hq, hd] and applied by
``einsum``), so weights carry across as copies
(``interop.params_from_numpy``).  The reference stacks the ``pattern``'s
repeats and runs them under ``lax.scan``; here the stack is unrolled:
``layers[g * len(pattern) + i]`` is the reference's
``params["groups"][f"l{i}"][g]``, and the ``tail`` layers follow.  The
reference's sharding hints (``constrain``) are no-ops on one device and
are dropped.

Caches are a list, one entry per layer in layer order:
``{"mixer": {"k", "v"} | KVIndex, "ffn": ()}``.  Windowed layers keep
ring caches of ``min(window, max_len)`` slots.  A decode step returns new
caches and leaves its inputs as they were, as the reference's does.
Entry points run their matrix products at full precision
(``core.index.full_fp32_matmul``: no TF32, bf16 reduced in float32).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import torch
from torch import nn

from ..core.index import full_fp32_matmul, resolve_device
from ..core.store import _unported
from . import ffn
from .attention import attention, decode_attention
from .common import (apply_rope, dense_init, embed, embed_init, make_norm,
                     softcap, unembed)
from .config import LayerSpec, ModelConfig

#: The model parts not ported yet (ROADMAP Queue A item 11a).
UNPORTED = {"rglru": "the RG-LRU mixer (models/rglru.py)",
            "rwkv": "the RWKV6 mixer (models/rwkv6.py)",
            "moe": "the mixture-of-experts channel mixer (models/ffn.py "
                   "moe_init / moe_apply)",
            "encdec": "the encoder-decoder (models/encdec.py)"}


def check_ported(cfg: ModelConfig) -> None:
    """Refuse a configuration that needs a part not ported yet."""
    if cfg.family == "encdec":
        raise _unported(f"{cfg.name!r} (encdec)", "11a", UNPORTED["encdec"])
    for spec in layer_specs(cfg):
        if spec.kind in UNPORTED:
            raise _unported(f"{cfg.name!r} ({spec.kind} layers)", "11a",
                            UNPORTED[spec.kind])
        if spec.kind != "attn":
            raise ValueError(spec.kind)
    if cfg.n_experts:
        raise _unported(f"{cfg.name!r} (n_experts={cfg.n_experts})", "11a",
                        UNPORTED["moe"])


def layer_specs(cfg: ModelConfig) -> list:
    """Every layer's spec, in layer order (groups, then the tail)."""
    return list(cfg.pattern) * cfg.n_groups + list(cfg.tail_pattern)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A node of the parameter tree: tensors become parameters (no
    gradient: serving), mappings child nodes.  ``node["name"]`` reads a
    child as the reference's dict access does."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._parameters or name in self._modules


class Transformer(ParamTree):
    """The model's parameters: ``embedding`` [V, d], ``final_norm``,
    ``layers`` (an ``nn.ModuleList``, unrolled groups then the tail) and,
    untied, ``lm_head`` [V, d]."""

    def __init__(self, cfg: ModelConfig, tree: Mapping, layers):
        super().__init__(tree)
        self.cfg = cfg
        self.layers = nn.ModuleList(ParamTree(lp) for lp in layers)

    @property
    def device(self) -> torch.device:
        return self.embedding.device


def _attn_init(gen, cfg: ModelConfig, dtype):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {"wq": dense_init(gen, (d, hq, hd), 0, dtype),
         "wk": dense_init(gen, (d, hkv, hd), 0, dtype),
         "wv": dense_init(gen, (d, hkv, hd), 0, dtype),
         "wo": dense_init(gen, (hq, hd, d), 0, dtype)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.zeros((hd,), dtype=dtype, device=dev)}
        p["k_norm"] = {"scale": torch.zeros((hd,), dtype=dtype, device=dev)}
    return p


def _layer_init(gen, cfg: ModelConfig, dtype):
    norm_init, _ = make_norm(cfg.norm)
    dev = gen.device
    p = {"pre_norm": norm_init(cfg.d_model, dtype, dev),
         "mixer": _attn_init(gen, cfg, dtype),
         "mlp_pre_norm": norm_init(cfg.d_model, dtype, dev),
         "ffn": ffn.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind,
                             dtype)}
    if cfg.post_norm:
        p["post_norm"] = norm_init(cfg.d_model, dtype, dev)
        p["mlp_post_norm"] = norm_init(cfg.d_model, dtype, dev)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """A new model on the generator's device, its weights drawn in layer
    order, then the embedding, then (untied) ``lm_head``.

    The reference draws ``lm_head`` from the embedding's key, so its
    untied models start with ``lm_head == embedding``; here ``lm_head``
    takes its own draw (ROADMAP, faults of the reference)."""
    check_ported(cfg)
    dtype = cfg.compute_dtype
    norm_init, _ = make_norm(cfg.norm)
    layers = [_layer_init(gen, cfg, dtype) for _ in layer_specs(cfg)]
    tree = {"embedding": embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
            "final_norm": norm_init(cfg.d_model, dtype, gen.device)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = embed_init(gen, (cfg.vocab, cfg.d_model), dtype)
    return Transformer(cfg, tree, layers)


# ---------------------------------------------------------------------------
# Layer apply (shared by forward / prefill / decode)
# ---------------------------------------------------------------------------


def _qk_rmsnorm(p, x, eps):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


def _project_qkv(p, x, cfg: ModelConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = _qk_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = _qk_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    rd = int(cfg.head_dim * cfg.rotary_pct)
    q = apply_rope(q, positions, cfg.rope_theta, rd, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, rd, cfg.mrope_sections)
    return q, k, v


def _attn_apply(p, x, cfg: ModelConfig, spec: LayerSpec, positions):
    """Full-segment attention (forward / prefill).  x [B, S, d]."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = attention(q, k, v, causal=True, window=spec.window,
                    logit_cap=cfg.attn_logit_cap, scale=cfg.attn_scale,
                    p_bf16=cfg.attn_p_bf16)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


def _mixer_apply(p, x, cfg, spec, positions, state):
    """Returns (y, kv_for_cache_or_None, new_state)."""
    if state is not None and x.shape[1] == 1:           # decode step
        from .hntl_attention import KVIndex
        if isinstance(state, KVIndex):                  # HNTL-KV retrieval
            y, new_state = _attn_retrieval_decode(p, x, cfg, spec,
                                                  positions, state)
        else:
            y, new_state = _attn_decode(p, x, cfg, spec, positions, state)
        return y, None, new_state
    y, kv = _attn_apply(p, x, cfg, spec, positions)
    return y, kv, state


def _layer_apply(p, x, cfg: ModelConfig, spec: LayerSpec, positions,
                 state=None):
    """One (mixer + channel-mix) layer.  Returns (x, kv, new_state)."""
    _, norm = make_norm(cfg.norm)
    h = norm(p["pre_norm"], x, cfg.norm_eps)
    mixer_state = state["mixer"] if state is not None else None
    y, kv, new_mixer_state = _mixer_apply(p["mixer"], h, cfg, spec,
                                          positions, mixer_state)
    if cfg.post_norm:
        y = norm(p["post_norm"], y, cfg.norm_eps)
    x = x + y
    h = norm(p["mlp_pre_norm"], x, cfg.norm_eps)
    y = ffn.mlp_apply(p["ffn"], h, cfg.mlp_kind)
    if cfg.post_norm:
        y = norm(p["mlp_post_norm"], y, cfg.norm_eps)
    x = x + y
    new_state = None
    if state is not None:
        new_state = {"mixer": new_mixer_state, "ffn": state["ffn"]}
    return x, kv, new_state


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _tokens(params: Transformer, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.device).long()


def _embed_tokens(params, cfg: ModelConfig, tokens, patch_embeds=None):
    x = embed(params["embedding"], tokens, scale_by_dim=cfg.embed_scale)
    if patch_embeds is not None:                       # VLM stub frontend
        pe = torch.as_tensor(patch_embeds, device=x.device).to(x.dtype)
        # dynamic_update_slice at (0, 1, 0): the start clamps to fit
        start = max(0, min(1, x.shape[1] - pe.shape[1]))
        x = x.clone()
        x[:, start:start + pe.shape[1]] = pe
    return x


def _default_positions(cfg: ModelConfig, batch, seq, offset=0,
                       device=None):
    pos = offset + torch.arange(seq, device=device)
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections is not None:
        pos = pos.expand(3, batch, seq)                # text-only: all equal
    return pos


def _positions(params, cfg, positions, b, s):
    if positions is None:
        return _default_positions(cfg, b, s, device=params.device)
    return torch.as_tensor(positions, device=params.device).long()


def _final_hidden(params, cfg, x):
    _, norm = make_norm(cfg.norm)
    return norm(params["final_norm"], x, cfg.norm_eps)


def forward(params: Transformer, cfg: ModelConfig, tokens, positions=None,
            patch_embeds=None):
    """Full-segment forward.  Returns hidden [B, S, d]."""
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    positions = _positions(params, cfg, positions, b, s)
    with full_fp32_matmul():
        x = _embed_tokens(params, cfg, tokens, patch_embeds)
        for lp, spec in zip(params.layers, layer_specs(cfg)):
            x, _, _ = _layer_apply(lp, x, cfg, spec, positions)
        return _final_hidden(params, cfg, x)


def logits_fn(params, cfg: ModelConfig, hidden):
    table = params["lm_head"] if "lm_head" in params \
        else params["embedding"]
    with full_fp32_matmul():
        return softcap(unembed(table, hidden), cfg.final_logit_cap)


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def _cache_len_for(spec: LayerSpec, max_len: int) -> int:
    if spec.window is not None:
        return min(spec.window, max_len)               # ring cache
    return max_len


def _layer_cache_init(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      max_len: int, dtype, device):
    t = _cache_len_for(spec, max_len)
    shape = (batch, t, cfg.n_kv_heads, cfg.head_dim)
    return {"mixer": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)},
            "ffn": ()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zeroed caches, one entry per layer.  ``device=None``: the card."""
    dev = resolve_device(device)
    return [_layer_cache_init(spec, cfg, batch, max_len, cfg.compute_dtype,
                              dev) for spec in layer_specs(cfg)]


def _ring_positions(t_cache: int, q_pos, window: Optional[int]):
    """Absolute position stored in each ring-cache slot given query pos.

    Slot i holds the largest p <= q_pos-1 with p % T == i (T = cache
    size); empty slots map to -1 via the p >= 0 check in decode_attention.
    """
    i = torch.arange(t_cache, device=q_pos.device)[None, :]
    prev = q_pos[:, None] - 1                          # last written position
    return prev - torch.remainder(prev - i, t_cache)


def _attn_decode(p, x, cfg: ModelConfig, spec: LayerSpec, positions, state):
    """x [B, 1, d]; state {"k", "v" [B, T, hkv, hd]}.  positions [B, 1]
    (or [3, B, 1]): the token's absolute position."""
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    q_pos = (positions[0] if positions.dim() == 3 else positions)[:, 0]
    b, t_cache = x.shape[0], state["k"].shape[1]
    slot = torch.remainder(q_pos, t_cache)
    bidx = torch.arange(b, device=x.device)
    k_cache = state["k"].clone()
    v_cache = state["v"].clone()
    k_cache[bidx, slot] = k_new[:, 0]
    v_cache[bidx, slot] = v_new[:, 0]
    if spec.window is not None and t_cache <= spec.window:
        k_pos = _ring_positions(t_cache, q_pos + 1, spec.window)
    else:
        k_pos = torch.arange(t_cache, device=x.device)[None, :] \
            .expand(b, t_cache)
    out = decode_attention(q, k_cache, v_cache, q_pos, k_pos,
                           window=spec.window, logit_cap=cfg.attn_logit_cap,
                           scale=cfg.attn_scale)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, {"k": k_cache, "v": v_cache}


def _attn_retrieval_decode(p, x, cfg: ModelConfig, spec: LayerSpec,
                           positions, idx):
    """HNTL-KV long-context decode (the paper's Mode B as attention)."""
    from .hntl_attention import retrieval_decode_attention
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    q_pos = (positions[0] if positions.dim() == 3 else positions)[:, 0]
    out, new_idx = retrieval_decode_attention(q, k_new, v_new, idx, q_pos,
                                              cfg)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_idx


def _write_prefill_cache(cache, kv, seq_len: int):
    """Scatter prefill K/V into the (possibly ring) cache."""
    k, v = kv
    t_cache = cache["k"].shape[1]
    k_cache, v_cache = cache["k"], cache["v"]
    if seq_len <= t_cache:
        k_cache[:, :seq_len] = k
        v_cache[:, :seq_len] = v
    else:                                              # keep the last window
        slots = torch.remainder(
            torch.arange(seq_len - t_cache, seq_len, device=k.device),
            t_cache)
        k_cache[:, slots] = k[:, -t_cache:].to(k_cache.dtype)
        v_cache[:, slots] = v[:, -t_cache:].to(v_cache.dtype)
    return {"k": k_cache, "v": v_cache}


def prefill(params: Transformer, cfg: ModelConfig, tokens, positions=None,
            patch_embeds=None, max_len: Optional[int] = None):
    """Forward + cache build.  Returns (last-token logits [B, V], caches).

    max_len: cache capacity for later ``decode_step`` calls (>= the
    prompt's length; defaults to 2 * S so decoding can go past it).
    """
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    if max_len is None:
        max_len = 2 * s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is below the prompt's {s}")
    positions = _positions(params, cfg, positions, b, s)
    caches = []
    with full_fp32_matmul():
        x = _embed_tokens(params, cfg, tokens, patch_embeds)
        for lp, spec in zip(params.layers, layer_specs(cfg)):
            x, kv, _ = _layer_apply(lp, x, cfg, spec, positions)
            lc = _layer_cache_init(spec, cfg, b, max_len, cfg.compute_dtype,
                                   params.device)
            caches.append({"mixer": _write_prefill_cache(lc["mixer"], kv, s),
                           "ffn": lc["ffn"]})
            del kv
        hidden = _final_hidden(params, cfg, x[:, -1:, :])
    return logits_fn(params, cfg, hidden)[:, 0, :], caches


def decode_step(params: Transformer, cfg: ModelConfig, token, caches, pos):
    """One serving step.  token [B], pos [B] (position of this token).

    Returns (logits [B, V], new caches).
    """
    token = _tokens(params, token)
    pos = torch.as_tensor(pos, device=params.device).long()
    b = token.shape[0]
    positions = pos[:, None]
    if cfg.mrope_sections is not None:
        positions = positions.expand(3, b, 1)
    new_caches = []
    with full_fp32_matmul():
        x = _embed_tokens(params, cfg, token[:, None])
        for lp, spec, lc in zip(params.layers, layer_specs(cfg), caches):
            x, _, new_state = _layer_apply(lp, x, cfg, spec, positions, lc)
            new_caches.append(new_state)
        hidden = _final_hidden(params, cfg, x)
    return logits_fn(params, cfg, hidden)[:, 0, :], new_caches
