"""Whisper-style encoder-decoder backbone (audio frontend is a stub): the
serving half.

This package's port of the JAX package's ``models/encdec.py`` (``loss_fn``
comes with training, ROADMAP Queue A item 11b).  The encoder takes
precomputed frame embeddings [B, T, d] (the conv1/conv2 mel frontend is
out of scope), adds sinusoidal positions and runs bidirectional
self-attention; the decoder is a pre-LN causal transformer with
cross-attention over the encoder memory and learned positions.

The reference stacks each side's layers and scans them; here they are
unrolled into ``nn.ModuleList``s (``params.enc.layers[i]`` is the
reference's ``params["enc"]["layers"]`` sliced at i), and the serving
state is a list per decoder layer: self caches ``{"k", "v"}`` [B,
max_target_len, H, hd], cross caches ``{"k", "v"}`` [B, T, H, hd], or
cross ``KVIndex``es for the long-memory path (``build_cross_index`` /
``decode_step_retrieval``: the paper's Mode B as cross-attention, on
``hntl_scan_single``).  A decode step returns new self caches and leaves
its inputs as they were.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.index import full_fp32_matmul, resolve_device
from .attention import attention, decode_attention
from .common import (dense_init, embed, embed_init, layernorm,
                     layernorm_init, sinusoidal_positions, unembed)
from .config import ModelConfig
from .ffn import mlp_apply, mlp_init
from .transformer import ParamTree


class EncDec(ParamTree):
    """The model's parameters: ``enc`` (``layers``, ``final_ln``) and
    ``dec`` (``embedding`` [V, d], tied to the unembedding,
    ``pos_embedding`` [max_target_len, d], ``layers``, ``final_ln``)."""

    def __init__(self, cfg: ModelConfig, tree, enc_layers, dec_layers):
        super().__init__(tree)
        self.cfg = cfg
        self.enc.layers = nn.ModuleList(ParamTree(lp) for lp in enc_layers)
        self.dec.layers = nn.ModuleList(ParamTree(lp) for lp in dec_layers)

    @property
    def device(self) -> torch.device:
        return self.dec.embedding.device


def _attn_init(gen, d, h, hd, dtype):
    return {"wq": dense_init(gen, (d, h, hd), 0, dtype),
            "wk": dense_init(gen, (d, h, hd), 0, dtype),
            "wv": dense_init(gen, (d, h, hd), 0, dtype),
            "wo": dense_init(gen, (h, hd, d), 0, dtype)}


def _enc_layer_init(gen, cfg: ModelConfig, dtype):
    dev = gen.device
    return {"ln1": layernorm_init(cfg.d_model, dtype, dev),
            "attn": _attn_init(gen, cfg.d_model, cfg.n_heads, cfg.head_dim,
                               dtype),
            "ln2": layernorm_init(cfg.d_model, dtype, dev),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", dtype)}


def _dec_layer_init(gen, cfg: ModelConfig, dtype):
    dev = gen.device
    return {"ln1": layernorm_init(cfg.d_model, dtype, dev),
            "self_attn": _attn_init(gen, cfg.d_model, cfg.n_heads,
                                    cfg.head_dim, dtype),
            "ln_x": layernorm_init(cfg.d_model, dtype, dev),
            "cross_attn": _attn_init(gen, cfg.d_model, cfg.n_heads,
                                     cfg.head_dim, dtype),
            "ln2": layernorm_init(cfg.d_model, dtype, dev),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", dtype)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> EncDec:
    """A new model on the generator's device: encoder layers, decoder
    layers, then the token and position embeddings."""
    dtype = cfg.compute_dtype
    dev = gen.device
    enc = [_enc_layer_init(gen, cfg, dtype) for _ in range(cfg.n_enc_layers)]
    dec = [_dec_layer_init(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    tree = {
        "enc": {"final_ln": layernorm_init(cfg.d_model, dtype, dev)},
        "dec": {"embedding": embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
                "pos_embedding": embed_init(
                    gen, (cfg.max_target_len, cfg.d_model), dtype),
                "final_ln": layernorm_init(cfg.d_model, dtype, dev)},
    }
    return EncDec(cfg, tree, enc, dec)


def _mha(p, xq, xkv, *, causal, q_offset=0):
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"])
    out = attention(q, k, v, causal=causal, q_offset=q_offset)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def encode(params: EncDec, cfg: ModelConfig, frames):
    """frames [B, T, d] precomputed embeddings -> memory [B, T, d]."""
    frames = torch.as_tensor(frames, device=params.device)
    t = frames.shape[1]
    pos = torch.from_numpy(sinusoidal_positions(t, cfg.d_model)).to(
        params.device)
    dt = cfg.compute_dtype
    with full_fp32_matmul():
        x = frames.to(dt) + pos[None].to(dt)
        for lp in params.enc.layers:
            h = layernorm(lp["ln1"], x, cfg.norm_eps)
            x = x + _mha(lp["attn"], h, h, causal=False)
            h = layernorm(lp["ln2"], x, cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h, "gelu")
        return layernorm(params.enc.final_ln, x, cfg.norm_eps)


def decode(params: EncDec, cfg: ModelConfig, tokens, memory, q_offset=0):
    """Teacher-forced decoder forward.  tokens [B, S] -> hidden [B, S, d]."""
    tokens = torch.as_tensor(tokens, device=params.device).long()
    s = tokens.shape[1]
    dec = params.dec
    with full_fp32_matmul():
        x = embed(dec.embedding, tokens)
        x = x + dec.pos_embedding[q_offset:q_offset + s][None]
        for lp in dec.layers:
            h = layernorm(lp["ln1"], x, cfg.norm_eps)
            x = x + _mha(lp["self_attn"], h, h, causal=True,
                         q_offset=q_offset)
            h = layernorm(lp["ln_x"], x, cfg.norm_eps)
            x = x + _mha(lp["cross_attn"], h, memory, causal=False)
            h = layernorm(lp["ln2"], x, cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h, "gelu")
        return layernorm(dec.final_ln, x, cfg.norm_eps)


def logits_fn(params: EncDec, hidden):
    """Logits against the tied token embedding, accumulated in float32."""
    with full_fp32_matmul():
        return unembed(params.dec.embedding, hidden)


# ---------------------------------------------------------------------------
# Serving: cross K/V made once; the self cache is a small linear cache.
# ---------------------------------------------------------------------------


def _cross_kv(lp, memory):
    k = torch.einsum("btd,dhk->bthk", memory, lp["cross_attn"]["wk"])
    v = torch.einsum("btd,dhk->bthk", memory, lp["cross_attn"]["wv"])
    return k, v


def build_cross_cache(params: EncDec, cfg: ModelConfig, memory) -> list:
    """Per-layer cross-attention K/V [B, T, H, hd] from encoder memory."""
    out = []
    with full_fp32_matmul():
        for lp in params.dec.layers:
            k, v = _cross_kv(lp, memory)
            out.append({"k": k, "v": v})
    return out


def init_self_cache(cfg: ModelConfig, batch: int, device=None) -> list:
    """Zeroed self caches, one per decoder layer.  ``device=None``: the
    card."""
    dev = resolve_device(device)
    shape = (batch, cfg.max_target_len, cfg.n_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}
            for _ in range(cfg.n_layers)]


def _self_attend(lp, x, sc, pos, cfg):
    """The decoder layer's self-attention on one token: writes its K/V at
    ``pos`` into a copy of the cache.  Returns (x, new cache)."""
    b = x.shape[0]
    h = layernorm(lp["ln1"], x, cfg.norm_eps)
    p = lp["self_attn"]
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k_new = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v_new = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    bidx = torch.arange(b, device=x.device)
    kc, vc = sc["k"].clone(), sc["v"].clone()
    kc[bidx, pos] = k_new[:, 0]
    vc[bidx, pos] = v_new[:, 0]
    t_cache = kc.shape[1]
    k_pos = torch.arange(t_cache, device=x.device)[None].expand(b, t_cache)
    out = decode_attention(q, kc, vc, pos, k_pos)
    x = x + torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return x, {"k": kc, "v": vc}


def _step(params, cfg, token, self_cache, pos, cross_fn):
    """One decode token through every decoder layer; ``cross_fn(li, qx)``
    is layer li's cross-attention output [B, 1, H, hd]."""
    token = torch.as_tensor(token, device=params.device).long()
    pos = torch.as_tensor(pos, device=params.device).long()
    dec = params.dec
    new_cache = []
    with full_fp32_matmul():
        x = embed(dec.embedding, token[:, None])
        x = x + dec.pos_embedding[pos][:, None, :]
        for li, (lp, sc) in enumerate(zip(dec.layers, self_cache)):
            x, nc = _self_attend(lp, x, sc, pos, cfg)
            new_cache.append(nc)
            h = layernorm(lp["ln_x"], x, cfg.norm_eps)
            qx = torch.einsum("bsd,dhk->bshk", h, lp["cross_attn"]["wq"])
            x = x + torch.einsum("bshk,hkd->bsd", cross_fn(li, qx),
                                 lp["cross_attn"]["wo"])
            h = layernorm(lp["ln2"], x, cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h, "gelu")
        x = layernorm(dec.final_ln, x, cfg.norm_eps)
        logits = unembed(dec.embedding, x)[:, 0, :]
    return logits, new_cache


def decode_step(params: EncDec, cfg: ModelConfig, token, self_cache,
                cross_cache, pos):
    """One decode token.  token [B], pos [B]; cross_cache from
    ``build_cross_cache``.  Returns (logits [B, V], new self cache)."""
    def cross(li, qx):
        cc = cross_cache[li]
        b, t_mem = qx.shape[0], cc["k"].shape[1]
        mem_pos = torch.arange(t_mem, device=qx.device)[None].expand(b,
                                                                     t_mem)
        return decode_attention(
            qx, cc["k"], cc["v"],
            torch.full((b,), t_mem, dtype=torch.long, device=qx.device),
            mem_pos)
    return _step(params, cfg, token, self_cache, pos, cross)


def build_cross_index(params: EncDec, cfg: ModelConfig, memory) -> list:
    """Seal the encoder memory into per-layer HNTL-KV indexes (Mode B for
    cross-attention).  memory [B, T, d]; T must divide by cfg.kv_cap."""
    from .hntl_attention import build_kv_index
    out = []
    with full_fp32_matmul():
        for lp in params.dec.layers:
            k, v = _cross_kv(lp, memory)
            out.append(build_kv_index(k, v, cfg, device=k.device))
    return out


def decode_step_retrieval(params: EncDec, cfg: ModelConfig, token,
                          self_cache, cross_idx, pos):
    """``decode_step`` with HNTL-retrieval cross-attention over a sealed
    encoder memory (``cross_idx``: one ``KVIndex`` per decoder layer):
    one ``hntl_scan_single`` launch per layer on the card."""
    from .hntl_attention import retrieval_cross_attention
    return _step(params, cfg, token, self_cache, pos,
                 lambda li, qx: retrieval_cross_attention(qx, cross_idx[li],
                                                          cfg))
