"""Shared model pieces: initializers, norms, activations, RoPE, embeddings.

This package's port of the JAX package's ``models/common.py``.  Parameters
are tensors drawn from an explicit ``torch.Generator`` (so the draws are
not JAX's: weights are carried across with ``interop.params_from_numpy``);
every ``apply`` is a plain function of tensors.  Norm statistics, RoPE
phases and the unembedding run in float32, outputs return to the input's
dtype, as in the reference.  ``cross_entropy`` comes with training
(ROADMAP item 11b).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.bfloat16):
    """Truncated-normal (+-2 sigma) fan-in init, drawn in float32 on the
    generator's device."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16):
    """std = 1/sqrt(d): pairs with ``embed_scale`` (gemma) and keeps tied
    unembedding logits O(1) at init."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.normal_(w, 0.0, 1.0, generator=gen)
    return (w * (1.0 / math.sqrt(shape[-1]))).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, dtype=torch.bfloat16, device=None):
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """gemma-style RMSNorm: x / rms(x) * (1 + scale)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].to(torch.float32))).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.bfloat16, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(torch.float32) \
        + params["bias"].to(torch.float32)
    return y.to(x.dtype)


def make_norm(kind: str):
    if kind == "rms":
        return rmsnorm_init, rmsnorm
    if kind == "layer":
        return layernorm_init, layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Activations / softcap
# ---------------------------------------------------------------------------

def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """logistic(x) as 1 / (1 + exp(-x)), one op at a time: in bf16 each op
    rounds to bf16, as the reference's ``jax.nn.sigmoid`` does where XLA
    lowers it (``torch.sigmoid`` rounds once, and differs from it in ~1/3
    of bf16 values)."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * logistic(x), rounded per op as ``sigmoid``."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` op for op: its constants in x's
    dtype, x**3 as two products, each op rounded to x's dtype (in bf16
    ``F.gelu`` rounds once and differs from it in ~2/5 of values)."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


ACTS = {
    "silu": silu,
    "gelu": gelu_tanh,
    "relu": F.relu,
}


def softcap(x: torch.Tensor, cap):
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary position embeddings (full / partial / multimodal M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(rotary_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, rotary_dim, 2,
                                         dtype=torch.float32, device=device)
                            / rotary_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, rotary_dim=None,
               mrope_sections=None) -> torch.Tensor:
    """Rotate ``x [B, S, H, hd]`` by position-dependent phases.

    positions: [B, S], or [3, B, S] for M-RoPE (temporal, h, w streams).
    rotary_dim: if < hd, only the leading dims rotate (stablelm).
    mrope_sections: per-stream frequency-block sizes summing to
      rotary_dim // 2 (qwen2-vl: each band reads its own stream).
    """
    hd = x.shape[-1]
    rd = rotary_dim if rotary_dim is not None else hd
    freqs = rope_freqs(rd, theta, x.device)                 # [rd//2]
    ang = positions[..., None].to(torch.float32) * freqs
    if mrope_sections is not None:
        if positions.dim() != 3:
            raise ValueError("M-RoPE needs [3, B, S] positions")
        parts, start = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(ang[i, :, :, start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)                      # [B, S, rd//2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x[..., :rd].to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rd < hd:
        out = torch.cat([out, x[..., rd:].to(torch.float32)], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, dim: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal table [n, dim] (float32 numpy, made
    at build time, as the reference's)."""
    log_timescale = np.log(10000.0) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2))
    t = np.arange(n)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed(table: torch.Tensor, tokens: torch.Tensor,
          scale_by_dim: bool = False):
    out = table[tokens]
    if scale_by_dim:
        out = out * torch.tensor(math.sqrt(table.shape[1]), dtype=out.dtype,
                                 device=out.device)
    return out


def unembed(table: torch.Tensor, x: torch.Tensor):
    """Logits = x @ table.T, accumulated in float32 (both sides cast
    first, as the reference's ``preferred_element_type``)."""
    return torch.matmul(x.to(torch.float32), table.to(torch.float32).T)
