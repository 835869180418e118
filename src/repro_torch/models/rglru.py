"""RG-LRU recurrent block (RecurrentGemma / Griffin hybrid layers).

This package's port of the JAX package's ``models/rglru.py``.

Recurrence (per channel):
    r_t = sigmoid(W_a x_t)          (recurrence gate, block-diagonal)
    i_t = sigmoid(W_x x_t)          (input gate,      block-diagonal)
    a_t = exp(-c * softplus(L) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A segment (prefill, forward) runs the recurrence as a log-depth scan
over the sequence axis (recursive doubling: ceil(log2 S) rounds of
elementwise products, where the reference uses
``jax.lax.associative_scan``); the float order of the two scans differs,
so they agree to rounding, not bit for bit.  Decode is a single state
update.  The block wraps the recurrence with the Griffin structure: a
gated GeLU branch times a causal depthwise conv1d branch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ACTS, dense_init, sigmoid

_C = 8.0
_EPS = 1e-6


def rg_block_init(gen: torch.Generator, d: int, r: int, n_blocks: int,
                  conv_width: int, dtype):
    bs = r // n_blocks
    dev = gen.device
    # Lambda init so a^c in ~(0.9, 0.999) (Griffin appendix)
    u = torch.empty((r,), dtype=torch.float32, device=dev)
    u.uniform_(0.9 ** 2, 0.999 ** 2, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))            # softplus^-1
    return {
        "w_gate_rnn": dense_init(gen, (d, r), 0, dtype),      # gelu branch
        "w_in": dense_init(gen, (d, r), 0, dtype),            # conv branch
        "w_out": dense_init(gen, (r, d), 0, dtype),
        "conv_w": dense_init(gen, (conv_width, r), 0, dtype),
        "conv_b": torch.zeros((r,), dtype=dtype, device=dev),
        # block-diagonal gates [n_blocks, bs, 2*bs] (recurrence | input)
        "gate_w": dense_init(gen, (n_blocks, bs, 2 * bs), 1, torch.float32),
        "gate_b": torch.zeros((n_blocks, 2 * bs), dtype=torch.float32,
                              device=dev),
        "lambda_p": lam,                                      # [r] f32
    }


def causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d.  x [B, S, r], w [W, r].

    state: [B, W-1, r] trailing context from the previous segment (decode).
    Returns (y [B, S, r], new_state [B, W-1, r]).
    """
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)             # [B, S+W-1, r]
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(width)) + b
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return y.to(x.dtype), new_state


def _gates(params, x):
    """Block-diagonal recurrence/input gates.  x [B, S, r] -> (r_t, i_t)."""
    b, s, r = x.shape
    nb = params["gate_w"].shape[0]
    xb = x.reshape(b, s, nb, r // nb).to(torch.float32)
    g = torch.einsum("bsnh,nhk->bsnk", xb, params["gate_w"]) \
        + params["gate_b"]
    g = g.reshape(b, s, 2 * r)
    return sigmoid(g[..., :r]), sigmoid(g[..., r:])


def _linear_scan(a, beta):
    """h_t = a_t h_{t-1} + beta_t with h_{-1} = 0, along axis 1, by
    recursive doubling: after the round at ``shift``, each (A_t, B_t)
    composes the steps (t - 2 shift, t]."""
    s, shift = a.shape[1], 1
    while shift < s:
        beta = torch.cat([beta[:, :shift],
                          a[:, shift:] * beta[:, :-shift] + beta[:, shift:]],
                         dim=1)
        if 2 * shift < s:
            a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]],
                          dim=1)
        shift *= 2
    return beta


def rglru(params, x, h0=None):
    """The RG-LRU recurrence over a full segment (forward / prefill).

    x [B, S, r]; h0 [B, r] initial state.  Returns (y [B, S, r], h_S [B, r]).
    """
    rt, it = _gates(params, x)
    log_a = -_C * F.softplus(params["lambda_p"]) * rt        # [B, S, r] f32
    a = torch.exp(log_a)
    gated = it * x.to(torch.float32)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                  min=_EPS)) * gated
    if h0 is not None:
        beta = torch.cat([beta[:, :1] + (a[:, 0] * h0.to(torch.float32))
                          [:, None], beta[:, 1:]], dim=1)
    h = _linear_scan(a, beta)
    return h.to(x.dtype), h[:, -1, :]


def rglru_step(params, x, h):
    """One decode step.  x [B, 1, r], h [B, r] -> (y [B, 1, r], h')."""
    rt, it = _gates(params, x)
    log_a = -_C * F.softplus(params["lambda_p"]) * rt[:, 0]
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=_EPS)) \
        * (it[:, 0] * x[:, 0].to(torch.float32))
    h_new = a * h.to(torch.float32) + beta
    return h_new[:, None, :].to(x.dtype), h_new


def rg_block_apply(params, x, state=None):
    """Griffin recurrent block.  x [B, S, d].

    state: None (forward) or {"h": [B, r], "conv": [B, W-1, r]}.
    Returns (y [B, S, d], new_state or None).
    """
    gate = ACTS["gelu"](x @ params["w_gate_rnn"])
    u = x @ params["w_in"]
    conv_state = state["conv"] if state is not None else None
    u, new_conv = causal_conv(u, params["conv_w"], params["conv_b"],
                              conv_state)
    if state is not None and x.shape[1] == 1:
        h, h_last = rglru_step(params, u, state["h"])
    else:
        h0 = state["h"] if state is not None else None
        h, h_last = rglru(params, u, h0)
    y = (gate * h) @ params["w_out"]
    new_state = {"h": h_last, "conv": new_conv} if state is not None \
        else None
    return y, new_state


def rg_state_init(batch: int, r: int, conv_width: int, dtype, device=None):
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, conv_width - 1, r), dtype=dtype,
                                device=device)}
