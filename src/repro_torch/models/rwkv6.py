"""RWKV-6 "Finch" blocks: data-dependent-decay time-mix + channel-mix.

This package's port of the JAX package's ``models/rwkv6.py``.

Time-mix recurrence per head (head size N), following arXiv:2404.05892:

    out_t = r_t . (S_{t-1} + (u * k_t) outer v_t)
    S_t   = diag(w_t) S_{t-1} + k_t outer v_t

with data-dependent per-channel decay w_t = exp(-exp(w0 + lora_w(x~_t))) and
data-dependent token-shift interpolation (ddlerp) feeding r/k/v/w/g.  The
sequential state S is [B, H, N, N]; a segment runs the step scan, a loop
over time, as the reference's runtime path does.  Under
``lowering.flags().wkv_chunks`` a segment of more than one token runs
the chunked block-parallel form (``_wkv_chunked``, min(wkv_chunks, S)
chunks) instead, as the reference does.  Attention-free: HNTL-KV does
not apply.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ACTS, dense_init, sigmoid
from .lowering import flags

_LORA = 32
_LORA_W = 64
_LOG_CLIP = 30.0


def timemix_init(gen: torch.Generator, d: int, head_size: int, dtype):
    h = d // head_size
    dev = gen.device
    f32 = torch.float32
    u = torch.empty((h, head_size), dtype=f32, device=dev)
    u.normal_(0.0, 1.0, generator=gen)
    return {
        # ddlerp: base mix mu_x plus 5 per-stream deltas via a shared lora
        "mu_x": torch.zeros((d,), dtype=f32, device=dev),
        "mu_rkvwg": torch.zeros((5, d), dtype=f32, device=dev),
        "lora_a": dense_init(gen, (d, 5 * _LORA), 0, f32),
        "lora_b": dense_init(gen, (5, _LORA, d), 1, f32),
        # decay
        "w0": torch.full((d,), -6.0, dtype=f32, device=dev),
        "wlora_a": dense_init(gen, (d, _LORA_W), 0, f32),
        "wlora_b": dense_init(gen, (_LORA_W, d), 0, f32),
        "u": 0.1 * u,
        "wr": dense_init(gen, (d, d), 0, dtype),
        "wk": dense_init(gen, (d, d), 0, dtype),
        "wv": dense_init(gen, (d, d), 0, dtype),
        "wg": dense_init(gen, (d, d), 0, dtype),
        "wo": dense_init(gen, (d, d), 0, dtype),
        "ln_x_scale": torch.ones((d,), dtype=f32, device=dev),
        "ln_x_bias": torch.zeros((d,), dtype=f32, device=dev),
    }


def channelmix_init(gen: torch.Generator, d: int, ff: int, dtype):
    dev = gen.device
    return {
        "mu_k": torch.zeros((d,), dtype=torch.float32, device=dev),
        "mu_r": torch.zeros((d,), dtype=torch.float32, device=dev),
        "cm_wr": dense_init(gen, (d, d), 0, dtype),
        "cm_w": dense_init(gen, (d, ff), 0, dtype),
        "cm_w2": dense_init(gen, (ff, d), 0, dtype),
    }


def _shifted(x, last=None):
    """Token shift: x_{t-1} (zeros / carried state at t=0).  x [B, S, d]."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    else:
        last = last[:, None, :].to(x.dtype)
    return torch.cat([last, x[:, :-1]], dim=1)


def _ddlerp(params, x, xprev):
    """Data-dependent interpolation producing the 5 mixed streams r,k,v,w,g."""
    delta = (xprev - x).to(torch.float32)
    base = x.to(torch.float32) + delta * params["mu_x"]
    lo = torch.tanh(base @ params["lora_a"])                  # [B,S,5*L]
    b, s, _ = lo.shape
    lo = lo.reshape(b, s, 5, _LORA)
    dyn = torch.einsum("bsfl,fld->bsfd", lo, params["lora_b"])  # [B,S,5,d]
    mixed = x.to(torch.float32)[:, :, None, :] + delta[:, :, None, :] \
        * (params["mu_rkvwg"] + dyn)
    return [mixed[:, :, i, :] for i in range(5)]              # r,k,v,w,g


def _wkv_scan(r, k, v, w, u, s0):
    """The Finch recurrence.  r,k,v,w [B, S, H, N] (w in (0,1)); s0 [B,H,N,N].

    Returns (out [B, S, H, N], s_final).
    """
    s = s0
    ub = u[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # [B, H, N]
        kv = kt[..., :, None] * vt[..., None, :]              # [B,H,N,N]
        outs.append(torch.einsum("bhi,bhij->bhj", rt, s + ub * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(outs, dim=1), s


def _wkv_chunk_body(r, k, v, w, u, s0):
    """One chunk of the block-parallel WKV.

    r,k,v,w [B, C, H, N]; s0 [B, H, N, N].  Within a chunk, decays are
    factored through cumulative per-channel products W_t = prod_{s<=t} w_s:

        out_t = (r_t*W_{t-1}) . S0  +  tril_strict((R~ K~^T)) V
                + (r_t*(u*k_t)) v_t
        S_C   = diag(W_C) S0 + (W_C/W_j * k_j)^T V

    with R~ = r*W_{t-1}, K~ = k/W_j: two [C,C]/[C,N] products instead of
    C sequential rank-1 updates.  Log space with clipping keeps k/W from
    overflowing for strong decays.
    """
    c = r.shape[1]
    logw = torch.log(torch.clamp(w, min=1e-38))          # [B,C,H,N] (<0)
    cum = torch.cumsum(logw, dim=1)                      # log W_t
    cum_prev = cum - logw                                # log W_{t-1}
    r_t = r * torch.exp(torch.clamp(cum_prev, -_LOG_CLIP, _LOG_CLIP))
    k_t = k * torch.exp(torch.clamp(-cum, -_LOG_CLIP, _LOG_CLIP))

    # cross-token term: strictly causal [C, C] per (B, H)
    att = torch.einsum("bihn,bjhn->bhij", r_t, k_t)      # i=query, j=key
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    att = torch.where(mask[None, None], att, 0.0)
    out = torch.einsum("bhij,bjhn->bihn", att, v)

    # state term + diagonal (current-token bonus) term
    out = out + torch.einsum("bihn,bhnm->bihm", r_t, s0)
    out = out + torch.einsum("bihn,bihm->bihm", r * (u[None, None] * k), v)

    # state update
    w_end = cum[:, -1][:, :, :, None]                    # [B,H,N,1] log W_C
    k_scaled = k * torch.exp(torch.clamp(cum[:, -1][:, None] - cum,
                                         -_LOG_CLIP, _LOG_CLIP))
    s_new = torch.exp(torch.clamp(w_end, -_LOG_CLIP, 0.0)) * s0 \
        + torch.einsum("bjhn,bjhm->bhnm", k_scaled, v)
    return out, s_new


def _wkv_chunked(r, k, v, w, u, s0, n_chunks: int):
    """Chunked WKV, a Python loop over chunks.  Exact (up to float
    association) against the step scan."""
    s = r.shape[1]
    c = -(-s // n_chunks)
    pad = n_chunks * c - s
    if pad:
        def zeros(t):
            return F.pad(t, (0, 0, 0, 0, 0, pad))
        r, k, v = zeros(r), zeros(k), zeros(v)
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    outs = []
    state = s0
    for ci in range(n_chunks):
        sl = slice(ci * c, (ci + 1) * c)
        o, state = _wkv_chunk_body(r[:, sl], k[:, sl], v[:, sl], w[:, sl],
                                   u, state)
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :s], state


def timemix_apply(params, x, head_size: int, state=None):
    """x [B, S, d].  state: None or {"s": [B,H,N,N], "shift": [B, d]}."""
    b, s, d = x.shape
    h = d // head_size
    xprev = _shifted(x, None if state is None else state["shift"])
    xr, xk, xv, xw, xg = _ddlerp(params, x, xprev)

    f32 = torch.float32
    r = (xr.to(x.dtype) @ params["wr"]).reshape(b, s, h, head_size)
    k = (xk.to(x.dtype) @ params["wk"]).reshape(b, s, h, head_size)
    v = (xv.to(x.dtype) @ params["wv"]).reshape(b, s, h, head_size)
    g = ACTS["silu"](xg.to(x.dtype) @ params["wg"])
    w = torch.exp(-torch.exp(
        params["w0"] + torch.tanh(xw @ params["wlora_a"])
        @ params["wlora_b"]))
    w = w.reshape(b, s, h, head_size)

    s0 = state["s"] if state is not None else \
        torch.zeros((b, h, head_size, head_size), dtype=f32, device=x.device)
    if flags().wkv_chunks and s > 1:
        out, s_fin = _wkv_chunked(r.to(f32), k.to(f32), v.to(f32), w,
                                  params["u"], s0,
                                  n_chunks=min(flags().wkv_chunks, s))
    else:
        out, s_fin = _wkv_scan(r.to(f32), k.to(f32), v.to(f32), w,
                               params["u"], s0)

    # per-head groupnorm, then output gate
    o = out.reshape(b, s, h, head_size)
    mu = torch.mean(o, dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, unbiased=False)
    o = ((o - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, d)
    o = o * params["ln_x_scale"] + params["ln_x_bias"]
    y = (o.to(x.dtype) * g) @ params["wo"]

    new_state = None
    if state is not None:
        new_state = {"s": s_fin, "shift": x[:, -1, :].to(f32)}
    return y, new_state


def channelmix_apply(params, x, state=None):
    """x [B, S, d].  state: None or {"shift": [B, d]}."""
    xprev = _shifted(x, None if state is None else state["shift"])
    delta = (xprev - x).to(torch.float32)
    xk = (x.to(torch.float32) + delta * params["mu_k"]).to(x.dtype)
    xr = (x.to(torch.float32) + delta * params["mu_r"]).to(x.dtype)
    kk = torch.square(F.relu(xk @ params["cm_w"]))
    y = sigmoid(xr @ params["cm_wr"]) * (kk @ params["cm_w2"])
    new_state = None
    if state is not None:
        new_state = {"shift": x[:, -1, :].to(torch.float32)}
    return y, new_state


def rwkv_state_init(batch: int, d: int, head_size: int, device=None):
    h = d // head_size
    f32 = torch.float32
    return {
        "tm": {"s": torch.zeros((batch, h, head_size, head_size), dtype=f32,
                                device=device),
               "shift": torch.zeros((batch, d), dtype=f32, device=device)},
        "cm": {"shift": torch.zeros((batch, d), dtype=f32, device=device)},
    }
