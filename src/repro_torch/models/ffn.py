"""Channel mixers: dense gated MLPs and fixed-capacity top-k MoE.

This package's port of the JAX package's ``models/ffn.py``.

The MoE dispatch is the reference's capacity-bounded scheme: tokens are
ranked within their chosen expert by a stable sort over token order;
each expert processes a fixed-capacity [E, C, d] slab; tokens past an
expert's capacity are dropped (their residual path passes through);
capacity_factor=1.25 by default.  Porting notes:

- the router's top-k is a stable descending sort (ties to the lower
  expert index, as ``jax.lax.top_k``), never ``torch.topk``;
- the reference's ``mode="drop"`` scatters write an out-of-range row for
  a dropped pair; here the pairs are masked explicitly, and unfilled
  slots keep the sentinel token row ``t`` (a zero row);
- the combine gathers each token's ``top_k`` weighted expert outputs and
  sums them in expert-rank order, where the reference scatter-adds:
  ``index_add_`` on CUDA float32 uses atomics, whose order (and bits)
  change from run to run.
"""
from __future__ import annotations

import torch

from .common import ACTS, dense_init


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, ff: int, kind: str, dtype):
    if kind in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, (d, ff), 0, dtype),
                "w_up": dense_init(gen, (d, ff), 0, dtype),
                "w_down": dense_init(gen, (ff, d), 0, dtype)}
    return {"w_up": dense_init(gen, (d, ff), 0, dtype),
            "w_down": dense_init(gen, (ff, d), 0, dtype)}


def mlp_apply(params, x, kind: str):
    if kind in ("swiglu", "geglu"):
        act = ACTS["silu"] if kind == "swiglu" else ACTS["gelu"]
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = ACTS["gelu"](x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def moe_init(gen: torch.Generator, d: int, ff: int, n_experts: int, dtype):
    return {"router": dense_init(gen, (d, n_experts), 0, torch.float32),
            "e_gate": dense_init(gen, (n_experts, d, ff), 1, dtype),
            "e_up": dense_init(gen, (n_experts, d, ff), 1, dtype),
            "e_down": dense_init(gen, (n_experts, ff, d), 1, dtype)}


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = int(n_tokens * top_k / n_experts * capacity_factor)
    return max(8, -(-c // 8) * 8)           # pad to a multiple of 8


def moe_apply(params, x, *, top_k: int, capacity_factor: float = 1.25,
              norm_topk: bool = True):
    """x [B, S, d] -> (y [B, S, d], aux), aux = mean(load * importance)
    * E (the Switch load-balance loss)."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)

    gate_logits = xf.to(torch.float32) @ params["router"]           # [T, E]
    probs = torch.softmax(gate_logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]               # [T, K]
    if norm_topk:
        top_p = top_p / torch.clamp(torch.sum(top_p, -1, keepdim=True),
                                    min=1e-9)

    # Switch-style load-balance aux: fraction routed vs mean prob per expert
    importance = torch.mean(probs, dim=0)                           # [E]
    load = torch.mean(torch.nn.functional.one_hot(
        top_e[:, 0], e).to(torch.float32), dim=0)
    aux = torch.sum(importance * load) * e

    cap = _capacity(t, e, top_k, capacity_factor)

    # ---- dispatch: rank tokens within their expert (stable over token id)
    flat_e = top_e.reshape(-1)                                      # [T*K]
    flat_tok = torch.arange(t, device=dev).repeat_interleave(top_k)
    flat_w = top_p.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)                    # [E]
    offsets = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(t * top_k, device=dev) - offsets[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)

    in_cap = rank < cap
    slot_e, slot_c = flat_e[in_cap], rank[in_cap]
    disp_tok = torch.full((e, cap), t, dtype=torch.long, device=dev)
    disp_tok[slot_e, slot_c] = flat_tok[in_cap]

    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xe = xpad[disp_tok]                                             # [E, C, d]

    # ---- expert computation (batched products over the [E, C, d] slab)
    h = ACTS["silu"](torch.bmm(xe, params["e_gate"])) \
        * torch.bmm(xe, params["e_up"])
    ye = torch.bmm(h, params["e_down"])                             # [E, C, d]

    # ---- combine: each token's K weighted outputs, summed in rank order
    slot = torch.where(in_cap, flat_e * cap + rank, 0)
    yk = ye.reshape(e * cap, d)[slot].to(torch.float32) * flat_w[:, None]
    yk.masked_fill_(~in_cap[:, None], 0.0)
    y =torch.sum(yk.reshape(t, top_k, d), dim=1)
    return y.reshape(b, s, d).to(x.dtype), aux
