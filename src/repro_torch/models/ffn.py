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
  a dropped pair; here a dropped pair writes a spill column that is cut
  off, and unfilled slots keep the sentinel token row ``t`` (a zero
  row).  Every shape is fixed by the input's (counts by ``scatter_add_``,
  no boolean mask), so the meta device traces it (``launch.dryrun``);
- the combine gathers each token's ``top_k`` weighted expert outputs and
  sums them in expert-rank order, where the reference scatter-adds:
  ``index_add_`` on CUDA float32 uses atomics, whose order (and bits)
  change from run to run.

``moe_apply``'s parts (``route``, ``expert_ranks``, ``dispatch_table``,
``expert_ffn``, ``combine``) also serve the expert-parallel train step,
which computes the same function with the batch split over data rows
(the functions below; ``models.transformer.mesh_loss``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import counting
from .common import ACTS, dense_init, matmul_f32


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


def mlp_apply(params, x, kind: str, partial: bool = False):
    """The MLP of ``x``.  ``partial``: the parameters are one model
    slot's block of the hidden columns, and the result is its float32
    partial sum of ``w_down``'s product (``common.matmul_f32``), which
    the slots add before one rounding."""
    if kind in ("swiglu", "geglu"):
        act = ACTS["silu"] if kind == "swiglu" else ACTS["gelu"]
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = ACTS["gelu"](x @ params["w_up"])
    if partial:
        return matmul_f32(h, params["w_down"])
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


def route(gate_logits, top_k: int, norm_topk: bool = True):
    """[T, E] float32 router logits -> (probs [T, E], top_p [T, K],
    top_e [T, K]): the softmax, then a stable descending sort (ties to
    the lower expert), the kept weights renormalised with ``norm_topk``."""
    probs = torch.softmax(gate_logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]               # [T, K]
    if norm_topk:
        top_p = top_p / torch.clamp(torch.sum(top_p, -1, keepdim=True),
                                    min=1e-9)
    return probs, top_p, top_e


def expert_ranks(top_e, n_experts: int):
    """(flat_e [T*K], rank [T*K], counts [E]) of the (token, choice)
    pairs in token order: each pair's expert, its rank among that
    expert's pairs by a stable sort over token order, and the pairs per
    expert."""
    flat_e = top_e.reshape(-1)
    dev = flat_e.device
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.long, device=dev) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(flat_e.shape[0], device=dev) \
        - offsets[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return flat_e, rank, counts


def dispatch_table(flat_e, rank, flat_tok, n_experts: int, cap: int,
                   n_tokens: int):
    """[E, cap]: the token in each expert's capacity slot (``n_tokens``,
    the zero row, where none is).  A pair at rank >= cap is dropped: it
    writes the spill column ``cap``, cut off."""
    in_cap = rank < cap
    disp_tok = torch.full((n_experts, cap + 1), n_tokens, dtype=torch.long,
                          device=flat_e.device)
    disp_tok[flat_e, torch.where(in_cap, rank, cap)] = flat_tok
    return disp_tok[:, :cap]


def expert_ffn(e_gate, e_up, e_down, xe):
    """The experts' SwiGLU over a [n, c, d] slab of n experts' capacity
    slots: batched products, reported to the cost counter as the
    "experts" part."""
    with counting.part("experts"):
        h = ACTS["silu"](torch.bmm(xe, e_gate)) * torch.bmm(xe, e_up)
        return torch.bmm(h, e_down)                                 # [n, c, d]


def combine(yk, flat_w, in_cap, top_k: int):
    """[T*K, d] expert outputs of the pairs (any row where dropped) ->
    [T, d] float32: each token's K weighted outputs summed in rank
    order, a dropped pair adding 0."""
    yk = yk.to(torch.float32) * flat_w[:, None]
    yk.masked_fill_(~in_cap[:, None], 0.0)
    return torch.sum(yk.reshape(-1, top_k, yk.shape[-1]), dim=1)


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
    probs, top_p, top_e = route(gate_logits, top_k, norm_topk)

    # Switch-style load-balance aux: fraction routed vs mean prob per expert
    importance = torch.mean(probs, dim=0)                           # [E]
    load = torch.mean(torch.nn.functional.one_hot(
        top_e[:, 0], e).to(torch.float32), dim=0)
    aux = torch.sum(importance * load) * e

    cap = _capacity(t, e, top_k, capacity_factor)

    # ---- dispatch: rank tokens within their expert (stable over token id)
    flat_e, rank, _ = expert_ranks(top_e, e)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(top_k)
    disp_tok = dispatch_table(flat_e, rank, flat_tok, e, cap, t)
    in_cap = rank < cap

    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xe = xpad[disp_tok]                                             # [E, C, d]

    # ---- expert computation (batched products over the [E, C, d] slab)
    ye = expert_ffn(params["e_gate"], params["e_up"], params["e_down"], xe)

    # ---- combine: each token's K weighted outputs, summed in rank order
    slot = torch.where(in_cap, flat_e * cap + rank, 0)
    y = combine(ye.reshape(e * cap, d)[slot], top_p.reshape(-1), in_cap,
                top_k)
    return y.reshape(b, s, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Expert parallelism: the MoE of a batch split over data rows
# ---------------------------------------------------------------------------
#
# On a mesh the batch's rows (contiguous blocks of its sequences, in order)
# each route their own tokens; routing, capacity and ranks stay the whole
# batch's, as on one device.  A pair's rank within its expert is its rank
# in one device's stable sort over the global token order: its rank within
# its row plus the earlier rows' counts for that expert (``prior``, an
# exclusive scan of the rows' [E] counts; a row may be split further into
# contiguous units, each ranked the same way).  The [E, C] cells of the
# one-device slab are split into blocks: experts block m (of the model
# slots') by capacity block j (of the rows'), one owner each, so no cell is
# computed twice.  Which pairs of a row go to which owner follows from the
# counts alone (``owner_sizes``).


def capacity_blocks(cap: int, n_rows: int) -> list:
    """[(start, length)] of the capacity slots each of ``n_rows`` rows'
    owners computes: ``cap`` split in order, the first ``cap % n_rows``
    blocks one longer."""
    q, r = divmod(cap, n_rows)
    out, start = [], 0
    for j in range(n_rows):
        n = q + (j < r)
        out.append((start, n))
        start += n
    return out


def global_ranks(rank, flat_e, prior, cap: int):
    """(global rank, in capacity) of a row's pairs: ``rank`` within the
    row plus ``prior`` [E], the earlier rows' pairs per expert."""
    grank = rank + prior[flat_e]
    return grank, grank < cap


def even_counts(tokens: list, top_k: int, n_experts: int):
    """[units, E] pairs per expert were each unit's ``tokens * top_k``
    pairs spread as evenly as they can be: the counts a trace on the meta
    device (no values) sizes the moves by."""
    out = np.zeros((len(tokens), n_experts), dtype=np.int64)
    for j, t in enumerate(tokens):
        q, r = divmod(t * top_k, n_experts)
        out[j] = q + (np.arange(n_experts) < r)
    return out


def owner_sizes(counts, cap: int, n_rows: int, n_blocks: int):
    """[units, capacity blocks, experts blocks]: how many of each unit's
    pairs each owner computes, from the units' [units, E] ``counts`` (an
    int64 numpy array; units hold the batch's tokens in order) alone: unit
    u's pairs for expert e hold the global ranks [prior, prior + count),
    cut at ``cap``; ``cap`` splits into ``n_rows`` capacity blocks."""
    n_units, n_experts = counts.shape
    blocks = capacity_blocks(cap, n_rows)
    lo = np.cumsum(counts, 0) - counts
    hi = np.minimum(lo + counts, cap)
    starts = np.fromiter((s for s, _ in blocks), np.int64, n_rows)
    ends = starts + np.fromiter((n for _, n in blocks), np.int64, n_rows)
    cut = np.maximum(0, np.minimum(hi[:, :, None], ends)
                     - np.maximum(lo[:, :, None], starts))  # [units, E, J]
    cut = cut.reshape(n_units, n_blocks, n_experts // n_blocks, n_rows)
    return cut.sum(2).transpose(0, 2, 1)


def cell_owners(flat_e, grank, in_cap, cap: int, n_rows: int,
                n_experts: int, n_blocks: int):
    """(owner, expert within its block, capacity slot within its block)
    of each pair of a row: owner j * ``n_blocks`` + m computes experts
    block m of capacity block j; a dropped pair's owner is
    ``n_rows * n_blocks``, past every owner."""
    dev = flat_e.device
    blocks = capacity_blocks(cap, n_rows)
    ends = torch.tensor([s + n for s, n in blocks], dtype=torch.long,
                        device=dev)
    starts = torch.tensor([s for s, _ in blocks] + [cap], dtype=torch.long,
                          device=dev)
    j = torch.where(in_cap, torch.bucketize(grank, ends, right=True),
                    n_rows)
    eb = n_experts // n_blocks
    m = torch.div(flat_e, eb, rounding_mode="floor")
    owner = torch.where(in_cap, j * n_blocks + m, n_rows * n_blocks)
    return owner, flat_e - m * eb, grank - starts[j]


def owner_pairs(owner, sizes: list) -> list:
    """The pairs of a row each owner computes (``sizes``: their counts,
    in owner order, host integers): index tensors into the row's pairs,
    each in pair order."""
    order = torch.sort(owner, stable=True)[1]
    return list(torch.split(order[:sum(sizes)], sizes))


def assemble_dispatch(parts: list, n_experts: int, cap: int,
                      n_tokens: int):
    """The one-device [E, cap] dispatch table from the rows' parts
    [(flat_e, global rank, global token of each pair)]: what the owners'
    cells hold, put together (``moe_apply``'s ``dispatch_table`` of the
    whole batch, which it equals)."""
    dev = parts[0][0].device
    table = torch.full((n_experts, cap + 1), n_tokens, dtype=torch.long,
                       device=dev)
    for flat_e, grank, tok in parts:
        table[flat_e, torch.clamp(grank, max=cap)] = tok
    return table[:, :cap]
