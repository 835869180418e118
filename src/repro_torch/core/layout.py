"""Block-SoA packing.

The paper's physical layout (§2.4): per-grain data in blocks of B vectors,
coordinates dimension-major, capacity padded so every grain is a whole
number of blocks and all addressing is affine (pointerless).
"""
from __future__ import annotations

import numpy as np
import torch


def round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def pack_grains(assign, n_grains: int, block: int, cap=None):
    """Slot layout for a grain assignment.

    Returns (slot_of_point [N] i64, assign, cap, counts [G] i32): point i
    lives at (assign[i], slot_of_point[i]), slots filled in point order
    within each grain.  Vectorised: a stable argsort by grain plus each
    point's rank within its grain gives the same slots as a cursor loop.
    """
    assign = np.asarray(assign)
    counts = np.bincount(assign, minlength=n_grains)
    if cap is None:
        cap = round_up(max(int(counts.max()), block), block)
    if int(counts.max()) > cap:
        raise ValueError(
            f"grain overflow: max count {int(counts.max())} > cap {cap}; "
            "use balanced_assign or raise cap")
    order = np.argsort(assign, kind="stable")
    start = np.cumsum(counts) - counts                    # first slot row
    slot = np.empty(assign.shape[0], dtype=np.int64)
    slot[order] = np.arange(assign.shape[0], dtype=np.int64) \
        - start[assign[order]]
    return slot, assign, int(cap), counts.astype(np.int32)


def scatter_to_grains(values: torch.Tensor, assign: torch.Tensor,
                      slot: torch.Tensor, n_grains: int, cap: int, fill=0):
    """Scatter per-point rows [N, ...] into padded [G, cap, ...] storage on
    the values' device."""
    out = torch.full((n_grains, cap) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[assign, slot] = values
    return out
