"""Block-SoA packing.

The paper's physical layout (§2.4): per-grain data in blocks of B vectors,
coordinates dimension-major, capacity padded so every grain is a whole
number of blocks and all addressing is affine (pointerless).  The panel
file (``write_panel_file``/``open_panel_file``) is the same layout on
disk: the tiered residency plane's cold tier.
"""
from __future__ import annotations

import json
import os

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


def pack_members(members, cap: int):
    """Lay explicit member lists out as Block-SoA id/valid panels: the
    maintenance plane's group rewrite primitive (host numpy).

    members: a sequence of [m_g] int arrays (local raw rows of each
    group, m_g <= cap), packed densely from slot 0; the other slots are
    -1/False padding.  Returns (ids [G, cap] i32, valid [G, cap] bool).
    """
    ids = np.full((len(members), cap), -1, np.int32)
    valid = np.zeros((len(members), cap), bool)
    for gi, rows in enumerate(members):
        m = len(rows)
        if m > cap:
            raise ValueError(f"group {gi} overflows cap: {m} > {cap}")
        ids[gi, :m] = np.asarray(rows, np.int32)
        valid[gi, :m] = True
    return ids, valid


def write_panel_file(path: str, panels: dict) -> dict:
    """Write a dict of grain-axis host panels to one Block-SoA file.

    Field-major and C-ordered (all of ``coords``, then all of ``res``,
    ...), so one grain's panel, or a contiguous range of grains, is one
    sequential read.  Returns the meta ``{field: {"offset", "dtype",
    "shape"}}`` that ``open_panel_file`` maps back; a JSON sidecar at
    ``path + ".json"`` holds the same meta.  The file is fsynced before
    the meta is returned: a written panel file is durable.
    """
    meta, off = {}, 0
    with open(path, "wb") as f:
        for name, arr in panels.items():
            arr = np.ascontiguousarray(arr)
            arr.tofile(f)
            meta[name] = {"offset": off, "dtype": str(arr.dtype),
                          "shape": list(arr.shape)}
            off += arr.nbytes
        f.flush()
        os.fsync(f.fileno())
    with open(path + ".json", "w") as f:
        json.dump({"fields": meta, "nbytes": off}, f)
    return meta


def open_panel_file(path: str, meta: dict) -> dict:
    """Map a ``write_panel_file`` file back as read-only memmaps,
    ``{field: np.memmap}`` of the original dtypes and shapes.  Bytes are
    read only when a grain slice is taken."""
    return {name: np.memmap(path, dtype=np.dtype(m["dtype"]), mode="r",
                            offset=int(m["offset"]), shape=tuple(m["shape"]))
            for name, m in meta.items()}
