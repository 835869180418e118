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


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def coord_width_bits(qmaxg, n_grains: int, full_bits: int = 16) -> np.ndarray:
    """Stored bits per coordinate of each grain: 4, 8 or ``full_bits``.

    ``qmaxg``: the per-grain quantization magnitude of a density-aware
    build (None: every grain at the fixed ``full_bits``).
    """
    if qmaxg is None:
        return np.full(n_grains, full_bits, np.uint8)
    qm = _host(qmaxg)
    return np.where(qm <= 7, 4, np.where(qm <= 127, 8, full_bits)) \
        .astype(np.uint8)


def pack_coords_blob(coords, qmaxg):
    """Serialize [G, k, cap] int16 coordinate panels at each grain's
    stored width: what the mixed-precision index costs at rest (host
    numpy).  The device keeps the panels widened to int16; int4 grains
    take two signed nibbles a byte (``quantize.pack_int4``), int8 grains
    one byte a coordinate, full-width grains two.

    Returns (blob [B] u8, offsets [G+1] i64, width_bits [G] u8).
    """
    from .quantize import pack_int4
    coords = _host(coords)
    g = coords.shape[0]
    widths = coord_width_bits(qmaxg, g)
    parts, offsets = [], [0]
    for gi in range(g):
        c = coords[gi].reshape(-1)
        if widths[gi] == 4:
            b = pack_int4(torch.from_numpy(c)).numpy()
        elif widths[gi] == 8:
            b = c.astype(np.int8).view(np.uint8)
        else:
            b = c.astype("<i2").view(np.uint8).reshape(-1)
        parts.append(b)
        offsets.append(offsets[-1] + b.size)
    blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return blob, np.asarray(offsets, np.int64), widths


def unpack_coords_blob(blob, offsets, width_bits, k: int, cap: int):
    """Inverse of :func:`pack_coords_blob`: blob -> [G, k, cap] int16."""
    from .quantize import unpack_int4
    g = len(width_bits)
    out = np.zeros((g, k, cap), np.int16)
    for gi in range(g):
        raw = np.asarray(blob[offsets[gi]:offsets[gi + 1]], np.uint8)
        if width_bits[gi] == 4:
            vals = unpack_int4(torch.from_numpy(raw), k * cap).numpy() \
                .astype(np.int16)
        elif width_bits[gi] == 8:
            vals = raw.view(np.int8).astype(np.int16)
        else:
            vals = raw.view("<i2").astype(np.int16)
        out[gi] = vals.reshape(k, cap)
    return out


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
