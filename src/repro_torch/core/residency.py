"""Tiered grain-panel residency: serving a store beyond device memory.

The stacked plane of ``core.store`` keeps every grain panel on the device.
Here the grain panel is the unit of residency instead: a segment set's
panel tier (coords, res, sketch, ids, valid, tags, ts: the arrays that
grow with ``cap``) is written to one disk-backed panel file
(``layout.write_panel_file``), and only a hot set of grains, elected from
the per-grain probe traffic under a byte budget, stays on the device as a
compacted mini-plane.  The frames (basis, mu, scales, sketch basis,
qmaxg) and the routing plane stay on the device, in the ``routing_stub``:
routing and the query projection run on them, once per search.

A probed cold grain is staged on demand, in chunks of at most
``prefetch_grains`` grains: on the card each chunk is assembled in one of
two pinned host buffers (from the panel file's memmaps, or from a host
LRU of assembled chunks), copied to one of two device buffers on a side
stream, and scanned on the compute stream once the copy's event has
fired; a buffer is refilled only after the copy out of it (host side) and
the pass that read it (device side) have finished.  So the host assembles
chunk k+1 while chunk k is copied and chunk k-1 is scanned, and at most
two chunks of cold panels occupy the device.

Bit-identity with the all-warm plane holds by construction:

- routing and the projection run once per search on the resident frames,
  in the all-warm plane's query batches (``planner.static_route``,
  ``planner.project_probes``); every pass is handed a gathered slice of
  the result, and a gather is exact;
- a mini-plane's panels are a slice of the stacked plane's (the same
  bytes), and the slot mask it carries is the host replica of the
  all-warm plane's in-scan predicate (``host_keep_mask``: boolean algebra
  on the same stored values);
- the store merges the passes' pools in the select's key order (distance,
  probe, slot) and runs the Mode B tail once, on the merged pool, through
  the all-warm plane's epilogue and batches.

The JAX package's ``repro.core.residency`` is the reference.  It projects
the queries again inside every pass, over the pass's own shape, which on
XLA:CPU changes rq's bits; the port does not.
"""
from __future__ import annotations

import contextlib
import os
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..analysis.sanitize import place
from . import layout
from .types import GrainStore, HNTLIndex, RoutingPlane, StackedSegments

#: The panel tier: what the panel file holds (``sketch`` when present).
PANEL_FIELDS = ("coords", "res", "sketch", "ids", "valid", "tags", "ts")
#: The frame tier: per-grain metadata that stays on the device.
FRAME_FIELDS = ("basis", "mu", "scale", "res_scale", "sketch_basis",
                "sketch_scale", "qmaxg")
#: Fills of the trailing dummy grain's frames (as ``stack_segments`` pads:
#: unit scales, qmax 1).
_FRAME_FILL = {"scale": 1.0, "res_scale": 1.0, "sketch_scale": 1.0,
               "qmaxg": 1}
#: What a pass reads of a staged grain, in buffer order: its index into
#: the frame tables, the panel fields a scan reads, and the slot mask made
#: for the search.  The mask comes last, so the bytes before it depend on
#: the grains alone and are what the host LRU keeps.
STAGED_FIELDS = ("slots", "coords", "res", "sketch", "ids", "mask")
#: Byte alignment of every staged field: the select kernel's vector loads
#: need 16-byte aligned panels; 128 keeps each field on its own L2 lines.
STAGE_ALIGN = 128


def pow2ceil(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def _unlink_files(*paths) -> None:
    for p in paths:
        with contextlib.suppress(OSError):
            os.unlink(p)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def host_keep_mask(panels: dict, live: Optional[np.ndarray], tag_mask,
                   ts_range):
    """Host replica of ``planner._mixed_recall_mask`` over the panel
    file's memmaps: (keep [G, cap] | None, grain_ok [G] | None).  Boolean
    algebra on the stored values the device predicate reads, so the
    routing pushdown and the slot mask of the paged plane equal the
    all-warm plane's bit for bit."""
    if tag_mask is None and ts_range is None and live is None:
        return None, None
    keep = np.asarray(panels["valid"])
    if live is not None:
        keep = keep & live
    if tag_mask is not None:
        keep = keep & ((np.asarray(panels["tags"])
                        & np.uint32(tag_mask)) != 0)
    if ts_range is not None:
        lo, hi = np.float32(ts_range[0]), np.float32(ts_range[1])
        ts = np.asarray(panels["ts"])
        keep = keep & (ts >= lo) & (ts < hi)
    return keep, keep.any(axis=1)


def host_tenant_mask(panels: dict, extra: Optional[np.ndarray],
                     grain_ok: Optional[np.ndarray],
                     tenant_live: Optional[np.ndarray],
                     tenant_ix: Optional[np.ndarray]):
    """Host replica of the per-query tenant routing pushdown of the
    coalesced serving plane (``serve.tenancy``): [Q, G] from the tenants'
    visibility stack ``tenant_live`` [T, G, cap] and each query's
    ``tenant_ix``, joined with the shared [G] ``grain_ok``; the shared one
    itself without tenants, or None."""
    if tenant_live is None:
        return grain_ok
    base = extra if extra is not None else np.asarray(panels["valid"])
    ok_q = np.any(tenant_live & base[None], axis=2)[tenant_ix]    # [Q, G]
    return ok_q if grain_ok is None else ok_q & grain_ok[None, :]


def compact_probes(gids: np.ndarray, na: np.ndarray, member_map: np.ndarray,
                   dummy_slot: int):
    """Compact one pass's probes out of a probe plan (host numpy).

    gids [Q, P] grain ids and na [Q] active counts (the plan); member_map
    [G] i32 maps a grain to its slot in this pass's mini-plane (-1: not a
    member).  Per query the member probes are stable-partitioned to the
    front (plan order kept), the width is padded to a power of two, and
    the slack points at the mini-plane's trailing all-invalid dummy grain.

    Returns (plan_gids [Q, W] i32 mini-plane slots, plan_na [Q] i32 >= 1,
    W, active_q [Q] bool: which queries probe any member, pos [Q, W] i64:
    the plan position each compacted probe came from) or None when no
    query probes a member.  ``pos`` is what the store gathers each probe's
    projection with; slack positions point at non-member probes, which
    ``plan_na`` kills.
    """
    p_n = gids.shape[1]
    act = np.arange(p_n, dtype=np.int32)[None, :] < na[:, None]
    slots = member_map[gids]                                      # [Q, P]
    sel = act & (slots >= 0)
    cnt = sel.sum(axis=1).astype(np.int32)
    if not cnt.any():
        return None
    order = np.argsort(~sel, axis=1, kind="stable")
    w = min(pow2ceil(int(cnt.max())), p_n)
    pos = order[:, :w]
    picked = np.take_along_axis(slots, pos, axis=1)
    plan_g = np.where(np.arange(w, dtype=np.int32)[None, :] < cnt[:, None],
                      picked, np.int32(dummy_slot)).astype(np.int32)
    return plan_g, np.maximum(cnt, 1), w, cnt > 0, pos


def device_plan(hot_map: torch.Tensor, gids: torch.Tensor, *,
                dummy_slot: int) -> torch.Tensor:
    """Map a probe plan's gids through the hot map on the device: hot
    probes to their hot mini-plane slots, cold ones to the trailing dummy
    grain.  No host round trip, so the hot pass is queued before the
    host reads the plan back to schedule the cold chunks."""
    m = hot_map[gids.long()]
    return torch.where(m >= 0, m, dummy_slot).to(torch.int32)


def chunk_cold(cold: np.ndarray, chunk: int) -> list:
    """Split the cold grains to stage into chunks of at most ``chunk`` (a
    power of two), each of a power-of-two size, so the passes' shapes come
    from a small set.  A short tail repeats its last grain; the repeat is
    never probed (the member map points a grain at one slot)."""
    out, i, n = [], 0, len(cold)
    while i < n:
        rem = n - i
        take = min(chunk, rem)
        size = chunk if rem >= chunk else pow2ceil(rem)
        part = cold[i:i + take]
        if len(part) < size:
            part = np.concatenate(
                [part, np.full(size - len(part), part[-1], part.dtype)])
        out.append(part)
        i += take
    return out


class _Stager:
    """The double buffer of one chunk size on the card: two pinned host
    buffers and two device buffers, used in turn.  Host buffer i is
    refilled after the copy out of it has finished (the host waits on its
    event); device buffer i is written after the pass that read it has
    finished (the side stream waits on that pass's event)."""

    def __init__(self, nbytes: int, device: torch.device):
        self.device = device
        self.host = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.dev = [torch.empty(nbytes, dtype=torch.uint8, device=device)
                    for _ in range(2)]
        self.copied = [None, None]
        self.read = [None, None]
        self.stream = torch.cuda.Stream(device)
        self.turn = 0

    def stage(self, fill):
        """``fill(host numpy uint8 view) -> staged bytes``, then the copy
        to the device.  Returns (buffer index, device buffer, bytes)."""
        i, self.turn = self.turn, self.turn ^ 1
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        staged = fill(self.host[i].numpy())
        with torch.cuda.stream(self.stream):
            if self.read[i] is not None:
                self.stream.wait_event(self.read[i])
            self.dev[i].copy_(self.host[i], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.copied[i] = ev
        torch.cuda.current_stream(self.device).wait_event(ev)
        return i, self.dev[i], staged

    def done(self, i: int) -> None:
        """The pass that reads device buffer i has been queued."""
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.read[i] = ev


class TieredPlane:
    """The panel file and the device hot set of one segment set.

    Holds the panel file (unlinked by a finalizer when the plane dies, as
    a cold raw file is), the frames on the device, the hot mini-plane,
    the staging buffers and the counters ``residency_stats`` reports.
    """

    STAGE_CACHE_ENTRIES = 16

    def __init__(self, path: str, panels: dict, frames: dict,
                 sizes: np.ndarray, device: torch.device):
        self.path = path
        self.panels = panels                 # {field: np.memmap [G, ...]}
        self.frames = frames                 # {field: tensor [G + 1, ...]}
        self.sizes = np.asarray(sizes)
        self.device = torch.device(device)
        self.n_grains, self.cap = (int(v) for v in panels["ids"].shape)
        self.k = int(panels["coords"].shape[1])
        self.hot_slots = np.zeros(0, np.int64)
        self.hot_map = np.full(self.n_grains, -1, np.int32)
        self.hot_map_dev = place(self.hot_map, self.device)
        self.hot_epochs = 0
        self._hot = (None, None, None)       # (hot epoch, buffer, plane)
        self._hot_mask_key = None
        self.staged_bytes = 0                # cold chunk bytes copied over
        self.chunk_dispatches = 0
        self.paged_queries = 0
        # host LRU of assembled chunks (their panel bytes, keyed by the
        # grains): the panel file never changes, so a hit is exact
        self._stage_cache = OrderedDict()
        self._stagers = {}
        self._layouts = {}
        self._finalizer = weakref.finalize(self, _unlink_files, path,
                                           path + ".json")

    @classmethod
    def from_stacked(cls, stacked: StackedSegments, path: str,
                     device) -> "TieredPlane":
        """Write a host-stacked plane's panel tier to ``path`` and keep its
        frames on ``device``.  Tags go to the file as u32, their width in
        the JAX package, so a grain's panel bytes (the budget unit) are
        the same in both."""
        g = stacked.index.grains
        panels = {}
        for name in PANEL_FIELDS:
            leaf = getattr(g, name)
            if leaf is not None:
                a = leaf.cpu().numpy()
                panels[name] = a.astype(np.uint32) if name == "tags" else a
        meta = layout.write_panel_file(path, panels)
        frames = {}
        leaves = {name: getattr(g, name) for name in FRAME_FIELDS}
        leaves["sizes"] = stacked.index.routing.sizes
        for name, leaf in leaves.items():
            if leaf is not None:
                dummy = torch.full((1, *leaf.shape[1:]),
                                   _FRAME_FILL.get(name, 0), dtype=leaf.dtype)
                frames[name] = place(torch.cat([leaf.cpu(), dummy]), device)
        return cls(path, layout.open_panel_file(path, meta), frames,
                   stacked.index.routing.sizes.cpu().numpy(), device)

    # ------------------------------------------------------------- geometry
    def panel_bytes_per_grain(self) -> int:
        """Panel-file bytes of one grain: the budget unit."""
        return sum(v.nbytes // self.n_grains for v in self.panels.values())

    def budget_slots(self, budget_bytes: int) -> int:
        per = self.panel_bytes_per_grain()
        if per <= 0:
            return self.n_grains
        return max(0, min(self.n_grains, int(budget_bytes // per)))

    def slot_map(self, slots: np.ndarray) -> np.ndarray:
        """[G] i32: grain -> its slot in a mini-plane over ``slots``, -1
        for non-members (a repeated grain maps to its last slot)."""
        m = np.full(self.n_grains, -1, np.int32)
        m[np.asarray(slots, np.int64)] = np.arange(len(slots),
                                                   dtype=np.int32)
        return m

    # ------------------------------------------------------------ admission
    def set_hot(self, slots: np.ndarray) -> bool:
        """Install a hot set (sorted, deduplicated).  True when it changed;
        the hot mini-plane is then rebuilt at the next search."""
        sl = np.unique(np.asarray(slots, np.int64))
        if np.array_equal(sl, self.hot_slots):
            return False
        self.hot_slots = sl
        self.hot_map = self.slot_map(sl)
        self.hot_map_dev = place(self.hot_map, self.device)
        self._hot = (None, None, None)
        self.hot_epochs += 1
        return True

    @property
    def n_hot(self) -> int:
        return int(self.hot_slots.shape[0])

    # ------------------------------------------------------------- planes
    def routing_stub(self) -> StackedSegments:
        """The resident frame plane: the real routing plane and frames,
        zero-cap panels.  ``planner.static_route`` routes on it and
        ``planner.project_probes`` projects on it; no panel is read."""
        g_n, fr, dev = self.n_grains, self.frames, self.device

        def z(name, *shape):
            dt = _torch_dtype(self.panels[name].dtype) \
                if name in self.panels else torch.int32
            return torch.zeros(shape, dtype=dt, device=dev)

        def frame(name):
            return fr[name][:g_n] if name in fr else None

        sk = self.panels.get("sketch")
        grains = GrainStore(
            coords=z("coords", g_n, self.k, 0), res=z("res", g_n, 0),
            sketch=z("sketch", g_n, sk.shape[1], 0) if sk is not None
            else None,
            ids=z("ids", g_n, 0), valid=z("valid", g_n, 0),
            **{name: frame(name) for name in FRAME_FIELDS})
        return StackedSegments(
            index=HNTLIndex(routing=RoutingPlane(centroids=grains.mu,
                                                 sizes=frame("sizes")),
                            grains=grains, raw=None),
            gid_of_row=torch.zeros(0, dtype=torch.int32, device=dev),
            row_offset=torch.zeros(1, dtype=torch.int32, device=dev))

    def _layout(self, n: int):
        """Byte layout of a staged mini-plane of ``n`` grains (the dummy
        included): ({field: (offset, numpy dtype, shape)}, total bytes)."""
        hit = self._layouts.get(n)
        if hit is not None:
            return hit
        fields, off = {}, 0
        for name in STAGED_FIELDS:
            if name == "slots":
                dt, shape = np.dtype(np.int64), (n,)
            elif name == "mask":
                dt, shape = np.dtype(bool), (n, self.cap)
            elif name in self.panels:
                v = self.panels[name]
                dt, shape = v.dtype, (n, *v.shape[1:])
            else:
                continue
            fields[name] = (off, dt, shape)
            off += layout.round_up(int(np.prod(shape)) * dt.itemsize,
                                   STAGE_ALIGN)
        self._layouts[n] = (fields, off)
        return fields, off

    def _fill(self, sl: np.ndarray, mask_src, buf: np.ndarray) -> int:
        """Assemble the staged bytes of a mini-plane over grains ``sl`` plus
        one dummy grain into ``buf`` (uint8): the panel fields from the
        host LRU or, on a miss, from the panel file (the disk read); the
        mask from ``mask_src`` [G, cap].  Returns the bytes staged."""
        fields, nbytes = self._layout(len(sl) + 1)

        def view(name):
            off, dt, shape = fields[name]
            return buf[off:off + int(np.prod(shape)) * dt.itemsize] \
                .view(dt).reshape(shape)

        panel_end = fields["mask"][0]
        key = sl.tobytes()
        hit = self._stage_cache.get(key)
        if hit is not None:
            self._stage_cache.move_to_end(key)
            buf[:panel_end] = hit
        else:
            s = view("slots")
            s[:-1] = sl
            s[-1] = self.n_grains                 # the frames' dummy row
            for name in STAGED_FIELDS[1:-1]:
                if name not in fields:
                    continue
                v = view(name)
                np.take(self.panels[name], sl, axis=0, out=v[:-1],
                        mode="clip")
                v[-1] = -1 if name == "ids" else 0
            self._stage_cache[key] = buf[:panel_end].copy()
            while len(self._stage_cache) > self.STAGE_CACHE_ENTRIES:
                self._stage_cache.popitem(last=False)
        m = view("mask")
        np.take(mask_src, sl, axis=0, out=m[:-1], mode="clip")
        m[-1] = False
        return nbytes

    def _plane_from(self, raw: torch.Tensor, n: int) -> StackedSegments:
        """The mini-plane over a staged buffer ``raw`` (uint8, on the
        device): panel fields are views of it, frames gathered from the
        resident tables by the staged grain indices."""
        fields, _ = self._layout(n)

        def view(name):
            if name not in fields:
                return None
            off, dt, shape = fields[name]
            nb = int(np.prod(shape)) * dt.itemsize
            return raw[off:off + nb].view(_torch_dtype(dt)).view(shape)

        slots = view("slots")
        fr = self.frames

        def frame(name):
            return fr[name][slots] if name in fr else None

        grains = GrainStore(
            coords=view("coords"), res=view("res"), sketch=view("sketch"),
            ids=view("ids"), valid=view("mask"),
            **{name: frame(name) for name in FRAME_FIELDS})
        dev = raw.device
        return StackedSegments(
            index=HNTLIndex(routing=RoutingPlane(centroids=grains.mu,
                                                 sizes=frame("sizes")),
                            grains=grains, raw=None),
            gid_of_row=torch.zeros(0, dtype=torch.int32, device=dev),
            row_offset=torch.zeros(1, dtype=torch.int32, device=dev))

    def hot_plane(self, mask_src, mask_key) -> StackedSegments:
        """The resident hot mini-plane (hot set + dummy grain), built once
        per hot epoch; its slot mask is rewritten in place when the
        search's mask (``mask_key``: liveness epoch and filters) changes."""
        n = self.n_hot + 1
        epoch, raw, plane = self._hot
        if epoch != self.hot_epochs:
            buf = np.empty(self._layout(n)[1], np.uint8)
            self._fill(self.hot_slots, mask_src, buf)
            raw = place(buf, self.device)
            plane = self._plane_from(raw, n)
            self._hot = (self.hot_epochs, raw, plane)
            self._hot_mask_key = mask_key
        elif self._hot_mask_key != mask_key:
            mask = np.zeros((n, self.cap), bool)
            np.take(mask_src, self.hot_slots, axis=0, out=mask[:-1],
                    mode="clip")
            plane.index.grains.valid.copy_(place(mask, self.device))
            self._hot_mask_key = mask_key
        return plane

    def chunk_plane(self, slots: np.ndarray, mask_src):
        """Stage one cold chunk.  Returns (plane, member_map [G] i32,
        release): call ``release()`` once the pass over the plane has been
        queued; the chunk's buffers are reused only after that pass."""
        sl = np.asarray(slots, np.int64)
        n = len(sl) + 1
        nbytes = self._layout(n)[1]
        if self.device.type == "cuda":
            stager = self._stagers.get(nbytes)
            if stager is None:
                stager = self._stagers[nbytes] = _Stager(nbytes, self.device)
            i, raw, staged = stager.stage(
                lambda host: self._fill(sl, mask_src, host))

            def release():
                stager.done(i)
        else:
            buf = np.empty(nbytes, np.uint8)
            staged = self._fill(sl, mask_src, buf)
            raw = torch.from_numpy(buf)

            def release():
                pass
        self.staged_bytes += staged
        self.chunk_dispatches += 1
        return self._plane_from(raw, n), self.slot_map(sl), release
