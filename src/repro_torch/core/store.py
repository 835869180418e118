"""The log-structured vector store (paper §1-§2): its read and mutation path.

Grains are self-contained, so the index maps onto immutable segments:

- **append**: new vectors go to a mutable memtable that is scanned
  exactly; ``seal()`` freezes it into an immutable HNTL segment, built on
  the store's device.  A sealed segment is never modified.
- **one search over all segments**: the sealed segments are padded to a
  common (G, cap) shape and stacked on the device into one
  ``StackedSegments`` plane (cached until the segment set changes), so a
  search over any number of segments is one ``planner.search_stacked``
  call (global routing over the concatenated routing plane, one candidate
  stage, one merged pool, one exact re-rank) plus the memtable scan.
- **mutations**: ``delete`` tombstones gids, ``upsert`` appends a new
  version that shadows every older one, and rows may carry a TTL.  None of
  them touches a segment: liveness is a host (gid, seq) table per
  manifest, placed on the device once per mutation epoch as the plane's
  ``live`` bitmap, so a delete shows in the next search without a
  re-stack.
- **snapshots and branches**: a ``Manifest`` freezes the segment refs, the
  memtable rows and the mutation table; ``branch`` forks a store that
  shares every sealed segment and copies the rest, so mutations on one
  side never reach the other.
- **mixed recall**: tag bitmasks and timestamps are checked in the scan
  and pushed down into routing (grains with no matching record are never
  probed), not filtered afterwards.
- **lifecycle**: ``compact`` merges size tiers of sealed segments into
  rebuilt ones, dropping dead and expired rows; ``maintain`` repairs the
  grains that deletes and upserts left unhealthy (``core.maintenance``),
  and ``grain_health`` reports the signals it acts on.  Both run on the
  store's device and replace the segment tuple once per call
  (copy-on-write: snapshots and branches keep their segments).
- **cold raw tier** (``cold_tier=True``): a sealed segment's raw vectors
  go to a memmap file in ``cold_dir`` (fsynced before the segment is
  visible) instead of the device; a Mode B re-rank gathers its pool's
  rows from the memmaps into a pinned host buffer, copies them over and
  re-ranks on the device with the warm tier's arithmetic, so a cold store
  returns a warm store's results bit for bit.  A cold file is refcounted
  by the segments that address it (a maintenance child shares its
  parent's) and unlinked when the last one dies.
- **tiered residency** (``device_budget=``): the stacked plane's grain
  panels go to one panel file and only a hot set of grains under the byte
  budget stays on the device (``core.residency``); probed cold grains are
  staged in chunks of ``prefetch_grains``, and the hot set is re-elected
  from the probe traffic every ``residency_interval`` searches.  Searches
  return the all-warm plane's ids and dists bit for bit.
- **the cascade** (``scan_impl="cascade"``, ``budgets=(b1, b2)``): on
  the stacked plane, the cold re-rank (which reads only the ``b2``
  survivors) and the tiered plane, where the budgets act per pass, as in
  the JAX package.
- **adaptive routing** (``search(adaptive=True)``): one routing pass
  applies the distance-gap stopping rule and the hub set, then the
  queries run in power-of-two probe-width buckets, so an easy query
  scans fewer grains; on the stacked plane, the cold tier and the tiered
  plane.  The probe-traffic counters it keeps elect the hubs and feed
  ``grain_health``, ``hub_grains`` and ``probe_stats``.
- **tenancy** (``serve.tenancy``): the fused dispatch takes a per-query
  visibility bitmap (``tenant_live`` [T, G, cap] + ``tenant_ix`` [Q]) over
  a registry's union of segments, on the stacked plane, the cold tier and
  the tiered plane, with the static, cascade and adaptive planes.

- **the sharded plane** (``search(mesh=...)``): ``shard_segments`` lays
  the stacked plane out shard-aligned (grain axis padded to the shard
  count, raw rows permuted so each shard owns its grains' rows), it is
  placed on a ``launch.mesh.SearchMesh`` once per segment set, and each
  shard runs the whole pipeline on its slice before one merge.

- **host<->device traffic**: every copy on the search path goes through
  ``analysis.sanitize``: host arrays reach the device with ``place``
  (pinned, non-blocking) and the few values the host must read (the
  adaptive plan, the paged plan, a cold re-rank's candidate rows, a
  plane's host tables when it is built) come back with ``fetch`` /
  ``fetch_async``, so every search plane runs inside
  ``sanitize.sync_guard()``.

The JAX package's ``repro.core.store`` is the reference.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import tempfile
import threading
import time
import uuid
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from . import index as index_mod
from . import maintenance, planner, residency, routing, scanplane
from ..analysis.sanitize import fetch, fetch_async, place
from .cascade import check_budgets
from .types import (BIG, GrainStore, HNTLConfig, HNTLIndex, RoutingPlane,
                    SearchResult, ShardedStackedSegments, StackedSegments)

#: Device bytes of the [queries, memtable rows, d] difference tensor of one
#: chunk of the memtable scan (a 1024-query batch against 5k rows at
#: d=768 would be 15 GB at once).
MEMTABLE_CHUNK_BYTES = 1 << 30

#: Planes kept by a store's LRU plane cache.  A warm store's stacked plane
#: pins a device copy of the stacked raw tier (~3 GB at N=1M, d=768), so
#: the cap is small.
STACK_CACHE_ENTRIES = 2


@dataclasses.dataclass(frozen=True)
class Segment:
    """An immutable sealed segment: an HNTL index on the store's device.

    Local row r has global id ``id_base + r``, or ``id_map[r]`` when the
    segment's gids are not one contiguous run (a memtable that held
    upserts).  Host arrays: tags [n] u32, ts [n] f32, id_map/seq [n] i64,
    expire [n] f64 absolute TTL deadlines (None = no TTL in the segment).
    A cold segment has ``index.raw`` None and its [n, d] f32 raw vectors
    in the memmap file ``cold_path``.
    """

    seg_id: int
    index: HNTLIndex
    n: int
    id_base: int
    tags: Optional[np.ndarray]
    ts: Optional[np.ndarray]
    id_map: Optional[np.ndarray] = None
    seq: Optional[np.ndarray] = None
    expire: Optional[np.ndarray] = None
    cold_path: Optional[str] = None
    d: int = 0

    def raw_vectors(self) -> np.ndarray:
        """The raw tier [n, d] f32 on the host: a read-only memmap of a
        cold segment's file, a copy of a warm segment's device tier."""
        if self.index.raw is not None:
            return self.index.raw.cpu().numpy()
        return np.memmap(self.cold_path, dtype=np.float32, mode="r",
                         shape=(self.n, self.d))

    def global_ids(self) -> np.ndarray:
        """Global id of every local row, in build order.  [n] i64."""
        if self.id_map is not None:
            return self.id_map
        return np.arange(self.id_base, self.id_base + self.n, dtype=np.int64)

    def global_seqs(self) -> np.ndarray:
        """Insert sequence of every local row (gid == seq for a segment
        sealed before any upsert)."""
        return self.seq if self.seq is not None else self.global_ids()

    def map_local(self, local_ids: torch.Tensor) -> torch.Tensor:
        """Local candidate ids -> global ids (-1 stays -1).  [Q, k] i64."""
        local = local_ids.long()
        if self.id_map is None:
            return torch.where(local >= 0, local + self.id_base, -1)
        id_map = torch.from_numpy(self.id_map).to(local.device)
        return torch.where(local >= 0, id_map[torch.clamp(local, min=0)], -1)


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Immutable snapshot of a store: segment refs plus a frozen view of
    the memtable rows and of the mutation table.

    ``mut_gid``/``mut_seq`` are the sorted liveness overrides: gid g's live
    version is mut_seq[i] where mut_gid[i] == g (-1 = deleted); a gid
    absent from the table is live at its only version.
    """

    segments: tuple                  # tuple[Segment, ...]
    mem_n: int                       # number of captured memtable rows
    mem: tuple = ()                  # tuple[np.ndarray]: captured rows
    mem_tags: tuple = ()             # tuple[int]
    mem_ts: tuple = ()               # tuple[float]
    mem_ids: tuple = ()              # tuple[int]: gid of each captured row
    mem_seq: tuple = ()              # tuple[int]: insert seq of each row
    mem_expire: tuple = ()           # tuple[float]: TTL deadline (inf=none)
    mut_gid: Optional[np.ndarray] = None  # [M] i64 sorted mutated gids
    mut_seq: Optional[np.ndarray] = None  # [M] i64 live seq (-1 = deleted)
    writer: str = ""                 # identity of the capturing store
    epoch: int = 0                   # mutation epoch at capture time
    maint_epoch: int = 0             # maintenance epoch at capture time


def _unlink_quiet(path: str) -> None:
    with contextlib.suppress(OSError):
        os.unlink(path)


# Cold files are refcounted per Segment object that addresses them: a
# maintenance epoch derives a Segment that shares its parent's cold file,
# so the file must outlive whichever of the two dies last.  Finalizers run
# on whatever thread triggers a collection, so every change goes through
# _COLD_LOCK, an RLock: a finalizer can fire inside a locked region on the
# same thread.  The port keeps its own lock and counter: a file of the JAX
# package is never adopted here (interop copies the rows instead).
_COLD_LOCK = threading.RLock()
_COLD_REFS: collections.Counter = collections.Counter()


def _release_cold(path: str) -> None:
    with _COLD_LOCK:
        _COLD_REFS[path] -= 1
        reclaim = _COLD_REFS[path] <= 0
        if reclaim:
            del _COLD_REFS[path]
    if reclaim:
        _unlink_quiet(path)


def _reclaim_cold_on_gc(seg, path: str) -> None:
    """Unlink a cold file when the last Segment addressing it dies.

    Snapshots, branches and the plane cache hold the same Segment object,
    so tying the file's life to the objects' is the copy-on-write
    contract: a compacted-away segment's file lives as long as a manifest
    can search it.  The count and the finalizer are taken in one locked
    step; if the finalizer cannot be registered the count is rolled back.
    (POSIX: a memmap still open keeps reading after the unlink.)
    """
    with _COLD_LOCK:
        _COLD_REFS[path] += 1
        try:
            weakref.finalize(seg, _release_cold, path)
        except BaseException:
            _COLD_REFS[path] -= 1
            raise


@contextlib.contextmanager
def _cold_construction(path: Optional[str]):
    """The window between writing a cold file and handing it to a
    Segment's finalizer.  The body calls ``adopt(seg)`` once the Segment
    exists; an exception before that unlinks the file, unless a live
    Segment already pins it (a maintenance child failing must not take
    its parent's file).  ``path=None`` (warm tier) passes through."""
    if path is None:
        yield lambda seg: None
        return
    adopted = []

    def adopt(seg) -> None:
        _reclaim_cold_on_gc(seg, path)
        adopted.append(True)

    try:
        yield adopt
    except BaseException:
        if not adopted:
            with _COLD_LOCK:
                orphan = _COLD_REFS[path] <= 0
                if orphan:
                    _COLD_REFS.pop(path, None)
            if orphan:
                _unlink_quiet(path)
        raise


def _write_cold_file(path: str, x: np.ndarray) -> str:
    """Write raw rows [n, d] f32 to a memmap file and fsync it: a manifest
    may reference the file the moment this returns, so its bytes must be
    on stable storage first, not only in the page cache."""
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=x.shape)
    mm[:] = x
    mm.flush()
    del mm
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    return path


class _RawRows:
    """The raw tier of a segment tuple read by flat row, as the ``raw`` of
    ``planner._candidate_epilogue``: warm segments gathered on their
    device, cold ones from their memmaps into a pinned host buffer (one
    block per segment) and copied over in one go.  ``stats`` (the
    store's) counts the cold reads: calls, rows, bytes, host seconds, and
    the copies' CUDA event pairs."""

    def __init__(self, segments: Sequence[Segment], device: torch.device,
                 stats: dict):
        self.device = device
        self.offsets = np.cumsum([0] + [s.n for s in segments])
        self.offsets_dev = place(self.offsets, device)
        self.warm = [(si, s.index.raw) for si, s in enumerate(segments)
                     if s.index.raw is not None]
        self.cold = [(si, s.raw_vectors()) for si, s in enumerate(segments)
                     if s.index.raw is None]
        self.d = int(segments[0].index.grains.mu.shape[1])
        self.stats = stats

    def __call__(self, rows: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        shape, dev = tuple(rows.shape), self.device
        flat, okf = rows.reshape(-1), ok.reshape(-1)
        n = flat.numel()
        # one spare row at the end takes the writes of the slots a warm
        # segment does not own: fixed shapes, no read of the data's counts
        out = torch.zeros((n + 1, self.d), device=dev)
        seg = torch.searchsorted(self.offsets_dev, flat, right=True) - 1
        for si, x in self.warm:
            hit = torch.logical_and(seg == si, okf)
            at = torch.clamp(flat - int(self.offsets[si]), 0, x.shape[0] - 1)
            dst = torch.where(hit, torch.arange(n, device=dev), n)
            out.index_copy_(0, dst, x[at])
        if self.cold:
            t0 = time.perf_counter()
            flat_h, ok_h, seg_h = (t.numpy() for t in fetch(flat, okf, seg))
            cold_si = np.array([si for si, _ in self.cold])
            sel = np.flatnonzero(ok_h & np.isin(seg_h, cold_si))
            sel = sel[np.argsort(seg_h[sel], kind="stable")]
            buf = torch.empty((len(sel), self.d), dtype=torch.float32,
                              pin_memory=dev.type == "cuda")
            host = buf.numpy()
            bounds = np.searchsorted(seg_h[sel], cold_si)
            ends = np.searchsorted(seg_h[sel], cold_si, side="right")
            for (si, mm), lo, hi in zip(self.cold, bounds, ends):
                np.take(mm, flat_h[sel[lo:hi]] - self.offsets[si], axis=0,
                        out=host[lo:hi], mode="clip")
            self.stats["host_s"] += time.perf_counter() - t0
            if dev.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                got = buf.to(dev, non_blocking=True)
                ev[1].record()
                self.stats["h2d"].append(ev)
            else:
                got = buf
            out.index_copy_(0, place(sel, dev), got)
            self.stats["calls"] += 1
            self.stats["rows"] += len(sel)
            self.stats["bytes"] += buf.numel() * 4
        return out[:n].reshape(shape + (self.d,))


def _new_rerank_stats() -> dict:
    return {"calls": 0, "rows": 0, "bytes": 0, "host_s": 0.0, "h2d": []}


def _rerank_pool(dists, rows, q, raw, *, pool: int, topk: int,
                 translate) -> SearchResult:
    """The Mode B tail on a candidate pool made elsewhere (a cold store's
    Mode A pool, the tiered plane's merged pool): the all-warm plane's
    ``planner._candidate_epilogue`` over the same ``QUERY_BATCH``
    batches, so a re-rank here equals the all-warm plane's bit for bit.
    ``raw``: the raw tier or a ``_RawRows``.  With a cold ``_RawRows``
    this is the cold Mode B re-rank (the JAX package's ``_cold_rerank``,
    which re-ranks on the host in numpy)."""
    return planner._in_batches(
        lambda sl: planner._candidate_epilogue(
            dists[sl], rows[sl], q[sl], raw, pool=pool, topk=topk, mode="B",
            translate=translate), q.shape[0], topk, q.device)


def _finalize(ids: torch.Tensor, d: torch.Tensor, topk: int) -> SearchResult:
    """Merge candidate pools into a [Q, topk] result on their device.

    A stable sort by distance: a tie keeps the pools' order (sealed plane
    first, then the memtable).  Slots at the pruned sentinel (filtered,
    padding, fewer candidates than topk) come back as id -1.
    """
    d, order = torch.sort(d, dim=1, stable=True)
    d = d[:, :topk]
    ids = torch.gather(ids, 1, order[:, :topk])
    ids = torch.where(d < BIG / 2, ids, -1)
    pad = topk - ids.shape[1]
    if pad > 0:
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        d = torch.nn.functional.pad(d, (0, pad), value=BIG)
    return SearchResult(ids=ids.to(torch.int32), dists=d)


def _width_buckets(n_active: np.ndarray, nprobe: int) -> list:
    """Adaptive routing's query buckets: [(w, query indices)] by
    power-of-two probe width w >= n_active[q] (capped at ``nprobe``),
    narrowest first."""
    w = np.ones_like(n_active)
    while bool((w < n_active).any()):
        w = np.where(w < n_active, w * 2, w)
    w = np.minimum(w, nprobe)
    return [(int(v), np.flatnonzero(w == v)) for v in np.unique(w)]


def _bucketed(buckets: list, q_n: int, topk: int, dev, run):
    """(ids [Q, topk] i32, dists [Q, topk] f32) from ``run(w,
    queries on dev) -> SearchResult`` over each width bucket, (-1, BIG)
    past a bucket's results."""
    out_ids = torch.full((q_n, topk), -1, dtype=torch.int32, device=dev)
    out_d = torch.full((q_n, topk), BIG, device=dev)
    for w, sel in buckets:
        sel_d = _to_device(sel, dev)
        res = run(w, sel_d)
        k = res.ids.shape[1]
        out_ids[sel_d, :k] = res.ids
        out_d[sel_d, :k] = res.dists
    return out_ids, out_d


def _live_rows(mut_gid: Optional[np.ndarray], mut_seq: Optional[np.ndarray],
               gids: np.ndarray, seqs: np.ndarray) -> Optional[np.ndarray]:
    """Tombstone/shadow verdict for physical rows.  None = all live.

    A row (gid g, seq s) is dead iff g is in the mutation table with a
    live seq != s: deleted (-1) or shadowed by a later upsert.
    """
    if mut_gid is None or len(mut_gid) == 0 or len(gids) == 0:
        return None
    pos = np.minimum(np.searchsorted(mut_gid, gids), len(mut_gid) - 1)
    dead = (mut_gid[pos] == gids) & (mut_seq[pos] != seqs)
    if not dead.any():
        return None
    return ~dead


def _concat_expiry(segments: Sequence[Segment]) -> Optional[np.ndarray]:
    """Per-row TTL deadlines across segments, or None when no segment
    carries any."""
    if all(s.expire is None for s in segments):
        return None
    return np.concatenate(
        [s.expire if s.expire is not None else np.full(s.n, np.inf)
         for s in segments])


def _fuse(leaves: list, fill, gmax: int) -> torch.Tensor:
    """[S*gmax, ...] stack of per-segment [g, ...] leaves on their device,
    each padded with ``fill`` to the largest shape."""
    ref = leaves[0]
    rest = [max(a.shape[i] for a in leaves) for i in range(1, ref.dim())]
    out = ref.new_full((len(leaves) * gmax, *rest), fill)
    for si, a in enumerate(leaves):
        out[(slice(si * gmax, si * gmax + a.shape[0]),)
            + tuple(slice(0, n) for n in a.shape[1:])] = a
    return out


def _move(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev`` through the sanctioned copies: ``fetch`` from a
    card to the host, ``place`` otherwise."""
    if dev.type == "cpu" and t.device.type != "cpu":
        return fetch(t)
    return place(t, dev)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``place`` for the search's own per-call host arrays (tenant, hub,
    plan and row-selection arrays), under one name so that a profile can
    time these copies apart from the memtable's and the planes'."""
    return place(a, dev)


def _on(grains: GrainStore, dev: torch.device) -> GrainStore:
    return GrainStore(**{f.name: None if getattr(grains, f.name) is None
                         else _move(getattr(grains, f.name), dev)
                         for f in dataclasses.fields(GrainStore)})


def stack_segments(segments: Sequence[Segment], *, device=None,
                   keep_raw: bool = True) -> StackedSegments:
    """Fuse sealed segments into one ``StackedSegments`` plane.

    Every GrainStore leaf is padded to the common (G_max, cap_max) shape
    and stacked on a leading segment axis fused with the grain axis.
    Padding: scale/res_scale/sketch_scale 1 (no divide by zero in the
    envelope filter), sizes 0 (never routed), valid False, ids -1, tags and
    ts 0, and qmaxg 1 on padding grains (``int32_safe_qmax(k)`` over a
    fixed-width segment in a stack with mixed precision).  Grain ids
    become flat rows of the concatenated raw tier; ``gid_of_row``
    translates them back to global ids.

    device: where the plane is built (default: the segments' device);
    ``"cpu"`` is the host stack the tiered plane writes its panel file
    from.  keep_raw=False leaves the raw tier out (``index.raw`` None),
    as it is when any segment is cold.
    """
    segs = list(segments)
    if not segs:
        raise ValueError("cannot stack an empty segment list")
    dev = torch.device(device) if device is not None \
        else segs[0].index.device
    grains = [_on(s.index.grains, dev) for s in segs]
    g0 = grains[0]
    gmax = max(g.n_grains for g in grains)
    has_sketch = g0.sketch is not None
    if any((g.sketch is not None) != has_sketch for g in grains):
        raise ValueError("segments disagree on sketch presence (mixed cfg.s)")
    any_qmax = any(g.qmaxg is not None for g in grains)
    qeff_fb = index_mod.int32_safe_qmax(g0.k)
    offsets = np.zeros(len(segs) + 1, np.int64)
    np.cumsum([s.n for s in segs], out=offsets[1:])

    def fuse(name, fill):
        return _fuse([getattr(g, name) for g in grains], fill, gmax)

    def flat_rows(g, off):
        return torch.where(g.ids >= 0, g.ids + int(off), -1).to(torch.int32)

    def or_full(g, name, dtype, value=0):
        """A segment's optional leaf, or its stand-in filled with value."""
        v = getattr(g, name)
        shape = (g.n_grains,) if name == "qmaxg" else tuple(g.ids.shape)
        return v if v is not None else torch.full(shape, value, dtype=dtype,
                                                  device=dev)

    fused = dict(
        coords=fuse("coords", 0), res=fuse("res", 0),
        ids=_fuse([flat_rows(g, o) for g, o in zip(grains, offsets)], -1,
                  gmax),
        valid=fuse("valid", False), basis=fuse("basis", 0.0),
        mu=fuse("mu", 0.0), scale=fuse("scale", 1.0),
        res_scale=fuse("res_scale", 1.0),
        tags=_fuse([or_full(g, "tags", torch.int64) for g in grains], 0,
                   gmax),
        ts=_fuse([or_full(g, "ts", torch.float32) for g in grains], 0.0,
                 gmax),
        sketch=fuse("sketch", 0) if has_sketch else None,
        sketch_basis=fuse("sketch_basis", 0.0) if has_sketch else None,
        sketch_scale=fuse("sketch_scale", 1.0) if has_sketch else None,
        qmaxg=_fuse([or_full(g, "qmaxg", torch.int32, qeff_fb)
                     for g in grains], 1, gmax) if any_qmax else None)
    g_st = GrainStore(**fused)
    sizes = _fuse([_move(s.index.routing.sizes, dev) for s in segs], 0,
                  gmax)
    warm = keep_raw and all(s.index.raw is not None for s in segs)
    index = HNTLIndex(
        routing=RoutingPlane(centroids=g_st.mu, sizes=sizes),
        grains=g_st,
        raw=torch.cat([_move(s.index.raw, dev) for s in segs]) if warm
        else None)
    gid_of_row = np.concatenate([s.global_ids() for s in segs])
    return StackedSegments(
        index=index,
        gid_of_row=place(gid_of_row.astype(np.int32), dev),
        row_offset=place(offsets.astype(np.int32), dev))


def shard_segments(segments: Sequence[Segment], n_shards: int, *,
                   device="cpu"):
    """Re-lay-out the stacked plane for an ``n_shards``-way mesh.

    Builds on :func:`stack_segments` (on ``device``: ``"cpu"`` for the
    host layout, the store's device for the store's own planes), then
    makes the layout shard-aligned:

    - the fused grain axis is padded to a multiple of ``n_shards`` with
      dead grains (sizes 0, valid False) and split into contiguous chunks,
      one per shard;
    - the raw tier is permuted grain-wise: shard s's slice holds exactly
      the member rows of the grains in its chunk, in scan order, padded to
      a common per-shard row count; grain ``ids`` become rows local to the
      owning shard's slice, so a shard's Mode B re-rank never reads
      another shard's raw tier;
    - ``gid_of_row`` is permuted the same way (-1 on padding rows).

    The permutation is computed on the host from the id panels; the
    permuted raw tier and id table are gathered on ``device``.  Returns
    ``(plane, perm)``: the ``ShardedStackedSegments`` and the host
    ``perm [n_shards * rows_per_shard] i64`` table mapping a permuted row
    back to its flat row (-1 on padding rows), which the cold tier's
    re-rank reads.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    stacked = stack_segments(segments, device=device)
    g = stacked.index.grains
    dev = g.coords.device
    sg = g.n_grains
    g_pad = -(-sg // n_shards) * n_shards - sg
    g_local = (sg + g_pad) // n_shards

    def padg(t, fill):
        if t is None or not g_pad:
            return t
        return torch.cat([t, t.new_full((g_pad,) + tuple(t.shape[1:]),
                                        fill)])

    ids, valid = (t.numpy() for t in fetch(padg(g.ids, -1),  # flat rows
                                           padg(g.valid, False)))
    owned = [ids[s * g_local:(s + 1) * g_local][
        valid[s * g_local:(s + 1) * g_local]].astype(np.int64)
        for s in range(n_shards)]                   # rows per shard
    rows_per_shard = max(1, max(len(r) for r in owned))
    perm = np.full(n_shards * rows_per_shard, -1, np.int64)
    new_ids = np.full_like(ids, -1)
    lut = np.full(stacked.gid_of_row.shape[0], -1, np.int64)
    for s, rows in enumerate(owned):
        perm[s * rows_per_shard:s * rows_per_shard + len(rows)] = rows
        lut[:] = -1
        lut[rows] = np.arange(len(rows))
        ch = ids[s * g_local:(s + 1) * g_local]
        new_ids[s * g_local:(s + 1) * g_local] = np.where(
            ch >= 0, lut[np.maximum(ch, 0)], -1).astype(np.int32)
    keep = place(np.maximum(perm, 0), dev)
    is_row = place(perm >= 0, dev)
    gid_perm = torch.where(is_row, stacked.gid_of_row[keep], -1).to(
        torch.int32)
    mu = padg(g.mu, 0.0)
    grains = GrainStore(
        coords=padg(g.coords, 0), res=padg(g.res, 0),
        sketch=padg(g.sketch, 0), ids=place(new_ids, dev),
        valid=place(valid, dev), basis=padg(g.basis, 0.0),
        mu=mu, scale=padg(g.scale, 1.0), res_scale=padg(g.res_scale, 1.0),
        sketch_basis=padg(g.sketch_basis, 0.0),
        sketch_scale=padg(g.sketch_scale, 1.0),
        tags=padg(g.tags, 0), ts=padg(g.ts, 0.0), qmaxg=padg(g.qmaxg, 1))
    raw = stacked.index.raw
    index = HNTLIndex(
        routing=RoutingPlane(centroids=mu,
                             sizes=padg(stacked.index.routing.sizes, 0)),
        grains=grains, raw=raw[keep] if raw is not None else None)
    return ShardedStackedSegments(index=index, gid_of_row=gid_perm), perm


class VectorStore:
    """Log-structured vector memory with HNTL-indexed sealed segments.

    ``device=None`` puts the segments and every search on the card (and
    raises without one); ``device="cpu"`` runs the plain PyTorch path.

    cold_tier: keep sealed segments' raw vectors in memmap files in
      ``cold_dir`` (default: a new temporary directory) instead of on the
      device.
    device_budget: device bytes for resident grain panels (None: the
      all-warm stacked plane); ``residency_interval`` searches between hot
      set elections; ``prefetch_grains`` grains per staged cold chunk
      (rounded up to a power of two).
    """

    def __init__(self, cfg: HNTLConfig, *, seal_threshold: int = 8192,
                 clock=time.time, device=None,
                 cold_tier: bool = False, cold_dir: Optional[str] = None,
                 device_budget: Optional[int] = None,
                 residency_interval: int = 64, prefetch_grains: int = 64):
        if device_budget is not None and device_budget < 0:
            raise ValueError("device_budget must be >= 0 bytes")
        if residency_interval < 1:
            raise ValueError("residency_interval must be >= 1")
        if prefetch_grains < 1:
            raise ValueError("prefetch_grains must be >= 1")
        self.cfg = cfg
        self.seal_threshold = seal_threshold
        self.device = index_mod.resolve_device(device)
        self.cold_tier = cold_tier
        self._cold_dir = cold_dir
        if cold_tier or device_budget is not None:
            self._cold_dir = self.cold_dir          # made now, not mid-seal
        self.device_budget = device_budget
        self.residency_interval = int(residency_interval)
        self.prefetch_grains = residency.pow2ceil(prefetch_grains)
        self._segments: list[Segment] = []
        self._mem: list[np.ndarray] = []
        self._mem_tags: list[int] = []
        self._mem_ts: list[float] = []
        self._mem_ids: list[int] = []           # gid per memtable row
        self._mem_seq: list[int] = []           # insert seq per memtable row
        self._mem_expire: list[float] = []      # TTL deadline (inf = none)
        self._next_id = 0
        self._next_seq = 0
        self._next_seg = 0
        self._clock = clock
        # Mutation table: gid -> live insert seq (-1 = deleted).  The epoch
        # counts mutations; the per-plane liveness bitmaps are keyed on
        # (writer, epoch), so a delete invalidates them without a re-stack.
        self._live_seq: dict = {}
        self._epoch = 0
        self._mut_cache = (-1, None, None)      # (epoch, mut_gid, mut_seq)
        self._maint_epoch = 0                   # maintenance epochs applied
        # the writer's identity: the manifests' ``writer`` and the suffix of
        # its cold and panel files (branches share cold_dir and seg ids)
        self._cold_tag = uuid.uuid4().hex[:8]
        # LRU of planes keyed by kind ("stacked" or "tiered") and the
        # segments' identities; every scan plane reads the same leaves.
        # Entries keep their segment tuple alive so the id()-keys cannot be
        # reused.
        self._stack_cache: collections.OrderedDict = \
            collections.OrderedDict()
        # Adaptive routing's probe traffic per segment set (same keys and
        # pinning as the plane LRU): routing-win and active-probe counters
        # over the stacked grain axis, which elect the hub set and feed
        # grain_health; only adaptive searches add to them.
        self._probe_traffic: collections.OrderedDict = \
            collections.OrderedDict()
        self._rerank_stats = _new_rerank_stats()

    @property
    def cold_dir(self) -> str:
        """Directory of the cold raw files and panel files (made on first
        use when not given)."""
        if self._cold_dir is None:
            self._cold_dir = tempfile.mkdtemp(prefix="aperon_cold_")
        return self._cold_dir

    # ------------------------------------------------------------ write path
    def _expiry_of(self, ttl, n: int) -> list:
        """Absolute TTL deadlines for n new rows (inf = never expires)."""
        if ttl is None:
            return [np.inf] * n
        now = self._clock()
        ttls = np.broadcast_to(np.asarray(ttl, np.float64), (n,))
        return [now + float(t) for t in ttls]

    def _append_rows(self, vecs, ids, tags, ts, ttl) -> None:
        n = vecs.shape[0]
        self._mem.extend(list(vecs))
        self._mem_tags.extend(list(tags) if tags is not None else [0] * n)
        self._mem_ts.extend(list(ts) if ts is not None else [0.0] * n)
        self._mem_ids.extend(int(i) for i in ids)
        self._mem_seq.extend(range(self._next_seq, self._next_seq + n))
        self._next_seq += n
        self._mem_expire.extend(self._expiry_of(ttl, n))
        if len(self._mem) >= self.seal_threshold:
            self.seal()

    def add(self, vecs, tags: Optional[Sequence[int]] = None,
            ts: Optional[Sequence[float]] = None, ttl=None) -> np.ndarray:
        """Append vectors; returns their global ids.

        ttl: optional per-record (scalar or [n]) time to live in seconds;
        an expired record vanishes from every search.
        """
        vecs = np.asarray(vecs, np.float32)
        n = vecs.shape[0]
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        self._append_rows(vecs, ids, tags, ts, ttl)
        return ids

    def delete(self, ids) -> int:
        """Tombstone records by global id.  No segment is touched and no
        plane re-stacked: the next search masks the rows in the scan.
        Returns the number newly tombstoned (dead ids are no-ops, and gids
        never assigned are ignored: a tombstone there would kill the
        future insert that gets the gid)."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        newly = 0
        for g in ids.tolist():
            if not 0 <= g < self._next_id:
                continue
            if self._live_seq.get(g) != -1:
                newly += 1
            self._live_seq[g] = -1
        if newly:
            self._epoch += 1
        return newly

    def upsert(self, ids, vecs, tags: Optional[Sequence[int]] = None,
               ts: Optional[Sequence[float]] = None, ttl=None) -> np.ndarray:
        """Write new versions of records under their global ids.

        The new version goes to the memtable under the same gid with a
        fresh insert seq, and the mutation table makes every older row of
        that gid dead.  Ids never seen before act as plain inserts.
        """
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        vecs = np.asarray(vecs, np.float32)
        if ids.shape[0] != vecs.shape[0]:
            raise ValueError(f"upsert: {ids.shape[0]} ids for "
                             f"{vecs.shape[0]} vectors")
        if (ids < 0).any():
            raise ValueError("upsert needs non-negative gids")
        new_seq = range(self._next_seq, self._next_seq + len(ids))
        for g, s in zip(ids.tolist(), new_seq):
            self._live_seq[g] = s
        self._next_id = max(self._next_id, int(ids.max()) + 1)
        self._epoch += 1
        self._append_rows(vecs, ids, tags, ts, ttl)
        return ids

    def _grain_count(self, n: int) -> int:
        """Grains for a segment of n rows: the configured G per
        seal_threshold rows, at least one block per grain."""
        scale = max(1, -(-n // max(self.seal_threshold, 1)))
        return max(1, min(self.cfg.n_grains * scale,
                          n // max(self.cfg.block, 32)))

    def _write_cold(self, x: np.ndarray, seg_id: int) -> str:
        # the writer's tag keeps writers apart: branches share cold_dir and
        # the segment counter, so seg_id alone would let them collide
        return _write_cold_file(os.path.join(
            self.cold_dir, f"seg{seg_id:06d}_{self._cold_tag}.raw"), x)

    def seal(self) -> Optional[Segment]:
        """Freeze the memtable into an immutable HNTL segment, built on the
        store's device (its raw tier written to a cold file first when the
        store is cold)."""
        if not self._mem:
            return None
        x = np.stack(self._mem)
        tags = np.asarray(self._mem_tags, np.uint32)
        ts = np.asarray(self._mem_ts, np.float32)
        gids = np.asarray(self._mem_ids, np.int64)
        seqs = np.asarray(self._mem_seq, np.int64)
        expire = np.asarray(self._mem_expire, np.float64)
        n = x.shape[0]
        cfg = dataclasses.replace(self.cfg, n_grains=self._grain_count(n))
        idx, _ = index_mod.build(x, cfg, tags=tags, ts=ts,
                                 keep_raw=not self.cold_tier,
                                 device=self.device)
        cold_path = (self._write_cold(x, self._next_seg)
                     if self.cold_tier else None)
        # a pure-add memtable holds one contiguous gid run; upserts
        # interleave re-used gids, which need the id_map
        contiguous = bool(np.array_equal(gids,
                                         np.arange(gids[0], gids[0] + n)))
        with _cold_construction(cold_path) as adopt:
            seg = Segment(
                seg_id=self._next_seg, index=idx, n=n,
                id_base=int(gids[0]) if contiguous else 0, tags=tags, ts=ts,
                id_map=None if contiguous else gids, seq=seqs,
                expire=expire if np.isfinite(expire).any() else None,
                cold_path=cold_path, d=x.shape[1])
            adopt(seg)
        self._segments.append(seg)
        self._next_seg += 1
        self._mem, self._mem_tags, self._mem_ts = [], [], []
        self._mem_ids, self._mem_seq, self._mem_expire = [], [], []
        return seg

    # ----------------------------------------------------- grain maintenance
    def _seg_live_rows(self, seg: Segment, mg, ms,
                       now: float) -> Optional[np.ndarray]:
        """[n] bool per raw row of one segment: the tombstone, shadow and
        TTL verdict (None = all live), which every health signal reads."""
        live = _live_rows(mg, ms, seg.global_ids(), seg.global_seqs())
        if seg.expire is not None:
            alive_t = seg.expire > now
            if not alive_t.all():
                live = alive_t if live is None else live & alive_t
        return live

    def grain_health(self, *, now: Optional[float] = None) -> list:
        """Per-grain health of every sealed segment (read-only).

        One dict per segment of host arrays: ``live_cnt`` [G], ``captured``
        [G] (the existing frame over the live rows), ``best`` [G] (the refit
        bound), ``drift2`` [G] (squared centroid walk-off) and ``var_live``
        [G], the signals ``maintain()`` acts on, computed on the device;
        and ``route_wins`` [G] (queries whose closest grain this was) and
        ``touches`` [G] (active probes on it), adaptive routing's
        probe-traffic counters for the live segment set: zeros until an
        ``adaptive=True`` search has run against it.
        """
        now = self._clock() if now is None else now
        mg, ms = self._mut_arrays()
        traffic = self._probe_traffic.get(
            tuple(id(s) for s in self._segments))
        s_n = max(len(self._segments), 1)
        gmax = traffic["wins"].shape[0] // s_n if traffic else 0
        out = []
        for si, seg in enumerate(self._segments):
            stats = maintenance.grain_stats(
                seg, self._seg_live_rows(seg, mg, ms, now))
            g_seg = stats["live_cnt"].shape[0]
            if traffic is not None and g_seg <= gmax:
                lo = si * gmax
                wins = traffic["wins"][lo:lo + g_seg].copy()
                touch = traffic["touches"][lo:lo + g_seg].copy()
            else:
                wins = np.zeros(g_seg, np.int64)
                touch = np.zeros(g_seg, np.int64)
            out.append({k: stats[k] for k in
                        ("live_cnt", "captured", "best", "drift2",
                         "var_live")}
                       | {"seg_id": seg.seg_id, "route_wins": wins,
                          "touches": touch})
        return out

    # ------------------------------------------------- adaptive probe traffic
    def _traffic_for(self, segments: tuple, g_total: int) -> dict:
        """The probe-traffic counters of one segment set (zeroed on first
        use).  The entry pins the segment tuple, so its id()-key cannot be
        reused, as the plane cache's entries do; the LRU keeps
        max(4, ``STACK_CACHE_ENTRIES``) of them."""
        key = tuple(id(s) for s in segments)
        hit = self._probe_traffic.get(key)
        if hit is None or hit["wins"].shape[0] != g_total:
            hit = {"segments": tuple(segments),
                   "wins": np.zeros(g_total, np.int64),
                   "touches": np.zeros(g_total, np.int64),
                   "queries": 0, "active_probes": 0}
            self._probe_traffic[key] = hit
            while len(self._probe_traffic) > max(4, STACK_CACHE_ENTRIES):
                self._probe_traffic.popitem(last=False)
        else:
            self._probe_traffic.move_to_end(key)
        return hit

    def _purge_probe_traffic(self) -> None:
        """Drop the traffic entries that pin a segment no longer in the
        store (after ``compact()``/``maintain()`` replaced it), or the
        replaced segment, and through ``_COLD_REFS`` its cold file, would
        live until the LRU happened to evict the entry.  Entries of
        snapshots and branches whose segments are all still live stay."""
        live = {id(s) for s in self._segments}
        for key in [k for k, hit in self._probe_traffic.items()
                    if any(id(s) not in live for s in hit["segments"])]:
            del self._probe_traffic[key]

    def _hub_mask_host(self, traffic: dict) -> Optional[np.ndarray]:
        """The hub set as a [G] bool mask over the stacked grain axis (None
        before any traffic): the ``cfg.hub_size`` grains with the most
        routing wins (ties to the lower grain), which every adaptive query
        probes."""
        wins = traffic["wins"]
        if self.cfg.hub_size <= 0 or wins.max(initial=0) <= 0:
            return None
        top = np.argsort(wins, kind="stable")[::-1][:self.cfg.hub_size]
        mask = np.zeros(wins.shape[0], bool)
        mask[top[wins[top] > 0]] = True
        return mask

    def hub_grains(self) -> np.ndarray:
        """Stacked-plane grain indices of the current hub set (sorted;
        empty until adaptive traffic exists for the live segment set)."""
        hit = self._probe_traffic.get(tuple(id(s) for s in self._segments))
        mask = self._hub_mask_host(hit) if hit is not None else None
        if mask is None:
            return np.zeros(0, np.int64)
        return np.nonzero(mask)[0].astype(np.int64)

    def probe_stats(self) -> dict:
        """Adaptive routing's traffic for the live segment set: adaptive
        ``queries``, their ``active_probes`` and ``mean_active`` probes per
        query (0.0 before any traffic)."""
        hit = self._probe_traffic.get(tuple(id(s) for s in self._segments))
        if hit is None or hit["queries"] == 0:
            return {"queries": 0, "active_probes": 0, "mean_active": 0.0}
        return {"queries": hit["queries"],
                "active_probes": hit["active_probes"],
                "mean_active": hit["active_probes"] / hit["queries"]}

    def maintain(self, *, now: Optional[float] = None,
                 policy: Optional[maintenance.MaintenancePolicy] = None
                 ) -> maintenance.MaintenanceReport:
        """Grain maintenance over all sealed segments, on the store's
        device.

        Finds unhealthy grains (overfull, underfull, stale; see
        ``core.maintenance``) from the live set and repairs them: overfull
        grains split by 2-means, underfull grains merge into their nearest
        neighbour with room (all-dead grains retire, all-dead segments are
        dropped), and every touched group is re-fit on its live rows.

        Copy-on-write: raw tiers and id tables are shared with the old
        segments, untouched grains are copied bit-identical, healthy
        segments keep their identity, snapshots and branches keep their
        segments, and one new segment tuple comes out per epoch, so the
        plane cache re-stacks at most once.  ``compact()`` runs it by
        default.
        """
        now = self._clock() if now is None else now
        policy = policy if policy is not None \
            else maintenance.MaintenancePolicy()
        mg, ms = self._mut_arrays()
        qeff = index_mod.int32_safe_qmax(self.cfg.k, self.cfg.coord_bits)
        reports, new_segs, changed = [], [], False
        for seg in self._segments:
            new_seg, rep = maintenance.maintain_segment(
                seg, self._seg_live_rows(seg, mg, ms, now), self.cfg,
                policy, qeff)
            reports.append(rep)
            changed |= new_seg is not seg
            if new_seg is None:            # every row dead: dropped
                continue
            if new_seg is not seg and new_seg.cold_path is not None:
                # the repaired child shares its parent's cold file
                _reclaim_cold_on_gc(new_seg, new_seg.cold_path)
            new_segs.append(new_seg)
        if changed:
            self._segments = new_segs
            self._maint_epoch += 1
            self._purge_tombstones()
            self._purge_probe_traffic()
        return maintenance.MaintenanceReport(segments=tuple(reports))

    # ------------------------------------------------------------ compaction
    def compact(self, *, fanin: int = 4, tier_factor: int = 4,
                max_rounds: int = 16, now: Optional[float] = None,
                maintain: bool = True,
                policy: Optional[maintenance.MaintenancePolicy]
                = None) -> int:
        """Size-tiered compaction of the sealed segments, on the store's
        device.

        Segments fall into size tiers (tier t holds segments of roughly
        seal_threshold * tier_factor^t rows).  Whenever a tier holds
        ``fanin`` segments, its ``fanin`` oldest are merged into one
        rebuilt segment: raw rows concatenated on the device, grains
        re-partitioned at the merged scale, global ids kept in ``id_map``.
        Rounds repeat until no tier is full (a merge can cascade upward).

        Compaction reclaims mutations: tombstoned rows, upsert-shadowed
        versions and rows whose TTL passed (as of ``now``, default the
        store clock) are dropped from the merged segment, and tombstones
        whose gid no longer exists in this store are purged afterwards.
        Older snapshots and branches keep the pre-merge segments and their
        own liveness tables.

        Unless ``maintain=False``, a ``maintain()`` pass follows: merged
        segments are healthy by construction, so it repairs the segments
        compaction did not touch.  Returns the number of merges.
        """
        if fanin < 2:
            raise ValueError(f"fanin must be >= 2, got {fanin}")
        if tier_factor < 2:
            raise ValueError(f"tier_factor must be >= 2, got {tier_factor}")
        now = self._clock() if now is None else now
        merges = 0
        for _ in range(max_rounds):
            if not self._compact_once(fanin, tier_factor, now):
                break
            merges += 1
        if merges:
            self._purge_tombstones()
        if maintain:
            self.maintain(now=now, policy=policy)
        return merges

    def _tier_of(self, n: int, tier_factor: int) -> int:
        t, size = 0, max(self.seal_threshold, 1)
        while n >= size * tier_factor:
            size *= tier_factor
            t += 1
        return t

    def _compact_once(self, fanin: int, tier_factor: int, now: float) -> bool:
        tiers: dict[int, list[Segment]] = collections.defaultdict(list)
        for seg in self._segments:
            tiers[self._tier_of(seg.n, tier_factor)].append(seg)
        for t in sorted(tiers):
            if len(tiers[t]) < fanin:
                continue
            group = sorted(tiers[t], key=lambda s: s.seg_id)[:fanin]
            merged = self._merge_segments(group, now)
            gone = {id(s) for s in group}
            pos = min(i for i, s in enumerate(self._segments)
                      if id(s) in gone)
            kept = [s for s in self._segments if id(s) not in gone]
            if merged is not None:             # None: every row was dead
                kept.insert(pos, merged)
            self._segments = kept
            self._purge_probe_traffic()
            return True
        return False

    def _merge_segments(self, group: Sequence[Segment],
                        now: float) -> Optional[Segment]:
        """Rebuild ``group`` as one segment with remapped global ids,
        dropping tombstoned, shadowed and expired rows.  The keep mask is
        made on the host; the live raw rows are selected on the device
        (warm segments) or read from the memmaps (cold ones).  A cold
        store builds without the raw tier and writes the merged rows to a
        new cold file.  Returns None when nothing in the group survives."""
        gids = np.concatenate([s.global_ids() for s in group])
        seqs = np.concatenate([s.global_seqs() for s in group])
        expire = _concat_expiry(group)
        tags = np.concatenate(
            [s.tags if s.tags is not None else np.zeros(s.n, np.uint32)
             for s in group])
        ts = np.concatenate(
            [s.ts if s.ts is not None else np.zeros(s.n, np.float32)
             for s in group])
        mg, ms = self._mut_arrays()
        keep = _live_rows(mg, ms, gids, seqs)
        keep = np.ones(len(gids), bool) if keep is None else keep.copy()
        if expire is not None:
            keep &= expire > now
        bounds = np.cumsum([0] + [s.n for s in group])
        parts = []
        for s, lo, hi in zip(group, bounds[:-1], bounds[1:]):
            sel = None if keep.all() else np.flatnonzero(keep[lo:hi])
            if s.index.raw is not None:
                part = s.index.raw if sel is None else s.index.raw[
                    torch.from_numpy(sel).to(s.index.device)]
                parts.append(part.cpu().numpy() if self.cold_tier else part)
                continue
            mm = s.raw_vectors()
            part = np.array(mm) if sel is None else np.take(mm, sel, axis=0)
            parts.append(part if self.cold_tier
                         else torch.from_numpy(part).to(self.device))
        x = np.concatenate(parts) if self.cold_tier else torch.cat(parts)
        if not keep.all():
            gids, seqs, tags, ts = (a[keep] for a in (gids, seqs, tags, ts))
            expire = expire[keep] if expire is not None else None
        n, d = x.shape
        if n == 0:
            return None
        cfg = dataclasses.replace(self.cfg, n_grains=self._grain_count(n))
        idx, _ = index_mod.build(x, cfg, tags=tags, ts=ts,
                                 keep_raw=not self.cold_tier,
                                 device=self.device)
        cold_path = (self._write_cold(x, self._next_seg)
                     if self.cold_tier else None)
        with _cold_construction(cold_path) as adopt:
            seg = Segment(seg_id=self._next_seg, index=idx, n=n, id_base=0,
                          tags=tags, ts=ts, id_map=gids.astype(np.int64),
                          seq=seqs,
                          expire=expire if expire is not None
                          and np.isfinite(expire).any() else None,
                          cold_path=cold_path, d=d)
            adopt(seg)
        self._next_seg += 1
        return seg

    def _purge_tombstones(self) -> None:
        """Drop liveness entries whose gid no longer exists anywhere in this
        store (compaction reclaimed every physical row).  Snapshots and
        branches keep their own tables."""
        if not self._live_seq:
            return
        present = [s.global_ids() for s in self._segments]
        present.append(np.asarray(self._mem_ids, np.int64))
        alive = np.unique(np.concatenate(present))
        mg = np.fromiter(self._live_seq.keys(), np.int64,
                         len(self._live_seq))
        gone = mg[~np.isin(mg, alive)]
        if len(gone):
            for g in gone.tolist():
                del self._live_seq[g]
            self._epoch += 1

    # ---------------------------------------------------------- control plane
    def _mut_arrays(self):
        """The mutation table as sorted (gid, seq) arrays, cached per
        epoch."""
        if self._mut_cache[0] != self._epoch:
            if self._live_seq:
                mg = np.fromiter(self._live_seq.keys(), np.int64,
                                 len(self._live_seq))
                ms = np.fromiter(self._live_seq.values(), np.int64,
                                 len(self._live_seq))
                order = np.argsort(mg)
                self._mut_cache = (self._epoch, mg[order], ms[order])
            else:
                self._mut_cache = (self._epoch, None, None)
        return self._mut_cache[1], self._mut_cache[2]

    def snapshot(self) -> Manifest:
        mg, ms = self._mut_arrays()
        return Manifest(segments=tuple(self._segments),
                        mem_n=len(self._mem), mem=tuple(self._mem),
                        mem_tags=tuple(self._mem_tags),
                        mem_ts=tuple(self._mem_ts),
                        mem_ids=tuple(self._mem_ids),
                        mem_seq=tuple(self._mem_seq),
                        mem_expire=tuple(self._mem_expire),
                        mut_gid=mg, mut_seq=ms,
                        writer=self._cold_tag, epoch=self._epoch,
                        maint_epoch=self._maint_epoch)

    def branch(self, *,
               seal_threshold: Optional[int] = None) -> "VectorStore":
        """Zero-copy fork: a new store sharing every sealed segment.

        The memtable and the mutation table are copied, so neither side's
        later writes, deletes or upserts reach the other.  The child keeps
        the cold tier, cold_dir and residency knobs, under a writer tag of
        its own."""
        child = VectorStore(self.cfg,
                            seal_threshold=self.seal_threshold
                            if seal_threshold is None else seal_threshold,
                            clock=self._clock, device=self.device,
                            cold_tier=self.cold_tier,
                            cold_dir=self._cold_dir,
                            device_budget=self.device_budget,
                            residency_interval=self.residency_interval,
                            prefetch_grains=self.prefetch_grains)
        child._segments = list(self._segments)
        child._mem = list(self._mem)
        child._mem_tags = list(self._mem_tags)
        child._mem_ts = list(self._mem_ts)
        child._mem_ids = list(self._mem_ids)
        child._mem_seq = list(self._mem_seq)
        child._mem_expire = list(self._mem_expire)
        child._next_id = self._next_id
        child._next_seq = self._next_seq
        child._next_seg = self._next_seg
        child._live_seq = dict(self._live_seq)
        child._epoch = self._epoch
        child._maint_epoch = self._maint_epoch     # the lineage continues
        return child

    @property
    def n_vectors(self) -> int:
        """Physical rows (live and tombstoned)."""
        return sum(s.n for s in self._segments) + len(self._mem)

    def n_live(self, now: Optional[float] = None) -> int:
        """Records a search can return: physical rows minus tombstoned,
        shadowed and expired ones."""
        now = self._clock() if now is None else now
        mg, ms = self._mut_arrays()
        total = 0
        for gids, seqs, expire in [
                (s.global_ids(), s.global_seqs(), s.expire)
                for s in self._segments] + [
                (np.asarray(self._mem_ids, np.int64),
                 np.asarray(self._mem_seq, np.int64),
                 np.asarray(self._mem_expire, np.float64))]:
            keep = _live_rows(mg, ms, gids, seqs)
            keep = np.ones(len(gids), bool) if keep is None else keep.copy()
            if expire is not None and len(gids):
                keep &= np.asarray(expire) > now
            total += int(keep.sum())
        return total

    @property
    def n_segments(self) -> int:
        return len(self._segments)

    @property
    def maintenance_epochs(self) -> int:
        """Maintenance epochs that changed this store's lineage (branches
        inherit the count; snapshots capture it as ``Manifest.maint_epoch``).
        Each epoch advances it by exactly one, however many grains it
        repaired, and costs at most one re-stack of the plane."""
        return self._maint_epoch

    # ------------------------------------------------------------- read path
    def _cache_get(self, key):
        hit = self._stack_cache.get(key)
        if hit is not None:
            self._stack_cache.move_to_end(key)
            return hit[1]
        return None

    def _cache_put(self, key, segments: tuple, value):
        self._stack_cache[key] = (tuple(segments), value)
        while len(self._stack_cache) > STACK_CACHE_ENTRIES:
            self._stack_cache.popitem(last=False)
        return value

    def _stacked_for(self, segments: tuple) -> dict:
        """The stacked plane of a segment set, stacked on first use.

        The entry also holds the host row tables (the segments' flat-row
        ranges ``offsets``, flat-row gid, seq and TTL, and a host copy of
        the grain id panels) that the per-epoch liveness bitmap and the
        tenant bitmaps are computed from; ``row_base`` is None: the id
        panels hold flat rows of the segments' order."""
        key = ("stacked", tuple(id(s) for s in segments))
        hit = self._cache_get(key)
        if hit is not None:
            return hit
        stacked = stack_segments(segments)
        ids_h, off_h = fetch(stacked.index.grains.ids, stacked.row_offset)
        entry = {
            "plane": stacked,
            "ids_host": ids_h.numpy(),
            "offsets": off_h.numpy().astype(np.int64),
            "row_base": None,
            "row_gid": np.concatenate([s.global_ids() for s in segments]),
            "row_seq": np.concatenate([s.global_seqs() for s in segments]),
            "row_exp": _concat_expiry(segments),
            "live": (None, None),      # (epoch key, plane with live)
            "raw_rows": None,          # _RawRows of a cold segment set
        }
        return self._cache_put(key, segments, entry)

    def _raw_rows(self, entry: dict, segments: tuple) -> "_RawRows":
        if entry["raw_rows"] is None:
            entry["raw_rows"] = _RawRows(segments, self.device,
                                         self._rerank_stats)
        return entry["raw_rows"]

    # ------------------------------------------------------ tiered residency
    def _tiered_for(self, segments: tuple) -> dict:
        """The tiered plane of a segment set: the grain panels written to
        one panel file in ``cold_dir`` (``core.residency``), the frames and
        routing plane on the device (the stub), the host row tables, and
        the admission state (per-grain route_wins/touches counters and the
        hot set they elect).  It shares the plane LRU with the stacked
        planes; the panel file is unlinked when the plane dies."""
        key = ("tiered", tuple(id(s) for s in segments))
        hit = self._cache_get(key)
        if hit is not None:
            return hit
        host = stack_segments(segments, device="cpu", keep_raw=False)
        path = os.path.join(
            self.cold_dir,
            f"panels_{self._cold_tag}_{uuid.uuid4().hex[:8]}.soa")
        tiered = residency.TieredPlane.from_stacked(host, path, self.device)
        gids = host.gid_of_row.numpy().astype(np.int64)
        ids = np.asarray(tiered.panels["ids"])
        row_grain = np.full(len(gids), -1, np.int32)
        row_grain[ids[ids >= 0]] = np.nonzero(ids >= 0)[0]
        entry = {
            "plane": tiered.routing_stub(),
            "tiered": tiered,
            "ids_host": tiered.panels["ids"],
            "offsets": host.row_offset.numpy().astype(np.int64),
            "row_base": None,
            "row_gid": gids,
            "row_seq": np.concatenate([s.global_seqs() for s in segments]),
            "row_exp": _concat_expiry(segments),
            "gid_of_row": place(gids.astype(np.int32), self.device),
            "row_grain": place(row_grain, self.device),
            "live_host": (None, None),   # (epoch key, [G, cap] bitmap|None)
            "keep": (None, None),        # (filter key, (keep, ok, ok_dev))
            "raw_rows": None,
            "searches": 0,
            # admission counters: every tiered search feeds them
            "r_wins": np.zeros(tiered.n_grains, np.int64),
            "r_touches": np.zeros(tiered.n_grains, np.int64),
        }
        self._seed_hot(tiered)
        return self._cache_put(key, segments, entry)

    def _plane_entry_for(self, segments: tuple) -> dict:
        """The plane-cache entry a segment set is searched on under the
        current residency mode: the tiered one under a ``device_budget``,
        else the stacked one (the coalesced serving plane builds its tenant
        bitmaps on it, so tenancy follows the store's tier)."""
        if self.device_budget is not None:
            return self._tiered_for(segments)
        return self._stacked_for(segments)

    def _seed_hot(self, tiered) -> None:
        """Admission before any traffic: the biggest grains first (ties to
        the lower grain)."""
        h = tiered.budget_slots(self.device_budget)
        order = np.lexsort((np.arange(tiered.n_grains),
                            -tiered.sizes.astype(np.int64)))
        tiered.set_hot(order[:h])

    def _update_residency_entry(self, entry: dict) -> bool:
        """Re-elect the hot set: the top grains by route_wins + touches
        under the byte budget (by size while there is no traffic).  A grain
        that drops out is simply not copied into the next hot plane.
        True when the hot set changed."""
        tiered = entry["tiered"]
        h = tiered.budget_slots(self.device_budget)
        score = entry["r_wins"] + entry["r_touches"]
        if score.max(initial=0) <= 0:
            score = tiered.sizes.astype(np.int64)
        order = np.lexsort((np.arange(tiered.n_grains), -score))
        return tiered.set_hot(order[:h])

    def _tiered_entries(self):
        return [(segs, entry) for key, (segs, entry)
                in self._stack_cache.items() if key[0] == "tiered"]

    def update_residency(self) -> bool:
        """Re-elect the hot set of every cached tiered plane now (the pass
        that runs every ``residency_interval`` searches).  True when any
        hot set changed; a no-op until a tiered search built a plane."""
        changed = False
        for _, entry in self._tiered_entries():
            changed |= self._update_residency_entry(entry)
        return changed

    def residency_stats(self) -> dict:
        """Residency counters (zeros until a tiered search built a plane).
        The geometry (grains, hot set, budget unit) is the live segment
        set's plane's, else the busiest cached one's; the traffic counters
        (staged bytes, chunk dispatches, paged queries, searches) add up
        over every cached tiered plane."""
        out = {"n_grains": 0, "hot_grains": 0, "hot_bytes": 0,
               "panel_bytes_per_grain": 0, "staged_bytes": 0,
               "chunk_dispatches": 0, "paged_queries": 0,
               "hot_epochs": 0, "searches": 0}
        geom, geom_live, busiest = None, False, -1
        for segs, entry in self._tiered_entries():
            t = entry["tiered"]
            out["staged_bytes"] += t.staged_bytes
            out["chunk_dispatches"] += t.chunk_dispatches
            out["paged_queries"] += t.paged_queries
            out["searches"] += entry["searches"]
            is_live = segs == tuple(self._segments)
            if is_live and not geom_live or geom is None \
                    or (not geom_live and entry["searches"] > busiest):
                geom, geom_live = t, geom_live or is_live
                busiest = entry["searches"]
        if geom is not None:
            per = geom.panel_bytes_per_grain()
            out.update(n_grains=geom.n_grains, hot_grains=geom.n_hot,
                       hot_bytes=geom.n_hot * per,
                       panel_bytes_per_grain=per,
                       hot_epochs=geom.hot_epochs)
        return out

    def _tiered_live(self, entry: dict, man: Manifest, now: float):
        """Host [G, cap] liveness bitmap of a tiered plane (None: all live),
        cached per (writer, epoch[, now]) like the stacked plane's ``live``
        leaf, from the same row tables and id panels: the same bits."""
        has_ttl = entry["row_exp"] is not None
        key = (man.writer, man.epoch, now if has_ttl else None)
        ck, cached = entry["live_host"]
        if ck == key:
            return key, cached
        live_row = _live_rows(man.mut_gid, man.mut_seq,
                              entry["row_gid"], entry["row_seq"])
        if has_ttl:
            alive_t = entry["row_exp"] > now
            if not alive_t.all():
                live_row = alive_t if live_row is None \
                    else live_row & alive_t
        bitmap = None
        if live_row is not None:
            ids = np.asarray(entry["ids_host"]).astype(np.int64)
            bitmap = (ids >= 0) & live_row[np.maximum(ids, 0)]
        entry["live_host"] = (key, bitmap)
        return key, bitmap

    def _tiered_keep(self, entry: dict, live_key, bitmap, tag_mask,
                     ts_range):
        """The host replica of the in-scan predicate over the panel file:
        (keep [G, cap] | None, grain_ok [G] | None, grain_ok on the
        device), cached per (liveness epoch, filters)."""
        key = (live_key, tag_mask, ts_range)
        ck, val = entry["keep"]
        if ck != key:
            keep, ok = residency.host_keep_mask(entry["tiered"].panels,
                                                bitmap, tag_mask, ts_range)
            val = (keep, ok, None if ok is None else place(ok, self.device))
            entry["keep"] = (key, val)
        return val

    def _live_plane(self, entry: dict, man: Manifest, now: float):
        """The entry's plane with the manifest epoch's liveness attached.

        The [G, cap] bitmap is computed on the host from the cached row
        tables, placed on the device and swapped in with
        ``dataclasses.replace`` (no re-stack).  It is cached per (writer,
        epoch), plus ``now`` when any row has a TTL."""
        has_ttl = entry["row_exp"] is not None
        key = (man.writer, man.epoch, now if has_ttl else None)
        ck, cached = entry["live"]
        if ck == key:
            return cached
        live_row = _live_rows(man.mut_gid, man.mut_seq,
                              entry["row_gid"], entry["row_seq"])
        if has_ttl:
            alive_t = entry["row_exp"] > now
            if not alive_t.all():
                live_row = alive_t if live_row is None \
                    else live_row & alive_t
        plane = entry["plane"]
        if live_row is not None:
            ids = entry["ids_host"]
            rows = ids.astype(np.int64)
            if entry["row_base"] is not None:     # shard-local -> permuted
                rows = rows + entry["row_base"][:, None]
            bitmap = (ids >= 0) & live_row[np.maximum(rows, 0)]
            if entry.get("rules") is not None:    # placed shard-wise
                from ..distributed import sharding as shd
                plane = plane.with_live(
                    shd.shard_plane_field(bitmap, entry["rules"], "live"))
            else:
                plane = dataclasses.replace(
                    plane, live=place(bitmap, plane.index.device))
        entry["live"] = (key, plane)
        return plane

    # ------------------------------------------------ the sharded plane
    def _sharded_for(self, segments: tuple, mesh, grain_axis: str) -> dict:
        """The mesh-sharded plane of a segment set: the shard-aligned
        layout (``shard_segments``, built on the store's device) placed
        shard-wise on the mesh, plus the host row tables the liveness
        bitmap, the tenant bitmaps and the cold re-rank read.  Row tables
        are permuted like the raw tier, so the bitmap lands shard-aligned.
        Cached in the plane LRU, keyed also by the mesh and grain axis.

        Maintenance delta path: a refit-only maintenance epoch rewrites
        grain panels but moves no rows, so the row permutation, and with
        it the placed raw tier and id table, is unchanged; when a cached
        plane on the same mesh proves that (``_reusable_row_leaves``), its
        placed ``raw``/``gid_of_row`` are reused and only the grain panels
        are placed."""
        from ..distributed import sharding as shd
        key = ("sharded", tuple(id(s) for s in segments), mesh, grain_axis)
        hit = self._cache_get(key)
        if hit is not None:
            return hit
        rules = shd.search_plane_rules(mesh, grain_axis=grain_axis)
        n_shards = rules.n_shards
        plane, perm = shard_segments(segments, n_shards, device=self.device)
        ids_host = fetch(plane.index.grains.ids).numpy()
        reuse = self._reusable_row_leaves(segments, mesh, grain_axis, perm)
        placed = shd.shard_search_plane(plane, rules, reuse=reuse)
        del plane
        offsets = np.zeros(len(segments) + 1, np.int64)
        np.cumsum([s.n for s in segments], out=offsets[1:])
        gids = np.concatenate([s.global_ids() for s in segments])
        seqs = np.concatenate([s.global_seqs() for s in segments])
        exp = _concat_expiry(segments)
        keep = np.maximum(perm, 0)
        entry = {
            "plane": placed,
            "perm": perm,
            "offsets": offsets,
            "gids": gids,
            "ids_host": ids_host,
            "row_gid": np.where(perm >= 0, gids[keep], -1),
            "row_seq": np.where(perm >= 0, seqs[keep], -1),
            "row_exp": (np.where(perm >= 0, exp[keep], np.inf)
                        if exp is not None else None),
            # shard-local panel ids -> permuted global rows
            "row_base": (np.arange(ids_host.shape[0]) // placed.g_local
                         * placed.rows_local),
            "rules": rules,
            "live": (None, None),
            "raw_rows": None,          # _RawRows of a cold segment set
        }
        if not placed.warm:            # the cold re-rank's row maps
            entry["perm_dev"] = place(perm, self.device)
            entry["gid_flat"] = place(gids.astype(np.int32), self.device)
        return self._cache_put(key, segments, entry)

    def _reusable_row_leaves(self, segments: tuple, mesh, grain_axis: str,
                             perm: np.ndarray) -> Optional[dict]:
        """The placed ``raw``/``gid_of_row`` of a cached sharded plane that
        are provably the ones about to be placed, or None.  Valid iff a
        cached plane on the same (mesh, grain_axis) has the same
        per-segment row tables (object identity on the immutable arrays:
        maintenance shares them through ``dataclasses.replace``) and the
        same row permutation."""
        for key, (old_segs, entry) in self._stack_cache.items():
            if key[0] != "sharded" or key[2:] != (mesh, grain_axis):
                continue
            if len(old_segs) != len(segments):
                continue
            same_rows = all(
                o.n == s.n and o.index.raw is s.index.raw
                and o.id_map is s.id_map and o.id_base == s.id_base
                and o.seq is s.seq
                for o, s in zip(old_segs, segments))
            if same_rows and np.array_equal(entry["perm"], perm):
                return {"raw": entry["plane"].field("raw"),
                        "gid_of_row": entry["plane"].field("gid_of_row")}
        return None

    def _sharded_statics(self, plane, topk: int, nprobe: Optional[int],
                         pool: Optional[int]):
        """Per-shard (probe, pool_eff), clamped to the local grain slice."""
        probe = max(1, min(nprobe if nprobe is not None else self.cfg.nprobe,
                           plane.g_local))
        want_pool = pool if pool is not None else self.cfg.pool
        return probe, min(max(want_pool, topk), probe * plane.cap)

    @staticmethod
    def _batch_axis(mesh, grain_axis: str, shard_queries: bool,
                    q_n: int) -> Optional[str]:
        """The query-batch mesh axis, or None to run the queries on the
        mesh's first row.  An unsatisfiable explicit request is an error,
        not a silent fallback."""
        if not shard_queries:
            return None
        other = [a for a in mesh.axis_names if a != grain_axis]
        if not other or mesh.shape[other[0]] <= 1:
            raise ValueError(
                f"shard_queries=True needs a >1-sized mesh axis besides "
                f"{grain_axis!r}; mesh has {dict(mesh.shape)}")
        if q_n % mesh.shape[other[0]] != 0:
            raise ValueError(
                f"shard_queries=True needs the {other[0]!r} axis size "
                f"({mesh.shape[other[0]]}) to divide the query count "
                f"({q_n}); pad the batch to a multiple of the axis")
        return other[0]

    def _search_segments_sharded(self, q, man, *, topk, mode, tag_mask,
                                 ts_range, scan_impl, nprobe, pool, mesh,
                                 grain_axis, shard_queries, now,
                                 budgets=None, tenant_live=None,
                                 tenant_ix=None, adaptive=False,
                                 probe_margin=1.0, min_probes=1):
        """The distributed fused search: per-shard route, scan, pool and
        re-rank (``planner.search_stacked_sharded``) and one merge.
        Returns (global ids [Q, k] i32, dists [Q, k] f32) on the store's
        device.

        tenant_live [T, G, cap] + tenant_ix [Q] (host arrays): as in
        ``_search_segments_fused``; the stack is placed grain-sharded on
        dim 1 (the tenant axis whole).

        adaptive: the stopping rule runs per shard on its local routing
        table, one fixed-shape pass per shard with the ragged ``n_active``
        handed to the select; no host bucketing.  Hub pinning stays a
        single-device feature: the traffic counters live on the stacked
        grain axis, which does not map onto the permuted layout, so no hub
        mask is passed (the planner takes one from callers that shard
        their own counters).

        A cold plane (no raw tier): each shard contributes its whole
        Mode A pool (``topk = n_shards * pe``) as permuted rows, ``perm``
        maps them to flat rows, and they are re-ranked with the rows of
        the cold files (``_RawRows``, ``_rerank_pool``)."""
        segments = man.segments
        entry = self._sharded_for(segments, mesh, grain_axis)
        plane = self._live_plane(entry, man, now)
        n_shards = plane.n_shards
        probe, pool_eff = self._sharded_statics(plane, topk, nprobe, pool)
        kw = dict(mesh=mesh, grain_axis=grain_axis,
                  batch_axis=self._batch_axis(mesh, grain_axis,
                                              shard_queries, q.shape[0]),
                  nprobe=probe, envelope_frac=self.cfg.envelope_frac,
                  qeff=index_mod.int32_safe_qmax(self.cfg.k,
                                                 self.cfg.coord_bits),
                  scan_impl=scan_impl, budgets=budgets, tag_mask=tag_mask,
                  ts_range=ts_range)
        if adaptive and not math.isinf(probe_margin):
            kw.update(probe_margin=probe_margin, min_probes=min_probes)
        if tenant_live is not None:
            from ..distributed import sharding as shd
            kw["tenant_live"] = shd.shard_plane_field(
                np.asarray(tenant_live, bool), entry["rules"],
                "tenant_live", dim=1)
            kw["tenant_ix"] = _to_device(np.asarray(tenant_ix, np.int32),
                                         q.device)
        if mode == "B" and not plane.warm:
            pe = (pool_eff if budgets is None
                  else min(pool_eff, int(budgets[1])))
            res = planner.search_stacked_sharded(
                plane, q, pool=pe, topk=n_shards * pe, mode="A",
                translate=False, **kw)
            perm, gid_flat = entry["perm_dev"], entry["gid_flat"]
            ok = torch.logical_and(res.ids >= 0, res.dists < BIG / 2)
            rows = torch.where(ok, perm[torch.clamp(res.ids, min=0).long()],
                               -1)
            ok = torch.logical_and(ok, rows >= 0)
            width = rows.shape[1]

            def translate(r, d):
                hit = torch.logical_and(r >= 0, d < BIG / 2)
                return torch.where(hit, gid_flat[torch.clamp(r, min=0)],
                                   -1).to(torch.int32)

            res = _rerank_pool(torch.where(ok, res.dists, BIG), rows, q,
                               self._raw_rows(entry, segments), pool=width,
                               topk=min(topk, width), translate=translate)
            return res.ids, res.dists
        res = planner.search_stacked_sharded(plane, q, pool=pool_eff,
                                             topk=topk, mode=mode, **kw)
        return res.ids, res.dists

    def search(self, q, *, topk: int = 10, mode: str = "B",
               tag_mask: Optional[int] = None,
               ts_range: Optional[tuple] = None,
               manifest: Optional[Manifest] = None,
               scan_impl: Optional[str] = None,
               budgets: Optional[tuple] = None,
               nprobe: Optional[int] = None, pool: Optional[int] = None,
               fused: bool = True, route_mode: str = "global",
               mesh=None, grain_axis: str = "model",
               shard_queries: bool = False, adaptive: bool = False,
               probe_margin: Optional[float] = None,
               min_probes: Optional[int] = None,
               now: Optional[float] = None) -> SearchResult:
        """Mixed-recall search over the sealed segments and the memtable,
        on the store's device.

        All sealed segments are searched by one ``planner.search_stacked``
        call (``fused=True``); ``fused=False`` runs the per-segment loop,
        the parity oracle.

        tag_mask: keep records with (tag & tag_mask) != 0.
        ts_range: (lo, hi), keep lo <= ts < hi.
        scan_impl: ScanPlane backend (``core.scanplane``); None = "auto".
        budgets: (b1, b2) per-stage survivor budgets of a staged backend
          (the cascade), validated here (b1 >= b2 >= topk); needs the
          fused plane.  A cold Mode B re-ranks the first min(pool, b2)
          candidates; under ``device_budget`` they act on each pass.
        nprobe / pool: override cfg.nprobe / cfg.pool on the stacked plane.
        route_mode: "global" (top-P over every segment's grains) or
          "per_segment" (top-P within each segment, still one call).
        adaptive: per-query probe counts.  After routing, the distance-gap
          rule (``routing.adaptive_prefix``) kills the probes whose grain
          lies beyond (1 + probe_margin) times the query's best grain's
          distance; the hub grains (the ``cfg.hub_size`` grains with the
          most routing wins so far) are always probed.  The queries then
          run in power-of-two probe-width buckets.  ``adaptive=False`` and
          ``probe_margin=inf`` are the static plane bit for bit.  Needs
          the fused plane and global routing.
        probe_margin / min_probes: the rule's knobs (None: ``cfg``'s);
          setting them without ``adaptive=True`` is an error.
        mesh: a ``launch.mesh.SearchMesh``: the distributed search plane.
          Grain panels and the permuted raw tier are split along
          ``grain_axis``, each shard routes, scans, pools and re-ranks its
          own slice (``planner.search_stacked_sharded``), and one merge of
          the per-shard pools follows.  nprobe/pool/budgets become
          per-shard knobs, clamped to each shard's slice.  The mesh's
          slots must be devices of the store's kind (a store on the card
          is never searched on CPU slots); needs the fused plane, global
          routing and no ``device_budget``.
        shard_queries: with a mesh, also split the queries over the mesh's
          other axis (its size must divide the query count and exceed 1).
        now: TTL clock (default: the store's clock).
        With ``device_budget`` set the sealed segments are searched on the
        tiered plane (fused, global routing, one device only).
        """
        if budgets is not None:
            check_budgets(budgets, topk)
            if not fused:
                raise ValueError(
                    "budgets= needs the fused search plane; the per-segment "
                    "loop (fused=False) has no staged candidate stage")
        routing.check_probe_args(adaptive, probe_margin, min_probes)
        if adaptive:
            if not fused:
                raise ValueError(
                    "adaptive=True needs the fused search plane; the "
                    "per-segment loop (fused=False) has no ragged-probe "
                    "stage")
            if route_mode != "global":
                raise ValueError(
                    "adaptive=True needs route_mode='global' (the stopping "
                    "rule compares one fused routing pass)")
        margin = (self.cfg.probe_margin if probe_margin is None
                  else float(probe_margin))
        minp = self.cfg.min_probes if min_probes is None else int(min_probes)
        if self.device_budget is not None:
            if not fused:
                raise ValueError(
                    "device_budget= (tiered residency) pages through the "
                    "fused stacked plane; fused=False has no paged path")
            if mesh is not None:
                raise ValueError(
                    "device_budget= (tiered residency) is single-device; "
                    "the sharded plane (mesh=) keeps every shard resident: "
                    "drop one of the two")
            if route_mode != "global":
                raise ValueError(
                    "device_budget= (tiered residency) routes once "
                    "globally; route_mode='per_segment' has no paged plan")
        if mesh is not None:
            if not fused:
                raise ValueError(
                    "mesh= requires the fused search plane; the per-segment "
                    "loop (fused=False) has no sharded path")
            if route_mode != "global":
                raise ValueError(
                    "the sharded plane routes per shard; route_mode "
                    "overrides only apply to the single-device plane")
            from ..distributed import sharding as shd
            shd.search_plane_rules(mesh, grain_axis=grain_axis)
            shd.check_mesh_devices(mesh, self.device)
        man = manifest or self.snapshot()
        now = self._clock() if now is None else now
        q = torch.as_tensor(q, dtype=torch.float32)
        if q.dim() == 1:
            q = q[None]
        q = place(q, self.device)
        with index_mod.full_fp32_matmul():
            if not fused:
                return self._search_looped(
                    q, man, topk=topk, mode=mode, tag_mask=tag_mask,
                    ts_range=ts_range, scan_impl=scan_impl, now=now)
            all_ids, all_d = [], []
            if man.segments and mesh is not None:
                ids_s, d_s = self._search_segments_sharded(
                    q, man, topk=topk, mode=mode, tag_mask=tag_mask,
                    ts_range=ts_range, scan_impl=scan_impl, budgets=budgets,
                    nprobe=nprobe, pool=pool, mesh=mesh,
                    grain_axis=grain_axis, shard_queries=shard_queries,
                    now=now, adaptive=adaptive and not math.isinf(margin),
                    probe_margin=margin, min_probes=minp)
                all_ids.append(ids_s)
                all_d.append(d_s)
            elif man.segments:
                ids_s, d_s = self._search_segments_fused(
                    q, man, topk=topk, mode=mode, tag_mask=tag_mask,
                    ts_range=ts_range, scan_impl=scan_impl, budgets=budgets,
                    nprobe=nprobe, pool=pool, route_mode=route_mode, now=now,
                    adaptive=adaptive and not math.isinf(margin),
                    probe_margin=margin, min_probes=minp)
                all_ids.append(ids_s)
                all_d.append(d_s)
            return self._merge_with_memtable(q, man, all_ids, all_d, topk,
                                             tag_mask, ts_range, now)

    def _merge_with_memtable(self, q, man: Manifest, all_ids, all_d, topk,
                             tag_mask, ts_range, now) -> SearchResult:
        """Result tail of the fused and looped paths: append the memtable
        pool, handle the empty store, finalize to [Q, topk]."""
        mem_ids, mem_d = self._search_memtable(q, man, topk, tag_mask,
                                               ts_range, now)
        if mem_ids is not None:
            all_ids.append(mem_ids)
            all_d.append(mem_d)
        if not all_ids:
            shape = (q.shape[0], topk)
            return SearchResult(
                ids=torch.full(shape, -1, dtype=torch.int32, device=q.device),
                dists=torch.full(shape, BIG, device=q.device))
        return _finalize(torch.cat([i.long() for i in all_ids], dim=1),
                         torch.cat(all_d, dim=1), topk)

    def _fused_statics(self, segments: tuple, stacked: StackedSegments,
                       topk: int, nprobe: Optional[int],
                       pool: Optional[int], route_mode: str):
        """Clamp nprobe, pool and topk to the stacked plane's shape."""
        s_n = len(segments)
        gmax = stacked.index.grains.n_grains // s_n
        capmax = stacked.index.grains.cap
        want_probe = nprobe if nprobe is not None else self.cfg.nprobe
        if route_mode == "per_segment":
            probe = min(want_probe, gmax)
            n_slots = s_n * probe * capmax
        else:
            probe = min(want_probe, s_n * gmax)
            n_slots = probe * capmax
        want_pool = pool if pool is not None else self.cfg.pool
        pool_eff = min(max(want_pool, topk), n_slots)
        return probe, pool_eff, min(topk, pool_eff), (s_n, gmax)

    def _search_segments_fused(self, q, man, *, topk, mode, tag_mask,
                               ts_range, scan_impl, budgets, nprobe, pool,
                               route_mode, now, adaptive=False,
                               probe_margin=1.0, min_probes=1,
                               tenant_live=None, tenant_ix=None):
        """One ``planner.search_stacked`` call over the stacked plane (the
        tiered plane under a ``device_budget``; the bucketed dispatch of
        ``_adaptive_fused`` when ``adaptive``, whose margin is finite).
        Returns (global ids [Q, k] i32, dists [Q, k] f32) on the device.

        tenant_live [T, G, cap] bool + tenant_ix [Q] (host arrays): the
        coalesced serving plane's per-query visibility over ``man``, then a
        registry's union of segments; they reach the device through pinned
        memory and join the scan's mask and routing's pushdown.

        A cold plane (no stacked raw tier) runs Mode A for the pool and
        re-ranks it with the rows read from the cold files (``_RawRows``,
        ``_rerank_pool``): the same pool, batches and epilogue as a warm
        plane's Mode B, so the same bits.  Stage budgets cap the useful
        pool at b2, so a cold re-rank reads only that many rows."""
        if self.device_budget is not None:
            return self._search_segments_tiered(
                q, man, topk=topk, mode=mode, tag_mask=tag_mask,
                ts_range=ts_range, scan_impl=scan_impl, budgets=budgets,
                nprobe=nprobe, pool=pool, now=now, adaptive=adaptive,
                probe_margin=probe_margin, min_probes=min_probes,
                tenant_live=tenant_live, tenant_ix=tenant_ix)
        segments = man.segments
        entry = self._stacked_for(segments)
        stacked = self._live_plane(entry, man, now)
        probe, pool_eff, topk_eff, seg_shape = self._fused_statics(
            segments, stacked, topk, nprobe, pool, route_mode)
        cold = mode == "B" and stacked.index.raw is None
        pe = pool_eff if budgets is None else min(pool_eff, int(budgets[1]))
        tenants = {}
        if tenant_live is not None:
            tenants = dict(
                tenant_live=_to_device(np.asarray(tenant_live, bool),
                                       q.device),
                tenant_ix=_to_device(np.asarray(tenant_ix, np.int32),
                                     q.device))
        if adaptive:
            return self._adaptive_fused(
                q, segments, entry, stacked, mode=mode, probe=probe,
                pool_eff=pool_eff, topk_eff=topk_eff, pe=pe, cold=cold,
                budgets=budgets, scan_impl=scan_impl, tag_mask=tag_mask,
                ts_range=ts_range, probe_margin=probe_margin,
                min_probes=min_probes, **tenants)
        res = planner.search_stacked(
            stacked, q, nprobe=probe, pool=pool_eff,
            topk=pe if cold else topk_eff, mode="A" if cold else mode,
            envelope_frac=self.cfg.envelope_frac,
            qeff=index_mod.int32_safe_qmax(self.cfg.k, self.cfg.coord_bits),
            scan_impl=scan_impl, budgets=budgets, route_mode=route_mode,
            seg_shape=seg_shape, translate=not cold, tag_mask=tag_mask,
            ts_range=ts_range, **tenants)
        if cold:
            res = _rerank_pool(
                res.dists, res.ids, q, self._raw_rows(entry, segments),
                pool=pe, topk=topk_eff,
                translate=lambda r, d: planner._translate_rows(stacked, r, d))
        return res.ids, res.dists

    def _adaptive_fused(self, q, segments, entry, stacked, *, mode, probe,
                        pool_eff, topk_eff, pe, cold, budgets, scan_impl,
                        tag_mask, ts_range, probe_margin, min_probes,
                        tenant_live=None, tenant_ix=None):
        """Adaptive routing on the stacked plane, in two phases.

        1. One ``planner.probe_plan`` pass: routing, the stopping rule with
           the current hub set, and the traffic counters, read back to the
           host in one copy.
        2. The queries are bucketed by power-of-two probe width w >=
           n_active (``_width_buckets``), and each bucket runs
           ``search_stacked`` on its slice of the plan, (gids[:, :w],
           min(n_active, w)) at nprobe=w and pool min(pool, w * cap) (the
           cascade's b1 is clamped to w * cap there too): an easy query
           scans fewer grains instead of masking them.  A cold Mode B
           takes each bucket's Mode A pool and re-ranks it with the rows
           of the cold files (``_RawRows``, ``_rerank_pool``) over the
           bucket's batches, so it equals the warm plane bit for bit.
        The tenant pair (on the device) joins the routing pass, and each
        bucket takes its queries' rows of ``tenant_ix``.
        Returns (ids [Q, topk] i32, dists [Q, topk] f32) on the device,
        (-1, BIG) past a bucket's results."""
        dev, q_n = q.device, q.shape[0]
        traffic = self._traffic_for(segments, stacked.index.routing.n_grains)
        gids_d, na_d, plan_h = self._adaptive_plan(
            stacked, q, traffic, nprobe=probe, probe_margin=probe_margin,
            min_probes=min_probes, tag_mask=tag_mask, ts_range=ts_range,
            tenant_live=tenant_live, tenant_ix=tenant_ix)
        qeff = index_mod.int32_safe_qmax(self.cfg.k, self.cfg.coord_bits)
        cap = stacked.index.grains.cap
        raw = self._raw_rows(entry, segments) if cold else None

        def tr(r, d):
            return planner._translate_rows(stacked, r, d)

        def run(w, sel_d):
            pool_b = min(pool_eff, w * cap)
            topk_b = min(topk_eff, pool_b)
            qb = q[sel_d]
            kw = dict(nprobe=w, envelope_frac=self.cfg.envelope_frac,
                      qeff=qeff, scan_impl=scan_impl, budgets=budgets,
                      tag_mask=tag_mask, ts_range=ts_range,
                      probe_plan=(gids_d[sel_d, :w].contiguous(),
                                  torch.clamp(na_d[sel_d], max=w)))
            if tenant_live is not None:
                kw.update(tenant_live=tenant_live,
                          tenant_ix=tenant_ix[sel_d].contiguous())
            if not cold:
                return planner.search_stacked(stacked, qb, pool=pool_b,
                                              topk=topk_b, mode=mode, **kw)
            pe_b = min(pe, pool_b)
            res = planner.search_stacked(stacked, qb, pool=pool_b, topk=pe_b,
                                         mode="A", translate=False, **kw)
            return _rerank_pool(res.dists, res.ids, qb, raw, pool=pe_b,
                                topk=topk_b, translate=tr)

        return _bucketed(_width_buckets(plan_h[1], probe), q_n, topk_eff,
                         dev, run)

    def _adaptive_plan(self, plane, q, traffic, *, nprobe, probe_margin,
                       min_probes, tag_mask=None, ts_range=None,
                       grain_mask=None, tenant_live=None, tenant_ix=None):
        """``planner.probe_plan`` with the current hub set of ``traffic``,
        whose counters it then feeds.  Returns the plan on the device
        (gids [Q, P], n_active [Q]) and on the host (gids, n_active, wins,
        touches: the one device-to-host copy of an adaptive search)."""
        hub = self._hub_mask_host(traffic)
        gids_d, na_d, wins, touches = planner.probe_plan(
            plane, q, nprobe=nprobe, probe_margin=probe_margin,
            min_probes=min_probes,
            hub_mask=None if hub is None else _to_device(hub, q.device),
            tag_mask=tag_mask, ts_range=ts_range, tenant_live=tenant_live,
            tenant_ix=tenant_ix, grain_mask=grain_mask)
        q_n, p_n = gids_d.shape
        flat = fetch(torch.cat([gids_d.reshape(-1), na_d, wins,
                                touches])).numpy()
        cut = np.cumsum([q_n * p_n, q_n, wins.shape[0]])
        gids_h, na_h, wins_h, touch_h = np.split(flat, cut)
        plan_h = (gids_h.reshape(q_n, p_n), na_h, wins_h.astype(np.int64),
                  touch_h.astype(np.int64))
        traffic["wins"] += plan_h[2]
        traffic["touches"] += plan_h[3]
        traffic["queries"] += q_n
        traffic["active_probes"] += int(na_h.sum())
        return gids_d, na_d, plan_h

    def _search_segments_tiered(self, q, man, *, topk, mode, tag_mask,
                                ts_range, scan_impl, budgets, nprobe, pool,
                                now, adaptive=False, probe_margin=1.0,
                                min_probes=1, tenant_live=None,
                                tenant_ix=None):
        """The fused search on the tiered plane under ``device_budget``.
        Returns (global ids [Q, k] i32, dists [Q, k] f32) on the device,
        equal to the all-warm plane's bit for bit.

        1. Routing and the projection run once, on the resident frames, in
           the all-warm plane's batches (``planner.static_route``,
           ``planner.project_probes``), with the routing pushdown from the
           host replica of the filters and liveness.
        2. The hot pass scans the resident hot mini-plane over the whole
           plan (cold probes killed), queued before the host reads the
           plan back; then the probed cold grains are staged in chunks of
           ``prefetch_grains`` and each chunk's pass scans the compacted
           plan of the queries that probe it (a power-of-two subset).
        3. The passes' pools merge in the select's key order (distance,
           plan position, slot) into the all-warm plane's pool, and the
           Mode A cut or the Mode B re-rank (``_rerank_pool``) runs once.

        Stage budgets act on each pass, as in the JAX package: each pass
        runs the cascade over its own probes, and Mode B merges and
        re-ranks min(pool, b2) candidates.  At ``budgets=None`` the merged
        pool holds the all-warm cascade's candidates at the same
        distances, ordered alike except between equal distances.

        ``adaptive``: the plan is ``planner.probe_plan``'s on the stub (the
        stopping rule and the hub set of the same traffic entry as the
        all-warm plane's, which it feeds), read back before any pass; its
        ``n_active`` kills the slack probes of the hot pass and of every
        cold chunk.  The projection runs once per search, per power-of-two
        width bucket as the all-warm plane's buckets run it
        (``_bucket_projection``), and Mode B re-ranks each bucket's share
        of the merged pool over the bucket's batches: the same bits.

        Tenants (host ``tenant_live`` [T, G, cap] + ``tenant_ix`` [Q]): the
        per-query [Q, G] routing pushdown is computed on the host
        (``residency.host_tenant_mask``), and every pass takes the bitmap
        sliced to its mini-plane's grains, with an all-False row for the
        dummy grain, and the ``tenant_ix`` rows of its queries.
        """
        segments = man.segments
        entry = self._tiered_for(segments)
        tiered = entry["tiered"]
        cap, g_total = tiered.cap, tiered.n_grains
        q_n, dev = q.shape[0], q.device
        probe = min(nprobe if nprobe is not None else self.cfg.nprobe,
                    g_total)
        want_pool = pool if pool is not None else self.cfg.pool
        pool_eff = min(max(want_pool, topk), probe * cap)
        topk_eff = min(topk, pool_eff)
        target = pool_eff if mode == "B" else topk_eff
        if mode == "B" and budgets is not None:
            target = min(pool_eff, int(budgets[1]))
        qeff = index_mod.int32_safe_qmax(self.cfg.k, self.cfg.coord_bits)
        live_key, bitmap = self._tiered_live(entry, man, now)
        keep, grain_ok, grain_ok_dev = self._tiered_keep(
            entry, live_key, bitmap, tag_mask, ts_range)
        mask_src = keep if keep is not None else tiered.panels["valid"]
        mask_key = (live_key, tag_mask, ts_range)
        pkw = dict(scan_impl=scan_impl, budgets=budgets, qeff=qeff)
        tl_host = ti_host = ti_d = None
        if tenant_live is not None:
            tl_host = np.asarray(tenant_live, bool)
            ti_host = np.asarray(tenant_ix, np.int64)
            ti_d = _to_device(ti_host.astype(np.int32), dev)
            grain_ok = residency.host_tenant_mask(
                tiered.panels, keep, grain_ok, tl_host, ti_host)  # [Q, G]
            grain_ok_dev = _to_device(grain_ok, dev)

        def tenant_slice(slots, ti):
            """The bitmap over a mini-plane's grains (+ the dummy)."""
            if tl_host is None:
                return {}
            tl = tl_host[:, np.asarray(slots, np.int64)]
            tl = np.concatenate(
                [tl, np.zeros((tl.shape[0], 1, tl.shape[2]), bool)], axis=1)
            return dict(tenant_mask=_to_device(tl, dev), tenant_ix=ti)

        # 1: the plan and the projection, once
        stub = entry["plane"]
        buckets = na_d = plan_read = None
        if adaptive:
            gids_d, na_d, (gids_h, na_h, wins_h, touch_h) = \
                self._adaptive_plan(
                    stub, q, self._traffic_for(segments, g_total),
                    nprobe=probe, probe_margin=probe_margin,
                    min_probes=min_probes, grain_mask=grain_ok_dev)
            buckets = _width_buckets(na_h, probe)
            zq, rq, alive, sq = self._bucket_projection(stub.index, q, gids_d,
                                                        buckets, qeff)
        else:
            gids_d, _ = planner.static_route(stub.index.routing, q,
                                             nprobe=probe,
                                             grain_mask=grain_ok_dev)
            zq, rq, alive, sq = planner.project_probes(
                stub.index, q, gids_d, self.cfg.envelope_frac, qeff)
            plan_read = fetch_async(gids_d)

        # 2a: the hot pass, queued before the host waits for the plan
        passes = []
        if tiered.n_hot > 0:
            plane_h = tiered.hot_plane(mask_src, mask_key)
            plan_h = residency.device_plan(tiered.hot_map_dev, gids_d,
                                           dummy_slot=tiered.n_hot)
            keep_h = torch.logical_and(alive, plan_h != tiered.n_hot)
            passes.append(self._tiered_pass(
                plane_h, q, plan_h, na_d, (zq, rq, keep_h, sq),
                width=min(target, probe * cap),
                **tenant_slice(tiered.hot_slots, ti_d), **pkw))
        if not adaptive:
            gids_h = plan_read.wait().numpy()
            na_h = np.full(q_n, probe, np.int32)
            wins_h = np.bincount(gids_h[:, 0], minlength=g_total)
            touch_h = np.bincount(gids_h.ravel(), minlength=g_total)
        entry["r_wins"] += wins_h
        entry["r_touches"] += touch_h
        entry["searches"] += 1
        tiered.paged_queries += q_n
        # an election applies from the next search: this one's hot pass is
        # queued on the current hot set, which the cold chunks complement
        hot_map = tiered.hot_map
        if entry["searches"] % self.residency_interval == 0:
            self._update_residency_entry(entry)

        # 2b: the cold chunks, staged double-buffered
        need = (hot_map[gids_h] < 0) & (tiered.sizes[gids_h] > 0)
        need &= np.arange(probe)[None, :] < na_h[:, None]
        if grain_ok is not None:      # masked grains scan to BIG anyway
            need &= grain_ok[gids_h] if grain_ok.ndim == 1 else \
                np.take_along_axis(grain_ok, gids_h.astype(np.int64), axis=1)
        cold = np.unique(gids_h[need])
        for ch in residency.chunk_cold(cold, self.prefetch_grains):
            plane_c, member, release = tiered.chunk_plane(ch, mask_src)
            plan = residency.compact_probes(gids_h, na_h, member, len(ch))
            if plan is None:
                release()
                continue
            plan_g, plan_na, w, act_q, pos = plan
            n_act = int(act_q.sum())
            qp = residency.pow2ceil(n_act)
            qsel = None
            if qp < q_n:              # only the queries that probe it
                qidx = np.flatnonzero(act_q)
                qsel = np.concatenate(
                    [qidx, np.full(qp - n_act, qidx[0], qidx.dtype)])
                plan_g, plan_na, pos = plan_g[qsel], plan_na[qsel], pos[qsel]
            qsel_d = None if qsel is None else _to_device(qsel, dev)
            pos_d = _to_device(pos, dev)
            ti_c = ti_d
            if ti_host is not None and qsel is not None:
                ti_c = _to_device(ti_host[qsel].astype(np.int32), dev)

            def part(t, qsel_d=qsel_d, pos_d=pos_d):
                if t is None:
                    return None
                t = t if qsel_d is None else t[qsel_d]
                idx = pos_d.reshape(pos_d.shape + (1,) * (t.dim() - 2))
                return torch.gather(t, 1, idx.expand(
                    pos_d.shape + t.shape[2:]))

            d_c, r_c = self._tiered_pass(
                plane_c, q if qsel_d is None else q[qsel_d],
                _to_device(plan_g, dev), _to_device(plan_na, dev),
                tuple(part(t) for t in (zq, rq, alive, sq)),
                width=min(target, w * cap), **tenant_slice(ch, ti_c),
                **pkw)
            release()
            if qsel_d is not None:    # back to [Q] rows
                rows_q = qsel_d[:n_act]
                d_full = torch.full((q_n, d_c.shape[1]), BIG, device=dev)
                r_full = torch.full((q_n, d_c.shape[1]), -1,
                                    dtype=r_c.dtype, device=dev)
                d_full[rows_q], r_full[rows_q] = d_c[:n_act], r_c[:n_act]
                d_c, r_c = d_full, r_full
            passes.append((d_c, r_c))

        # 3: the all-warm plane's pool, then its tail
        d_p, r_p = self._merge_passes(passes, gids_d, entry["row_grain"],
                                      target, q_n, dev)
        gid_of_row = entry["gid_of_row"]

        def translate(r, d):
            ok = torch.logical_and(r >= 0, d < BIG / 2)
            return torch.where(ok, gid_of_row[torch.clamp(r, min=0).long()],
                               -1).to(torch.int32)

        if mode != "B":
            return translate(r_p[:, :topk_eff], d_p[:, :topk_eff]), \
                d_p[:, :topk_eff]
        raw = self._raw_rows(entry, segments)
        if buckets is None:
            res = _rerank_pool(d_p, r_p, q, raw, pool=target, topk=topk_eff,
                               translate=translate)
            return res.ids, res.dists
        # adaptive: each bucket's share of the pool, re-ranked as the
        # all-warm plane's bucket re-ranks it
        def run(w, sel_d):
            pool_b = min(pool_eff, w * cap)
            pe_b = min(target, pool_b)
            return _rerank_pool(d_p[sel_d, :pe_b], r_p[sel_d, :pe_b],
                                q[sel_d], raw, pool=pe_b,
                                topk=min(topk_eff, pool_b),
                                translate=translate)

        return _bucketed(buckets, q_n, topk_eff, dev, run)

    def _bucket_projection(self, index, q, gids, buckets, qeff):
        """An adaptive plan's projection as the all-warm plane's buckets
        compute it: per bucket (w, queries), ``planner.project_probes``
        over its queries' first w probes, in the same batches, so each
        (query, probe) gets the same bits; gathered into [Q, P] tensors
        (zeros, and keep False, past a query's bucket width)."""
        q_n, p_n = gids.shape
        out = None
        for w, sel in buckets:
            sel_d = _to_device(sel, q.device)
            part = planner.project_probes(index, q[sel_d],
                                          gids[sel_d, :w].contiguous(),
                                          self.cfg.envelope_frac, qeff)
            if out is None:
                out = [None if t is None else
                       t.new_zeros((q_n, p_n) + tuple(t.shape[2:]))
                       for t in part]
            for o, t in zip(out, part):
                if o is not None:
                    o[sel_d, :w] = t
        if out is None:               # no queries
            return planner.project_probes(index, q, gids,
                                          self.cfg.envelope_frac, qeff)
        return tuple(out)

    def _tiered_pass(self, plane, q, gids, n_active, proj, *, width: int,
                     scan_impl, budgets, qeff, tenant_mask=None,
                     tenant_ix=None):
        """One residency pass (the hot mini-plane, or a staged cold chunk)
        over its probe plan and the gathered projection ``proj``: the
        candidate stage on the registered scan plane, cut to its top
        ``width`` by (distance, plan position, slot), ``budgets`` applied
        to this pass alone, the tenant bitmap over the mini-plane's grains
        (``tenant_mask`` [T, n + 1, cap], ``tenant_ix`` [Q]) in its mask.
        A select plane runs one call; a gather plane runs
        ``QUERY_BATCH``-query batches (it copies every probed panel per
        query).  Returns (dists [Q, width], rows [Q, width] with -1 at the
        pruned entries)."""
        index = plane.index
        select = scanplane.get_scan_plane(scan_impl, index.device).kind \
            == scanplane.SELECT
        step = q.shape[0] if select else planner.QUERY_BATCH
        out_d, out_r = [], []
        for lo in range(0, q.shape[0], max(step, 1)):
            sl = slice(lo, lo + step)
            d, r = planner.candidate_stage(
                index, q[sl], gids[sl], envelope_frac=self.cfg.envelope_frac,
                qeff=qeff, width=width, scan_impl=scan_impl, budgets=budgets,
                n_active=None if n_active is None else n_active[sl],
                tenant_mask=tenant_mask,
                tenant_ix=None if tenant_ix is None else tenant_ix[sl],
                proj=tuple(None if t is None else t[sl] for t in proj))
            if not select:
                d, pos = planner._smallest(d, width)
                r = torch.gather(r, 1, pos)
            out_d.append(d)
            out_r.append(torch.where(d < BIG / 2, r, -1))
        return torch.cat(out_d), torch.cat(out_r)

    @staticmethod
    def _merge_passes(passes, gids, row_grain, target: int, q_n: int, dev):
        """The passes' pools merged into the all-warm select's pool: the
        top ``target`` of their union in its key order (distance, plan
        position, slot).  Within a pass candidates of one grain are in slot
        order already, so a stable sort by plan position and then one by
        distance gives that order.  Padded with (BIG, -1) to ``target``."""
        if passes:
            d = torch.cat([p[0] for p in passes], dim=1)
            r = torch.cat([p[1] for p in passes], dim=1)
        else:
            d = torch.full((q_n, 0), BIG, device=dev)
            r = torch.full((q_n, 0), -1, dtype=torch.int32, device=dev)
        grain = row_grain[torch.clamp(r, min=0).long()]
        at = (gids[:, :, None] == grain[:, None, :]).to(torch.uint8) \
            .argmax(dim=1)                                       # [Q, M]
        order = torch.sort(at, dim=1, stable=True).indices
        d, r = torch.gather(d, 1, order), torch.gather(r, 1, order)
        d, order = torch.sort(d, dim=1, stable=True)
        d, r = d[:, :target], torch.gather(r, 1, order)[:, :target]
        pad = target - d.shape[1]
        if pad > 0:
            d = torch.nn.functional.pad(d, (0, pad), value=BIG)
            r = torch.nn.functional.pad(r, (0, pad), value=-1)
        return d, r

    def _search_memtable(self, q, man: Manifest, topk, tag_mask, ts_range,
                         now):
        """Exact scan of the manifest's captured memtable rows (never the
        live memtable: a seal after the snapshot must not change what it
        returns), with its mutation table, TTLs and filters applied.

        Runs on the device in query chunks of at most
        ``MEMTABLE_CHUNK_BYTES`` of differences; filtered rows are masked
        before the top-k so they cannot shadow valid ones."""
        if man.mem_n <= 0:
            return None, None
        keep = np.ones(man.mem_n, bool)
        gids = np.asarray(man.mem_ids[:man.mem_n], np.int64)
        seqs = np.asarray(man.mem_seq[:man.mem_n], np.int64)
        lv = _live_rows(man.mut_gid, man.mut_seq, gids, seqs)
        if lv is not None:
            keep &= lv
        if man.mem_expire:
            keep &= np.asarray(man.mem_expire[:man.mem_n], np.float64) > now
        if tag_mask is not None:
            keep &= (np.asarray(man.mem_tags[:man.mem_n], np.uint32)
                     & np.uint32(tag_mask)) != 0
        if ts_range is not None:
            tsv = np.asarray(man.mem_ts[:man.mem_n], np.float32)
            lo, hi = (np.float32(v) for v in ts_range)
            keep &= (tsv >= lo) & (tsv < hi)
        dev = q.device
        mem = place(np.stack(man.mem[:man.mem_n]), dev)
        keep_t = place(keep, dev)
        kk = min(topk, man.mem_n)
        chunk = max(1, MEMTABLE_CHUNK_BYTES // (mem.numel() * 4))
        pos, dists = [], []
        for lo in range(0, q.shape[0], chunk):
            d_all = (mem[None, :, :] - q[lo:lo + chunk, None, :]).square_() \
                .sum(dim=-1)
            d_all = torch.where(keep_t[None, :], d_all, BIG)
            d_s, order = torch.sort(d_all, dim=1, stable=True)
            dists.append(d_s[:, :kk])
            pos.append(order[:, :kk])
        return place(gids, dev)[torch.cat(pos)], torch.cat(dists)

    # --------------------------------------------------- per-segment loop
    def _seg_live_mask(self, man: Manifest, seg: Segment,
                       now) -> Optional[torch.Tensor]:
        """[G, cap] liveness bitmap of one segment's grain panels (the
        loop's counterpart of the stacked ``live`` leaf), or None."""
        lv = _live_rows(man.mut_gid, man.mut_seq,
                        seg.global_ids(), seg.global_seqs())
        if seg.expire is not None:
            alive_t = seg.expire > now
            if not alive_t.all():
                lv = alive_t if lv is None else lv & alive_t
        if lv is None:
            return None
        ids = seg.index.grains.ids.cpu().numpy()   # local rows, -1 padding
        return torch.from_numpy((ids >= 0) & lv[np.maximum(ids, 0)]).to(
            seg.index.device)

    def _search_looped(self, q, man: Manifest, *, topk, mode, tag_mask,
                       ts_range, scan_impl, now) -> SearchResult:
        """Per-segment loop: one ``index.search`` per segment, the pools
        merged with the memtable's.  The parity oracle of ``search``."""
        all_ids, all_d = [], []
        for seg in man.segments:
            extra, _ = planner._mixed_recall_mask(
                seg.index.grains, tag_mask, ts_range,
                live=self._seg_live_mask(man, seg, now))
            if mode == "B" and seg.index.raw is None:
                # a cold segment: the warm search's pool in Mode A, then
                # the re-rank from its cold file (the same bits)
                g = seg.index.grains
                n_slots = min(self.cfg.nprobe, g.n_grains) * g.cap
                pool_w = min(max(self.cfg.pool, topk), n_slots)
                res = index_mod.search(seg.index, q, self.cfg, topk=pool_w,
                                       mode="A", scan_impl=scan_impl,
                                       extra_mask=extra)
                res = _rerank_pool(
                    res.dists, res.ids, q,
                    _RawRows((seg,), self.device, self._rerank_stats),
                    pool=pool_w, topk=min(topk, n_slots),
                    translate=planner._pruned_to_minus_one)
            else:
                res = index_mod.search(seg.index, q, self.cfg, topk=topk,
                                       mode=mode, scan_impl=scan_impl,
                                       extra_mask=extra)
            all_ids.append(seg.map_local(res.ids))
            all_d.append(res.dists)
        return self._merge_with_memtable(q, man, all_ids, all_d, topk,
                                         tag_mask, ts_range, now)
