"""Multi-tenant serving: a registry of branch tenants and coalesced
retrieval over their union plane.

**TenantRegistry**: one namespace is one ``branch()`` of a shared base
store.  Tenants share the base's sealed segments by reference; private
writes land in the tenant's own memtable, capped by ``memtable_budget``
(overflow force-seals into a private segment, nothing is dropped), and
private deletes and upserts stay in the tenant's own liveness table.  At
most ``max_live`` tenants are hydrated: the least recently used one is
frozen (its memtable sealed, its segment refs and counters kept, no
tensors of its own) and the next access thaws an equivalent store on the
base store's device.  A manifest taken before a freeze stays valid: it
pins its segments.

**coalesced_retrieve**: requests of many tenants that share (mode, topk,
tag_mask, ts_range) run as ONE padded fused dispatch over the registry's
union plane (base + every tenant's private segments, stacked once and
cached in the base store's plane LRU).  A request's tenancy is a row of a
per-query visibility bitmap [T, G, cap] (segment membership, the tenant's
liveness table and TTLs), applied in the scan and in routing's pushdown,
so the hot path never re-stacks and no row crosses tenants.  Each
tenant's rows are then merged with its own memtable scan and finalized
in one call.  Results are ``SearchResult`` s of tensors on the base
store's device.

With ``mesh=`` the union plane is the base store's sharded plane: the
per-tenant bitmaps are built over its permuted rows and placed along the
grain axis, and each group runs as one sharded dispatch.

The JAX package's ``repro.serve.tenancy`` is the reference.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..analysis.sanitize import place
from ..core import index as index_mod
from ..core import routing
from ..core.cascade import check_budgets
from ..core.store import Manifest, VectorStore, _finalize, _live_rows
from ..core.types import BIG, SearchResult

#: Coalesced query batches are padded up to power-of-two buckets of at
#: least this many rows, so a window's shapes come from a small set;
#: padding rows carry tenant 0 and a zero query, and are dropped.
BUCKET = 8


@dataclasses.dataclass
class RetrievalRequest:
    """One tenant-scoped retrieval in flight through the coalescer."""

    rid: int
    tenant: str
    q: np.ndarray                      # [d] f32
    topk: int
    mode: str
    tag_mask: Optional[int] = None
    ts_range: Optional[tuple] = None
    result: Optional[SearchResult] = None   # ids [topk], dists [topk]
    done: bool = False


@dataclasses.dataclass
class _FrozenTenant:
    """An evicted tenant: sealed-segment refs and the store's counters.

    No tensors of its own and no memtable rows (eviction seals first).
    The writer tag and the epochs are kept, so the thawed store continues
    the same (writer, epoch) lineage and cached bitmaps stay coherent."""

    segments: list
    next_id: int
    next_seq: int
    next_seg: int
    live_seq: dict
    epoch: int
    maint_epoch: int
    cold_tag: str


class TenantRegistry:
    """Per-namespace ``branch()`` es of one base store, with budgets.

    base: the shared corpus, sealed here so tenants share segments only.
    memtable_budget: a tenant's memtable row cap (its seal threshold).
    max_live: the LRU bound on hydrated tenant stores.
    """

    def __init__(self, base: VectorStore, *, memtable_budget: int = 1024,
                 max_live: int = 64):
        if memtable_budget < 1:
            raise ValueError("memtable_budget must be >= 1")
        if max_live < 1:
            raise ValueError("max_live must be >= 1")
        base.seal()
        self.base = base
        self.memtable_budget = int(memtable_budget)
        self.max_live = int(max_live)
        self._live: "OrderedDict[str, VectorStore]" = OrderedDict()
        self._frozen: Dict[str, _FrozenTenant] = {}
        # registration order: the union must not follow LRU order, or the
        # union plane's cache key would change every window
        self._order: List[str] = []

    # ------------------------------------------------------------ lifecycle
    def get(self, name: str) -> VectorStore:
        """The tenant's hydrated store (branched or thawed on first use)."""
        st = self._live.get(name)
        if st is not None:
            self._live.move_to_end(name)
            return st
        if name in self._frozen:
            st = self._thaw(self._frozen.pop(name))
        else:
            st = self.base.branch(seal_threshold=self.memtable_budget)
            self._order.append(name)
        self._live[name] = st
        while len(self._live) > self.max_live:
            old, old_st = self._live.popitem(last=False)
            self._frozen[old] = self._freeze(old_st)
        return st

    def evict(self, name: str) -> bool:
        """Freeze a tenant now (session teardown).  Its data survives: the
        memtable is sealed and the next ``get`` thaws it.  False for an
        unknown or already frozen tenant."""
        st = self._live.pop(name, None)
        if st is None:
            return False
        self._frozen[name] = self._freeze(st)
        return True

    @staticmethod
    def _freeze(st: VectorStore) -> _FrozenTenant:
        st.seal()
        return _FrozenTenant(
            segments=list(st._segments), next_id=st._next_id,
            next_seq=st._next_seq, next_seg=st._next_seg,
            live_seq=dict(st._live_seq), epoch=st._epoch,
            maint_epoch=st._maint_epoch, cold_tag=st._cold_tag)

    def _thaw(self, fz: _FrozenTenant) -> VectorStore:
        b = self.base
        st = VectorStore(b.cfg, seal_threshold=self.memtable_budget,
                         clock=b._clock, device=b.device,
                         cold_tier=b.cold_tier, cold_dir=b._cold_dir,
                         device_budget=b.device_budget,
                         residency_interval=b.residency_interval,
                         prefetch_grains=b.prefetch_grains)
        st._segments = list(fz.segments)
        st._next_id = fz.next_id
        st._next_seq = fz.next_seq
        st._next_seg = fz.next_seg
        st._live_seq = dict(fz.live_seq)
        st._epoch = fz.epoch
        st._maint_epoch = fz.maint_epoch
        st._cold_tag = fz.cold_tag      # the same writer: cache keys go on
        return st

    def tenants(self) -> tuple:
        """Every registered namespace, in registration order."""
        return tuple(self._order)

    @property
    def n_live(self) -> int:
        return len(self._live)

    # -------------------------------------------------------- serving plane
    def union_segments(self) -> tuple:
        """Base + every tenant's private segments, deduplicated by identity
        in registration order: the coalesced plane's segment set.  It
        changes only when a tenant seals (or maintenance swaps a tuple), so
        the stacked plane in the base store's LRU serves every window."""
        segs, seen = [], set()
        for name in [None] + self._order:
            if name is None:
                slist = self.base._segments
            elif name in self._live:
                slist = self._live[name]._segments
            else:
                slist = self._frozen[name].segments
            for s in slist:
                if id(s) not in seen:
                    seen.add(id(s))
                    segs.append(s)
        return tuple(segs)

    def run_maintenance(self, now: Optional[float] = None, *,
                        compact_fanin: Optional[int] = None) -> dict:
        """Plane upkeep off the serving path: each live tenant's
        ``compact`` (with ``compact_fanin``) or ``maintain``, through the
        usual manifest swap, so in-flight manifests keep their segments and
        the next window re-stacks the union once.  Returns {tenant:
        segments maintain() changed} (0 after a compaction)."""
        out = {}
        for name, st in list(self._live.items()):
            if compact_fanin is not None:
                st.compact(fanin=compact_fanin, now=now)
                out[name] = 0
            else:
                rep = st.maintain(now=now)
                out[name] = sum(1 for r in rep.segments if not r.unchanged)
        return out

    # ------------------------------------------------- per-tenant bitmaps
    @staticmethod
    def _visible_rows(entry: dict, union: tuple, man: Manifest,
                      now: float) -> np.ndarray:
        """[rows] bool over the union plane's rows (flat, or permuted on a
        sharded plane): the manifest's segments, its liveness table and
        TTLs."""
        mine = {id(s) for s in man.segments}
        offs = entry["offsets"]
        vis = np.zeros(int(offs[-1]), bool)
        for si, seg in enumerate(union):
            if id(seg) in mine:
                vis[offs[si]:offs[si + 1]] = True
        if entry["row_base"] is not None:        # sharded layout: permute
            perm = entry["perm"]
            vis = np.where(perm >= 0, vis[np.maximum(perm, 0)], False)
        lv = _live_rows(man.mut_gid, man.mut_seq, entry["row_gid"],
                        entry["row_seq"])
        if lv is not None:
            vis &= lv
        if entry["row_exp"] is not None:
            vis &= entry["row_exp"] > now
        return vis

    def _tenant_bitmap(self, entry: dict, union: tuple, man: Manifest,
                       now: float) -> np.ndarray:
        """[G, cap] host bitmap of the union plane slots one tenant sees,
        cached in the plane entry per (writer, epoch, segments, and ``now``
        when rows carry a TTL).  Membership is by row range, so gids that
        two tenants both wrote never collide.  The entry pins the union's
        segments, so keys of ``id(s)`` stay valid."""
        has_ttl = entry["row_exp"] is not None
        key = (man.writer, man.epoch, tuple(id(s) for s in man.segments),
               now if has_ttl else None)
        cache = entry.setdefault("tenant_bm", OrderedDict())
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            return hit
        ok = self._visible_rows(entry, union, man, now)
        ids = np.asarray(entry["ids_host"])
        rows = ids.astype(np.int64)
        if entry["row_base"] is not None:        # shard-local -> permuted
            rows = rows + entry["row_base"][:, None]
        bm = (ids >= 0) & ok[np.maximum(rows, 0)]
        cache[key] = bm
        while len(cache) > 4 * self.max_live:
            cache.popitem(last=False)
        return bm


def pad_rows(n: int) -> int:
    """Rows of a coalesced batch of n requests: the next power of two of
    at least ``BUCKET``."""
    b = BUCKET
    while b < n:
        b *= 2
    return b


def coalesced_retrieve(registry: TenantRegistry,
                       requests: List[RetrievalRequest], *,
                       mesh=None, grain_axis: str = "model",
                       scan_impl: Optional[str] = None,
                       budgets: Optional[tuple] = None,
                       nprobe: Optional[int] = None,
                       pool: Optional[int] = None,
                       adaptive: bool = False,
                       probe_margin: Optional[float] = None,
                       min_probes: Optional[int] = None,
                       now: Optional[float] = None
                       ) -> List[RetrievalRequest]:
    """Serve many tenants' retrievals with one dispatch per (mode, topk,
    tag_mask, ts_range) group.

    A group runs as one padded ``_search_segments_fused`` call over the
    registry's union plane with the per-query tenant bitmap; a request's
    routing, scan, pool and epilogue are its own, so the other requests of
    its batch change nothing but the batch's shape.  Each request's pool
    is merged with its tenant's memtable scan and finalized to [topk];
    the result lands on ``req.result`` with ``req.done = True``.

    budgets: (b1, b2) of a staged ``scan_impl`` (the cascade), checked
      against each request's topk.
    adaptive / probe_margin / min_probes: as in ``VectorStore.search``
      (None: the base config's knobs); the stopping rule runs on each
      query's tenant-masked routing pass.
    mesh / grain_axis: run every group on the base store's sharded plane
      of the union (``VectorStore.search(mesh=)``'s per-shard knobs); the
      mesh's slots must be devices of the base store's kind.
    """
    base = registry.base
    if mesh is not None:
        from ..distributed import sharding as shd
        shd.search_plane_rules(mesh, grain_axis=grain_axis)
        shd.check_mesh_devices(mesh, base.device)
        if base.device_budget is not None:
            raise ValueError(
                "device_budget= (tiered residency) is single-device; the "
                "sharded plane (mesh=) keeps every shard resident: drop "
                "one of the two")
    now = base._clock() if now is None else now
    if budgets is not None:
        for r in requests:
            check_budgets(budgets, r.topk)
    routing.check_probe_args(adaptive, probe_margin, min_probes)
    margin = (base.cfg.probe_margin if probe_margin is None
              else float(probe_margin))
    minp = base.cfg.min_probes if min_probes is None else int(min_probes)
    groups: "OrderedDict[tuple, List[RetrievalRequest]]" = OrderedDict()
    for r in requests:
        groups.setdefault((r.mode, r.topk, r.tag_mask, r.ts_range),
                          []).append(r)
    # Snapshot every tenant of the window BEFORE the union: hydrating one
    # tenant can freeze another, which seals its memtable into a new
    # segment; a snapshot taken after the union could name a segment the
    # union lacks.
    mans: Dict[str, Manifest] = {}
    for r in requests:
        if r.tenant not in mans:
            mans[r.tenant] = registry.get(r.tenant).snapshot()
    union = registry.union_segments()
    with index_mod.full_fp32_matmul():
        for (mode, topk, tag_mask, ts_range), reqs in groups.items():
            _dispatch_group(registry, union, reqs, mans, mode=mode,
                            topk=topk, tag_mask=tag_mask, ts_range=ts_range,
                            scan_impl=scan_impl, budgets=budgets,
                            nprobe=nprobe, pool=pool, now=now,
                            adaptive=adaptive and not math.isinf(margin),
                            probe_margin=margin, min_probes=minp,
                            mesh=mesh, grain_axis=grain_axis)
    return requests


def _dispatch_group(registry: TenantRegistry, union: tuple,
                    reqs: List[RetrievalRequest],
                    mans: Dict[str, Manifest], *, mode: str, topk: int,
                    tag_mask, ts_range, scan_impl, budgets, nprobe, pool,
                    now: float, adaptive: bool, probe_margin: float,
                    min_probes: int, mesh=None,
                    grain_axis: str = "model") -> None:
    base = registry.base
    dev = base.device
    names: List[str] = []
    rows_of: Dict[str, List[int]] = {}
    for i, r in enumerate(reqs):
        if r.tenant not in rows_of:
            names.append(r.tenant)
            rows_of[r.tenant] = []
        rows_of[r.tenant].append(i)
    n = len(reqs)
    qp = pad_rows(n) if union else n
    q_host = np.zeros((qp, base.cfg.d), np.float32)
    q_host[:n] = np.stack([np.asarray(r.q, np.float32) for r in reqs])
    q = place(q_host, dev)

    seg = None
    if union:
        tix = np.zeros(qp, np.int32)
        for t, name in enumerate(names):
            tix[rows_of[name]] = t
        man_u = Manifest(segments=union, mem_n=0, writer="<registry>")
        kw = dict(topk=topk, mode=mode, tag_mask=tag_mask,
                  ts_range=ts_range, scan_impl=scan_impl, budgets=budgets,
                  nprobe=nprobe, pool=pool, now=now, adaptive=adaptive,
                  probe_margin=probe_margin, min_probes=min_probes,
                  tenant_ix=tix)
        if mesh is not None:
            entry = base._sharded_for(union, mesh, grain_axis)
            tl = np.stack([registry._tenant_bitmap(entry, union, mans[name],
                                                   now) for name in names])
            ids, d = base._search_segments_sharded(
                q, man_u, mesh=mesh, grain_axis=grain_axis,
                shard_queries=False, tenant_live=tl, **kw)
        else:
            # under a device_budget the union plane is the tiered entry:
            # its host id panels give the same bitmaps, and the fused
            # dispatch pages through it
            entry = base._plane_entry_for(union)
            tl = np.stack([registry._tenant_bitmap(entry, union, mans[name],
                                                   now) for name in names])
            ids, d = base._search_segments_fused(
                q, man_u, route_mode="global", tenant_live=tl, **kw)
        seg = (ids[:n].long(), d[:n])

    # each tenant's rows: its memtable scan, then one finalize
    for name in names:
        rows = rows_of[name]
        sel = place(np.asarray(rows, np.int64), dev)
        parts_i, parts_d = [], []
        if seg is not None:
            parts_i.append(seg[0][sel])
            parts_d.append(seg[1][sel])
        m_ids, m_d = base._search_memtable(q[sel], mans[name], topk,
                                           tag_mask, ts_range, now)
        if m_ids is not None:
            parts_i.append(m_ids)
            parts_d.append(m_d)
        if parts_i:
            res = _finalize(torch.cat(parts_i, dim=1),
                            torch.cat(parts_d, dim=1), topk)
        else:                                   # an empty store
            res = SearchResult(
                ids=torch.full((len(rows), topk), -1, dtype=torch.int32,
                               device=dev),
                dists=torch.full((len(rows), topk), BIG, device=dev))
        for j, i in enumerate(rows):
            reqs[i].result = SearchResult(ids=res.ids[j], dists=res.dists[j])
            reqs[i].done = True
