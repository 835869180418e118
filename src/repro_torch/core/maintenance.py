"""Grain maintenance: split, merge, retire and refit under churn.

Grains are built locally coherent: routing assumes the centroid is where
the members are, and the quantized tangent-local distances assume the
PCA frame spans the members' local structure.  Deletes and upsert
shadowing carve survivors out of sealed grains; their mean walks off the
frozen centroid and the frame keeps spending its k dimensions on
structure that is gone.  Searches stay exact under exhaustive knobs, but
at production knobs recall rots.  This module is the repair plane.  Per
sealed segment it computes per-grain health from the store's liveness
and the raw tier:

- **overfull**: live occupancy far above the segment's per-grain target.
  Repair: *split* by deterministic 2-means over the live members
  (``kmeans.two_means``), growing the grain axis.
- **underfull**: live occupancy far below the grain's built rows.
  Repair: *merge* the live members into the nearest grain with room
  (``routing.merge_target``); all-dead grains retire, and a segment
  whose every row is dead is dropped.
- **stale**: the frame's captured energy over the live rows
  (``pca.captured_fraction``) falls measurably below the best any
  rank-(k+s) frame could capture (``pca.best_captured_fraction``), or the
  live mean walked off the centroid.  Repair: *refit* the group in place
  (new mean, local PCA, both quantizer scales, re-encode).

Rewrite discipline: only touched groups are re-encoded; every untouched
grain's panel rows, routing row and scales are copied bit-identical, and
an all-healthy segment comes back by identity (no plane re-stack).  The
raw tier is never rewritten: dead raw rows are reclaimed by
``VectorStore.compact``.  One maintenance epoch replaces the store's
segment tuple once, so the plane cache re-stacks at most once per epoch.

The JAX package's ``repro.core.maintenance`` is the reference.  The
health statistics and the re-encode run on the segment's device, in
grain chunks of at most ``GATHER_CHUNK_BYTES`` of gathered rows (a cold
segment's rows are read from its memmap and copied over chunk by
chunk, ``raw_rows``); the plan
(``_plan_segment``), the 2-means split and the merge-target choice run on
the host in numpy, fed the statistics copied back, so equal statistics
give equal plans.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import index as index_mod
from . import kmeans as km
from . import layout, pca, quantize, routing
from .types import GrainStore, HNTLConfig, HNTLIndex

#: Device bytes of the [grains, cap, d] member rows gathered at once from
#: the raw tier for the health statistics and the re-encode (512 grains of
#: cap 1664 at d=768 would be 2.6 GB at once).
GATHER_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class MaintenancePolicy:
    """Health thresholds for the maintenance plane.

    target = live rows / grains of the segment; all ratios are against it.
    """

    underfull_frac: float = 0.25   # live < frac * built rows -> merge
    overfull_ratio: float = 2.0    # live > ratio * target -> split
    stale_ratio: float = 0.90      # captured < ratio * refit bound -> stale
    stale_margin: float = 0.01     # plus an absolute gap (no fp-noise refits)
    # ||live mean - frozen centroid||^2 > ratio * live variance -> stale:
    # deletes that shift the survivors' mean along the frame's own span
    # leave the captured fraction fine but the centroid misplaced.
    drift_ratio: float = 0.25
    min_split_rows: Optional[int] = None   # default 2 * cfg.block
    min_refit_rows: int = 4        # don't judge a frame on fewer live rows


@dataclasses.dataclass
class SegmentReport:
    """What maintenance did to one segment."""

    seg_id: int
    changed: bool
    dropped: bool = False          # every row dead -> segment removed
    grains_before: int = 0
    grains_after: int = 0
    splits: int = 0                # grains bisected (each adds one grain)
    merges: int = 0                # underfull grains folded into another
    retires: int = 0               # all-dead grains removed
    refits: int = 0                # re-encoded groups (split and merge
    #                                targets included)
    unchanged: tuple = ()          # (old_gi, new_gi) pairs copied verbatim
    slots_preserved: bool = True   # no membership moved (refit-only epoch)


@dataclasses.dataclass
class MaintenanceReport:
    """Aggregate over all sealed segments of one ``store.maintain()``."""

    segments: tuple = ()

    @property
    def changed(self) -> bool:
        return any(s.changed for s in self.segments)

    def total(self, field: str) -> int:
        return sum(getattr(s, field) for s in self.segments)

    def summary(self) -> str:
        return (f"splits={self.total('splits')} merges={self.total('merges')}"
                f" retires={self.total('retires')}"
                f" refits={self.total('refits')} dropped_segments="
                f"{sum(s.dropped for s in self.segments)}")


def raw_rows(seg):
    """``rows`` (host int array, any shape) -> the raw vectors [..., d] f32
    of those local rows on the segment's device: gathered on the device
    from a warm segment's raw tier, or read from a cold segment's memmap
    and copied over."""
    dev = seg.index.device
    if seg.index.raw is not None:
        x = seg.index.raw
        return lambda rows: x[torch.from_numpy(
            np.asarray(rows, np.int64)).to(dev)]
    mm = seg.raw_vectors()

    def gather(rows):
        r = np.asarray(rows, np.int64)
        return torch.from_numpy(np.take(mm, r.reshape(-1), axis=0).reshape(
            *r.shape, mm.shape[1])).to(dev)
    return gather


def _occupancy_stats(seg, live_rows: Optional[np.ndarray]) -> dict:
    """The cheap half of the health stats: panel occupancy only (host
    copies of the id and valid panels; no raw-tier read)."""
    g = seg.index.grains
    ids = g.ids.cpu().numpy()
    valid = g.valid.cpu().numpy()
    live_panel = valid & (ids >= 0)
    if live_rows is not None:
        live_panel &= np.asarray(live_rows, bool)[np.maximum(ids, 0)]
    return dict(ids=ids, valid=valid, live_panel=live_panel,
                live_cnt=live_panel.sum(axis=1))


def _pristine_stats(seg, occ: dict) -> dict:
    """Stats of a segment with no dead rows: every frame is in its build or
    refit state, so captured == best and drift == 0 by construction.  Only
    the occupancy signals can fire; if they do, the caller computes the
    full stats before acting."""
    g_n = occ["valid"].shape[0]
    return occ | dict(captured=np.ones(g_n, np.float32),
                      best=np.ones(g_n, np.float32),
                      drift2=np.zeros(g_n, np.float32),
                      var_live=np.ones(g_n, np.float32),
                      live_mean=np.zeros(
                          (g_n, seg.index.grains.mu.shape[1]), np.float32))


def grain_stats(seg, live_rows: Optional[np.ndarray]) -> dict:
    """Per-grain live stats of one sealed segment.

    Computed on the segment's device in grain chunks of at most
    ``GATHER_CHUNK_BYTES`` of gathered [chunk, cap, d] rows, reduced to
    [G] and [G, d] per chunk and copied to the host.  live_rows: [n] bool
    per raw row (None = all live).  Returns numpy ``live_panel`` [G, cap],
    ``live_cnt`` [G], ``captured`` [G] (existing frame, live-mean
    centred), ``best`` [G] (refit bound), ``live_mean`` [G, d],
    ``drift2`` [G], ``var_live`` [G], and ``raw``, the segment's
    ``raw_rows`` (for reuse).
    """
    g = seg.index.grains
    occ = _occupancy_stats(seg, live_rows)
    raw = raw_rows(seg)
    g_n, cap = occ["ids"].shape
    rows = np.maximum(occ["ids"], 0)
    live = torch.from_numpy(occ["live_panel"]).to(g.mu.device)
    s = g.sketch_basis.shape[2] if g.sketch_basis is not None else 0
    chunk = max(1, GATHER_CHUNK_BYTES // (cap * g.mu.shape[1] * 4))
    parts = []
    with index_mod.full_fp32_matmul():
        for lo in range(0, g_n, chunk):
            sl = slice(lo, lo + chunk)
            xg, m = raw(rows[sl]), live[sl]                # [c, cap, d]
            captured, mean = pca.captured_fraction(
                xg, m, g.basis[sl], g.sketch_basis[sl] if s else None)
            best = pca.best_captured_fraction(xg, m, g.k, s)
            drift2 = torch.sum((mean - g.mu[sl]) ** 2, dim=1)
            w = m[..., None].to(xg.dtype)
            spread = torch.sum(((xg - mean[:, None, :]) * w) ** 2,
                               dim=(1, 2))
            parts.append((captured, best, mean, drift2, spread))
    captured, best, mean, drift2, spread = (
        torch.cat(p).cpu().numpy() for p in zip(*parts))
    # routing health: how far the live mean walked off the frozen centroid,
    # against the survivors' own spread (float64, as numpy's int divide)
    return occ | dict(captured=captured, best=best, live_mean=mean,
                      drift2=drift2,
                      var_live=spread / np.maximum(occ["live_cnt"], 1),
                      raw=raw)


def _encode_groups(xm, valid, fit, *, k: int, s: int, qeff: int,
                   quantile: float, mult: float, bit_alloc: str = "fixed",
                   captured_min: float = 0.85, min_rows: int = 8) -> dict:
    """Re-encode a batch of grain groups with the build's per-grain math
    (same PCA, scale fitters and quantizers as ``index.build``).

    xm [T, cap, d]: member rows (zeros at invalid slots); valid [T, cap]:
    slots physically present; fit [T, cap]: the slots the frame and the
    scales are fit on (the live subset: dead slots are re-encoded under
    the new frame so they stay addressable, but never steer it).

    bit_alloc="density" re-tiers each group's stored width from its fresh
    fit (``quantize.assign_grain_qmax`` as at build); "fixed" keeps
    ``qeff``.  ``out["qmaxg"]`` records the decision either way.
    """
    w = fit.to(xm.dtype)
    cnt = torch.clamp(w.sum(dim=1), min=1.0)                    # [T]
    mu = (xm * w[..., None]).sum(dim=1) / cnt[:, None]          # [T, d]
    xc = (xm - mu[:, None, :]) * valid[..., None]               # [T, cap, d]
    basis, sketch_basis, var = pca.grain_pca(xc, fit, k, s)
    z = xc @ basis                                              # [T, cap, k]
    if bit_alloc == "density":
        qm = quantize.assign_grain_qmax(var, cnt, captured_min=captured_min,
                                        min_rows=min_rows)
    else:
        qm = torch.full(var.shape, qeff, dtype=torch.int32,
                        device=xm.device)
    scale = quantize.fit_scale(z, fit, qmax=qm.to(xm.dtype),
                               quantile=quantile, mult=mult)
    zq = quantize.quantize_coords(z, scale[:, None, None],
                                  qmax=qm[:, None, None])
    vc2 = torch.sum(xc * xc, dim=-1)
    r = torch.clamp(vc2 - torch.sum(z * z, dim=-1), min=0.0)
    out = dict(mu=mu, basis=basis, scale=scale, var=var, qmaxg=qm,
               coords=zq.transpose(1, 2).contiguous())
    if s > 0:
        s_coords = xc @ sketch_basis
        r = torch.clamp(r - torch.sum(s_coords * s_coords, dim=-1), min=0.0)
        sk_scale = quantize.fit_scale(s_coords, fit, qmax=127,
                                      quantile=quantile, mult=mult)
        sq = quantize.quantize_coords(s_coords, sk_scale[:, None, None],
                                      qmax=127).to(torch.int8)
        out["sketch"] = sq.transpose(1, 2).contiguous()
        out["sketch_basis"] = sketch_basis
        out["sketch_scale"] = sk_scale
    res_scale = quantize.fit_res_scale(r, fit)
    out["res_scale"] = res_scale
    out["res"] = quantize.quantize_residual(r, res_scale[:, None])
    return out


def _plan_segment(stats: dict, cfg: HNTLConfig, policy: MaintenancePolicy):
    """Per-grain actions from the health stats (host numpy).

    Returns (actions [G] str in {keep, refit, split, merge, retire},
    merge_dst [G] int, target float).  ``merge`` means "fold my live rows
    into merge_dst and retire me"; the dst becomes a re-encoded group.
    """
    live_cnt = stats["live_cnt"].astype(np.int64)
    built_cnt = stats["valid"].sum(axis=1).astype(np.int64)  # physical rows
    g_n = len(live_cnt)
    total_live = int(live_cnt.sum())
    # two occupancy scales: what a grain holds now (the live mean, the
    # hotspot scale for splits) and what the layout was built for (the
    # physical mean, the scale a husk is judged against)
    live_target = max(total_live / max(g_n, 1), 1.0)
    built_target = max(float(built_cnt.sum()) / max(g_n, 1), 1.0)
    target = max(live_target, built_target)
    min_split = (policy.min_split_rows if policy.min_split_rows is not None
                 else 2 * cfg.block)

    actions = np.full(g_n, "keep", dtype=object)
    merge_dst = np.full(g_n, -1, np.int64)

    frame_stale = ((stats["best"] - stats["captured"] > policy.stale_margin)
                   & (stats["captured"]
                      < policy.stale_ratio * stats["best"]))
    centroid_stale = (stats["drift2"]
                      > policy.drift_ratio * stats["var_live"] + 1e-8)
    stale = ((frame_stale | centroid_stale)
             & (live_cnt >= policy.min_refit_rows))
    actions[stale] = "refit"
    actions[live_cnt == 0] = "retire"
    overfull = ((live_cnt > policy.overfull_ratio * target)
                & (live_cnt >= min_split))
    actions[overfull] = "split"

    # Underfull husks (grains that lost most of their own built rows) fold
    # into the nearest grain with room, smallest first.  A grain chosen as
    # a dst stays a dst; split, retired and merged grains are never
    # targets.  The merged size is capped at min_split - 1 as well, so no
    # merge makes a grain the next epoch would split.
    cap = stats["valid"].shape[1]
    cur_cnt = live_cnt.copy()
    underfull = np.flatnonzero(
        (live_cnt > 0) & (live_cnt < policy.underfull_frac * built_cnt))
    limit = max(int(policy.overfull_ratio * target), int(min_split) - 1)
    dsts: set = set()
    for src in underfull[np.argsort(live_cnt[underfull], kind="stable")]:
        if int(src) in dsts:               # already grew: no merge chains
            continue
        excluded = [gi for gi in range(g_n)
                    if actions[gi] in ("retire", "split", "merge")]
        dst = routing.merge_target(stats["live_mean"], cur_cnt, cap,
                                   int(src), excluded=excluded,
                                   max_merged=limit)
        if dst < 0:
            continue                       # nowhere with room: leave as-is
        actions[src] = "merge"
        merge_dst[src] = dst
        dsts.add(dst)
        cur_cnt[dst] += cur_cnt[src]
        cur_cnt[src] = 0
    return actions, merge_dst, target


def _split(raw, mem: np.ndarray) -> np.ndarray:
    """Which half (0/1) each member of an overfull grain goes to: 2-means
    on the host over the members' raw rows (``raw``: ``raw_rows``);
    identical members hand their farthest half over instead."""
    xs = raw(mem).cpu().numpy()
    _, half = km.two_means(xs)
    if not (half == 0).any() or not (half == 1).any():
        d2 = np.sum((xs - xs.mean(0)) ** 2, axis=1)
        half = np.zeros(len(mem), np.int64)
        half[km.steal_rows(d2, len(mem) // 2)] = 1
    return half


def maintain_segment(seg, live_rows: Optional[np.ndarray], cfg: HNTLConfig,
                     policy: MaintenancePolicy, qeff: int):
    """Repair one sealed segment.  Returns (new_segment, SegmentReport).

    new_segment is ``seg`` itself when every grain is healthy, None when
    every row is dead (the caller drops the segment), else a new Segment
    sharing the raw tier and id tables, with only the touched groups
    re-encoded.
    """
    g = seg.index.grains
    g_n, cap = g.n_grains, g.cap
    rep = SegmentReport(seg_id=seg.seg_id, changed=False,
                        grains_before=g_n, grains_after=g_n)
    if live_rows is None:
        # no dead rows: only occupancy signals can fire, so plan on the
        # cheap stats (no raw-tier read, no eigendecomposition)
        stats = _pristine_stats(seg, _occupancy_stats(seg, None))
    else:
        stats = grain_stats(seg, live_rows)
    if int(stats["live_cnt"].sum()) == 0:
        rep.changed = rep.dropped = True
        rep.retires, rep.grains_after = g_n, 0
        rep.slots_preserved = False
        return None, rep

    actions, merge_dst, _ = _plan_segment(stats, cfg, policy)
    if (actions == "keep").all():
        rep.unchanged = tuple((gi, gi) for gi in range(g_n))
        return seg, rep                    # identity: no re-stack
    if "raw" not in stats:                 # the pristine plan wants repairs
        stats = grain_stats(seg, live_rows)
        actions, merge_dst, _ = _plan_segment(stats, cfg, policy)
        if (actions == "keep").all():      # (only through fp margins)
            rep.unchanged = tuple((gi, gi) for gi in range(g_n))
            return seg, rep

    ids, valid, live_panel = stats["ids"], stats["valid"], stats["live_panel"]
    raw = stats["raw"]
    live_members = [ids[gi][live_panel[gi]].astype(np.int64)
                    for gi in range(g_n)]
    for src in np.flatnonzero(actions == "merge"):
        live_members[merge_dst[src]] = np.concatenate(
            [live_members[merge_dst[src]], live_members[src]])

    # ---- final grain order: originals in place, split halves appended ----
    # entries: ("copy", gi) | ("refit", gi) | ("pack", gi, member_rows)
    entries, appends = [], []
    dsts = set(int(dd) for dd in merge_dst[merge_dst >= 0])
    for gi in range(g_n):
        act = actions[gi]
        if act in ("retire", "merge"):
            rep.retires += act == "retire"
            rep.merges += act == "merge"
            continue
        if gi in dsts:                     # a merge target: repack + refit
            entries.append(("pack", gi, live_members[gi]))
            rep.refits += 1
        elif act == "keep":
            entries.append(("copy", gi))
        elif act == "refit":
            entries.append(("refit", gi))
            rep.refits += 1
        else:                              # split
            mem = live_members[gi]
            half = _split(raw, mem)
            entries.append(("pack", gi, mem[half == 0]))
            appends.append(("pack", gi, mem[half == 1]))
            rep.splits += 1
            rep.refits += 2
    entries += appends
    rep.slots_preserved = not appends and len(entries) == g_n and all(
        e[0] != "pack" for e in entries)

    # ---- batched re-encode of every touched group, on the device ---------
    touched = [e for e in entries if e[0] != "copy"]
    panels = {}
    if touched:
        t_ids = np.full((len(touched), cap), -1, np.int32)
        t_valid = np.zeros((len(touched), cap), bool)
        t_fit = np.zeros((len(touched), cap), bool)
        pack_idx = [i for i, e in enumerate(touched) if e[0] == "pack"]
        if pack_idx:
            p_ids, p_valid = layout.pack_members(
                [touched[i][2] for i in pack_idx], cap)
            t_ids[pack_idx], t_valid[pack_idx] = p_ids, p_valid
            t_fit[pack_idx] = p_valid      # packed rows are all live
        for i, e in enumerate(touched):
            if e[0] == "refit":            # keep the slot layout, fit on live
                gi = e[1]
                t_ids[i], t_valid[i], t_fit[i] = \
                    ids[gi], valid[gi], live_panel[gi]
        dev = g.mu.device
        rows = np.maximum(t_ids, 0)
        valid_t = torch.from_numpy(t_valid).to(dev)
        fit_t = torch.from_numpy(t_fit).to(dev)
        chunk = max(1, GATHER_CHUNK_BYTES // (cap * g.mu.shape[1] * 4))
        encs = []
        with index_mod.full_fp32_matmul():
            for lo in range(0, len(touched), chunk):
                sl = slice(lo, lo + chunk)
                xm = torch.where(valid_t[sl, :, None], raw(rows[sl]), 0.0)
                encs.append(_encode_groups(
                    xm, valid_t[sl], fit_t[sl], k=cfg.k, s=cfg.s, qeff=qeff,
                    quantile=cfg.scale_quantile, mult=cfg.scale_mult,
                    bit_alloc=cfg.bit_alloc,
                    captured_min=cfg.int4_captured_min,
                    min_rows=cfg.int4_min_rows))
        panels = {name: torch.cat([e[name] for e in encs]) for name in encs[0]}
        panels["ids"], panels["valid"], panels["fit"] = t_ids, t_valid, t_fit

    new_seg = _assemble_segment(seg, entries, panels, rep)
    rep.changed = True
    rep.grains_after = len(entries)
    return new_seg, rep


def _assemble_segment(seg, entries, panels, rep: SegmentReport):
    """The final grain tensors, on the segment's device: untouched rows
    gathered bit-identical from the old panels, touched rows from the
    batched re-encode."""
    g = seg.index.grains
    dev = g.coords.device
    copies = [(i, e[1]) for i, e in enumerate(entries) if e[0] == "copy"]
    touched = [(i, e) for i, e in enumerate(entries) if e[0] != "copy"]
    rep.unchanged = tuple((gi, new_gi) for new_gi, gi in copies)

    def index_of(v):
        return torch.tensor(v, dtype=torch.long, device=dev)

    new_copy = index_of([i for i, _ in copies])
    old_copy = index_of([gi for _, gi in copies])
    new_touch = index_of([i for i, _ in touched])

    def assemble(old, fill, enc):
        """[len(entries), ...]: copied rows from ``old``, touched rows from
        ``enc`` (None where the segment has no such leaf)."""
        if old is None:
            return None
        out = old.new_full((len(entries), *old.shape[1:]), fill)
        out[new_copy] = old[old_copy]
        if touched:
            out[new_touch] = enc.to(device=dev, dtype=old.dtype)
        return out

    def host(name):
        return torch.from_numpy(np.ascontiguousarray(panels[name])) \
            if touched else None

    # per-slot tags/ts of touched groups: a refit keeps its slot layout (its
    # old rows), a packed group re-scatters from the segment's raw rows
    row_fields = {}
    for name, table in (("tags", seg.tags), ("ts", seg.ts)):
        old = getattr(g, name)
        if old is None or not touched:
            row_fields[name] = None
            continue
        t_ids, t_valid = panels["ids"], panels["valid"]
        src = (np.asarray(table)[np.maximum(t_ids, 0)] if table is not None
               else np.zeros(t_ids.shape))
        vals = torch.from_numpy(np.where(t_valid, src, 0).astype(
            np.int64 if name == "tags" else np.float32)).to(dev)
        for ti, (_, e) in enumerate(touched):
            if e[0] == "refit":
                vals[ti] = old[e[1]]
        row_fields[name] = vals

    sizes_touched = (torch.from_numpy(panels["fit"].sum(axis=1))
                     if touched else None)
    grains = GrainStore(
        coords=assemble(g.coords, 0, panels.get("coords")),
        res=assemble(g.res, 0, panels.get("res")),
        sketch=assemble(g.sketch, 0, panels.get("sketch")),
        ids=assemble(g.ids, -1, host("ids")),
        valid=assemble(g.valid, False, host("valid")),
        basis=assemble(g.basis, 0.0, panels.get("basis")),
        mu=assemble(g.mu, 0.0, panels.get("mu")),
        scale=assemble(g.scale, 1.0, panels.get("scale")),
        res_scale=assemble(g.res_scale, 1.0, panels.get("res_scale")),
        sketch_basis=assemble(g.sketch_basis, 0.0,
                              panels.get("sketch_basis")),
        sketch_scale=assemble(g.sketch_scale, 1.0,
                              panels.get("sketch_scale")),
        tags=assemble(g.tags, 0, row_fields["tags"]),
        ts=assemble(g.ts, 0.0, row_fields["ts"]),
        qmaxg=assemble(g.qmaxg, 1, panels.get("qmaxg")))
    index = HNTLIndex(
        routing=routing.rebuild_plane(
            grains.mu, assemble(seg.index.routing.sizes, 0, sizes_touched)),
        grains=grains,
        raw=seg.index.raw)   # the raw tier (or cold file) is never rewritten
    return dataclasses.replace(seg, index=index)
