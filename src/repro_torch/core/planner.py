"""Dual-mode query planner (paper §2.1, §2.3).

Pipeline per query batch:
  (1) centroid routing (top-P grains),
  (2) per-grain tangent projection of the query + quantization envelope
      filter,
  (3) Block-SoA scan of the surviving grains (a ScanPlane backend),
  (4) Mode A: top-k straight from the approximate distances;
      Mode B: gather raw vectors for the C-pool and re-rank exactly in f32.

Queries run in batches of ``QUERY_BATCH``: the projection gathers one
[d, k] basis per (query, probe), [Q, P, d, k] in all, which at Q=1024,
P=16, d=768, k=32 would be 1.6 GB (plus 0.4 GB of sketch basis) at once.
Every stage is row-wise in the queries, so batching changes no result.
Every top-k is a stable sort: ties go to the lower position, as with
``jax.lax.top_k``.

``search`` runs one index; ``search_stacked`` runs a store's sealed
segments fused into one ``StackedSegments`` plane, with the tag/ts
predicates and the store's liveness bitmap evaluated in the scan and
pushed down into routing.  Both end in ``_candidate_epilogue``.

Tenancy (the coalesced serving plane of ``serve.tenancy``): a per-query
visibility bitmap ``tenant_live`` [T, G, cap] + ``tenant_ix`` [Q] joins
the slot predicate in the candidate stage and, any-reduced per grain, the
routing pushdown ([Q, G], ``_tenant_grain_mask``).

``search_stacked_sharded`` runs the same pipeline per shard of a
grain-sharded plane on a ``launch.mesh.SearchMesh``, then one merge of the
per-shard pools.

``probe_plan`` is the adaptive routing stage alone (routing, the
``routing.adaptive_prefix`` stopping rule and the probe-traffic counters)
for the store's bucketed adaptive dispatch.  ``static_route`` and
``project_probes`` run the routing and projection
stages of ``search_stacked`` alone, in the same batches, so a caller that
scans the probed grains in passes of its own (the store's tiered
residency plane) hands every pass bits equal to the ones the one-call
plane computes: the float results of a matrix product or a reduction may
change with its shape, so no stage is run over a different batch.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import quantize, routing, scan, scanplane
from .cascade import check_budgets
from .types import (BIG, HNTLIndex, RoutingPlane, SearchResult,
                    ShardedStackedSegments, StackedSegments)

#: Queries per batch of ``search`` (bounds the [Q, P, d, k] basis gather).
QUERY_BATCH = 256


def project_queries(index: HNTLIndex, q: torch.Tensor, gids: torch.Tensor):
    """Project each query into each probed grain's tangent frame.

    q [Q, d], gids [Q, P] -> dict of per-(query, grain) quantities:
    zq [Q, P, k], vc2 [Q, P], rq [Q, P] and, with a sketch, sq [Q, P, s].
    """
    g = index.grains
    gl = gids.long()
    vc = q[:, None, :] - g.mu[gl]                             # [Q, P, d]
    zq = torch.einsum("qpd,qpdk->qpk", vc, g.basis[gl])       # [Q, P, k]
    vc2 = torch.sum(vc * vc, dim=-1)                          # [Q, P]
    out = {"zq": zq, "vc2": vc2}
    rq = vc2 - torch.sum(zq * zq, dim=-1)     # ||e_q||^2 (W orthonormal)
    if g.sketch_basis is not None:
        sq = torch.einsum("qpd,qpds->qps", vc, g.sketch_basis[gl])
        rq = rq - torch.sum(sq * sq, dim=-1)
        out["sq"] = sq
    out["rq"] = torch.clamp(rq, min=0.0)
    return out


def _project_quantized(index: HNTLIndex, q: torch.Tensor,
                       gids: torch.Tensor, envelope_frac: float, qeff: int):
    """Per-(query, probed grain) prep shared by both plane kinds: tangent
    projection, envelope verdict and query-side quantization.

    Returns (zq [Q, P, k] i32, rq [Q, P] f32, keep [Q, P] bool,
             sq [Q, P, s] i32 | None).
    """
    g = index.grains
    gl = gids.long()
    proj = project_queries(index, q, gids)
    scale = g.scale[gl][..., None]                            # [Q, P, 1]
    # Mixed precision: each probed grain quantizes the query at its own
    # stored width, so query and panel share one integer lattice.
    qm = qeff if g.qmaxg is None else g.qmaxg[gl][..., None]
    keep = quantize.envelope_keep(proj["zq"], scale, envelope_frac, qmax=qm)
    zq_q = quantize.quantize_coords(proj["zq"], scale,
                                    qmax=qm).to(torch.int32)
    sq = None
    if g.sketch_basis is not None:
        sq = quantize.quantize_coords(
            proj["sq"], g.sketch_scale[gl][..., None],
            qmax=127).to(torch.int32)
    return zq_q, proj["rq"], keep, sq


def _projected(index, q, gids, envelope_frac, qeff, proj):
    """``proj`` (the output of ``_project_quantized`` for these queries and
    probes, computed by the caller) or the projection computed here."""
    if proj is not None:
        return proj
    return _project_quantized(index, q, gids, envelope_frac, qeff)


def scan_probed(index: HNTLIndex, q: torch.Tensor, gids: torch.Tensor,
                envelope_frac: float, qeff: int, scan_fn=None,
                extra_mask: Optional[torch.Tensor] = None,
                tenant_mask: Optional[torch.Tensor] = None,
                tenant_ix: Optional[torch.Tensor] = None,
                n_active: Optional[torch.Tensor] = None, proj=None):
    """Gather-plane stages (2)+(3): project, envelope-filter, scan per-query
    copies of the probed panels.

    Returns (dists [Q, P*cap] f32, ids [Q, P*cap] i32).  extra_mask
    [G, cap], the tenant pair and n_active fold into the slot or probe
    verdicts exactly as in the select planes.  ``proj``: a precomputed
    (zq, rq, keep, sq) for these probes (see ``project_probes``).
    """
    g = index.grains
    gl = gids.long()
    zq_q, rq, keep, sq = _projected(index, q, gids, envelope_frac, qeff,
                                    proj)
    keep = scan.probe_alive(keep, n_active)
    kw = {}
    if g.sketch_basis is not None:
        kw = dict(sq=sq, sketch=g.sketch[gl], sketch_scale=g.sketch_scale[gl])
    if extra_mask is not None:
        kw["extra_mask"] = extra_mask[gl]
    if tenant_mask is not None:
        tq = tenant_mask[tenant_ix.long()[:, None], gl]       # [Q, P, cap]
        kw["extra_mask"] = tq if "extra_mask" not in kw \
            else torch.logical_and(kw["extra_mask"], tq)
    fn = scan_fn if scan_fn is not None else scan.blocksoa_scan
    dists = fn(zq_q, rq, g.coords[gl], g.res[gl], g.valid[gl], g.scale[gl],
               g.res_scale[gl], **kw)                         # [Q, P, cap]
    dists = torch.where(keep[..., None], dists, BIG)    # kill pruned grains
    qn = q.shape[0]
    return dists.reshape(qn, -1), g.ids[gl].reshape(qn, -1)


def select_args(index: HNTLIndex, q: torch.Tensor, gids: torch.Tensor,
                envelope_frac: float, qeff: int, *, width: int,
                budgets: Optional[tuple] = None,
                extra_mask: Optional[torch.Tensor] = None,
                tenant_mask: Optional[torch.Tensor] = None,
                tenant_ix: Optional[torch.Tensor] = None,
                n_active: Optional[torch.Tensor] = None, proj=None):
    """The (args, kwargs) a select runner is called with: the projected
    and quantized queries plus the stacked panel tier, unchanged (no
    per-query gather).  ``width`` is clamped to P * cap; ``budgets`` (a
    staged runner's) ride along."""
    g = index.grains
    zq_q, rq, keep, sq = _projected(index, q, gids, envelope_frac, qeff,
                                    proj)
    mask = g.valid if extra_mask is None \
        else torch.logical_and(g.valid, extra_mask)           # [G, cap]
    args = (gids.to(torch.int32).contiguous(), zq_q.contiguous(),
            rq.contiguous(), keep.contiguous(), g.coords, g.res,
            mask.contiguous(), g.ids, g.scale, g.res_scale)
    kw = {"width": min(width, gids.shape[1] * g.cap)}
    if g.sketch_basis is not None:
        kw.update(sq=sq.contiguous(), sketch=g.sketch,
                  sketch_scale=g.sketch_scale)
    if tenant_mask is not None:
        kw.update(tenant_mask=tenant_mask, tenant_ix=tenant_ix)
    if budgets is not None:
        kw["budgets"] = budgets
    if n_active is not None:
        kw["n_active"] = n_active
    return args, kw


def select_probed(index: HNTLIndex, q: torch.Tensor, gids: torch.Tensor,
                  envelope_frac: float, qeff: int, *, width: int, runner,
                  budgets: Optional[tuple] = None,
                  extra_mask: Optional[torch.Tensor] = None,
                  tenant_mask: Optional[torch.Tensor] = None,
                  tenant_ix: Optional[torch.Tensor] = None,
                  n_active: Optional[torch.Tensor] = None, proj=None):
    """Select-plane stages (2)+(3)+(first top-k): project, then hand the
    stacked panel tier to a streaming scan→select runner.

    Returns (dists [Q, width] f32 ascending, rows [Q, width] i32).
    """
    args, kw = select_args(index, q, gids, envelope_frac, qeff, width=width,
                           budgets=budgets, extra_mask=extra_mask,
                           tenant_mask=tenant_mask,
                           tenant_ix=tenant_ix, n_active=n_active, proj=proj)
    return runner(*args, **kw)


def candidate_stage(index: HNTLIndex, q: torch.Tensor, gids: torch.Tensor,
                    *, envelope_frac: float, qeff: int, width: int,
                    scan_impl: Optional[str] = None,
                    budgets: Optional[tuple] = None,
                    extra_mask: Optional[torch.Tensor] = None,
                    tenant_mask: Optional[torch.Tensor] = None,
                    tenant_ix: Optional[torch.Tensor] = None,
                    n_active: Optional[torch.Tensor] = None, proj=None):
    """Dispatch the candidate stage to a ScanPlane backend.

    Gather backends return the full [Q, P*cap] slot matrix; select
    backends the [Q, min(width, P*cap)] pool.  Either feeds the Mode A/B
    tail unchanged.  ``budgets``: per-stage survivor budgets (b1, b2) for
    a staged backend (the cascade); any other backend refuses them.
    ``proj``: a precomputed projection of these probes
    (``project_probes``), else it is computed here.
    """
    plane = scanplane.get_scan_plane(scan_impl, index.device)
    if budgets is not None and not plane.staged:
        raise ValueError(
            f"scan plane {plane.name!r} is not staged; per-stage survivor "
            "budgets need a cascade backend (scan_impl='cascade')")
    if plane.kind == scanplane.SELECT:
        if n_active is not None and not plane.adaptive:
            raise ValueError(
                f"scan plane {plane.name!r} does not accept the "
                "ragged-probe vector (n_active=)")
        return select_probed(index, q, gids, envelope_frac, qeff,
                             width=width, runner=plane.runner,
                             budgets=budgets, extra_mask=extra_mask,
                             tenant_mask=tenant_mask,
                             tenant_ix=tenant_ix, n_active=n_active,
                             proj=proj)
    return scan_probed(index, q, gids, envelope_frac, qeff,
                       scan_fn=plane.runner, extra_mask=extra_mask,
                       tenant_mask=tenant_mask, tenant_ix=tenant_ix,
                       n_active=n_active, proj=proj)


def _smallest(d: torch.Tensor, n: int):
    """Stable ascending top-n along dim 1: (values, positions)."""
    v, pos = torch.sort(d, dim=1, stable=True)
    return v[:, :n], pos[:, :n]


def _candidate_epilogue(dists, rows, q, raw, *, pool: int, topk: int,
                        mode: str, translate):
    """The Mode A/B tail of every plane: candidate pool -> (Mode B) exact
    f32 re-rank against ``raw`` -> top-k -> ``translate(rows, dists)``.

    The single-index and stacked searches both end here, and so does the
    store's re-rank of a merged pool (a cold raw tier, the tiered plane),
    so the pooling and re-rank arithmetic (and with it their parity) is
    one code path.  ``raw``: the [N, d] raw tier, or a function
    ``(rows [Q, C] i64 >= 0, ok [Q, C] bool) -> [Q, C, d]`` that fetches
    the rows (only the ``ok`` ones need be right).
    Returns (ids [Q, topk] i32, dists [Q, topk] f32).
    """
    if mode == "A":
        d_k, pos = _smallest(dists, topk)
        rows_k = torch.gather(rows, 1, pos)
    else:
        if raw is None:
            raise ValueError("Mode B needs the raw tier (build keep_raw=True)")
        d_c, pos = _smallest(dists, pool)                     # [Q, C]
        cand_rows = torch.gather(rows, 1, pos)
        safe = torch.clamp(cand_rows, min=0).long()
        ok = d_c < BIG / 2
        cand = raw(safe, ok) if callable(raw) else raw[safe]  # [Q, C, d]
        exact = torch.sum((cand - q[:, None, :]) ** 2, dim=-1)
        exact = torch.where(ok, exact, BIG)
        d_k, pos_e = _smallest(exact, topk)
        rows_k = torch.gather(cand_rows, 1, pos_e)
    return translate(rows_k, d_k), d_k


def _pruned_to_minus_one(rows, dists):
    """Single-index translation: ids are the index's own; a pruned slot
    (filtered, padding, pool exhausted) is id -1."""
    return torch.where(dists < BIG / 2, rows, -1).to(torch.int32)


def _in_batches(run, n: int, topk: int,
                device: torch.device) -> SearchResult:
    """``run(rows) -> (ids, dists)`` over ``QUERY_BATCH``-query slices
    ``rows`` of ``n`` queries."""
    ids, dists = [], []
    for lo in range(0, n, QUERY_BATCH):
        i, d = run(slice(lo, lo + QUERY_BATCH))
        ids.append(i)
        dists.append(d)
    if not ids:
        empty = torch.empty((0, topk), device=device)
        return SearchResult(ids=empty.to(torch.int32), dists=empty)
    return SearchResult(ids=torch.cat(ids), dists=torch.cat(dists))


def _search_batch(index, q, *, nprobe, pool, topk, mode, envelope_frac,
                  qeff, scan_impl, budgets, extra_mask):
    gids, _ = routing.route(index.routing, q, nprobe)
    dists, ids = candidate_stage(
        index, q, gids, envelope_frac=envelope_frac, qeff=qeff,
        width=min(max(pool, topk), nprobe * index.grains.cap),
        scan_impl=scan_impl, budgets=budgets, extra_mask=extra_mask)
    return _candidate_epilogue(dists, ids, q, index.raw, pool=pool,
                               topk=topk, mode=mode,
                               translate=_pruned_to_minus_one)


def _check_mode(mode: str) -> None:
    if mode not in ("A", "B"):
        raise ValueError(f"mode must be 'A' or 'B', got {mode!r}")


def search(index: HNTLIndex, q: torch.Tensor, *, nprobe: int, pool: int,
           topk: int, mode: str = "B", envelope_frac: float = 0.25,
           qeff: int = 8191, scan_impl: Optional[str] = None,
           budgets: Optional[tuple] = None,
           extra_mask: Optional[torch.Tensor] = None) -> SearchResult:
    """Full HNTL search on the index's device.  mode='A' self-contained,
    mode='B' tiered re-rank.

    scan_impl: ScanPlane backend name (``core.scanplane``); None = auto.
    budgets: (b1, b2) per-stage survivor budgets for a staged (cascade)
      backend.
    Pruned result slots (filtered, padding, pool exhausted) return id -1.
    """
    check_budgets(budgets, topk)
    _check_mode(mode)
    return _in_batches(
        lambda sl: _search_batch(
            index, q[sl], nprobe=nprobe, pool=pool, topk=topk, mode=mode,
            envelope_frac=envelope_frac, qeff=qeff, scan_impl=scan_impl,
            budgets=budgets, extra_mask=extra_mask), q.shape[0], topk,
        index.device)


# ---------------------------------------------------------------------------
# Fused multi-segment search (the store's data plane)
# ---------------------------------------------------------------------------


def _mixed_recall_mask(grains, tag_mask, ts_range, live=None):
    """[G, cap] in-scan predicate and [G] routing pushdown from the tag/ts
    filters and the store's liveness bitmap.

    Returns (extra_mask | None, grain_ok | None).  ``grain_ok`` keeps a
    grain out of routing when none of its slots passes, so no probe is
    spent on a grain the filters (or deletes) empty.  ``ts_range`` bounds
    are compared in float32, as the JAX package compares them.
    """
    if tag_mask is None and ts_range is None and live is None:
        return None, None
    keep = grains.valid
    if live is not None:
        keep = torch.logical_and(keep, live)
    if tag_mask is not None and grains.tags is not None:
        keep = torch.logical_and(keep, (grains.tags & int(tag_mask)) != 0)
    if ts_range is not None and grains.ts is not None:
        lo, hi = (float(np.float32(v)) for v in ts_range)
        keep = torch.logical_and(keep, (grains.ts >= lo) & (grains.ts < hi))
    return keep, torch.any(keep, dim=1)


def _tenant_grains(grains, extra, tenant_live):
    """[T, G] bool: the grains each tenant sees a slot of that also passes
    the shared predicate ``extra`` (None = the valid slots)."""
    base = extra if extra is not None else grains.valid
    return torch.any(torch.logical_and(tenant_live, base[None]), dim=2)


def _tenant_grain_mask(grain_ok, tenant_ok, tenant_ix):
    """The per-query routing pushdown: ``tenant_ok`` [T, G] (from
    ``_tenant_grains``) gathered by ``tenant_ix`` [Q] and joined with the
    shared [G] pushdown ``grain_ok``.  Returns [Q, G] (or ``grain_ok``
    unchanged without tenants)."""
    if tenant_ok is None:
        return grain_ok
    ok_q = tenant_ok[tenant_ix.long()]                        # [Q, G]
    return ok_q if grain_ok is None \
        else torch.logical_and(ok_q, grain_ok[None, :])


def _translate_rows(stacked: StackedSegments, rows: torch.Tensor,
                    dists: torch.Tensor) -> torch.Tensor:
    """Flat raw rows -> global ids (-1 for padding and pruned slots)."""
    ok = torch.logical_and(rows >= 0, dists < BIG / 2)
    gid = stacked.gid_of_row[torch.clamp(rows, min=0).long()]
    return torch.where(ok, gid, -1).to(torch.int32)


def search_stacked(stacked: StackedSegments, q: torch.Tensor, *,
                   nprobe: int, pool: int, topk: int, mode: str = "B",
                   envelope_frac: float = 0.25, qeff: int = 8191,
                   scan_impl: Optional[str] = None,
                   budgets: Optional[tuple] = None,
                   route_mode: str = "global",
                   seg_shape: Optional[tuple] = None, translate: bool = True,
                   tag_mask: Optional[int] = None,
                   ts_range: Optional[tuple] = None,
                   tenant_live=None, tenant_ix=None, probe_margin=None,
                   min_probes: int = 1, hub_mask=None,
                   probe_plan=None) -> SearchResult:
    """HNTL search across all sealed segments of a store in one call.

    One routing pass over the concatenated [S*G] routing plane, one
    candidate stage on the stacked panels, one merged pool and one Mode B
    re-rank over the concatenated raw tier, per ``QUERY_BATCH`` queries.

    route_mode: "global" (top-P over every segment's grains, with the
      filter pushdown) or "per_segment" (top-P within each segment, no
      pushdown: the per-segment loop's probe set; needs seg_shape (S, G)).
    translate: map flat rows to global ids (else return the flat rows).
    tag_mask / ts_range: keep slots with (tag & tag_mask) != 0 and
      lo <= ts < hi, in the scan and in routing; ``stacked.live`` joins
      the same predicate.
    probe_plan: a precomputed (gids [Q, P] i32, n_active [Q] i32 | None)
      that replaces routing (``static_route``, ``probe_plan``); probes
      p >= n_active[q] are killed.  Needs global routing.
    probe_margin + min_probes + hub_mask [G] bool (adaptive routing):
      after routing, ``routing.adaptive_prefix`` kills the probes beyond
      the distance-gap rule (hubs always probed) and the ragged-probe
      vector rides to the candidate stage.  ``probe_margin=None`` or inf
      is the static plane, bit for bit (inf is short-cut, never computed).
    budgets: (b1, b2) per-stage survivor budgets for a staged (cascade)
      backend.
    tenant_live [T, G, cap] bool + tenant_ix [Q] i32 (the coalesced
      serving plane): query q sees only the slots of row tenant_ix[q], in
      the scan and in its own routing pushdown.  Needs global routing.
    """
    check_budgets(budgets, topk)
    if (tenant_live is None) != (tenant_ix is None):
        raise ValueError("tenant_live and tenant_ix come together")
    if tenant_live is not None and route_mode != "global":
        raise ValueError("tenant visibility needs global routing (a "
                         "per-query pushdown): route_mode='global'")
    adaptive = probe_margin is not None and not math.isinf(probe_margin)
    if adaptive and route_mode != "global":
        raise ValueError("adaptive routing needs global routing "
                         "(route_mode='global')")
    _check_mode(mode)
    if route_mode not in ("global", "per_segment"):
        raise ValueError(f"route_mode must be 'global' or 'per_segment', "
                         f"got {route_mode!r}")
    if route_mode == "per_segment" and seg_shape is None:
        raise ValueError("route_mode='per_segment' needs seg_shape=(S, G)")
    if probe_plan is not None and route_mode != "global":
        raise ValueError("probe_plan needs global routing (one fused grain "
                         "axis)")
    index = stacked.index
    extra, grain_ok = _mixed_recall_mask(index.grains, tag_mask, ts_range,
                                         live=stacked.live)
    tenant_ok = None
    if tenant_live is not None and probe_plan is None:
        tenant_ok = _tenant_grains(index.grains, extra, tenant_live)
    tr = ((lambda r, d: _translate_rows(stacked, r, d)) if translate
          else (lambda r, d: r))

    def run(sl):
        qb, n_active = q[sl], None
        ti = None if tenant_ix is None else tenant_ix[sl]
        if probe_plan is not None:
            gids, n_active = probe_plan[0][sl], probe_plan[1]
            n_active = None if n_active is None else n_active[sl]
        elif route_mode == "per_segment":
            gids, _ = routing.route_per_segment(index.routing, qb, nprobe,
                                                seg_shape)
        else:
            gids, gd2 = routing.route(
                index.routing, qb, nprobe,
                grain_mask=_tenant_grain_mask(grain_ok, tenant_ok, ti))
            if adaptive:
                gids, n_active = routing.adaptive_prefix(
                    gids, gd2, margin=probe_margin, min_probes=min_probes,
                    hub_mask=hub_mask)
        dists, rows = candidate_stage(
            index, qb, gids, envelope_frac=envelope_frac, qeff=qeff,
            width=max(pool, topk), scan_impl=scan_impl, budgets=budgets,
            extra_mask=extra, tenant_mask=tenant_live, tenant_ix=ti,
            n_active=n_active)
        return _candidate_epilogue(dists, rows, qb, index.raw, pool=pool,
                                   topk=topk, mode=mode, translate=tr)

    return _in_batches(run, q.shape[0], topk, index.device)


def static_route(plane: RoutingPlane, q: torch.Tensor, *, nprobe: int,
                 grain_mask: Optional[torch.Tensor] = None):
    """The routing stage of ``search_stacked`` (global routing) alone:
    ``routing.route`` over the same ``QUERY_BATCH``-query batches, so the
    probe sets are bit-identical to the ones the one-call plane scans.
    ``grain_mask``: the [G] pushdown, or a per-query [Q, G] one (tenants),
    sliced with the queries.  Returns (gids [Q, P] i32, d2 [Q, P] f32)."""
    per_query = grain_mask is not None and grain_mask.dim() == 2

    def mask(lo):
        return grain_mask[lo:lo + QUERY_BATCH] if per_query else grain_mask

    out = [routing.route(plane, q[lo:lo + QUERY_BATCH], nprobe,
                         grain_mask=mask(lo))
           for lo in range(0, q.shape[0], QUERY_BATCH)]
    if not out:
        return (torch.empty((0, nprobe), dtype=torch.int32, device=q.device),
                torch.empty((0, nprobe), device=q.device))
    return tuple(torch.cat(t) for t in zip(*out))


def probe_plan(stacked: StackedSegments, q: torch.Tensor, *, nprobe: int,
               probe_margin: float, min_probes: int = 1,
               hub_mask: Optional[torch.Tensor] = None,
               tag_mask: Optional[int] = None,
               ts_range: Optional[tuple] = None,
               tenant_live: Optional[torch.Tensor] = None,
               tenant_ix: Optional[torch.Tensor] = None,
               grain_mask: Optional[torch.Tensor] = None):
    """The adaptive routing stage of ``search_stacked`` alone: routing with
    the same filter, liveness and tenant pushdown, in the same
    ``QUERY_BATCH`` batches (so at ``probe_margin=inf`` the gids are
    ``static_route``'s bit for bit), then the ``routing.adaptive_prefix``
    rule.

    Returns (gids [Q, P] i32, n_active [Q] i32, wins [G] i32, touches [G]
    i32): ``wins[g]`` counts the queries whose closest grain is g,
    ``touches[g]`` the active probes on g; the hub set and
    ``grain_health`` read them.  ``probe_margin=inf`` returns the static
    plan (every probe active).  The store buckets the queries by
    ``n_active`` on the host and hands each bucket its slice of the plan
    through ``search_stacked(probe_plan=...)``.

    grain_mask ([G] or per-query [Q, G] bool): a routing pushdown that
    replaces the filter/liveness/tenant one (the paged plane's stub has no
    panels, so the store computes it from the host copy of the panels).
    """
    index = stacked.index
    if grain_mask is None:
        extra, grain_mask = _mixed_recall_mask(
            index.grains, tag_mask, ts_range, live=stacked.live)
        if tenant_live is not None:
            grain_mask = _tenant_grain_mask(
                grain_mask, _tenant_grains(index.grains, extra, tenant_live),
                tenant_ix)
    gids, gd2 = static_route(index.routing, q, nprobe=nprobe,
                             grain_mask=grain_mask)
    if math.isinf(probe_margin):
        n_active = torch.full((q.shape[0],), gids.shape[1],
                              dtype=torch.int32, device=q.device)
    else:
        gids, n_active = routing.adaptive_prefix(
            gids, gd2, margin=probe_margin, min_probes=min_probes,
            hub_mask=hub_mask)
    g_n = index.routing.n_grains
    active = (torch.arange(gids.shape[1], device=q.device)[None, :]
              < n_active[:, None]).to(torch.int32)
    gl = gids.long()
    wins = torch.zeros(g_n, dtype=torch.int32, device=q.device)
    wins.index_add_(0, gl[:, 0], torch.ones_like(gids[:, 0]))
    touches = torch.zeros(g_n, dtype=torch.int32, device=q.device)
    touches.index_add_(0, gl.reshape(-1), active.reshape(-1))
    return gids, n_active, wins, touches


# ---------------------------------------------------------------------------
# Distributed fused search (grain-sharded across a mesh)
# ---------------------------------------------------------------------------


def sharded_knobs(n_shards: int, g_local: int, cap: int, *, nprobe: int,
                  pool: int, topk: int, mode: str):
    """The per-shard clamps of ``search_stacked_sharded``: (probe,
    pool_eff, k_local, k_final).  ``pool`` caps each shard's contribution
    in both modes (Mode B pools at least topk before its re-rank)."""
    probe = max(1, min(nprobe, g_local))
    slots = probe * cap
    pool_eff = (min(max(pool, topk), slots) if mode == "B"
                else max(1, min(pool, slots)))
    k_local = min(topk, pool_eff)
    return probe, pool_eff, k_local, min(topk, n_shards * k_local)


def search_stacked_sharded(plane, q: torch.Tensor, *, mesh,
                           grain_axis: str = "model",
                           batch_axis: Optional[str] = None, nprobe: int,
                           pool: int, topk: int, mode: str = "B",
                           envelope_frac: float = 0.25, qeff: int = 8191,
                           scan_impl: Optional[str] = None,
                           budgets: Optional[tuple] = None,
                           translate: bool = True,
                           tag_mask: Optional[int] = None,
                           ts_range: Optional[tuple] = None,
                           tenant_live=None, tenant_ix=None,
                           probe_margin: Optional[float] = None,
                           min_probes: int = 1,
                           hub_mask=None) -> SearchResult:
    """Grain-sharded fused search: each shard runs the whole pipeline on
    its own grain slice, then one merge of the per-shard pools.

    ``plane``: a ``ShardedStackedSegments`` (``store.shard_segments``;
    placed here) or a ``distributed.sharding.PlacedPlane`` on ``mesh``.
    Per shard, in shard order, on the shard's device: the mixed-recall
    mask and tenant pushdown, top-P routing over its local centroids,
    (adaptive) ``routing.adaptive_prefix`` on the local table with the
    shard's slice of ``hub_mask``, the candidate stage on the ScanPlane
    backend (the select kernel then runs once per shard and 256-query
    batch, at G = G_l), and the Mode A/B epilogue, the Mode B re-rank
    from the shard's own permuted raw slice, translated to global ids
    locally.  The merge moves each shard's [Q, k_local] (ids, dists) to
    the query row's first slot, concatenates them in mesh order and keeps
    the first ``k_final`` of a stable sort by distance (ties to the lower
    position, as ``jax.lax.top_k`` keeps them).

    Knobs are per shard (``sharded_knobs``): ``nprobe`` grains probed and
    ``pool`` candidates pooled on each shard, clamped to its slice;
    ``budgets`` are checked against k_local.  With exhaustive knobs the
    ids equal ``search_stacked``'s for every shard count.

    ``batch_axis``: split the queries into contiguous slices over that
    mesh axis; slice b runs on row b of the mesh and the results are
    concatenated in order.  Without it the queries run on row 0.
    ``translate=False`` returns permuted global rows (shard-local row +
    shard * rows_local) for the host's cold-tier re-rank.
    ``tenant_live`` [T, n*G_l, cap] (placed along dim 1 here, or placed
    already) + ``tenant_ix`` [Q]: per-query visibility, as in
    ``search_stacked``.  ``probe_margin=None`` or inf is the static plane.
    """
    from ..distributed import sharding as shd

    if isinstance(plane, ShardedStackedSegments):
        plane = shd.shard_search_plane(
            plane, shd.search_plane_rules(mesh, grain_axis=grain_axis))
    rules = plane.rules
    if rules.mesh != mesh or rules.grain_axis != grain_axis:
        raise ValueError("the plane was placed on another mesh or grain "
                         "axis than the search names")
    _check_mode(mode)
    if (tenant_live is None) != (tenant_ix is None):
        raise ValueError("tenant_live and tenant_ix come together")
    adaptive = probe_margin is not None and not math.isinf(probe_margin)
    n_shards = rules.n_shards
    probe, pool_eff, k_local, k_final = sharded_knobs(
        n_shards, plane.g_local, plane.cap, nprobe=nprobe, pool=pool,
        topk=topk, mode=mode)
    check_budgets(budgets, k_local)
    if mode == "B" and not plane.warm:
        raise ValueError("in-scan Mode B needs the warm tier; a cold "
                         "plane re-ranks on the host")
    if tenant_live is not None and not isinstance(tenant_live, tuple):
        tenant_live = shd.shard_plane_field(tenant_live, rules,
                                            "tenant_live", dim=1)
    if hub_mask is not None and not isinstance(hub_mask, tuple):
        hub_mask = shd.shard_plane_field(hub_mask, rules, "hub_mask")
    if tenant_ix is not None:
        tenant_ix = torch.as_tensor(tenant_ix)
    n_rows = 1
    if batch_axis is not None:
        if batch_axis == grain_axis or batch_axis not in mesh.axis_names:
            raise ValueError(f"batch_axis must be the mesh axis besides "
                             f"{grain_axis!r}, got {batch_axis!r}")
        n_rows = rules.n_rows
        if q.shape[0] % n_rows:
            raise ValueError(f"{q.shape[0]} queries do not split over the "
                             f"{n_rows}-way {batch_axis!r} axis")
    per_row = q.shape[0] // n_rows
    out_ids, out_d = [], []
    for r in range(n_rows):
        qs = slice(r * per_row, (r + 1) * per_row)
        lead = rules.slot_device(r, 0)
        g_ids, g_d = [], []
        for s in range(n_shards):
            sl = plane.slots[r][s]
            dev = sl.index.device
            res = _shard_body(
                sl, q[qs].to(dev), shard=s, rows_local=plane.rows_local,
                probe=probe, pool_eff=pool_eff, k_local=k_local, mode=mode,
                envelope_frac=envelope_frac, qeff=qeff,
                scan_impl=scan_impl, budgets=budgets, translate=translate,
                tag_mask=tag_mask, ts_range=ts_range,
                tenant_live=None if tenant_live is None
                else tenant_live[r][s],
                tenant_ix=None if tenant_ix is None
                else tenant_ix[qs].to(device=dev, dtype=torch.int32),
                probe_margin=probe_margin if adaptive else None,
                min_probes=min_probes,
                hub=None if hub_mask is None else hub_mask[r][s])
            g_ids.append(res.ids.to(lead))
            g_d.append(res.dists.to(lead))
        # the merge: [Q, n_shards * k_local] in mesh order, first k_final
        d, order = torch.sort(torch.cat(g_d, dim=1), dim=1, stable=True)
        ids = torch.gather(torch.cat(g_ids, dim=1), 1, order[:, :k_final])
        out_ids.append(ids.to(q.device))
        out_d.append(d[:, :k_final].to(q.device))
    return SearchResult(ids=torch.cat(out_ids), dists=torch.cat(out_d))


def _shard_body(sl, qv, *, shard, rows_local, probe, pool_eff, k_local,
                mode, envelope_frac, qeff, scan_impl, budgets, translate,
                tag_mask, ts_range, tenant_live, tenant_ix, probe_margin,
                min_probes, hub) -> SearchResult:
    """One shard's pipeline over its slice ``sl`` (a 1-shard
    ``ShardedStackedSegments`` on its device), in ``QUERY_BATCH`` batches.
    Returns [Q, k_local] global ids (or permuted global rows) and
    dists."""
    index = sl.index
    extra, grain_ok = _mixed_recall_mask(index.grains, tag_mask, ts_range,
                                         live=sl.live)
    tenant_ok = None
    if tenant_live is not None:
        tenant_ok = _tenant_grains(index.grains, extra, tenant_live)

    def local_ids(rows_k, d_k):
        ok = torch.logical_and(rows_k >= 0, d_k < BIG / 2)
        safe = torch.clamp(rows_k, min=0).long()
        out = sl.gid_of_row[safe] if translate \
            else safe + shard * rows_local
        return torch.where(ok, out, -1).to(torch.int32)

    def run(bs):
        qb = qv[bs]
        ti = None if tenant_ix is None else tenant_ix[bs]
        gids, gd2 = routing.route(
            index.routing, qb, probe,
            grain_mask=_tenant_grain_mask(grain_ok, tenant_ok, ti))
        n_active = None
        if probe_margin is not None:
            gids, n_active = routing.adaptive_prefix(
                gids, gd2, margin=probe_margin, min_probes=min_probes,
                hub_mask=hub)
        dists, rows = candidate_stage(
            index, qb, gids, envelope_frac=envelope_frac, qeff=qeff,
            width=max(pool_eff, k_local), scan_impl=scan_impl,
            budgets=budgets, extra_mask=extra, tenant_mask=tenant_live,
            tenant_ix=ti, n_active=n_active)
        return _candidate_epilogue(dists, rows, qb, index.raw,
                                   pool=pool_eff, topk=k_local, mode=mode,
                                   translate=local_ids)

    return _in_batches(run, qv.shape[0], k_local, index.device)


def project_probes(index: HNTLIndex, q: torch.Tensor, gids: torch.Tensor,
                   envelope_frac: float, qeff: int):
    """The projection stage of ``search_stacked`` alone, over the same
    ``QUERY_BATCH``-query batches of a [Q, P] probe plan: (zq [Q, P, k]
    i32, rq [Q, P] f32, keep [Q, P] bool, sq [Q, P, s] i32 | None), bit
    for bit what the one-call plane computes for each (query, probe).
    Only the index's frames (mu, basis, scales, qmaxg) are read."""
    parts = [_project_quantized(index, q[lo:lo + QUERY_BATCH],
                                gids[lo:lo + QUERY_BATCH], envelope_frac,
                                qeff)
             for lo in range(0, q.shape[0], QUERY_BATCH)]
    return tuple(None if t[0] is None else torch.cat(t)
                 for t in zip(*parts))
