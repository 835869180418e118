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
"""
from __future__ import annotations

from typing import Optional

import torch

from . import quantize, routing, scan, scanplane
from .cascade import check_budgets
from .types import BIG, HNTLIndex, SearchResult

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


def scan_probed(index: HNTLIndex, q: torch.Tensor, gids: torch.Tensor,
                envelope_frac: float, qeff: int, scan_fn=None,
                extra_mask: Optional[torch.Tensor] = None,
                tenant_mask: Optional[torch.Tensor] = None,
                tenant_ix: Optional[torch.Tensor] = None,
                n_active: Optional[torch.Tensor] = None):
    """Gather-plane stages (2)+(3): project, envelope-filter, scan per-query
    copies of the probed panels.

    Returns (dists [Q, P*cap] f32, ids [Q, P*cap] i32).  extra_mask
    [G, cap], the tenant pair and n_active fold into the slot or probe
    verdicts exactly as in the select planes.
    """
    g = index.grains
    gl = gids.long()
    zq_q, rq, keep, sq = _project_quantized(index, q, gids, envelope_frac,
                                            qeff)
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
                extra_mask: Optional[torch.Tensor] = None,
                tenant_mask: Optional[torch.Tensor] = None,
                tenant_ix: Optional[torch.Tensor] = None,
                n_active: Optional[torch.Tensor] = None):
    """The (args, kwargs) a select runner is called with: the projected
    and quantized queries plus the stacked panel tier, unchanged (no
    per-query gather).  ``width`` is clamped to P * cap."""
    g = index.grains
    zq_q, rq, keep, sq = _project_quantized(index, q, gids, envelope_frac,
                                            qeff)
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
    if n_active is not None:
        kw["n_active"] = n_active
    return args, kw


def select_probed(index: HNTLIndex, q: torch.Tensor, gids: torch.Tensor,
                  envelope_frac: float, qeff: int, *, width: int, runner,
                  extra_mask: Optional[torch.Tensor] = None,
                  tenant_mask: Optional[torch.Tensor] = None,
                  tenant_ix: Optional[torch.Tensor] = None,
                  n_active: Optional[torch.Tensor] = None):
    """Select-plane stages (2)+(3)+(first top-k): project, then hand the
    stacked panel tier to a streaming scan→select runner.

    Returns (dists [Q, width] f32 ascending, rows [Q, width] i32).
    """
    args, kw = select_args(index, q, gids, envelope_frac, qeff, width=width,
                           extra_mask=extra_mask, tenant_mask=tenant_mask,
                           tenant_ix=tenant_ix, n_active=n_active)
    return runner(*args, **kw)


def candidate_stage(index: HNTLIndex, q: torch.Tensor, gids: torch.Tensor,
                    *, envelope_frac: float, qeff: int, width: int,
                    scan_impl: Optional[str] = None,
                    extra_mask: Optional[torch.Tensor] = None,
                    tenant_mask: Optional[torch.Tensor] = None,
                    tenant_ix: Optional[torch.Tensor] = None,
                    n_active: Optional[torch.Tensor] = None):
    """Dispatch the candidate stage to a ScanPlane backend.

    Gather backends return the full [Q, P*cap] slot matrix; select
    backends the [Q, min(width, P*cap)] pool.  Either feeds the Mode A/B
    tail unchanged.
    """
    plane = scanplane.get_scan_plane(scan_impl, index.device)
    if plane.kind == scanplane.SELECT:
        if n_active is not None and not plane.adaptive:
            raise ValueError(
                f"scan plane {plane.name!r} does not accept the "
                "ragged-probe vector (n_active=)")
        return select_probed(index, q, gids, envelope_frac, qeff,
                             width=width, runner=plane.runner,
                             extra_mask=extra_mask, tenant_mask=tenant_mask,
                             tenant_ix=tenant_ix, n_active=n_active)
    return scan_probed(index, q, gids, envelope_frac, qeff,
                       scan_fn=plane.runner, extra_mask=extra_mask,
                       tenant_mask=tenant_mask, tenant_ix=tenant_ix,
                       n_active=n_active)


def _smallest(d: torch.Tensor, n: int):
    """Stable ascending top-n along dim 1: (values, positions)."""
    v, pos = torch.sort(d, dim=1, stable=True)
    return v[:, :n], pos[:, :n]


def _search_batch(index, q, *, nprobe, pool, topk, mode, envelope_frac,
                  qeff, scan_impl, extra_mask):
    gids, _ = routing.route(index.routing, q, nprobe)
    dists, ids = candidate_stage(
        index, q, gids, envelope_frac=envelope_frac, qeff=qeff,
        width=min(max(pool, topk), nprobe * index.grains.cap),
        scan_impl=scan_impl, extra_mask=extra_mask)
    if mode == "A":
        d_k, pos = _smallest(dists, topk)
        ids_k = torch.gather(ids, 1, pos)
    else:
        # Mode B: candidate pool C -> exact f32 L2 re-rank against raw.
        if index.raw is None:
            raise ValueError("Mode B needs the raw tier (build keep_raw=True)")
        d_c, pos = _smallest(dists, pool)                     # [Q, C]
        cand_ids = torch.gather(ids, 1, pos)
        cand = index.raw[torch.clamp(cand_ids, min=0).long()]  # [Q, C, d]
        exact = torch.sum((cand - q[:, None, :]) ** 2, dim=-1)
        exact = torch.where(d_c < BIG / 2, exact, BIG)
        d_k, pos_e = _smallest(exact, topk)
        ids_k = torch.gather(cand_ids, 1, pos_e)
    ids_k = torch.where(d_k < BIG / 2, ids_k, -1).to(torch.int32)
    return ids_k, d_k


def search(index: HNTLIndex, q: torch.Tensor, *, nprobe: int, pool: int,
           topk: int, mode: str = "B", envelope_frac: float = 0.25,
           qeff: int = 8191, scan_impl: Optional[str] = None,
           budgets: Optional[tuple] = None,
           extra_mask: Optional[torch.Tensor] = None) -> SearchResult:
    """Full HNTL search on the index's device.  mode='A' self-contained,
    mode='B' tiered re-rank.

    scan_impl: ScanPlane backend name (``core.scanplane``); None = auto.
    budgets: refused until the cascade is ported (validated first).
    Pruned result slots (filtered, padding, pool exhausted) return id -1.
    """
    check_budgets(budgets, topk)
    if budgets is not None:
        raise ValueError("budgets= needs the cascade scan plane, which is "
                         "not ported yet")
    if mode not in ("A", "B"):
        raise ValueError(f"mode must be 'A' or 'B', got {mode!r}")
    ids, dists = [], []
    for lo in range(0, q.shape[0], QUERY_BATCH):
        i, d = _search_batch(
            index, q[lo:lo + QUERY_BATCH], nprobe=nprobe, pool=pool,
            topk=topk, mode=mode, envelope_frac=envelope_frac, qeff=qeff,
            scan_impl=scan_impl, extra_mask=extra_mask)
        ids.append(i)
        dists.append(d)
    if not ids:
        empty = torch.empty((0, topk), device=index.device)
        return SearchResult(ids=empty.to(torch.int32), dists=empty)
    return SearchResult(ids=torch.cat(ids), dists=torch.cat(dists))
