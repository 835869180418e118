"""Level-1 hierarchical centroid routing (paper §2.3).

For a query batch Q we compute ambient-space distances to all G grain
centroids and keep the top-P (nprobe).  Empty grains are never selected.
``grain_mask`` is the mixed-recall filter pushdown: grains it rules out
are excluded from routing.

On a ``StackedSegments`` plane ``route`` takes the top-P over every
segment's grains at once; ``route_per_segment`` takes the top-P within
each segment (the per-segment loop's probe set) in one call.

``merge_target`` (host numpy) and ``rebuild_plane`` serve the maintenance
plane.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .types import BIG, RoutingPlane


def _centroid_d2(plane: RoutingPlane, q: torch.Tensor,
                 grain_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked query->centroid distances.  q [Q, d] -> d2 [Q, G]."""
    c = plane.centroids
    c2 = torch.sum(c * c, dim=-1)                                # [G]
    q2 = torch.sum(q * q, dim=-1, keepdim=True)                  # [Q, 1]
    d2 = q2 - 2.0 * (q @ c.T) + c2[None, :]                      # [Q, G]
    ok = plane.sizes > 0
    if grain_mask is not None:
        # [G] shared pushdown, or [Q, G] per-query visibility
        ok = torch.logical_and(ok, grain_mask)
    if ok.dim() == 1:
        ok = ok[None, :]
    return torch.where(ok, d2, BIG)


def route(plane: RoutingPlane, q: torch.Tensor, nprobe: int,
          grain_mask: Optional[torch.Tensor] = None):
    """Select the top-P closest grains per query.

    Ties break to the lower grain index, as ``jax.lax.top_k`` does: the
    selection is a stable sort (``torch.topk`` promises no tie order).
    Returns (grain_ids [Q, P] i32, grain_d2 [Q, P] f32).
    """
    d2 = _centroid_d2(plane, q, grain_mask)
    d, idx = torch.sort(d2, dim=1, stable=True)
    return idx[:, :nprobe].to(torch.int32), d[:, :nprobe]


def route_per_segment(plane: RoutingPlane, q: torch.Tensor, nprobe: int,
                      seg_shape: tuple):
    """Top-P routing within each segment of a stacked routing plane.

    ``plane`` holds S*G fused grains and ``seg_shape`` = (S, G).  Ties break
    to the lower grain index within a segment (a stable sort).  Returns
    (grain_ids [Q, S*P] i32, indices into the fused grain axis, and
    grain_d2 [Q, S*P] f32).
    """
    s, g = seg_shape
    d2 = _centroid_d2(plane, q, None).reshape(q.shape[0], s, g)
    d, idx = torch.sort(d2, dim=2, stable=True)
    p = min(nprobe, g)
    idx = idx[:, :, :p] + (torch.arange(s, device=q.device) * g)[None, :,
                                                                  None]
    return (idx.reshape(q.shape[0], -1).to(torch.int32),
            d[:, :, :p].reshape(q.shape[0], -1))


def adaptive_prefix(gids: torch.Tensor, gd2: torch.Tensor, *,
                    margin: float, min_probes: int = 1,
                    hub_mask: Optional[torch.Tensor] = None):
    """Per-query early termination over the routed top-P.

    A probe p stays active iff gd2[q, p] <= (1 + margin) * gd2[q, 0] (the
    distance-gap rule), or its grain is a hub (``hub_mask`` [G] bool), and
    its grain is valid (gd2 < BIG / 2); the first ``min_probes`` probes
    always stay.  Active probes are stable-partitioned to the front
    (ascending gd2 stays ascending), so the select takes a per-query
    prefix length.  ``(1 + margin)`` is a Python float times the f32
    ``gd2``, as in the JAX package.  ``margin=inf`` must be short-cut by
    the caller ((1 + inf) * 0 is NaN).

    Returns (gids [Q, P] i32 reordered, n_active [Q] i32 >= 1).
    """
    p_n = gids.shape[1]
    pos = torch.arange(p_n, device=gids.device)[None, :]
    active = gd2 <= (1.0 + margin) * gd2[:, :1]
    if hub_mask is not None:
        active = torch.logical_or(active, hub_mask[gids.long()])
    active = torch.logical_and(active, gd2 < BIG / 2)
    active = torch.logical_or(active, pos < min_probes)
    # stable partition: actives first, their routing order kept
    order = torch.sort((~active).to(torch.uint8), dim=1, stable=True).indices
    gids_s = torch.gather(gids, 1, order)
    n_active = torch.clamp(active.sum(dim=1, dtype=torch.int32), min=1)
    return gids_s, n_active


def merge_target(centroids, live_counts, cap: int, src: int,
                 excluded=(), max_merged: Optional[int] = None) -> int:
    """The grain an underfull grain ``src`` merges into: the nearest other
    centroid whose group has room for src's live rows (combined count <=
    cap, and <= ``max_merged`` when given, so a merge never makes the
    overfull grain the next epoch would split).  Host numpy.

    ``excluded``: grains that may not be targets.  Returns the target
    grain, or -1 when none has room.
    """
    c = np.asarray(centroids, np.float32)
    cnt = np.asarray(live_counts, np.int64)
    d2 = np.sum((c - c[src]) ** 2, axis=1)
    d2[src] = np.inf
    for gi in excluded:
        d2[gi] = np.inf
    merged = cnt + cnt[src]
    limit = cap if max_merged is None else min(cap, max_merged)
    d2[(merged > limit) | (cnt == 0)] = np.inf
    best = int(np.argmin(d2))
    return best if np.isfinite(d2[best]) else -1


def rebuild_plane(centroids: torch.Tensor,
                  sizes: torch.Tensor) -> RoutingPlane:
    """A routing plane from maintenance's final per-grain tables, on the
    centroids' device.  Every rebuild goes through here, so the invariant
    "routing rows == grain panels" has one owner."""
    c = centroids.to(torch.float32)
    s = sizes.to(device=c.device, dtype=torch.int32)
    if c.shape[0] != s.shape[0]:
        raise ValueError(f"{c.shape[0]} centroids for {s.shape[0]} sizes")
    return RoutingPlane(centroids=c, sizes=s)


def check_probe_args(adaptive: bool, probe_margin, min_probes=None) -> None:
    """Host validation of the adaptive-probing knobs, run before a search
    so a bad combination fails with one message."""
    if probe_margin is not None:
        if not adaptive:
            raise ValueError(
                "probe_margin= only applies to adaptive routing; pass "
                "adaptive=True (or drop probe_margin)")
        m = float(probe_margin)
        if math.isnan(m) or m < 0.0:
            raise ValueError(
                f"probe_margin must be a float >= 0 (inf = exhaustive, "
                f"i.e. static nprobe), got {probe_margin!r}")
    if min_probes is not None and (isinstance(min_probes, bool)
                                   or not isinstance(min_probes, int)
                                   or min_probes < 1):
        raise ValueError(
            f"min_probes must be an int >= 1, got {min_probes!r}")
