"""Level-1 hierarchical centroid routing (paper §2.3).

For a query batch Q we compute ambient-space distances to all G grain
centroids and keep the top-P (nprobe).  Empty grains are never selected.
``grain_mask`` is the mixed-recall filter pushdown: grains it rules out
are excluded from routing.
"""
from __future__ import annotations

from typing import Optional

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
