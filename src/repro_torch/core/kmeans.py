"""Balanced k-means grain partitioning (build-time).

Lloyd's algorithm with k-means++ seeding, on the corpus' device.  Random
draws come from a ``torch.Generator``, so seeds do not reproduce the JAX
package's ``jax.random`` stream: parity with it goes through
``index.build(..., centroids=)``.  The cluster sums use ``index_add_``,
whose float atomics on a GPU make the centroids vary in the last bits from
run to run.

``two_means`` and ``steal_rows`` are the maintenance plane's split
primitives; they run on the host in numpy, with the JAX package's
arithmetic, so the same members split the same way in both packages.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2, in the JAX/numpy op order.
    x [n, d], centers [G, d] -> [n, G]."""
    return (torch.sum(x * x, dim=1, keepdim=True) - 2.0 * (x @ centers.T)
            + torch.sum(centers * centers, dim=1)[None, :])


def _plusplus_init(x: torch.Tensor, g: int,
                   generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: iteratively pick centers ~ D^2."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=generator, device=x.device)
    centers = x.new_zeros((g, x.shape[1]))
    centers[0] = x[first[0]]
    x2 = torch.sum(x * x, dim=1)
    d2 = torch.clamp(x2 - 2.0 * (x @ centers[0]) + centers[0] @ centers[0],
                     min=0.0)
    for i in range(1, g):
        total = d2.sum()
        # all points on chosen centers: draw uniformly (no sync needed)
        w = torch.where(total > 0, d2, torch.ones_like(d2))
        idx = torch.multinomial(w, 1, generator=generator)[0]
        c = x[idx]
        centers[i] = c
        d2 = torch.minimum(
            d2, torch.clamp(x2 - 2.0 * (x @ c) + c @ c, min=0.0))
    return centers


def _assign(x: torch.Tensor, centers: torch.Tensor,
            chunk: int = 131072) -> torch.Tensor:
    """Nearest-center assignment, computed in row chunks to bound the
    [chunk, G] distance block.  -> [N] i64."""
    c2 = torch.sum(centers * centers, dim=-1)
    out = []
    for lo in range(0, x.shape[0], chunk):
        xc = x[lo:lo + chunk] @ centers.T
        out.append(torch.argmin(c2[None, :] - 2.0 * xc, dim=-1))
    return torch.cat(out)


def kmeans(x: torch.Tensor, g: int, generator: torch.Generator,
           iters: int = 25):
    """Lloyd's k-means, seeded from ``generator`` (on x's device).
    Returns (centroids [G, d], assignment [N] i64).  Cluster sums are an
    ``index_add_`` (no [N, G] one-hot)."""
    centers = _plusplus_init(x, g, generator)
    for _ in range(iters):
        assign = _assign(x, centers)
        counts = torch.bincount(assign, minlength=g).to(x.dtype)
        sums = torch.zeros_like(centers).index_add_(0, assign, x)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        # keep empty clusters where they were
        centers = torch.where(counts[:, None] > 0, new, centers)
    return centers, _assign(x, centers)


def preferences(x: torch.Tensor, centers: torch.Tensor, n_pref: int = 16,
                chunk: int = 65536):
    """Part (a) of the balanced assignment, on x's device: each point's
    ``n_pref`` nearest grains and the gap between its first two distances.

    Returns (pref [N, T] i64 numpy, ascending distance; gap [N] f32 numpy,
    d2[first] - d2[second], or zeros for one grain).  Ties in distance
    come out in ``torch.topk``'s order.
    """
    t = min(n_pref, centers.shape[0])
    prefs, gaps = [], []
    for lo in range(0, x.shape[0], chunk):
        d2 = _sq_dists(x[lo:lo + chunk], centers)
        v, i = torch.topk(d2, t, dim=1, largest=False, sorted=True)
        gap = v[:, 0] - v[:, 1] if t > 1 else torch.zeros_like(v[:, 0])
        prefs.append(i.cpu())
        gaps.append(gap.cpu())
    return torch.cat(prefs).numpy(), torch.cat(gaps).numpy()


def greedy_assign(pref: np.ndarray, gap: np.ndarray, cap: int, g: int,
                  row_order: Callable[[int], np.ndarray]) -> np.ndarray:
    """Part (b), on the host: the JAX package's capacity-bounded greedy.

    Points go in ``np.argsort(gap)`` order (those that care most about
    their first choice first); each takes its first grain with room.
    ``pref`` holds the first T choices; only a point whose T choices are
    all full reads its full order from ``row_order(i)``.  If every grain
    is full the point goes to its first choice.  Fed the same distances,
    this gives exactly the reference's assignment.
    """
    n = pref.shape[0]
    counts = [0] * g
    out = [0] * n
    first = pref[:, 0].tolist()
    for i in np.argsort(gap).tolist():
        c = first[i]
        if counts[c] < cap:
            counts[c] += 1
            out[i] = c
            continue
        c = next((c for c in pref[i].tolist() if counts[c] < cap), None)
        if c is None:                  # T choices full: read the full order
            c = next((c for c in row_order(i).tolist() if counts[c] < cap),
                     first[i])
        counts[c] += 1
        out[i] = c
    return np.asarray(out, dtype=np.int64)


def balanced_assign(x: torch.Tensor, centers: torch.Tensor, cap: int,
                    n_pref: int = 16) -> np.ndarray:
    """Capacity-bounded assignment: greedily spill overflow to the
    next-nearest grain with room.  The [N, G] distances are computed on
    x's device and never leave it; the host gets the top ``n_pref``
    preferences per point (instead of an [N, G] argsort).  -> [N] i64."""
    centers = centers.to(device=x.device, dtype=torch.float32)
    pref, gap = preferences(x, centers, n_pref)

    def row_order(i: int) -> np.ndarray:
        d2 = _sq_dists(x[i:i + 1], centers)[0]
        return torch.sort(d2, stable=True).indices.cpu().numpy()

    return greedy_assign(pref, gap, cap, centers.shape[0], row_order)


def two_means(x, iters: int = 16):
    """Deterministic host-side 2-means: the grain split primitive.

    No RNG (the same split must come out of every process that maintains
    the same store).  Farthest-point init: c0 is the member farthest from
    the mean, c1 the member farthest from c0.  x [m, d] float32, m >= 2.
    Returns (centers [2, d], assign [m] in {0, 1}); identical members leave
    one side empty, and callers then split otherwise.
    """
    xn = np.asarray(x, np.float32)
    c0 = xn[int(np.argmax(np.sum((xn - xn.mean(0)) ** 2, axis=1)))]
    c1 = xn[int(np.argmax(np.sum((xn - c0) ** 2, axis=1)))]
    centers = np.stack([c0, c1])
    assign = np.zeros(len(xn), np.int64)
    for it in range(iters):
        d2 = (np.sum(xn * xn, axis=1, keepdims=True)
              - 2.0 * xn @ centers.T + np.sum(centers * centers, axis=1))
        new_assign = np.argmin(d2, axis=1)
        if it > 0 and (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(2):
            if (assign == c).any():
                centers[c] = xn[assign == c].mean(0)
    return centers, assign


def steal_rows(d2_src, n_move: int) -> np.ndarray:
    """The ``n_move`` rows farthest from the source centroid (the ones its
    frame represents worst).  d2_src [m] -> indices of the rows to move."""
    return np.argsort(np.asarray(d2_src))[::-1][:n_move]
