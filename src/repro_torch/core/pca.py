"""Per-grain local PCA (tangent space) bases, batched over grains.

Paper §2.2: for each grain with centroid mu_g, W_g in R^{d x k} holds the
top-k principal directions of the centered members; the residual sketch
basis holds directions k..k+s of the same eigendecomposition.

Eigenvector signs (and the order of equal eigenvalues) depend on the
eigensolver, so bases agree with the JAX package's up to those: compare
the subspaces (projectors W Wᵀ), not the bases.

``captured_fraction`` and ``best_captured_fraction`` are the maintenance
plane's frame-staleness signals, batched over grains on the members'
device.
"""
from __future__ import annotations

import torch


def grain_cov(x_centered: torch.Tensor, mask: torch.Tensor,
              chunk: int = 128) -> torch.Tensor:
    """Covariances of the masked members.  x_centered [G, cap, d] (padded
    rows arbitrary), mask [G, cap] -> [G, d, d], computed ``chunk`` grains
    at a time so the masked copy of the members stays small."""
    g, _, d = x_centered.shape
    cov = torch.empty((g, d, d), dtype=x_centered.dtype,
                      device=x_centered.device)
    for lo in range(0, g, chunk):
        w = mask[lo:lo + chunk].to(x_centered.dtype)
        n = torch.clamp(w.sum(dim=1), min=1.0)
        xm = x_centered[lo:lo + chunk] * w[..., None]
        cov[lo:lo + chunk] = (xm.transpose(1, 2) @ xm) / n[:, None, None]
    return cov


def frames_from_cov(cov: torch.Tensor, k: int, s: int = 0):
    """Eigendecomposition of [G, d, d] covariances, largest first.

    Returns (basis [G, d, k], sketch_basis [G, d, s] or None,
    var_captured [G])."""
    eigval, eigvec = torch.linalg.eigh(cov)               # ascending
    eigval = torch.flip(eigval, dims=(-1,))
    eigvec = torch.flip(eigvec, dims=(-1,))
    basis = eigvec[..., :k].contiguous()
    sketch = eigvec[..., k:k + s].contiguous() if s > 0 else None
    total = torch.clamp(torch.sum(eigval, dim=-1), min=1e-30)
    return basis, sketch, torch.sum(eigval[..., :k], dim=-1) / total


def grain_pca(x_centered: torch.Tensor, mask: torch.Tensor, k: int,
              s: int = 0):
    """PCA of each grain's masked members.

    x_centered [G, cap, d], mask [G, cap] -> (basis [G, d, k],
    sketch_basis [G, d, s] or None, var_captured [G]).
    """
    return frames_from_cov(grain_cov(x_centered, mask), k, s)


def _live_centred(x: torch.Tensor, mask: torch.Tensor):
    """Rows centred on the masked rows' own mean, zero where masked out.
    x [G, cap, d], mask [G, cap] -> (xc [G, cap, d], mean [G, d])."""
    w = mask[..., None].to(x.dtype)
    cnt = torch.clamp(mask.sum(dim=1), min=1).to(x.dtype)
    mean = (x * w).sum(dim=1) / cnt[:, None]
    return (x - mean[:, None, :]) * w, mean


def captured_fraction(x: torch.Tensor, mask: torch.Tensor,
                      basis: torch.Tensor,
                      sketch_basis: torch.Tensor = None):
    """Fraction of the masked rows' centred energy a frame captures.

    Recentres on the masked rows' OWN mean, not the frame's frozen ``mu``:
    after deletes the survivors' mean drifts off the centroid, and energy
    the frame spends on that offset is energy it no longer has for the
    survivors' local structure.  The sketch basis counts as captured when
    present (the scan subtracts its energy from the residual too).

    x [G, cap, d] member rows; mask [G, cap] live validity; basis
    [G, d, k]; sketch_basis [G, d, s] or None.  Returns (captured [G] in
    [0, 1], live_mean [G, d]); empty grains report 1.0.
    """
    xc, mean = _live_centred(x, mask)
    total = torch.sum(xc * xc, dim=(1, 2))                     # [G]
    z = xc @ basis
    cap_e = torch.sum(z * z, dim=(1, 2))
    if sketch_basis is not None:
        sk = xc @ sketch_basis
        cap_e = cap_e + torch.sum(sk * sk, dim=(1, 2))
    captured = torch.where(total > 1e-12,
                           cap_e / torch.clamp(total, min=1e-12), 1.0)
    return torch.clamp(captured, 0.0, 1.0), mean


def best_captured_fraction(x: torch.Tensor, mask: torch.Tensor, k: int,
                           s: int = 0) -> torch.Tensor:
    """Upper bound on :func:`captured_fraction` over every rank-(k+s)
    frame: the top-(k+s) eigenvalue mass of the masked rows' covariance.
    Staleness is judged relative to it, so intrinsically high-dimensional
    grains are never flagged.  Returns [G] in [0, 1]; empty grains 1.0."""
    xc, _ = _live_centred(x, mask)
    ev = torch.linalg.eigvalsh(xc.transpose(1, 2) @ xc)       # ascending
    total = ev.sum(dim=1)
    top = ev[:, -(k + s):].sum(dim=1) if k + s > 0 \
        else torch.zeros_like(total)
    best = torch.where(total > 1e-12,
                       top / torch.clamp(total, min=1e-12), 1.0)
    return torch.clamp(best, 0.0, 1.0)
