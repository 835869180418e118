"""Per-grain local PCA (tangent space) bases, batched over grains.

Paper §2.2: for each grain with centroid mu_g, W_g in R^{d x k} holds the
top-k principal directions of the centered members; the residual sketch
basis holds directions k..k+s of the same eigendecomposition.

Eigenvector signs (and the order of equal eigenvalues) depend on the
eigensolver, so bases agree with the JAX package's up to those: compare
the subspaces (projectors W Wᵀ), not the bases.
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
