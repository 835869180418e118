"""Synthetic datasets from the paper's evaluation (§3.2).

This package's own numpy copy of the JAX package's generators: the same
seed gives the same arrays in both.

- isotropic_gaussian: d-dim N(0, I).  Local PCA captures ~k/d of the variance
  (paper: 6.5% at k=32... d=768 -> 32/768 = 4.2%; with grain-local anisotropy
  measured ~6.5%) — the adversarial case for tangent-local indexing.
- anisotropic_manifold: vectors near a low-dimensional curved manifold
  embedded in R^d with small ambient noise — grain-local PCA captures ~96%.
- clustered: SIFT-like mixture for the scale benchmark.
"""
from __future__ import annotations

import numpy as np


def isotropic_gaussian(n: int, d: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d), dtype=np.float32)


def anisotropic_manifold(n: int, d: int, intrinsic: int = 24,
                         curvature: float = 0.8, noise: float = 0.05,
                         seed: int = 0) -> np.ndarray:
    """Points on a smooth ``intrinsic``-dim manifold embedded in R^d.

    Construction: latent u ~ N(0, I_m); embed via a random linear map plus
    quadratic bending terms (curvature), then add isotropic ambient noise.
    Locally the surface is flat, so grain-local PCA with k >= intrinsic
    captures nearly all variance — the paper's favourable case.
    """
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, intrinsic)).astype(np.float32)
    a = rng.standard_normal((intrinsic, d)).astype(np.float32) / np.sqrt(intrinsic)
    # a few random quadratic features bend the sheet
    nq = intrinsic // 2
    pairs = rng.integers(0, intrinsic, size=(nq, 2))
    b = rng.standard_normal((nq, d)).astype(np.float32) / np.sqrt(nq)
    quad = (u[:, pairs[:, 0]] * u[:, pairs[:, 1]]).astype(np.float32)
    x = u @ a + curvature * (quad @ b)
    x += noise * rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32)


def clustered(n: int, d: int, n_clusters: int = 256, spread: float = 0.15,
              seed: int = 0) -> np.ndarray:
    """SIFT-like clustered corpus for the scale benchmark."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    local_dim = max(4, d // 8)
    basis = rng.standard_normal((n_clusters, local_dim, d)).astype(np.float32)
    basis /= np.sqrt(local_dim)
    coef = rng.standard_normal((n, local_dim)).astype(np.float32)
    x = centers[assign] + np.einsum("nl,nld->nd", coef, basis[assign])
    x += spread * rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32)


def queries_from(x: np.ndarray, nq: int, jitter: float = 0.01,
                 seed: int = 1) -> np.ndarray:
    """Query set: perturbed corpus points (standard recall protocol when the
    corpus has no official query split)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(x.shape[0], size=nq, replace=False)
    scale = float(np.mean(np.linalg.norm(x, axis=1))) / np.sqrt(x.shape[1])
    return (x[idx] + jitter * scale *
            rng.standard_normal((nq, x.shape[1]))).astype(np.float32)
