"""Inputs of the fused scan→select contract, made with numpy from a seed.

Used to hold ``fused_scan_select`` against its plain version: by
``chip_smoke.py`` on the card and by the port's tests.  Every function
returns a dict of numpy arrays under the kernel's argument names;
``split`` turns one into the runner's (args, kwargs).
"""
from __future__ import annotations

import numpy as np

#: ``fused_scan_select``'s positional arguments, in order.
ARG_NAMES = ("gids", "zq", "rq", "keep", "coords", "res", "mask", "rows",
             "scale", "res_scale")


def random_inputs(seed: int, *, q: int, p: int, g: int, k: int, cap: int,
                  s: int = 0, tenants: int = 0, ragged: bool = False,
                  keep_frac: float = 0.8, mask_frac: float = 0.85,
                  coord_range: int = 4000,
                  scale_range: tuple = (1e-4, 2e-4)) -> dict:
    """Random integer-exact inputs: coords and zq in [-coord_range,
    coord_range) (int32-safe for k * (2 * coord_range)^2 < 2^31), scale
    uniform in ``scale_range``, optional sketch (``s``), tenant stream
    (``tenants``) and ragged ``n_active``."""
    rng = np.random.default_rng(seed)
    c = coord_range
    a = dict(
        gids=rng.integers(0, g, size=(q, p)).astype(np.int32),
        zq=rng.integers(-c, c, size=(q, p, k)).astype(np.int32),
        rq=rng.uniform(0, 2, size=(q, p)).astype(np.float32),
        keep=rng.random((q, p)) < keep_frac,
        coords=rng.integers(-c, c, size=(g, k, cap)).astype(np.int16),
        res=rng.integers(0, 65536, size=(g, cap)).astype(np.int32),
        mask=rng.random((g, cap)) < mask_frac,
        rows=rng.permutation(g * cap).reshape(g, cap).astype(np.int32),
        scale=rng.uniform(*scale_range, size=g).astype(np.float32),
        res_scale=rng.uniform(1e-5, 2e-5, size=g).astype(np.float32))
    if s:
        a.update(sq=rng.integers(-127, 128, size=(q, p, s)).astype(np.int32),
                 sketch=rng.integers(-127, 128, size=(g, s, cap))
                 .astype(np.int8),
                 sketch_scale=rng.uniform(1e-3, 2e-3, size=g)
                 .astype(np.float32))
    if tenants:
        a.update(tenant_mask=rng.random((tenants, g, cap)) < 0.7,
                 tenant_ix=rng.integers(0, tenants, size=q).astype(np.int32))
    if ragged:
        a["n_active"] = rng.integers(1, p + 1, size=q).astype(np.int32)
    return a


def descending_inputs(*, q: int, p: int, k: int, cap: int) -> dict:
    """Every slot live and each nearer than every slot visited before it:
    probe i scans grain i, whose slot c lies at distance -(i * cap + c).
    So every slot enters the running top-W, and the kernel's candidate
    buffer fills and is folded into the carry as often as it can be.
    Distances stay exact in f32 while p * cap <= 2^24."""
    g = p
    visit = np.arange(g * cap, dtype=np.int32).reshape(g, cap)
    return dict(
        gids=np.tile(np.arange(p, dtype=np.int32), (q, 1)),
        zq=np.zeros((q, p, k), np.int32),
        rq=np.zeros((q, p), np.float32),
        keep=np.ones((q, p), bool),
        coords=np.zeros((g, k, cap), np.int16),
        res=-visit,
        mask=np.ones((g, cap), bool),
        rows=visit,
        scale=np.ones(g, np.float32),
        res_scale=np.ones(g, np.float32))


def split(a: dict, convert=lambda v: v):
    """(args, kwargs) of the select runner, each array passed through
    ``convert`` (for example to a tensor on a device)."""
    args = [convert(np.ascontiguousarray(a[n])) for n in ARG_NAMES]
    kw = {n: convert(np.ascontiguousarray(v)) for n, v in a.items()
          if n not in ARG_NAMES}
    return args, kw
