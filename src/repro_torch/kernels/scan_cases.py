"""Inputs of the Block-SoA scan contract, made with numpy from a seed.

Used to hold ``hntl_scan`` and ``hntl_scan_single`` against their plain
versions: by ``chip_smoke.py`` on the card and by the port's tests.
``panels`` returns a dict of numpy arrays under the kernels' argument
names, with a leading query axis Q (drop it with ``single``).
"""
from __future__ import annotations

import numpy as np

from ..core.index import int32_safe_qmax

#: The kernels' positional arguments, in order.
ARG_NAMES = ("zq", "rq", "coords", "res", "valid", "scale", "res_scale")

#: (P, Q, k, cap) of the JAX package's kernel sweep: tile-aligned, ragged
#: and tiny shapes (Q and cap off the TPU's 8 x 128 tiling included).
SWEEP = [
    (1, 1, 8, 128),
    (2, 3, 16, 256),
    (4, 128, 32, 512),
    (3, 130, 16, 384),
    (2, 5, 64, 128),
    (1, 256, 8, 1024),
]

#: (P, k, cap) of the JAX package's single-query sweep.
SINGLE_SWEEP = [(1, 8, 128), (3, 16, 200), (8, 32, 512)]


def panels(seed: int, *, p: int, q: int, k: int, cap: int,
           coord_range: int = 500, coord_dtype=np.int16,
           valid_frac: float = 0.85, zq_range=None) -> dict:
    """Random integer-exact inputs as in the JAX package's kernel tests:
    coords and zq in [-coord_range, coord_range), residuals in the
    unsigned 16-bit range, scales near 1e-3 and 1e-4.  ``zq_range``
    widens the queries alone (int32 wraparound cases)."""
    rng = np.random.default_rng(seed)
    c = coord_range
    zr = c if zq_range is None else zq_range
    return dict(
        zq=rng.integers(-zr, zr, (p, q, k), dtype=np.int64).astype(np.int32),
        rq=rng.random((p, q)).astype(np.float32),
        coords=rng.integers(-c, c, (p, k, cap)).astype(coord_dtype),
        res=rng.integers(0, 65535, (p, cap)).astype(np.int32),
        valid=rng.random((p, cap)) < valid_frac,
        scale=(rng.random(p) * 0.01 + 1e-4).astype(np.float32),
        res_scale=(rng.random(p) * 1e-3 + 1e-5).astype(np.float32),
    )


def extremes(*, p: int, q: int, k: int, cap: int) -> dict:
    """Every |zq - coord| at 2 * int32_safe_qmax(k): the largest exact
    int32 sum."""
    qmax = int32_safe_qmax(k)
    a = panels(0, p=p, q=q, k=k, cap=cap, valid_frac=1.0)
    a["zq"] = np.full((p, q, k), qmax, np.int32)
    a["coords"] = np.full((p, k, cap), -qmax, np.int16)
    return a


def single(a: dict) -> dict:
    """The single-query form of a Q=1 input: zq [P, k], rq [P]."""
    out = dict(a)
    out["zq"] = a["zq"][:, 0]
    out["rq"] = a["rq"][:, 0]
    return out


def args(a: dict, to) -> list:
    """The kernels' positional arguments, each passed through ``to``."""
    return [to(np.ascontiguousarray(a[n])) for n in ARG_NAMES]
