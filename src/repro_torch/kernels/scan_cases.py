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


# ---------------------------------------------------------------------------
# The Table 2 layouts (``kernels.layout_scan``)
# ---------------------------------------------------------------------------

#: ``aos_scan``'s and ``pointer_chase_scan``'s tensor arguments, in order
#: (the chase's ``n_steps`` sits between ``head`` and ``scale``).
AOS_ARG_NAMES = ("zq", "rq", "coords_aos", "res", "valid", "scale",
                 "res_scale")
CHASE_ARG_NAMES = ("zq", "rq", "coords_flat", "res_flat", "next_ptr", "head",
                   "scale", "res_scale")


def aos(seed: int, *, p: int, cap: int, k: int, coord_dtype=np.int16,
        coord_range: int = 500, valid_frac: float = 0.85,
        zq_range=None) -> dict:
    """``aos_scan`` inputs: the Block-SoA panels of ``panels`` in the
    vector-major layout [P, cap, k]."""
    a = single(panels(seed, p=p, q=1, k=k, cap=cap, coord_range=coord_range,
                      coord_dtype=coord_dtype, valid_frac=valid_frac,
                      zq_range=zq_range))
    a["coords_aos"] = np.ascontiguousarray(a.pop("coords").transpose(0, 2, 1))
    return a


def cyclic_list(rng, n: int) -> tuple:
    """(next_ptr [n] int32, head): one cycle through a random permutation,
    as ``benchmarks/table2_scan.py`` links its rows."""
    perm = rng.permutation(n).astype(np.int32)
    nxt = np.empty(n, np.int32)
    nxt[perm[:-1]] = perm[1:]
    nxt[perm[-1]] = perm[0]
    return nxt, int(perm[0])


def chase(seed: int, *, n: int, k: int, n_steps: int, coord_dtype=np.int32,
          coord_range: int = 500, head=None, bad_ptrs: int = 0,
          zq_range=None) -> dict:
    """``pointer_chase_scan`` inputs over a cyclic list of ``n`` rows;
    ``bad_ptrs`` of its pointers are replaced by negative and
    out-of-range values (read as JAX reads them), ``head`` overrides the
    cycle's start."""
    rng = np.random.default_rng(seed)
    c = coord_range
    zr = c if zq_range is None else zq_range
    nxt, start = cyclic_list(rng, n)
    if bad_ptrs:
        at = rng.choice(n, size=min(bad_ptrs, n), replace=False)
        pool = np.array([-1, -n, -n - 3, n, n + 7, -2 ** 31, 2 ** 31 - 1],
                        np.int64)
        nxt[at] = pool[np.arange(at.size) % pool.size].astype(np.int32)
    return dict(
        zq=rng.integers(-zr, zr, k, dtype=np.int64).astype(np.int32),
        rq=np.float32(rng.random()),
        coords_flat=rng.integers(-c, c, (n, k)).astype(coord_dtype),
        res_flat=rng.integers(0, 65535, n).astype(np.int32),
        next_ptr=nxt,
        head=np.int32(start if head is None else head),
        n_steps=n_steps,
        scale=np.float32(rng.random() * 0.01 + 1e-4),
        res_scale=np.float32(rng.random() * 1e-3 + 1e-5))


def chase_args(a: dict, to) -> list:
    """``pointer_chase_scan``'s positional arguments, each array (0-d
    ones too) passed through ``to``; ``n_steps`` stays an int."""
    out = [to(np.ascontiguousarray(a[n]) if np.ndim(a[n]) else
              np.asarray(a[n])) for n in CHASE_ARG_NAMES]
    return out[:6] + [a["n_steps"]] + out[6:]


def aos_args(a: dict, to) -> list:
    """``aos_scan``'s positional arguments, each passed through ``to``."""
    return [to(np.ascontiguousarray(a[n])) for n in AOS_ARG_NAMES]


#: (label, form, maker, seed, keyword arguments) of every case the layout
#: kernels are held to on the card: k of 1, 8, 32 and 33, int16 and int32
#: coordinates, invalid slots, int32 wraparound, ``n_steps`` below, at
#: and above N, out-of-range and negative pointers, heads at 0 and N - 1.
LAYOUT_CASES = [
    *((f"k={k} {np.dtype(dt).name}", form, make, 40 + i,
       dict(coord_dtype=dt, k=k, **(dict(p=3, cap=300) if form == "aos"
                                    else dict(n=500, n_steps=500))))
      for i, k in enumerate((1, 8, 32, 33)) for dt in (np.int16, np.int32)
      for form, make in (("aos", aos), ("chase", chase))),
    ("all invalid", "aos", aos, 60, dict(p=2, cap=257, k=8, valid_frac=0.0)),
    ("int32 wraparound", "aos", aos, 61, dict(
        p=2, cap=300, k=33, coord_dtype=np.int32, coord_range=2 ** 31 - 1,
        zq_range=2 ** 31 - 1)),
    ("int32 wraparound", "chase", chase, 62, dict(
        n=300, k=33, n_steps=300, coord_range=2 ** 31 - 1,
        zq_range=2 ** 31 - 1)),
    ("P=1 cap=65536 k=8 (Table 2)", "aos", aos, 63, dict(
        p=1, cap=65536, k=8, valid_frac=1.0)),
    ("n_steps < N", "chase", chase, 64, dict(n=400, k=8, n_steps=123)),
    ("n_steps > N (the cycle twice and more)", "chase", chase, 65, dict(
        n=400, k=8, n_steps=1000)),
    ("bad pointers, int16", "chase", chase, 66, dict(
        n=400, k=32, n_steps=800, coord_dtype=np.int16, bad_ptrs=40)),
    ("head 0", "chase", chase, 67, dict(n=300, k=8, n_steps=600, head=0,
                                        bad_ptrs=10)),
    ("head N-1", "chase", chase, 68, dict(n=300, k=8, n_steps=600, head=299,
                                          bad_ptrs=10)),
    ("head -1", "chase", chase, 69, dict(n=300, k=8, n_steps=50, head=-1)),
    ("head past N", "chase", chase, 70, dict(n=300, k=8, n_steps=50,
                                             head=10 ** 6)),
    ("N=1", "chase", chase, 71, dict(n=1, k=8, n_steps=5)),
]


def layout_cases() -> list:
    """(label, form, inputs) of ``LAYOUT_CASES``, the inputs made."""
    return [(label, form, make(seed, **kw))
            for label, form, make, seed, kw in LAYOUT_CASES]


def table2(n: int = 65536, k: int = 8, seed: int = 0) -> dict:
    """The inputs of ``benchmarks/table2_scan.py``'s ``run`` (the same
    draws in the same order): one panel of n int16 vectors in
    [-500, 500), residuals in [0, 60000), scale 1e-3, res_scale 1e-4, all
    slots valid, and a cyclic list over a random permutation.  Returns
    ``soa`` (``hntl_scan_single``'s inputs, [1, k, n]), ``aos`` ([1, n, k])
    and ``chase`` (int32 [n, k] rows, n steps from the cycle's start)."""
    rng = np.random.default_rng(seed)
    p = 1
    coords = rng.integers(-500, 500, (p, k, n)).astype(np.int16)
    res = rng.integers(0, 60000, (p, n)).astype(np.int32)
    valid = np.ones((p, n), bool)
    scale = np.full(p, 1e-3, np.float32)
    res_scale = np.full(p, 1e-4, np.float32)
    zq = rng.integers(-500, 500, (p, k)).astype(np.int32)
    rq = rng.random(p).astype(np.float32)
    nxt, head = cyclic_list(rng, n)
    soa = dict(zq=zq, rq=rq, coords=coords, res=res, valid=valid,
               scale=scale, res_scale=res_scale)
    return dict(
        soa=soa,
        aos=dict(soa, coords_aos=np.ascontiguousarray(
            coords.transpose(0, 2, 1))),
        chase=dict(zq=zq[0], rq=rq[0], coords_flat=np.ascontiguousarray(
            coords[0].T.astype(np.int32)), res_flat=res[0], next_ptr=nxt,
            head=np.int32(head), n_steps=n, scale=scale[0],
            res_scale=res_scale[0]))
