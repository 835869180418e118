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


def mini_plane_inputs(seed: int, *, q: int, p: int, g: int, k: int,
                      cap: int, s: int = 0) -> dict:
    """``random_inputs`` shaped like a tiered residency pass over a
    mini-plane of ``g`` grains: the last grain is the all-invalid dummy
    (mask False, rows -1, zero panels), each query has 1..p live probes
    (``n_active``) on the other grains, and the slack probes after them
    point at the dummy.  ``q`` should be a power of two, as the store's
    passes are."""
    a = random_inputs(seed, q=q, p=p, g=g, k=k, cap=cap, s=s, ragged=True)
    rng = np.random.default_rng(seed + 1)
    a["gids"] = rng.integers(0, g - 1, size=(q, p)).astype(np.int32)
    slack = np.arange(p)[None, :] >= a["n_active"][:, None]
    a["gids"][slack] = g - 1
    a["coords"][-1] = 0
    a["res"][-1] = 0
    a["mask"][-1] = False
    a["rows"][-1] = -1
    if s:
        a["sketch"][-1] = 0
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


def hot_grain_inputs(seed: int, **shape) -> dict:
    """``random_inputs`` with every query probing grain 0 at every probe:
    every pair lands in one run of the kernel's grain-ordered schedule."""
    a = random_inputs(seed, **shape)
    a["gids"][:] = 0
    return a


def tie_inputs(*, q: int, p: int, g: int, k: int, cap: int,
               s: int = 0) -> dict:
    """Every slot live and at the same distance (zero coordinates and
    sketch, a constant residual): the result is ordered by (probe, slot)
    alone.  Query i probes grains (i + j) % g at probe j, and probe p - 1
    repeats probe 0's grain, so equal keys meet across different grains
    and across two probes of one grain."""
    gids = (np.arange(q)[:, None] + np.arange(p)[None, :]) % g
    gids[:, -1] = gids[:, 0]
    a = dict(
        gids=gids.astype(np.int32),
        zq=np.zeros((q, p, k), np.int32),
        rq=np.zeros((q, p), np.float32),
        keep=np.ones((q, p), bool),
        coords=np.zeros((g, k, cap), np.int16),
        res=np.full((g, cap), 3, np.int32),
        mask=np.ones((g, cap), bool),
        rows=np.arange(g * cap, dtype=np.int32).reshape(g, cap),
        scale=np.ones(g, np.float32),
        res_scale=np.full(g, 0.5, np.float32))
    if s:
        a.update(sq=np.zeros((q, p, s), np.int32),
                 sketch=np.zeros((g, s, cap), np.int8),
                 sketch_scale=np.ones(g, np.float32))
    return a


def stage1_inputs(seed: int, *, q: int, p: int, g: int, cap: int,
                  **kw) -> dict:
    """``random_inputs`` in the form the cascade's stage 1 gives the
    select: a k=1 zero coordinate panel, zero query coordinates, and flat
    slot ids g * cap + c as rows, so each slot is priced at its residual,
    query-residual and sketch terms alone."""
    a = random_inputs(seed, q=q, p=p, g=g, k=1, cap=cap, **kw)
    a["zq"][:] = 0
    a["coords"][:] = 0
    a["rows"] = np.arange(g * cap, dtype=np.int32).reshape(g, cap)
    return a


#: Inputs of the wide paths (the block-sort probe kernel and the multi-way
#: merge): name -> (width, maker).  A width may be a function of the
#: kernels' block-sort threshold (``fused_select.block_sort_length()``,
#: read on the card; ``resolve_width``): lists one below, at and one
#: above it, as the fused plane gives them (width = L).  Every slot live
#: at width = P * cap; descending keys, where every slot enters the pool,
#: at a width just above 8,192; equal keys across probes; ragged
#: n_active; the cascade's stage-1 form at the paper's probe shape (P=16,
#: cap=1664: width 26,624 and 4,096) and with an odd probe count.
WIDE_CASES = {
    "block_sort_l_minus_1": (lambda bsl: bsl - 1, lambda: random_inputs(
        19, q=32, p=16, g=64, k=32, cap=2100, s=8, ragged=True)),
    "block_sort_l": (lambda bsl: bsl, lambda: random_inputs(
        20, q=32, p=16, g=64, k=32, cap=2100, s=8, ragged=True)),
    "block_sort_l_plus_1": (lambda bsl: bsl + 1, lambda: random_inputs(
        21, q=32, p=16, g=64, k=32, cap=2100, s=8, ragged=True)),
    "all_live_width_p_cap": (16 * 1664, lambda: random_inputs(
        11, q=32, p=16, g=64, k=32, cap=1664, s=8, keep_frac=1.0,
        mask_frac=1.0)),
    "descending_width_8193": (8193, lambda: descending_inputs(
        q=16, p=8, k=8, cap=2048)),
    "ties_across_probes_wide": (9000, lambda: tie_inputs(
        q=8, p=8, g=5, k=8, cap=1200, s=4)),
    "ragged_n_active_wide": (12000, lambda: random_inputs(
        12, q=64, p=16, g=64, k=32, cap=1000, s=8, ragged=True)),
    "stage1_form_p16_cap1664": (16 * 1664, lambda: stage1_inputs(
        13, q=64, p=16, g=256, cap=1664, s=8)),
    "stage1_form_width_4096": (4096, lambda: stage1_inputs(
        22, q=64, p=16, g=256, cap=1664, s=8)),
    "stage1_form_odd_p": (8999, lambda: stage1_inputs(
        14, q=16, p=9, g=40, cap=1000, s=8, keep_frac=0.7)),
}


def resolve_width(width, block_sort_l: int) -> int:
    """A case's width: ``width`` itself, or ``width(block_sort_l)``."""
    return width(block_sort_l) if callable(width) else width


#: Inputs whose per-probe list min(width, cap) is longer than the keys a
#: CTA sorts at once (4,096, ``kSortKeys`` in ``csrc/fused_select.cu``),
#: which the kernels build from each pair's sorted runs: name -> (width,
#: maker).
#: One run of 4,096 keys plus one key (cap 4,097, the scalar loads),
#: width = cap and width = P * cap at cap 8,320, ragged n_active and
#: killed pairs at cap 16,384, a sketch.
LONG_LIST_CASES = {
    "cap4097_one_run_plus_one_key": (4097, lambda: random_inputs(
        19, q=8, p=4, g=8, k=8, cap=4097, s=4)),
    "cap8320_width_cap": (8320, lambda: random_inputs(
        15, q=8, p=4, g=8, k=8, cap=8320)),
    "cap8320_width_p_cap": (4 * 8320, lambda: random_inputs(
        16, q=8, p=4, g=8, k=8, cap=8320)),
    "ragged_cap16384": (20000, lambda: random_inputs(
        17, q=8, p=4, g=8, k=8, cap=16384, ragged=True, keep_frac=0.7)),
    "sketch_cap8320": (10000, lambda: random_inputs(
        18, q=8, p=4, g=8, k=8, cap=8320, s=8)),
}


def split(a: dict, convert=lambda v: v):
    """(args, kwargs) of the select runner, each array passed through
    ``convert`` (for example to a tensor on a device)."""
    args = [convert(np.ascontiguousarray(a[n])) for n in ARG_NAMES]
    kw = {n: convert(np.ascontiguousarray(v)) for n, v in a.items()
          if n not in ARG_NAMES}
    return args, kw
