"""Fused scan→select: the main path's kernel, and its dispatch.

``fused_scan_select`` streams only the probed grain panels of the stacked
index, prices every slot with the exact-int32 Eq. 6 distance plus the
residual, sketch and mask epilogue, and keeps a running top-``width`` per
query: candidate state is [Q, width] instead of [Q, P*cap].

- CPU tensors run the plain PyTorch version, ``fused_scan_select_ref``
  (``core.scan.blocksoa_select_ref``).
- CUDA tensors run the hand-written kernels of ``csrc/fused_select.cu``
  (built at first use by ``_build``), or raise.  There is no fallback.
  One call is a schedule (``schedule``: the (query, probe) pairs in grain
  order, one ``torch.sort`` on the card), a per-probe kernel (each pair's
  own top-min(width, cap), in that order, so pairs that share a panel run
  together) and a merge.  A list of min(width, cap) keys below
  ``block_sort_length()`` is kept by one warp as a sorted carry (the main
  path); a longer one is priced and sorted block-wide by one CTA, in
  sorted runs of 4,096 keys where the cap exceeds that, merged per
  pair.  Up to ``SMEM_WIDTH`` with the warp's lists one kernel per
  query folds them into a top-``width`` carry in shared memory; every
  other shape (the cascade's stage 1, up to P * cap) takes a one-pass
  multi-way merge: a co-rank search per output tile, then one CTA per
  tile merging its slices of the lists.
- Meta tensors (the dry-run, ``launch.dryrun``) pass the same checks,
  return meta outputs of the kernels' shapes, launch nothing and report
  one call to the active cost counter (``counting``) with its
  ``select_cost``.  Any other device raises.

The kernels equal the plain version bit for bit: the same exact integer
sums, the same float op order without FMA contraction, and the same tie
order (stable by probe, then slot).  ``fused_scan_select.launches`` counts
calls that launched the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.scan import blocksoa_select_ref as fused_scan_select_ref
from ..core.scan import probe_alive
from ..core.types import BIG
from . import _build, counting
from ._launch import device_kind, launch

#: Widest ``width`` merged in shared memory (two copies of ``width`` keys
#: of 8 bytes, 128 KB at this limit, of the 227 KB a block may use) from
#: the warp's lists.  A wider ``width`` takes the multi-way merge in global
#: scratch and must be at most P * cap.  So the kernels take every
#: 1 <= width <= max(SMEM_WIDTH, P * cap).
SMEM_WIDTH = 8192

_SOURCE = "fused_select"
_ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                            ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    fn = lib.fused_scan_select_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.fused_scan_select_error_string.argtypes = [ctypes.c_int]
        lib.fused_scan_select_error_string.restype = ctypes.c_char_p
        lib.fused_scan_select_scratch_keys.argtypes = [ctypes.c_int] * 4
        lib.fused_scan_select_scratch_keys.restype = ctypes.c_longlong
        lib.fused_scan_select_smem_width.restype = ctypes.c_int
        lib.fused_scan_select_block_sort_length.restype = ctypes.c_int
        if lib.fused_scan_select_smem_width() != SMEM_WIDTH:
            raise RuntimeError("fused_select.cu and fused_select.py disagree "
                               "on the widest shared-memory merge")
    return lib


def block_sort_length() -> int:
    """The kernels' ``kBlockSortL``: a pair's list of min(width, cap) keys
    at least this long is built by the block-sort probe kernel and merged
    by the multi-way merge; a shorter one by the warp's carry.  Read from
    the built library (the card's build)."""
    return _lib().fused_scan_select_block_sort_length()


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"fused_scan_select: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"fused_scan_select: {name} has dtype {t.dtype}, "
                        f"expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_scan_select: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_scan_select: {name} must be contiguous")


def schedule(gids: torch.Tensor, keep: torch.Tensor, n_grains: int,
             n_active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-probe kernel's order of the Q*P (query, probe) pairs.

    int64 [Q*P] flat pair indices q * P + p: live pairs first, by grain id
    (gids in [0, n_grains)), pairs of one grain in (q, p) order; killed
    pairs (keep == 0 or p >= n_active[q]) last.  One stable sort on the
    tensors' device, no host sync; int16 keys where the grain ids fit
    (half the radix passes of int32).  It changes only when each pair
    runs, never the result.
    """
    dtype = torch.int16 if n_grains < torch.iinfo(torch.int16).max \
        else torch.int32
    killed = torch.iinfo(dtype).max               # after every grain id
    key = torch.where(probe_alive(keep, n_active), gids.to(dtype), killed)
    return torch.sort(key.reshape(-1), stable=True).indices


def vector_loads(cap: int, *panels: Optional[torch.Tensor]) -> bool:
    """Whether the per-probe kernel may read 4 slots per load: cap a
    multiple of 4 and every panel's base 16-byte aligned."""
    return cap % 4 == 0 and all(t is None or t.data_ptr() % 16 == 0
                                for t in panels)


def select_cost(gids, zq, rq, keep, coords, res, mask, rows, scale,
                res_scale, sq=None, sketch=None, sketch_scale=None, *,
                width: int, tenant_mask=None, tenant_ix=None,
                n_active=None):
    """(bytes, operations) of one call at the least its shapes allow,
    with no data to read (the meta branch): the probed panels read once
    each, min(G, Q * P) grains of them (per slot: coordinates, sketch,
    residual and mask; 12 bytes of scales per grain), the [Q, P] probe
    arrays and ``sq`` read once, a byte per (tenant, slot) of the probed
    grains, and the outputs written once (dists, rows and the row lookup:
    12 bytes per kept slot); every slot of every pair priced at
    3 (k + s) + 7 integer operations (``chip_smoke.py``'s
    ``select_bound``, which counts the probed grains and live slots from
    the data instead)."""
    q_n, p_n, k = zq.shape
    g_n, _, cap = coords.shape
    s = 0 if sq is None else sq.shape[2]
    grains = min(g_n, q_n * p_n)
    per_grain = cap * (coords.element_size() * k + s + 4 + 1) + 12
    nbytes = grains * per_grain + sum(
        t.numel() * t.element_size() for t in (gids, zq, rq, keep)) \
        + (0 if sq is None else sq.numel() * 4) + q_n * width * 12
    if tenant_mask is not None:
        nbytes += grains * cap + q_n * 4
    return nbytes, q_n * p_n * cap * (3 * (k + s) + 7)


def _launch(gids, zq, rq, keep, coords, res, mask, rows, scale, res_scale,
            sq, sketch, sketch_scale, width, tenant_mask, tenant_ix,
            n_active):
    dev = gids.device
    q_n, p_n, k = zq.shape
    g_n, _, cap = coords.shape
    if not 1 <= width <= min(max(SMEM_WIDTH, p_n * cap), 2 ** 31 - 1):
        raise ValueError(
            f"fused_scan_select: width={width} is outside the kernel's range "
            f"1..max({SMEM_WIDTH}, P * cap = {p_n * cap}) (below 2^31)")
    if p_n * cap >= 2 ** 32 - 1:
        raise ValueError("fused_scan_select: P * cap must be < 2^32 - 1")
    if (sketch is None) != (sq is None) or (sketch is None) != \
            (sketch_scale is None):
        raise ValueError("fused_scan_select: sq, sketch and sketch_scale "
                         "come together")
    if (tenant_mask is None) != (tenant_ix is None):
        raise ValueError("fused_scan_select: tenant_mask and tenant_ix "
                         "come together")
    _check("gids", gids, torch.int32, (q_n, p_n), dev)
    _check("zq", zq, torch.int32, (q_n, p_n, k), dev)
    _check("rq", rq, torch.float32, (q_n, p_n), dev)
    _check("keep", keep, torch.bool, (q_n, p_n), dev)
    _check("coords", coords, torch.int16, (g_n, k, cap), dev)
    for name, t, dt in (("res", res, torch.int32), ("mask", mask, torch.bool),
                        ("rows", rows, torch.int32)):
        _check(name, t, dt, (g_n, cap), dev)
    _check("scale", scale, torch.float32, (g_n,), dev)
    _check("res_scale", res_scale, torch.float32, (g_n,), dev)
    s = 0
    if sketch is not None:
        s = sq.shape[2]
        _check("sq", sq, torch.int32, (q_n, p_n, s), dev)
        _check("sketch", sketch, torch.int8, (g_n, s, cap), dev)
        _check("sketch_scale", sketch_scale, torch.float32, (g_n,), dev)
    if tenant_mask is not None:
        _check("tenant_mask", tenant_mask, torch.bool,
               (tenant_mask.shape[0], g_n, cap), dev)
        _check("tenant_ix", tenant_ix, torch.int32, (q_n,), dev)
    if n_active is not None:
        _check("n_active", n_active, torch.int32, (q_n,), dev)

    out_d = torch.empty((q_n, width), dtype=torch.float32, device=dev)
    out_r = torch.empty((q_n, width), dtype=torch.int32, device=dev)
    if q_n == 0:
        return out_d, out_r
    if p_n == 0 or cap == 0:                      # nothing to visit
        return out_d.fill_(BIG), out_r.fill_(-1)
    if q_n * p_n >= 2 ** 31:
        raise ValueError("fused_scan_select: Q * P must be < 2^31")
    if dev.type == "meta":
        counting.report("fused_scan_select", *select_cost(
            gids, zq, rq, keep, coords, res, mask, rows, scale, res_scale,
            sq, sketch, sketch_scale, width=width, tenant_mask=tenant_mask,
            tenant_ix=tenant_ix, n_active=n_active))
        return out_d, out_r
    lib = _lib()
    with torch.cuda.device(dev):
        order = schedule(gids, keep, g_n, n_active)
        lists = torch.empty((q_n * p_n, min(width, cap)), dtype=torch.int64,
                            device=dev)
        n_scratch = lib.fused_scan_select_scratch_keys(q_n, p_n, cap, width)
        scratch = (torch.empty(n_scratch, dtype=torch.int64, device=dev)
                   if n_scratch else None)
    vec = vector_loads(cap, coords, res, mask, sketch, tenant_mask)
    launch("fused_scan_select", lib, "fused_scan_select_launch",
           "fused_scan_select_error_string", dev, gids, zq, rq, keep, coords,
           res, mask, rows, scale, res_scale, sq, sketch, sketch_scale,
           tenant_mask, tenant_ix, n_active, order, lists, scratch, out_d,
           out_r, q_n, p_n, k, s, g_n, cap, width, int(vec), BIG)
    fused_scan_select.launches += 1
    return out_d, out_r


def fused_scan_select(gids, zq, rq, keep, coords, res, mask, rows, scale,
                      res_scale, sq=None, sketch=None, sketch_scale=None, *,
                      width: int, tenant_mask=None, tenant_ix=None,
                      n_active=None):
    """Streaming scan→select over the probed grains of a stacked index.

    Args (Q queries, P probed grains per query, G grains, cap slots):
      gids [Q, P] i32, zq [Q, P, k] i32, rq [Q, P] f32, keep [Q, P] bool,
      coords [G, k, cap] i16, res [G, cap] i32, mask [G, cap] bool,
      rows [G, cap] i32, scale/res_scale [G] f32.
      Optional sketch: sq [Q, P, s] i32, sketch [G, s, cap] i8,
      sketch_scale [G] f32.  Optional tenancy: tenant_mask [T, G, cap]
      bool + tenant_ix [Q] i32.  Optional ragged probes: n_active [Q] i32.

    Returns (dists [Q, width] f32 ascending, rows [Q, width] i32), with
    (BIG, -1) beyond the live candidates; see ``blocksoa_select_ref`` for
    the exact order.  CPU tensors take the plain version; CUDA tensors take
    the kernels (1 <= ``width`` <= max(``SMEM_WIDTH``, P * cap)) or raise.

    Device memory on the card, besides the outputs: the pairs' lists,
    Q * P * min(width, cap) keys of 8 bytes, and the multi-way merge's
    scratch (``fused_scan_select_scratch_keys``): its co-ranks and, where
    the cap exceeds 4,096 with a list of ``block_sort_length()`` keys or
    more, each pair's sorted runs, Q * P * ceil(cap / 4096) * min(4096,
    width, cap) keys.  At Q=256, P=16 and cap 22,912
    (width >= cap) the lists take 0.75 GB and the runs 0.81 GB per call.
    """
    if device_kind("fused_scan_select", gids, meta=True) == "cpu":
        return fused_scan_select_ref(
            gids, zq, rq, keep, coords, res, mask, rows, scale, res_scale,
            sq, sketch, sketch_scale, width=width, tenant_mask=tenant_mask,
            tenant_ix=tenant_ix, n_active=n_active)
    return _launch(gids, zq, rq, keep, coords, res, mask, rows, scale,
                   res_scale, sq, sketch, sketch_scale, width, tenant_mask,
                   tenant_ix, n_active)


fused_scan_select.launches = 0
