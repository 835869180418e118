"""Fused scan→select: the main path's kernel, and its dispatch.

``fused_scan_select`` streams only the probed grain panels of the stacked
index, prices every slot with the exact-int32 Eq. 6 distance plus the
residual, sketch and mask epilogue, and keeps a running top-``width`` per
query: candidate state is [Q, width] instead of [Q, P*cap].

- CPU tensors run the plain PyTorch version, ``fused_scan_select_ref``
  (``core.scan.blocksoa_select_ref``).
- CUDA tensors run the hand-written kernel ``csrc/fused_select.cu``
  (built at first use by ``_build``), or raise.  There is no fallback.

The kernel equals the plain version bit for bit: the same exact integer
sums, the same float op order without FMA contraction, and the same tie
order (stable by probe, then slot).  ``fused_scan_select.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.scan import blocksoa_select_ref as fused_scan_select_ref
from ..core.types import BIG
from . import _build

#: Largest ``width`` the kernel takes: its carry and candidate buffer live
#: in dynamic shared memory, next_pow2(width + 256) keys of 8 bytes each
#: (128 KB at this limit, of the 227 KB a block may use).
MAX_WIDTH = 8192

_SOURCE = "fused_select"
_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                            ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    fn = lib.fused_scan_select_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.fused_scan_select_error_string.argtypes = [ctypes.c_int]
        lib.fused_scan_select_error_string.restype = ctypes.c_char_p
        lib.fused_scan_select_max_width.restype = ctypes.c_int
        if lib.fused_scan_select_max_width() != MAX_WIDTH:
            raise RuntimeError("fused_select.cu and fused_select.py disagree "
                               "on the kernel's largest width")
    return lib


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


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(gids, zq, rq, keep, coords, res, mask, rows, scale, res_scale,
            sq, sketch, sketch_scale, width, tenant_mask, tenant_ix,
            n_active):
    dev = gids.device
    q_n, p_n, k = zq.shape
    g_n, _, cap = coords.shape
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(
            f"fused_scan_select: width={width} is outside the kernel's range "
            f"1..{MAX_WIDTH} (its top-W carry lives in shared memory)")
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
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_scan_select_launch(
            _ptr(gids), _ptr(zq), _ptr(rq), _ptr(keep), _ptr(coords),
            _ptr(res), _ptr(mask), _ptr(rows), _ptr(scale), _ptr(res_scale),
            _ptr(sq), _ptr(sketch), _ptr(sketch_scale), _ptr(tenant_mask),
            _ptr(tenant_ix), _ptr(n_active), _ptr(out_d), _ptr(out_r),
            q_n, p_n, k, s, g_n, cap, width, BIG, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.fused_scan_select_error_string(rc).decode()
        raise RuntimeError(f"fused_scan_select kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
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
    the kernel (``width`` <= ``MAX_WIDTH``) or raise.
    """
    if gids.device.type == "cpu":
        return fused_scan_select_ref(
            gids, zq, rq, keep, coords, res, mask, rows, scale, res_scale,
            sq, sketch, sketch_scale, width=width, tenant_mask=tenant_mask,
            tenant_ix=tenant_ix, n_active=n_active)
    if gids.device.type != "cuda":
        raise ValueError(f"fused_scan_select: no kernel for device "
                         f"{gids.device}")
    return _launch(gids, zq, rq, keep, coords, res, mask, rows, scale,
                   res_scale, sq, sketch, sketch_scale, width, tenant_mask,
                   tenant_ix, n_active)


fused_scan_select.launches = 0
