"""The paper's Table 2 baselines: the Array-of-Structures scan and the
linked-list (pointer-chase) scan, one device program each.

``aos_scan`` prices every slot of P vector-major panels [P, cap, k];
``pointer_chase_scan`` follows ``next_ptr`` from ``head`` for
``n_steps`` and prices each row it visits.  They are the counterparts of
the JAX package's ``core/scan.py`` ``aos_scan`` and
``pointer_chase_scan``, which ``jax.jit`` makes into one device program
each; the Block-SoA scan they are compared with is
``hntl_scan.hntl_scan_single``.

- CPU tensors run the plain PyTorch versions (``kernels.ref``).
- CUDA tensors run the hand-written kernels of ``csrc/layout_scan.cu``
  (built at first use by ``_build``), or raise.  There is no fallback.
- Any other device raises.

The kernels equal their plain versions bit for bit.  Coordinates are
int16 or int32 on the card.  ``aos_scan.launches`` and
``pointer_chase_scan.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.types import BIG
from . import _build
from ._launch import device_kind, launch
from .hntl_scan import _check
from .ref import aos_scan_ref, pointer_chase_scan_ref

_SOURCE = "layout_scan"
_COORD_BYTES = {torch.int16: 2, torch.int32: 4}


def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    if lib.aos_scan_launch.argtypes is None:
        lib.aos_scan_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
        lib.pointer_chase_scan_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
        lib.aos_scan_launch.restype = ctypes.c_int
        lib.pointer_chase_scan_launch.restype = ctypes.c_int
        lib.layout_scan_error_string.argtypes = [ctypes.c_int]
        lib.layout_scan_error_string.restype = ctypes.c_char_p
    return lib


def aos_scan(zq, rq, coords_aos, res, valid, scale, res_scale):
    """Array-of-Structures scan over P vector-major panels.

    zq [P, k] i32, rq [P] f32, coords_aos [P, cap, k] i16 or i32,
    res [P, cap] i32, valid [P, cap] bool, scale/res_scale [P] f32.
    Returns [P, cap] f32 (BIG on invalid slots).
    """
    if device_kind("aos_scan", zq) == "cpu":
        return aos_scan_ref(zq, rq, coords_aos, res, valid, scale, res_scale)
    fn, dev = "aos_scan", zq.device
    p, k = zq.shape
    cap = coords_aos.shape[1]
    _check(fn, "zq", zq, torch.int32, (p, k), dev)
    _check(fn, "rq", rq, torch.float32, (p,), dev)
    _check(fn, "coords_aos", coords_aos, tuple(_COORD_BYTES), (p, cap, k),
           dev)
    _check(fn, "res", res, torch.int32, (p, cap), dev)
    _check(fn, "valid", valid, torch.bool, (p, cap), dev)
    _check(fn, "scale", scale, torch.float32, (p,), dev)
    _check(fn, "res_scale", res_scale, torch.float32, (p,), dev)
    if p >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"{fn}: P and k must be < 2^31")
    out = torch.empty((p, cap), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    launch(fn, _lib(), "aos_scan_launch", "layout_scan_error_string", dev,
           zq, rq, coords_aos, _COORD_BYTES[coords_aos.dtype], res, valid,
           scale, res_scale, out, p, k, cap, BIG)
    aos_scan.launches += 1
    return out


def pointer_chase_scan(zq, rq, coords_flat, res_flat, next_ptr, head,
                       n_steps: int, scale, res_scale):
    """Linked-list scan: ``n_steps`` rows from ``head`` along ``next_ptr``.

    zq [k] i32, rq [] f32, coords_flat [N, k] i16 or i32, res_flat [N]
    i32, next_ptr [N] i32, head [] i32, scale/res_scale [] f32.  Returns
    [n_steps] f32 in visit order.  A pointer is read as the JAX package's
    gather reads it: negative counts from the end, then clamped to
    [0, N-1].
    """
    if device_kind("pointer_chase_scan", zq) == "cpu":
        return pointer_chase_scan_ref(zq, rq, coords_flat, res_flat,
                                      next_ptr, head, n_steps, scale,
                                      res_scale)
    fn, dev = "pointer_chase_scan", zq.device
    (k,) = zq.shape
    n = coords_flat.shape[0]
    _check(fn, "zq", zq, torch.int32, (k,), dev)
    _check(fn, "rq", rq, torch.float32, (), dev)
    _check(fn, "coords_flat", coords_flat, tuple(_COORD_BYTES), (n, k), dev)
    _check(fn, "res_flat", res_flat, torch.int32, (n,), dev)
    _check(fn, "next_ptr", next_ptr, torch.int32, (n,), dev)
    _check(fn, "head", head, torch.int32, (), dev)
    _check(fn, "scale", scale, torch.float32, (), dev)
    _check(fn, "res_scale", res_scale, torch.float32, (), dev)
    n_steps = int(n_steps)
    if n_steps < 0:
        raise ValueError(f"{fn}: n_steps must be >= 0, got {n_steps}")
    if k >= 2 ** 31:
        raise ValueError(f"{fn}: k must be < 2^31")
    out = torch.empty((n_steps,), dtype=torch.float32, device=dev)
    if n_steps == 0:
        return out
    if n == 0:
        raise ValueError(f"{fn}: an empty list has no rows to visit")
    launch(fn, _lib(), "pointer_chase_scan_launch",
           "layout_scan_error_string", dev, zq, rq, coords_flat,
           _COORD_BYTES[coords_flat.dtype], res_flat, next_ptr, head, scale,
           res_scale, out, n, n_steps, k)
    pointer_chase_scan.launches += 1
    return out


aos_scan.launches = 0
pointer_chase_scan.launches = 0
