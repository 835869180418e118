"""Block-SoA scan kernels: the single-query and the batched-query form.

``hntl_scan_single`` scans P independent (query, panel) pairs;
``hntl_scan`` scans P panels against Q queries each.  Both price every
slot with the exact-int32 Eq. 6 distance and the residual epilogue, with
``core.types.BIG`` on invalid slots.

- CPU tensors run the plain PyTorch versions (``kernels.ref``).
- CUDA tensors run the hand-written kernels of ``csrc/hntl_scan.cu``
  (built at first use by ``_build``), or raise.  There is no fallback.
- Meta tensors (the dry-run, ``launch.dryrun``) pass the CUDA branch's
  checks, return meta outputs of the kernel's shape, launch nothing and
  report one call to the active cost counter (``counting``) with its
  ``scan_cost``.
- Any other device raises.

The kernels equal their plain versions bit for bit: the same integer sums
modulo 2^32 and the same float op order without FMA contraction.
``hntl_scan.launches`` and ``hntl_scan_single.launches`` count kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.types import BIG
from . import _build, counting
from ._launch import device_kind, launch
from .ref import hntl_scan_ref, hntl_scan_single_ref

#: Largest k the single-query kernel takes (its zq lives in shared memory).
MAX_K = 4096

_SOURCE = "hntl_scan"
_COORD_BYTES = {torch.int16: 2, torch.int8: 1}
_PTRS = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5


def _lib() -> ctypes.CDLL:
    lib = _build.library(_SOURCE)
    if lib.hntl_scan_launch.argtypes is None:
        lib.hntl_scan_single_launch.argtypes = _PTRS + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.hntl_scan_launch.argtypes = _PTRS + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.hntl_scan_single_launch.restype = ctypes.c_int
        lib.hntl_scan_launch.restype = ctypes.c_int
        lib.hntl_scan_error_string.argtypes = [ctypes.c_int]
        lib.hntl_scan_error_string.restype = ctypes.c_char_p
        lib.hntl_scan_max_k.restype = ctypes.c_int
        if lib.hntl_scan_max_k() != MAX_K:
            raise RuntimeError("hntl_scan.cu and hntl_scan.py disagree on "
                               "the single-query kernel's largest k")
    return lib


def _check(fn, name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{fn}: {name} has dtype {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_all(fn, zq, rq, coords, res, valid, scale, res_scale, lead):
    """Contract checks common to both forms; ``lead`` is zq's leading
    shape ([P] or [P, Q])."""
    dev = zq.device
    p, k, cap = lead[0], zq.shape[-1], coords.shape[-1]
    _check(fn, "zq", zq, torch.int32, (*lead, k), dev)
    _check(fn, "rq", rq, torch.float32, lead, dev)
    _check(fn, "coords", coords, tuple(_COORD_BYTES), (p, k, cap), dev)
    _check(fn, "res", res, torch.int32, (p, cap), dev)
    _check(fn, "valid", valid, torch.bool, (p, cap), dev)
    _check(fn, "scale", scale, torch.float32, (p,), dev)
    _check(fn, "res_scale", res_scale, torch.float32, (p,), dev)
    if p >= 2 ** 31:
        raise ValueError(f"{fn}: P must be < 2^31")


def _run(fn, entry, zq, rq, coords, res, valid, scale, res_scale, out,
         dims):
    launch(fn, _lib(), entry, "hntl_scan_error_string", zq.device, zq, rq,
           coords, _COORD_BYTES[coords.dtype], res, valid, scale, res_scale,
           out, *dims, BIG)


def scan_cost(zq, rq, coords, res, valid, scale, res_scale):
    """(bytes, operations) of one launch of either scan: each input read
    once and the [P, Q, cap] float32 output written once; per (query,
    slot) k multiply-adds (2 operations each, the cross-term form) and
    the epilogue's 6.  Q = 1 for ``hntl_scan_single`` (zq [P, k])."""
    p, k, cap = coords.shape
    q = zq.numel() // max(p * k, 1)
    args = (zq, rq, coords, res, valid, scale, res_scale)
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + p * q * cap * 4
    return nbytes, p * q * cap * (2 * k + 6)


def hntl_scan_single(zq, rq, coords, res, valid, scale, res_scale):
    """Single-query Block-SoA scan over P independent grain panels.

    zq [P, k] i32, rq [P] f32, coords [P, k, cap] i16 or i8,
    res [P, cap] i32, valid [P, cap] bool, scale/res_scale [P] f32.
    Returns [P, cap] f32 (BIG on invalid slots).
    """
    kind = device_kind("hntl_scan_single", zq, meta=True)
    if kind == "cpu":
        return hntl_scan_single_ref(zq, rq, coords, res, valid, scale,
                                    res_scale)
    p = zq.shape[0]
    _check_all("hntl_scan_single", zq, rq, coords, res, valid, scale,
               res_scale, (p,))
    k, cap = zq.shape[1], coords.shape[2]
    if k > MAX_K:
        raise ValueError(f"hntl_scan_single: k={k} exceeds the kernel's "
                         f"limit {MAX_K}")
    out = torch.empty((p, cap), dtype=torch.float32, device=zq.device)
    if out.numel() == 0:
        return out
    if kind == "meta":
        counting.report("hntl_scan_single", *scan_cost(
            zq, rq, coords, res, valid, scale, res_scale))
        return out
    _run("hntl_scan_single", "hntl_scan_single_launch", zq, rq, coords, res,
         valid, scale, res_scale, out, (p, k, cap))
    hntl_scan_single.launches += 1
    return out


def hntl_scan(zq, rq, coords, res, valid, scale, res_scale):
    """Batched-query Block-SoA scan over P grain panels.

    zq [P, Q, k] i32, rq [P, Q] f32, coords [P, k, cap] i16 or i8,
    res [P, cap] i32, valid [P, cap] bool, scale/res_scale [P] f32.
    Returns [P, Q, cap] f32 (BIG on invalid slots).
    """
    kind = device_kind("hntl_scan", zq, meta=True)
    if kind == "cpu":
        return hntl_scan_ref(zq, rq, coords, res, valid, scale, res_scale)
    p, q = zq.shape[0], zq.shape[1]
    _check_all("hntl_scan", zq, rq, coords, res, valid, scale, res_scale,
               (p, q))
    k, cap = zq.shape[2], coords.shape[2]
    out = torch.empty((p, q, cap), dtype=torch.float32, device=zq.device)
    if out.numel() == 0:
        return out
    if kind == "meta":
        counting.report("hntl_scan", *scan_cost(
            zq, rq, coords, res, valid, scale, res_scale))
        return out
    _run("hntl_scan", "hntl_scan_launch", zq, rq, coords, res, valid, scale,
         res_scale, out, (p, q, k, cap))
    hntl_scan.launches += 1
    return out


hntl_scan_single.launches = 0
hntl_scan.launches = 0
