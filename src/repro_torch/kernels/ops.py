"""The Block-SoA scans as the rest of the package calls them.

Mirrors the JAX package's ``kernels/ops.py``.  The engine follows the
tensors' device: CPU tensors run the plain versions (``kernels.ref``),
CUDA tensors the hand-written kernels (``kernels.hntl_scan``), which raise
rather than give way to anything else.  ``backend="ref"`` forces the plain
version on any device (tests and on-card comparisons).

The sketch term (paper §2.2 s-dim residual sketch) is folded in by a
second kernel pass over the int8 sketch panels: Eq. 6 extends to
``||z_q - z_i||^2 + ||s_q - s_i||^2 + r_q + r_i`` where r now counts only
the energy outside span(W | S).  That pass runs with zero residuals, a
zero rq and a unit residual scale, and is added only to slots that are
still live: ``d = where(d < BIG/2, d + ds, d)``.
"""
from __future__ import annotations

import torch

from ..core.types import BIG
from . import hntl_scan as _kernels
from . import ref

_BACKENDS = ("auto", "ref")


def _engines(backend: str):
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    if backend == "ref":
        return ref.hntl_scan_ref, ref.hntl_scan_single_ref
    return _kernels.hntl_scan, _kernels.hntl_scan_single


def _c(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous()


def _scan(fn, zq, rq, coords, res, valid, scale, res_scale, sq, sketch,
          sketch_scale, extra_mask):
    keep = valid if extra_mask is None \
        else torch.logical_and(valid, extra_mask)
    d = fn(_c(zq), _c(rq), _c(coords), _c(res), _c(keep), _c(scale),
           _c(res_scale))
    if sketch is not None:
        # The sketch pass computes ONLY ||s_q - s_i||^2 * sketch_scale^2:
        # zero residual inputs and a neutral unit residual scale.
        ds = fn(_c(sq), torch.zeros_like(rq), _c(sketch),
                torch.zeros_like(res), torch.ones_like(valid),
                _c(sketch_scale), torch.ones_like(sketch_scale))
        d = torch.where(d < BIG / 2, d + ds, d)
    return d


def scan_batched(zq, rq, coords, res, valid, scale, res_scale, sq=None,
                 sketch=None, sketch_scale=None, extra_mask=None, *,
                 backend: str = "auto"):
    """Batched-query scan: P panels x Q queries.

    zq [P, Q, k] i32, rq [P, Q] f32, coords [P, k, cap] i16,
    res [P, cap] i32, valid [P, cap] bool, scale/res_scale [P] f32.
    Optional sketch: sq [P, Q, s] i32, sketch [P, s, cap] i8,
    sketch_scale [P].  Optional extra_mask [P, cap] bool (the in-situ
    mixed-recall predicate).  Returns [P, Q, cap] f32.
    """
    fn = _engines(backend)[0]
    return _scan(fn, zq, rq, coords, res, valid, scale, res_scale, sq,
                 sketch, sketch_scale, extra_mask)


def scan_single(zq, rq, coords, res, valid, scale, res_scale, sq=None,
                sketch=None, sketch_scale=None, extra_mask=None, *,
                backend: str = "auto"):
    """Single-query scan: P independent (panel, query) pairs.

    zq [P, k] i32, rq [P] f32, coords [P, k, cap] i16, res/valid [P, cap],
    scale/res_scale [P]; sketch and extra_mask as in ``scan_batched``
    without the Q axis.  Returns [P, cap] f32.
    """
    fn = _engines(backend)[1]
    return _scan(fn, zq, rq, coords, res, valid, scale, res_scale, sq,
                 sketch, sketch_scale, extra_mask)


def make_planner_scan_fn():
    """Adapter with ``core.scan.blocksoa_scan``'s signature, so a gather
    plane runs on the single-query kernel: every leading index of the
    gathered panels (the planner's [Q, P]) is one independent pair.

    zq [..., k] i32, rq [...] f32, coords [..., k, cap], res/valid
    [..., cap], scale/res_scale [...]; optional sq [..., s], sketch
    [..., s, cap], sketch_scale [...], extra_mask [..., cap]
    -> [..., cap] f32.
    """
    def fn(zq, rq, coords, res, valid, scale, res_scale, sq=None,
           sketch=None, sketch_scale=None, extra_mask=None):
        lead = tuple(zq.shape[:-1])
        k, cap = zq.shape[-1], coords.shape[-1]

        def flat(t, *tail):
            return None if t is None else t.reshape(-1, *tail)

        s = 0 if sq is None else sq.shape[-1]
        d = scan_single(
            flat(zq, k), flat(rq), flat(coords, k, cap), flat(res, cap),
            flat(valid, cap), flat(scale), flat(res_scale), sq=flat(sq, s),
            sketch=flat(sketch, s, cap), sketch_scale=flat(sketch_scale),
            extra_mask=flat(extra_mask, cap))
        return d.reshape(*lead, cap)
    return fn
