"""ScanPlane backend registry: pluggable candidate-generation engines.

- **gather** planes copy every probed panel per query, scan it with a
  ``blocksoa_scan``-signature function and hand the full [Q, nprobe*cap]
  distance matrix to the pooling stage;
- **select** planes stream the probed panels from the stacked index and
  emit only the running top-``width`` pool, [Q, width].

Registered backends:

  name          kind     engine
  ------------  -------  --------------------------------------------------
  "ref"         gather   plain PyTorch Block-SoA scan (the CPU default)
  "fused"       select   the hand-written CUDA scan→select kernel
                         (plain version for CPU tensors)
  "fused_ref"   select   the kernel's plain PyTorch version
  "auto"/None   —        "fused" for an index on CUDA, "ref" on the CPU

The JAX package's "pallas", "interpret", "cascade" and "cascade_ref"
planes are not ported yet; naming one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from . import scan
from ..kernels.fused_select import fused_scan_select

GATHER = "gather"
SELECT = "select"


@dataclasses.dataclass(frozen=True)
class ScanPlane:
    """One candidate-generation backend.

    ``runner`` signatures by kind:
      gather: ``blocksoa_scan``-compatible, on [Q, P, ...] gathered panels
        -> dists [Q, P, cap].
      select: ``fused_scan_select``-compatible (gids, zq, rq, keep, coords,
        res, mask, rows, scale, res_scale, [sq, sketch, sketch_scale], *,
        width) -> (dists [Q, width], rows [Q, width]).

    ``adaptive`` select backends accept ``n_active=``.
    """

    name: str
    kind: str
    runner: Callable
    doc: str = ""
    adaptive: bool = False


_REGISTRY: dict = {}


def register_scan_plane(name: str, kind: str, runner: Callable,
                        doc: str = "", adaptive: bool = False) -> ScanPlane:
    if kind not in (GATHER, SELECT):
        raise ValueError(f"scan plane kind must be {GATHER!r} or "
                         f"{SELECT!r}, got {kind!r}")
    plane = ScanPlane(name=name, kind=kind, runner=runner, doc=doc,
                      adaptive=adaptive)
    _REGISTRY[name] = plane
    return plane


def scan_plane_names() -> tuple:
    """Registered backend names (+ "auto")."""
    return tuple(_REGISTRY) + ("auto",)


def get_scan_plane(name: Optional[str], device=None) -> ScanPlane:
    """Resolve a backend name (None == "auto") to its ScanPlane.  "auto"
    is "fused" when ``device`` (the index's) is CUDA, else "ref"."""
    if name is None or name == "auto":
        on_card = device is not None and torch.device(device).type == "cuda"
        name = "fused" if on_card else "ref"
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scan plane {name!r}; registered: "
            f"{sorted(scan_plane_names())}") from None


register_scan_plane(
    "ref", GATHER, scan.blocksoa_scan,
    "plain PyTorch Block-SoA scan over gathered panels (the CPU default and "
    "the semantics reference)")
register_scan_plane(
    "fused", SELECT, fused_scan_select,
    "hand-written CUDA scan→select kernel: gather-free panel streaming and "
    "a running top-W in shared memory (plain version for CPU tensors)",
    adaptive=True)
register_scan_plane(
    "fused_ref", SELECT, scan.blocksoa_select_ref,
    "plain PyTorch version of the fused kernel (the select contract's "
    "reference)", adaptive=True)
