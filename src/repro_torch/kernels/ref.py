"""Plain PyTorch versions of the Block-SoA scan kernels (``hntl_scan.py``).

Mirrors the JAX package's ``kernels/ref.py`` oracles ``hntl_scan_ref`` and
``hntl_scan_single_ref``.  They are what the kernel wrappers run for CPU
tensors, and what the CUDA kernels are held to bit for bit on the card:

- the integer part  sum_j (zq_j - coords_j)^2  is taken in int32, so an
  out-of-contract input wraps exactly as it does in JAX and in the
  kernels.  The sum runs one dimension at a time, which changes no bit
  (int32 addition wraps, so any order gives the same result) and keeps
  the intermediate at the output's size instead of k times it;
- the float epilogue keeps the JAX op order
  ``((d_int * scale^2 + res * res_scale) + rq)``, each step rounded;
- slots whose ``valid`` is False read ``core.types.BIG``.
"""
from __future__ import annotations

import torch

from ..core.types import BIG


def _dist_int(zq: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """zq [P, Q, k] i32, coords [P, k, cap] -> [P, Q, cap] i32."""
    p, q, _ = zq.shape
    out = torch.zeros((p, q, coords.shape[2]), dtype=torch.int32,
                      device=zq.device)
    for j in range(zq.shape[2]):
        diff = zq[:, :, j, None] - coords[:, None, j, :].to(torch.int32)
        out += diff * diff
    return out


def hntl_scan_ref(zq, rq, coords, res, valid, scale, res_scale):
    """Plain version of the batched-query kernel ``hntl_scan``.

    zq [P, Q, k] i32, rq [P, Q] f32, coords [P, k, cap] i16 (or i8),
    res [P, cap] i32, valid [P, cap] bool, scale/res_scale [P] f32.
    Returns [P, Q, cap] f32 with BIG on invalid slots.
    """
    d = _dist_int(zq, coords).to(torch.float32) * (scale * scale)[:, None,
                                                                  None]
    d = d + res.to(torch.float32)[:, None, :] * res_scale[:, None, None]
    d = d + rq[:, :, None]
    return torch.where(valid[:, None, :], d, BIG)


def hntl_scan_single_ref(zq, rq, coords, res, valid, scale, res_scale):
    """Plain version of the single-query kernel ``hntl_scan_single``.

    zq [P, k] i32, rq [P] f32, coords [P, k, cap], res [P, cap],
    valid [P, cap], scale/res_scale [P].  Returns [P, cap] f32.
    """
    out = hntl_scan_ref(zq[:, None, :], rq[:, None], coords, res, valid,
                        scale, res_scale)
    return out[:, 0, :]
