"""Plain PyTorch versions of the scan kernels (``hntl_scan.py``,
``layout_scan.py``), and the top-C select oracle.

Mirrors the JAX package's ``kernels/ref.py`` oracles (``hntl_scan_ref``,
``hntl_scan_single_ref``, ``topc_select_ref``) and the Table 2 layouts of
its ``core/scan.py`` (``aos_scan``, ``pointer_chase_scan``).  The scans'
versions are what the kernel wrappers run for CPU tensors, and what the
CUDA kernels are held to bit for bit on the card:

- the integer part  sum_j (zq_j - coords_j)^2  is taken in int32, so an
  out-of-contract input wraps exactly as it does in JAX and in the
  kernels.  The sum runs one dimension at a time, which changes no bit
  (int32 addition wraps, so any order gives the same result) and keeps
  the intermediate at the output's size instead of k times it;
- the float epilogue keeps the JAX op order
  ``((d_int * scale^2 + res * res_scale) + rq)``, each step rounded (the
  pointer chase multiplies by scale twice: ``(d_int * scale) * scale``);
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


# ---------------------------------------------------------------------------
# The Table 2 layouts (``kernels.layout_scan``) and the top-C oracle
# ---------------------------------------------------------------------------

def aos_scan_ref(zq, rq, coords_aos, res, valid, scale, res_scale):
    """Plain version of the Array-of-Structures scan ``aos_scan``.

    zq [P, k] i32, rq [P] f32, coords_aos [P, cap, k] (vector-major, any
    integer dtype, widened to int32), res [P, cap], valid [P, cap] bool,
    scale/res_scale [P] f32.  Returns [P, cap] f32 with BIG on invalid
    slots: the Block-SoA scan's distance and op order
    ``(d_int * scale^2 + res * res_scale) + rq``.
    """
    diff = zq[:, None, :].to(torch.int32) - coords_aos.to(torch.int32)
    d_int = torch.sum(diff * diff, dim=-1, dtype=torch.int32)
    d = d_int.to(torch.float32) * (scale * scale)[:, None]
    d = d + res.to(torch.float32) * res_scale[:, None] + rq[:, None]
    return torch.where(valid, d, BIG)


def chase_order(next_ptr, head, n_steps: int) -> torch.Tensor:
    """The rows ``pointer_chase_scan`` visits, in order, as int64 on the
    host.  A pointer reads as the JAX package's gather reads it: a
    negative one counts from the end, then it is clamped to [0, N-1]."""
    nxt = next_ptr.detach().to("cpu", torch.int64)
    n = nxt.shape[0]
    if n_steps > 0 and n == 0:
        raise ValueError("pointer_chase_scan: an empty list has no rows "
                         "to visit")

    def norm(p):
        p = p + n if p < 0 else p
        return min(max(p, 0), n - 1)

    step = [norm(p) for p in nxt.tolist()]
    p = norm(int(head))
    order = [0] * n_steps
    for t in range(n_steps):
        order[t] = p
        p = step[p]
    return torch.tensor(order, dtype=torch.int64)


def pointer_chase_scan_ref(zq, rq, coords_flat, res_flat, next_ptr, head,
                           n_steps: int, scale, res_scale):
    """Plain version of the linked-list scan ``pointer_chase_scan``.

    zq [k] i32, coords_flat [N, k] (any integer dtype, widened to int32),
    res_flat [N], next_ptr [N] i32; rq, head, scale and res_scale are
    0-d tensors (f32, i32, f32, f32).  Returns [n_steps] f32 in visit
    order, in the JAX package's op order
    ``((d_int * scale) * scale + res * res_scale) + rq``.

    The visit order does not depend on the distances, so the list is
    walked first on a host copy (``chase_order``) and every distance is
    then computed in one pass.
    """
    rows = chase_order(next_ptr, head, n_steps).to(coords_flat.device)
    diff = zq.to(torch.int32)[None, :] - coords_flat[rows].to(torch.int32)
    d_int = torch.sum(diff * diff, dim=-1, dtype=torch.int32)
    d = d_int.to(torch.float32) * scale * scale
    return d + res_flat[rows].to(torch.float32) * res_scale + rq


def topc_select_ref(dists, ids, c: int):
    """Oracle for a streaming top-C select: the C smallest distances.

    dists [Q, M] f32, ids [Q, M] -> (dists [Q, C], ids [Q, C]), ascending.
    A stable sort, so equal distances keep the lower index first, as
    ``jax.lax.top_k`` does.
    """
    if not 0 <= c <= dists.shape[-1]:
        raise ValueError(f"topc_select_ref: c={c} is outside [0, "
                         f"{dists.shape[-1]}]")
    d, pos = torch.sort(dists, dim=-1, stable=True)
    return d[..., :c], torch.gather(ids, -1, pos[..., :c])
