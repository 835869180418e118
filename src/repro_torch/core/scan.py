"""Reference scan implementations (plain PyTorch).

``blocksoa_scan`` is the gather plane ("ref"); ``blocksoa_select_ref`` is
the plain version of the fused scan→select kernel ("fused_ref", and what
``kernels.fused_select.fused_scan_select`` runs for CPU tensors).
``aos_scan`` and ``pointer_chase_scan`` are the paper's Table 2 baselines
(the same math over a vector-major layout and over a linked list); they
run on ``kernels.layout_scan``'s kernels for CUDA tensors.

Integer-math note: coordinates are stored int16 but quantized to an
int32-safe range (``index.int32_safe_qmax``), so the accumulated squared
distance  sum_k (zq - zi)^2 <= k * (2*qeff)^2 < 2^31  is exact in int32.
Sums are taken in int32 (``dtype=torch.int32``; torch would widen to
int64 by default), so out-of-contract inputs wrap exactly as they do in
the JAX package and in the CUDA kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import layout_scan
from .types import BIG


def block_dist_int(zq: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Integer part of Eq. 6, batched over leading axes.

    zq [..., k] int32, coords [..., k, cap] int16/int8/int32 (dim-major)
    -> [..., cap] int32:  sum_k (zq - z_i)^2.
    """
    diff = zq[..., :, None].to(torch.int32) - coords.to(torch.int32)
    return torch.sum(diff * diff, dim=-2, dtype=torch.int32)


def probe_alive(keep: torch.Tensor,
                n_active: Optional[torch.Tensor]) -> torch.Tensor:
    """The envelope verdict keep [Q, P] with probes p >= n_active[q]
    killed too (adaptive routing's ragged-probe vector; None = all P)."""
    if n_active is None:
        return keep
    p = torch.arange(keep.shape[1], device=keep.device)[None, :]
    return torch.logical_and(keep, p < n_active[:, None])


def _epilogue(d_int, res, rq, scale, res_scale, s_int=None, sk_scale=None):
    """Eq. 6 float epilogue in the JAX package's op order:
    ((d_int * scale^2 + res * res_scale) + rq) + s_int * sk_scale^2."""
    d = d_int.to(torch.float32) * (scale * scale)[..., None]
    d = d + res.to(torch.float32) * res_scale[..., None] + rq[..., None]
    if s_int is not None:
        d = d + s_int.to(torch.float32) * (sk_scale * sk_scale)[..., None]
    return d


def blocksoa_scan(zq: torch.Tensor, rq: torch.Tensor, coords: torch.Tensor,
                  res: torch.Tensor, valid: torch.Tensor, scale: torch.Tensor,
                  res_scale: torch.Tensor,
                  sq: Optional[torch.Tensor] = None,
                  sketch: Optional[torch.Tensor] = None,
                  sketch_scale: Optional[torch.Tensor] = None,
                  extra_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Approximate distances for every slot of a batch of grain panels.

    Shapes (leading batch ``...`` = e.g. [Q, P]):
      zq [..., k] i32, rq [...] f32, coords [..., k, cap] i16,
      res [..., cap] i32, valid [..., cap] bool, scale/res_scale [...] f32,
      sq [..., s] i32 | None, sketch [..., s, cap] i8 | None,
      sketch_scale [...] | None, extra_mask [..., cap] bool | None.

    Returns dists [..., cap] f32 with invalid slots = BIG.
    """
    s_int = block_dist_int(sq, sketch) if sketch is not None else None
    d = _epilogue(block_dist_int(zq, coords), res, rq, scale, res_scale,
                  s_int, sketch_scale)
    keep = valid if extra_mask is None else torch.logical_and(valid,
                                                              extra_mask)
    return torch.where(keep, d, BIG)


def blocksoa_select_ref(gids: torch.Tensor, zq: torch.Tensor,
                        rq: torch.Tensor, keep: torch.Tensor,
                        coords: torch.Tensor, res: torch.Tensor,
                        mask: torch.Tensor, rows: torch.Tensor,
                        scale: torch.Tensor, res_scale: torch.Tensor,
                        sq: Optional[torch.Tensor] = None,
                        sketch: Optional[torch.Tensor] = None,
                        sketch_scale: Optional[torch.Tensor] = None, *,
                        width: int,
                        tenant_mask: Optional[torch.Tensor] = None,
                        tenant_ix: Optional[torch.Tensor] = None,
                        n_active: Optional[torch.Tensor] = None):
    """Plain version of the fused scan→select kernel.

    Shapes: gids [Q, P] i32, zq [Q, P, k] i32, rq/keep [Q, P],
    coords [G, k, cap] i16, res/mask/rows [G, cap], scale/res_scale [G];
    optional sq [Q, P, s] i32, sketch [G, s, cap] i8, sketch_scale [G];
    tenant_mask [T, G, cap] bool + tenant_ix [Q] i32 (query q also needs
    tenant_mask[tenant_ix[q], g]); n_active [Q] i32 (probes
    p >= n_active[q] are killed).

    Returns (dists [Q, width] f32 ascending, rows [Q, width] i32): the
    first ``width`` entries of a stable ascending sort of every probed slot
    by (dist, probe, slot), with (BIG, -1) beyond the live candidates and
    row -1 wherever dist >= BIG / 2.  That is exactly what the JAX kernel's
    running top-W carry yields: ``lax.top_k`` prefers the lower index and
    the carry, initialised to BIG, sits before each new tile, so no entry
    at or above BIG ever displaces it.  The slot matrix is gathered
    ([Q, P, k, cap]); this is the semantic reference, not the fast path.
    """
    q_n, p_n, _ = zq.shape
    cap = coords.shape[2]
    gl = gids.long()
    keep = probe_alive(keep, n_active)
    s_int = block_dist_int(sq, sketch[gl]) if sketch is not None else None
    d = _epilogue(block_dist_int(zq, coords[gl]), res[gl], rq, scale[gl],
                  res_scale[gl], s_int,
                  sketch_scale[gl] if sketch is not None else None)
    m = mask[gl]                                          # [Q, P, cap]
    if tenant_mask is not None:
        m = torch.logical_and(m, tenant_mask[tenant_ix.long()[:, None], gl])
    d = torch.where(torch.logical_and(m, keep[..., None]), d, BIG)

    w = min(width, p_n * cap)
    sd, pos = torch.sort(d.reshape(q_n, p_n * cap), dim=1, stable=True)
    out_d = sd[:, :w]
    out_r = torch.gather(rows[gl].reshape(q_n, p_n * cap), 1, pos[:, :w])
    out_d = torch.where(out_d < BIG, out_d, BIG)   # inf/NaN never enter
    if w < width:                                  # pad to the contract
        out_d = torch.cat([out_d, out_d.new_full((q_n, width - w), BIG)], 1)
        out_r = torch.cat([out_r, out_r.new_full((q_n, width - w), -1)], 1)
    out_r = torch.where(out_d < BIG / 2, out_r, -1)
    return out_d, out_r.to(torch.int32)


def aos_scan(zq: torch.Tensor, rq: torch.Tensor, coords_aos: torch.Tensor,
             res: torch.Tensor, valid: torch.Tensor, scale: torch.Tensor,
             res_scale: torch.Tensor) -> torch.Tensor:
    """Array-of-Structures layout scan (Table 2 middle row).

    zq [P, k] i32, rq [P] f32, coords_aos [P, cap, k] i16/i32
    (vector-major: the same math as ``blocksoa_scan``, with a
    transpose-per-vector access pattern), res [P, cap] i32, valid [P, cap]
    bool, scale/res_scale [P] f32.  Returns [P, cap] f32, BIG on invalid
    slots.
    """
    return layout_scan.aos_scan(*(t.contiguous() for t in (
        zq, rq, coords_aos, res, valid, scale, res_scale)))


def pointer_chase_scan(zq: torch.Tensor, rq, coords_flat: torch.Tensor,
                       res_flat: torch.Tensor, next_ptr: torch.Tensor, head,
                       n_steps: int, scale, res_scale) -> torch.Tensor:
    """Graph-style traversal (Table 2 bottom row): follow a linked list of
    row indices from ``head``; every access is a data-dependent gather.

    zq [k] i32, coords_flat [N, k] i16/i32, res_flat [N] i32, next_ptr [N]
    i32; rq, scale and res_scale float32 scalars and head an int32 scalar
    (numbers or 0-d tensors).  Returns dists [n_steps] f32 in visit order.
    A pointer is read as a JAX gather reads it: negative counts from the
    end, out of range is clamped to [0, N-1].
    """
    dev = zq.device

    def scalar(v, dtype):
        return torch.as_tensor(v, dtype=dtype, device=dev).reshape(())

    return layout_scan.pointer_chase_scan(
        zq.contiguous(), scalar(rq, torch.float32), coords_flat.contiguous(),
        res_flat.contiguous(), next_ptr.contiguous(),
        scalar(head, torch.int32), n_steps, scalar(scale, torch.float32),
        scalar(res_scale, torch.float32))
