"""Mixed-precision cascade: a staged select with per-stage survivor
budgets ``(b1, b2)``.

  stage 1: every probed slot is priced at the cheap remainder of the scan
    distance (residual term, query residual and sketch term: everything
    but the coordinate term, which is >= 0) by the select itself, run on
    a zero coordinate panel (k=1): the ported ``fused_scan_select`` on the
    card, its plain version for "cascade_ref".  Only the top ``b1`` flat
    slots g * cap + c survive; the [Q, P * cap] matrix never exists.
  stage 2: the survivors' coordinate columns are gathered ([Q, b1, k])
    and re-priced with the exact Block-SoA arithmetic, in the float op
    order of ``scan.blocksoa_scan``; the top ``b2`` are kept.
  stage 3: the planner's shared epilogue (Mode B: the exact re-rank).

With ``budgets=None`` stage 1 keeps every probed slot (b1 = P * cap) and
the cascade is lossless: its pool holds the "fused" plane's candidates
at the same distances, ordered alike except between candidates at one
exact distance (stage 2's stable sort keeps stage 1's order there).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import scan
from ..kernels.fused_select import fused_scan_select
from .types import BIG

#: Elements of one [rows, b1, k] gather of stage 2, at most: the query
#: batch is re-priced in slices of this many (per-query arithmetic is
#: elementwise and exact, so the slicing changes no bit).  At b1 = 26,624
#: and k = 32 that is 78 queries, 256 MB per int32 temporary.
STAGE2_ELEMENTS = 1 << 26


def check_budgets(budgets, topk: int) -> None:
    """Host-side validation of per-stage survivor budgets ``(b1, b2)``."""
    if budgets is None:
        return
    if len(budgets) != 2:
        raise ValueError(f"budgets must be (b1, b2), got {budgets!r}")
    b1, b2 = int(budgets[0]), int(budgets[1])
    if not b1 >= b2 >= 1:
        raise ValueError(
            f"stage budgets must satisfy b1 >= b2 >= 1, got {budgets!r}")
    if b2 < topk:
        raise ValueError(
            f"final-stage survivor budget {b2} < topk {topk}: the exact "
            "re-rank could never fill the result; raise b2 or lower topk")


def _stage1_filter(engine: str, gids, rq, keep, res, mask, scale, res_scale,
                   sq, sketch, sketch_scale, tenant_mask, tenant_ix,
                   b1: int, n_active=None):
    """Stage 1: the select on a zero coordinate panel (k=1, query
    coordinates 0), which prices each slot at the cheap remainder; every
    mask (validity, liveness, filters, tenant) applies there.  Returns
    (d1 [Q, b1] f32 ascending, fs [Q, b1] i32 flat slots g * cap + c,
    -1 where pruned)."""
    g_n, cap = res.shape
    q_n, p_n = gids.shape
    if g_n * cap >= 2 ** 31:
        raise ValueError("cascade: G * cap must be < 2^31 (flat slot ids "
                         "are int32)")
    dev = gids.device
    zq1 = torch.zeros((q_n, p_n, 1), dtype=torch.int32, device=dev)
    z1 = torch.zeros((g_n, 1, cap), dtype=torch.int16, device=dev)
    fsl = torch.arange(g_n * cap, dtype=torch.int32,
                       device=dev).reshape(g_n, cap)
    kw = {}
    if sketch is not None:
        kw = dict(sq=sq, sketch=sketch, sketch_scale=sketch_scale)
    if tenant_mask is not None:
        kw.update(tenant_mask=tenant_mask, tenant_ix=tenant_ix)
    if n_active is not None:
        kw["n_active"] = n_active
    runner = fused_scan_select if engine == "kernel" \
        else scan.blocksoa_select_ref
    return runner(gids, zq1, rq, keep, z1, res, mask, fsl, scale, res_scale,
                  width=b1, **kw)


def _stage2(fs, gids, zq, rq, coords, res, scale, res_scale, sq, sketch,
            sketch_scale):
    """Stage 2 on one slice of queries: the full quantized distance of
    each stage-1 survivor, BIG where it is pruned.  Returns (d [Q, b1],
    g_of [Q, b1] grain, c_of [Q, b1] slot)."""
    cap = coords.shape[2]
    fs_c = torch.clamp(fs, min=0).long()
    g_of = fs_c // cap                                        # [Q, b1]
    c_of = fs_c % cap
    eq = gids.long()[:, None, :] == g_of[:, :, None]          # [Q, b1, P]
    ok = torch.logical_and(fs >= 0, torch.any(eq, dim=-1))
    p_of = eq.to(torch.uint8).argmax(dim=-1)                  # first match

    def at_probe(t):                          # [Q, P, n] -> [Q, b1, n]
        idx = p_of[..., None].expand(p_of.shape + t.shape[2:])
        return torch.gather(t, 1, idx)

    diff = at_probe(zq) - coords[g_of, :, c_of].to(torch.int32)  # [Q,b1,k]
    d_int = torch.sum(diff * diff, dim=-1, dtype=torch.int32)   # wraps
    sc_s = scale[g_of]
    # the float op order of scan.blocksoa_scan
    d = d_int.to(torch.float32) * (sc_s * sc_s)
    d = d + res[g_of, c_of].to(torch.float32) * res_scale[g_of] \
        + torch.gather(rq, 1, p_of)
    if sketch is not None:
        diff = at_probe(sq) - sketch[g_of, :, c_of].to(torch.int32)
        s_int = torch.sum(diff * diff, dim=-1, dtype=torch.int32)
        ss_s = sketch_scale[g_of]
        d = d + s_int.to(torch.float32) * (ss_s * ss_s)
    return torch.where(ok, d, BIG), g_of, c_of


def _stage2_select(fs, gids, zq, rq, coords, res, rows, scale, res_scale,
                   sq, sketch, sketch_scale, *, width: int, b2: int):
    """Stage 2 over the stage-1 survivors ``fs`` [Q, b1], in query slices
    of at most ``STAGE2_ELEMENTS`` gathered coordinates: the top
    min(width, b1) by a stable ascending sort (ties keep stage 1's order),
    padded to [Q, width] with (BIG, -1), entries past ``b2`` cut to BIG,
    rows -1 wherever dist >= BIG / 2.  Returns (dists f32, rows i32)."""
    q_n, b1 = fs.shape
    take = min(width, b1)
    step = max(1, STAGE2_ELEMENTS // max(1, b1 * coords.shape[1]))
    out_d, out_r = [], []
    for lo in range(0, q_n, step):
        sl = slice(lo, lo + step)
        d, g_of, c_of = _stage2(
            fs[sl], gids[sl], zq[sl], rq[sl], coords, res, scale, res_scale,
            None if sq is None else sq[sl], sketch, sketch_scale)
        d, pos = torch.sort(d, dim=1, stable=True)
        d, pos = d[:, :take], pos[:, :take]
        out_d.append(d)
        out_r.append(rows[torch.gather(g_of, 1, pos),
                          torch.gather(c_of, 1, pos)])
    if out_d:
        out_d, out_r = torch.cat(out_d), torch.cat(out_r)
    else:
        out_d = torch.empty((0, take), device=fs.device)
        out_r = torch.empty((0, take), dtype=rows.dtype, device=fs.device)
    if take < width:                             # pad to the contract
        out_d = torch.nn.functional.pad(out_d, (0, width - take), value=BIG)
        out_r = torch.nn.functional.pad(out_r, (0, width - take), value=-1)
    if b2 < width:                               # stage 2's budget
        out_d = torch.where(torch.arange(width, device=out_d.device) < b2,
                            out_d, BIG)
    out_r = torch.where(out_d < BIG / 2, out_r, -1)
    return out_d, out_r.to(torch.int32)


def make_cascade_runner(stage1_engine: str):
    """A select-plane runner for the cascade.

    stage1_engine: "kernel" (stage 1 through ``fused_scan_select``: the
    CUDA kernel for CUDA tensors, its plain version for CPU tensors) or
    "ref" (stage 1 through the plain version, ``blocksoa_select_ref``).
    """
    if stage1_engine not in ("kernel", "ref"):
        raise ValueError(f"stage1_engine must be 'kernel' or 'ref', got "
                         f"{stage1_engine!r}")

    def cascade_select(gids, zq, rq, keep, coords, res, mask, rows, scale,
                       res_scale, sq=None, sketch=None, sketch_scale=None, *,
                       width: int, budgets: Optional[tuple] = None,
                       tenant_mask=None, tenant_ix=None, n_active=None):
        slots = gids.shape[1] * coords.shape[2]
        # killed probes fold into the keep verdict before stage 1, so every
        # stage prices active grains only
        keep = scan.probe_alive(keep, n_active)
        if budgets is None:
            b1, b2 = slots, width                # lossless: prune nothing
        else:
            check_budgets(budgets, 1)
            b1 = max(1, min(int(budgets[0]), slots))
            b2 = max(1, min(int(budgets[1]), width, b1))
        _, fs = _stage1_filter(stage1_engine, gids, rq, keep, res, mask,
                               scale, res_scale, sq, sketch, sketch_scale,
                               tenant_mask, tenant_ix, b1, n_active=n_active)
        return _stage2_select(fs, gids, zq, rq, coords, res, rows, scale,
                              res_scale, sq, sketch, sketch_scale,
                              width=width, b2=b2)

    return cascade_select
