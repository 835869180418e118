#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # the full-size run, one card
    python3 chip_smoke.py --n 100000 --grains 128   # a shorter rehearsal

What it does, in order (any failure exits non-zero before the last line):

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit line;
2. build: compiles every CUDA source of the port (one ``nvcc`` each, all
   at once) and prints the compiler's register / shared-memory / spill
   report;
3. kernel phase: ``fused_scan_select`` on the card against its plain
   PyTorch version on the card, ``torch.equal`` on dists and rows, for the
   sketch on and off, tenants, ragged probes, ragged cap and width, Q=1,
   k=1, a fully pruned pool, a main-path-shaped input, and inputs that
   fill the kernel's candidate buffer again and again (width up to the
   kernel's limit, every slot live, every slot entering the pool);
4. main path: the paper's width (d=768, k=32, s=8, B=128) with G=1024
   grains over the 1M-vector ``anisotropic_manifold`` corpus: the build
   with seconds per phase, index bytes and peak device memory; then 1024
   queries in Mode A and Mode B through ``repro_torch.core.search`` with
   the default plane.  The kernels' launch counters are zeroed just before
   and read just after; the ids must equal the "fused_ref" plane's on the
   same index; recall@10 against ``flat_search``; search time per batch
   and QPS on a host clock around work that ends in a synchronise;
5. kernel time at the main path's shape (CUDA events, after warm-up)
   beside its plain version's time and the bound computed from the inputs;
6. a ``torch.profiler`` breakdown of one Mode A and one Mode B search:
   device time by kernel and the device's busy share;
7. the kernel table as one JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
# int32 work runs on the CUDA cores; counted against the table's
# non-tensor-core rate (67 T operations/s), which no int32 rate exceeds.
CUDA_CORE_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# 1-2: device and build
# ---------------------------------------------------------------------------

def device_phase(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(f"device: {name} (torch.cuda.device_count()={count}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")
    log("nvidia-smi name, power.limit:")
    log(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("float32 matmul: torch.backends.cuda.matmul.allow_tf32 = False "
        "(full float32), cudnn.allow_tf32 = False")
    return name, count, smi[0]


def build_phase():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {len(built)} CUDA source(s) in "
        f"{time.perf_counter() - t0:.2f} s wall")
    for b in built.values():
        log(f"  {b.name}.cu -> {os.path.relpath(b.path, REPO)} "
            f"(nvcc {b.seconds:.2f} s)")
        for line in b.ptxas.splitlines():
            line = line.split("ptxas info    :")[-1].strip()
            if line.startswith("Compiling entry"):
                # template flags of fused_scan_select_kernel<sketch, tenant>
                flags = line.split("ILb")[-1].split("EEEv")[0].split("ELb")
                log("    ptxas: kernel " + ", ".join(
                    f"{k}={v}" for k, v in zip(("sketch", "tenant"), flags)))
            elif "registers" in line or "spill" in line:
                log("    ptxas:", line)
    return built


# ---------------------------------------------------------------------------
# 3: kernel against its plain version
# ---------------------------------------------------------------------------

KERNEL_CASES = {
    "sketch_off": dict(q=64, p=8, g=64, k=32, cap=256, width=64),
    "sketch_on": dict(q=64, p=8, g=64, k=32, cap=256, width=64, s=8),
    "tenant": dict(q=64, p=8, g=64, k=32, cap=256, width=64, s=8,
                   tenants=5),
    "ragged_n_active": dict(q=64, p=8, g=64, k=32, cap=256, width=64, s=8,
                            ragged=True),
    "cap_width_not_128": dict(q=33, p=7, g=40, k=32, cap=333, width=77,
                              s=8),
    "single_query": dict(q=1, p=16, g=64, k=32, cap=256, width=64, s=8),
    "k1_stage1": dict(q=32, p=8, g=64, k=1, cap=256, width=512, s=8),
    "fully_pruned": dict(q=16, p=8, g=64, k=32, cap=256, width=64, s=8,
                         pruned=True),
    "wide_width": dict(q=8, p=16, g=64, k=32, cap=512, width=4000, s=8),
    "main_path_shape": dict(q=256, p=16, g=1024, k=32, cap=1664, width=64,
                            s=8),
    # the candidate buffer fills and is folded into the carry again and
    # again: every slot live, and (descending) every slot entering the pool
    "all_live_max_width": dict(q=64, p=32, g=64, k=32, cap=2048, width=8192,
                               s=8, keep_frac=1.0, mask_frac=1.0),
    "descending_fold_every_tile": dict(descending=True, q=64, p=32, k=8,
                                       cap=2048, width=10),
    "descending_max_width": dict(descending=True, q=64, p=32, k=8, cap=2048,
                                 width=8192),
}


def hold(torch, fsel, args, kw, width, label):
    """Kernel == plain version on the card, bit for bit.  Returns the max
    absolute difference of the dists (0.0 when equal)."""
    d, r = fsel.fused_scan_select(*args, width=width, **kw)
    rd, rr = fsel.fused_scan_select_ref(*args, width=width, **kw)
    if d.is_cuda:
        torch.cuda.synchronize()
    err = float((d.double() - rd.double()).abs().max()) if d.numel() else 0.0
    check(torch.equal(r, rr),
          f"{label}: kernel rows differ from the plain version "
          f"({int((r != rr).sum())} entries)")
    check(torch.equal(d, rd), f"{label}: kernel dists differ from the "
          f"plain version (max abs {err})")
    return err


def kernel_phase(torch, dev):
    from repro_torch.kernels import fused_select as fsel
    from repro_torch.kernels import select_cases

    errs = []
    for i, (label, c) in enumerate(KERNEL_CASES.items()):
        c = dict(c)
        width = c.pop("width")
        if c.pop("descending", False):
            a = select_cases.descending_inputs(**c)
        else:
            if c.pop("pruned", False):
                c["keep_frac"] = 0.0
            a = select_cases.random_inputs(i, **c)
        args, kw = select_cases.split(
            a, lambda v: torch.from_numpy(v).to(dev))
        errs.append(hold(torch, fsel, args, kw, width, label))
        log(f"  kernel == plain: {label} (Q={c['q']} P={c['p']} "
            f"G={a['coords'].shape[0]} k={c['k']} cap={c['cap']} "
            f"s={c.get('s', 0)} width={width}) ok")
    log("kernels: fused_scan_select (held against fused_scan_select_ref, "
        f"torch.equal on dists and rows, {len(errs)} cases)")
    return max(errs)


# ---------------------------------------------------------------------------
# 4: main path
# ---------------------------------------------------------------------------

def main_path(torch, np, *, n, nq, grains, dev):
    from repro_torch.core import HNTLConfig, build, search, tree_bytes
    from repro_torch.core.flat import flat_search, recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.kernels import fused_select as fsel

    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    t0 = time.perf_counter()
    x = synthetic.anisotropic_manifold(n=n, d=768, intrinsic=24, seed=0)
    q = synthetic.queries_from(x, nq=nq)
    log(f"data: anisotropic_manifold n={n} d=768 intrinsic=24 seed=0, "
        f"{nq} queries, {time.perf_counter() - t0:.2f} s on the host")
    cfg = HNTLConfig(d=768, k=32, s=8, block=128, n_grains=grains,
                     nprobe=16, pool=64)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index, info = build(x, cfg, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    phases = " ".join(f"{k}={v:.2f}s" for k, v in info.seconds.items())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    g = index.grains
    parts = {"raw": index.raw, "coords": g.coords, "sketch": g.sketch,
             "res+ids+valid": None, "basis": g.basis,
             "sketch_basis": g.sketch_basis}
    sizes = {k: tree_bytes(v) for k, v in parts.items() if v is not None}
    sizes["res+ids+valid"] = sum(tree_bytes(t) for t in (g.res, g.ids,
                                                         g.valid))
    log(f"build: {build_s:.2f} s total ({phases}); cap={info.cap} "
        f"var_captured_mean={info.var_captured_mean:.4f}")
    log("index bytes: total=" + str(tree_bytes(index)) + " " + " ".join(
        f"{k}={v}" for k, v in sizes.items()))
    log(f"peak device memory (max_memory_allocated): {peak} bytes")

    qt = torch.from_numpy(q).to(dev)
    # ---- the main path: counters zeroed just before, read just after ----
    fsel.fused_scan_select.launches = 0
    res = {m: search(index, qt, cfg, topk=10, mode=m) for m in "AB"}
    sync()
    launches = {"fused_scan_select": fsel.fused_scan_select.launches}
    log(f"main path launches: {launches}")
    if dev.type == "cuda":
        check(launches["fused_scan_select"] > 0,
              "the main path never launched fused_scan_select")

    truth = flat_search(index.raw, qt, topk=10).ids
    recall = {}
    for m in "AB":
        ref = search(index, qt, cfg, topk=10, mode=m, scan_impl="fused_ref")
        check(torch.equal(res[m].ids, ref.ids),
              f"Mode {m}: ids differ from the fused_ref plane "
              f"({int((res[m].ids != ref.ids).sum())} entries)")
        ids, dists = res[m].ids, res[m].dists
        check(ids.shape == (nq, 10) and bool(torch.isfinite(dists).all()),
              f"Mode {m}: bad result shape or non-finite dists")
        check(bool(((ids >= -1) & (ids < n)).all()), f"Mode {m}: bad ids")
        recall[m] = recall_at_k(ids, truth)
    check(recall["B"] >= recall["A"],
          "Mode B re-ranks Mode A's pool exactly; its recall cannot be lower")
    ib = res["B"].ids.cpu().numpy()
    live = ib >= 0
    exact = ((x[np.maximum(ib, 0)].astype(np.float64)
              - q[:, None, :].astype(np.float64)) ** 2).sum(-1)
    check(np.allclose(res["B"].dists.cpu().numpy()[live], exact[live],
                      rtol=1e-4, atol=1e-3),
          "Mode B dists disagree with float64 distances on the host")
    log(f"recall@10 vs flat_search: Mode A {recall['A']:.4f}, "
        f"Mode B {recall['B']:.4f}")

    timing = {}
    for m in "AB":
        search(index, qt, cfg, topk=10, mode=m)
        sync()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            search(index, qt, cfg, topk=10, mode=m)
        sync()
        s = (time.perf_counter() - t0) / reps
        timing[m] = s
        log(f"search Mode {m}: {s * 1e3:.3f} ms for {nq} queries "
            f"({s * 1e3 / -(-nq // 256):.3f} ms per 256-query batch), "
            f"QPS {nq / s:.1f} (host clock, ends in a synchronise)")
    return dict(index=index, cfg=cfg, q=qt, launches=launches,
                recall=recall, search_s=timing, build_s=build_s,
                build_phases=info.seconds, peak=peak,
                index_bytes=tree_bytes(index))


# ---------------------------------------------------------------------------
# 5: kernel time at the main path's shape
# ---------------------------------------------------------------------------

def select_bound(torch, args, kw, width):
    """Least time for the work these inputs need: each probed panel byte
    read once, outputs written once; int32 ops of the slots scanned."""
    gids, zq, rq, keep, coords, res, mask, rows, scale, res_scale = args
    q_n, p_n, k = zq.shape
    cap = coords.shape[2]
    s = kw["sq"].shape[2] if "sq" in kw else 0
    probed = torch.unique(gids[keep].long())
    per_grain = cap * (2 * k + s + 4 + 1) + 12
    in_bytes = int(probed.numel()) * per_grain + sum(
        t.numel() * t.element_size() for t in (gids, zq, rq, keep)) \
        + (kw["sq"].numel() * 4 if s else 0)
    out_bytes = q_n * width * (4 + 4 + 4)          # dists, rows, row lookup
    slots = int(mask.sum(dim=1)[gids.long()][keep].sum())
    ops = slots * (3 * (k + s) + 7)
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / CUDA_CORE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations", in_bytes + out_bytes, ops)


def time_events(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_time_phase(torch, mp):
    from repro_torch.core import int32_safe_qmax, planner, routing
    from repro_torch.kernels import fused_select as fsel

    index, cfg = mp["index"], mp["cfg"]
    q = mp["q"][:256]
    gids, _ = routing.route(index.routing, q, cfg.nprobe)
    width = min(max(cfg.pool, 10), cfg.nprobe * index.grains.cap)
    args, kw = planner.select_args(
        index, q, gids, cfg.envelope_frac,
        int32_safe_qmax(cfg.k, cfg.coord_bits), width=width)
    width = kw.pop("width")
    err = hold(torch, fsel, args, kw, width, "main path inputs")
    for _ in range(3):
        fsel.fused_scan_select(*args, width=width, **kw)
    ms = time_events(torch, lambda: fsel.fused_scan_select(
        *args, width=width, **kw), 20)
    fsel.fused_scan_select_ref(*args, width=width, **kw)
    plain_ms = time_events(torch, lambda: fsel.fused_scan_select_ref(
        *args, width=width, **kw), 3)
    bound_ms, bound_by, nbytes, ops = select_bound(torch, args, kw, width)
    q_n, p_n, k = args[1].shape
    log(f"fused_scan_select at the main path's shape (Q={q_n} P={p_n} "
        f"G={args[4].shape[0]} k={k} cap={args[4].shape[2]} "
        f"s={kw['sq'].shape[2]} width={width}): kernel {ms:.4f} ms, plain "
        f"version {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by} ({nbytes} bytes, {ops} int ops); library: none (no "
        "single PyTorch call computes a masked scan with a running top-W)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err)


# ---------------------------------------------------------------------------
# 6: where a search's device time goes
# ---------------------------------------------------------------------------

def profile_phase(torch, mp, top=8):
    """torch.profiler (CUPTI) over one Mode A and one Mode B search of the
    main path's queries: device time by kernel, and device time over the
    unprofiled search wall time (phase 4) as the busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import search

    index, cfg, q = mp["index"], mp["cfg"], mp["q"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for m in "AB":
            search(index, q, cfg, topk=10, mode=m)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    wall_us = sum(mp["search_s"].values()) * 1e6
    if not dev_us:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile (Mode A + Mode B, {q.shape[0]} queries each): device "
        f"{dev_us / 1e3:.3f} ms over {wall_us / 1e3:.3f} ms of unprofiled "
        f"search wall, busy share {dev_us / wall_us:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.self_device_time_total / dev_us:6.1%} x{e.count:<4d} "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=1024)
    ap.add_argument("--grains", type=int, default=1024)
    a = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch is missing next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    t_start = time.perf_counter()
    name, count, smi = device_phase(torch)
    build_phase()
    err_cases = kernel_phase(torch, torch.device("cuda"))
    mp = main_path(torch, np, n=a.n, nq=a.nq, grains=a.grains,
                   dev=torch.device("cuda"))
    kt = kernel_time_phase(torch, mp)
    profile_phase(torch, mp)
    log(f"card: {smi}; total wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "fused_scan_select", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_select.cu",
        "replaces": "src/repro/kernels/fused_select.py:178",
        "launches": mp["launches"]["fused_scan_select"],
        "max_abs_err": max(err_cases, kt["max_abs_err"]),
        "ms": kt["ms"], "plain_ms": kt["plain_ms"],
        "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
