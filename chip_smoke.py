#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # the full-size run, one card
    python3 chip_smoke.py --n 100000 --grains 128 --kv-tokens 65536 \
        --store-n 100000 --tier-n 100000   # a shorter rehearsal
    compute-sanitizer --tool racecheck python3 chip_smoke.py --race-cases
        # one small launch of each kernel path, for a race checker

What it does, in order (any failure exits non-zero before the last line):

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit line;
2. build: compiles every CUDA source of the port (one ``nvcc`` each, all
   at once) and prints the compiler's register / shared-memory / spill
   report;
3. kernel phase: ``fused_scan_select`` on the card against its plain
   PyTorch version on the card, ``torch.equal`` on dists and rows, for the
   sketch on and off, tenants, ragged probes, ragged cap and width, Q=1,
   k=1, a fully pruned pool, a main-path-shaped input, inputs where every
   slot enters the running top-W (width up to the kernel's limit, every
   slot live, every slot entering the pool), one hot grain probed by every
   pair, exact ties across probes, cap below width, the scalar-load path
   (cap % 4 != 0) and killed pairs inside the grains' runs, and widths
   above the shared-memory carry (``select_cases.WIDE_CASES``: the tree
   merge up to P * cap, the cascade's stage-1 form), and per-probe lists
   above it (``select_cases.LONG_LIST_CASES``: caps of 8,320 and 16,384,
   built from each pair's chunk runs); then
   ``hntl_scan`` and ``hntl_scan_single`` against theirs (``torch.equal``)
   over the JAX package's kernel sweep, int32 extremes and wraparound,
   all-invalid panels, the int8 sketch panels, caps off 128, and the
   shapes of the gather plane and of HNTL-KV decode;
4. main path: the paper's width (d=768, k=32, s=8, B=128) with G=1024
   grains over the 1M-vector ``anisotropic_manifold`` corpus: the build
   with seconds per phase, index bytes and peak device memory; then 1024
   queries in Mode A and Mode B through ``repro_torch.core.search`` with
   the default plane.  The kernels' launch counters are zeroed just before
   and read just after; the ids must equal the "fused_ref" plane's on the
   same index; recall@10 against ``flat_search``; search time per batch
   and QPS on a host clock around work that ends in a synchronise;
5. the "kernel" gather plane on the same index and queries: Mode A and
   Mode B through ``hntl_scan_single`` (counters zeroed just before, read
   just after), ids and dists ``torch.equal`` to the "ref" plane's,
   recall@10 and search time;
6. ``ops.scan_batched`` on the same index: 128 queries projected and
   quantized into every grain's frame, an exhaustive [G, 128, cap] scan
   through ``hntl_scan`` (coordinates and sketch), equal to its plain
   version;
7. kernel times at the main path's shapes (CUPTI device time per call
   of every kernel the wrapper launches, each part beside it, and CUDA
   events; after warm-up) beside the plain versions' times and the bounds
   computed from the inputs;
8. HNTL-KV decode at phi3-mini-3.8b's attention width (32 query and 32 KV
   heads, head_dim 96, kt=16, cap=4096, nprobe=8, pool=128, tail=1024)
   over a 524,288-token bf16 context of clustered keys made on the card:
   the index build, then 8 ``retrieval_decode_attention`` steps, each held
   against exact attention over the whole cache
   (``reference_decode_attention``), against the same step through the
   plain scan (``torch.equal``) and against exact attention over the
   retrieved tokens in float64; step times, tokens touched and the
   kernel's launches;
9. ``torch.profiler`` breakdowns of one Mode A and one Mode B search, of
   one search on the "kernel" gather plane and of one HNTL-KV step:
   device time by kernel and the device's busy share;
9b. the mixed-precision cascade (``cascade_phase``): a density index
   (``bit_alloc="density"``) over the main path's corpus, its coordinate
   bytes at rest (``layout.pack_coords_blob``), 1024 queries in Mode A
   and B through ``planner.search(scan_impl="cascade")`` at budgets
   None, (4096, 64) and (nprobe * cap * 3 // 5, pool) (counters zeroed
   just before each search, read just after), each equal to
   "cascade_ref", at None to "fused" but for exact ties (counted);
   recall@10, times, each stage-1 call held to its plain version and
   timed beside its bound, stage 2 timed alone, a profile, peak memory;
10. the vector store (``store_phase``): 1,000,000 rows added in 8 chunks
   of 125,000 that each seal a 128-grain segment built on the card, a
   4,096-row memtable tail, 10,000 deletes and 1,024 upserts (the
   memtable then holds 5,120 rows); 1024 queries in Mode A, Mode B and
   Mode B under a tag filter and a timestamp filter through
   ``VectorStore.search`` (counters zeroed just before, read just after:
   4 ``fused_scan_select`` calls per search), each held to the
   "fused_ref" plane's ids, free of deleted gids, Mode B dists equal to
   the live vectors' exact distances; recall@10 against exact search
   over the live rows; the same four searches with
   ``scan_impl="cascade", budgets=(4096, 64)`` held to "cascade_ref";
   seal, stack and search times, the select kernel
   at the store's shape, profiles with and without the memtable, peak
   memory; and 256 queries through the "kernel" plane held to "ref";
10b. multi-tenant serving (``tenancy_phase``) on a ``branch()`` of that
   store before its memtable grows (the registry seals its 5,120 rows):
   ``TenantRegistry(memtable_budget=1024, max_live=24)``, 32 tenants of
   1,536 private docs (corpus rows moved to the tenant's own far point),
   64 shared and 16 own deletes and 32 shared upserts each; windows of
   1,024 requests (32 per tenant, Mode A, B and B under a tag filter)
   through ``coalesced_retrieve``: no cross-tenant, deleted or
   superseded row, the deleted and upserted shared rows hidden in the
   writer's bitmap and visible to another tenant's, ``torch.equal`` to
   "fused_ref", each request equal to its tenant's own search (ids;
   near-ties at a routing or pool boundary excused and counted), zero
   re-stacks after a warm-up window and ceil(padded rows / 256) select
   launches per group (counters zeroed just before, read just after);
   the same window through the cascade (== "cascade_ref") and adaptive
   routing (== "fused_ref"); window times and QPS, the host's share by
   part, a profile, and the select with its tenant stream held to its
   plain version and timed beside its bound;
10c. the grain-sharded search plane (``sharded_phase``, before 10b, on a
   branch of that store with its 5,120-row memtable): meshes of 1, 2, 4
   and 8 grain shards and (2 data x 4 model) with ``shard_queries``,
   slots round-robin over the cards (all ``cuda:0`` on one card); per
   mesh the store phase's four searches through
   ``VectorStore.search(mesh=)`` (counter zeroed just before each, read
   just after: shards x query rows x 256-query batches), each
   ``torch.equal`` to the mesh's "fused_ref", held to the live vectors,
   1 shard against the single-device search (ids, ties counted),
   recall@10, times, the placed plane's bytes; the exhaustive cut (4 x
   4,096 rows at d=768, every grain probed, ids equal at 1-8 shards);
   on 4 shards the "kernel" plane, the cascade at (4096, 64) and
   adaptive routing at 0.35 against their plain planes, a profile and
   the per-shard select against its plain version and bound; 10b's
   default window again over 4 shards, and 12's cold store on 4 shards
   (the host re-rank of every shard's pool); and 12e's (d): Mode A and B
   through ``make_host_mesh(1, 4)`` on the card's slots, ``torch.equal``
   to the ``make_search_mesh(4)`` plane;
9c. the select past its 8,192-key per-probe list in a search
   (``long_list_phase``): a density index over the first 262,144 rows in
   16 grains (cap above 8,192), 256 queries through "cascade" at
   ``budgets=None`` (Mode A and B) and "fused" at pool 10,000 (Mode A),
   equal to "cascade_ref" / "fused_ref" (``torch.equal``); each select
   held to its plain version and timed beside its bound; peak memory;
11. the store's lifecycle (``lifecycle_phase``) on the same store, its
   memtable at half the seal threshold: the searches first, then
   ``compact()`` with its defaults (2 merges, 8 -> 2 segments of ~497k
   rows and 512 grains, deleted and shadowed rows reclaimed, the
   maintenance pass a no-op); Mode A, Mode B and Mode B under a tag
   filter on the compacted plane (each held as in 10, recall@10, times
   with and without the memtable, profiles); deletes that empty 8 grains of one merged segment, take
   90% of 8 others and one side of 8 more, read back through
   ``grain_health()``; ``maintain()`` (retires, merges, refits; untouched
   grains bit-identical, the other segment by identity, the live set a
   bijection onto the valid slots, one re-stack), the searches again and
   256 queries through the "kernel" plane held to "ref";
12. serving beyond device memory (``tiered_phase``): a cold store
   (``cold_tier=True``) of 1,000,000 rows in 8 sealed segments, 10,000
   deletes, 1024 queries in a skewed mix (80% near rows of 128 grains);
   its all-warm plane held as in 10, then the same store under
   ``device_budget`` 0, 25% of the panel tier and twice the tier, every
   paged search equal to the all-warm one (ids and dists,
   ``torch.equal``); adaptive routing (``adaptive_phase``) at
   ``probe_margin`` 0.35 and 1.0 with 4 hubs: all-warm Mode A and B equal
   to "fused_ref" from the same traffic state, one select launch per
   (width bucket, 256 queries) at the bucket's width, ``adaptive=False``
   and ``probe_margin=inf`` equal to the static search, paged at 25% of
   the tier equal to all-warm with equal ``probe_stats()``; active probes,
   hubs, recall@10 adaptive and static, times, launches, busy shares;
   the cascade on the cold store (all-warm at (4096,
   64) held to "cascade_ref"; paged at 25% of the tier: at budgets None
   equal to the all-warm cascade but for exact ties, at (4096, 64), per
   pass, to the paged "cascade_ref"); tenancy on a branch of the cold
   store at 25% of the tier (``paged_tenancy``: 8 tenants, 256 requests,
   paged == all-warm, ``torch.equal``); again after 10,000 more deletes, after
   ``compact()`` (merged cold files written, the replaced ones gone from
   disk) and after ``maintain()`` (the repaired child shares its
   parent's cold file); seal (build, cold write), search, re-rank gather
   and staging times, every select launch of a paged search held to its
   plain version and timed, profiles, the device memory held; it checks
   the free disk first and removes its directory at the end;
12b. serving a model (``serve_phase``): phi3-mini-3.8b at its published
   width and depth (32 layers, d_model 3072, 32 heads of 96, d_ff 8192,
   vocab 32064, bf16), random weights drawn on the card from a seeded
   generator: ``repro_torch.launch.serve.main`` answers 8 requests (64
   prompt tokens, 32 new, 4 slots, a 65,536-row memory sidecar whose
   retrieval launches ``fused_scan_select``), tokens/s and engine ticks;
   decode against forward at full width in float32 (within 1e-4; in
   bf16 measured against the reference's tolerances) and the engine
   equal to a manual greedy loop; one 32,768-token request
   (``--serve-tokens``) prefilled, one exact decode step, promoted to 32
   ``KVIndex`` layers (``promote_to_retrieval``), then 16 retrieval
   decode steps, each launching ``hntl_scan_single`` 32 times (counter
   zeroed just before, read just after) and ``torch.equal`` to the same
   step through the plain scan; the first step against the exact one
   (measured, not gated), times, a profile of one step, the kernel at
   this shape beside its bound, index and cache bytes, peak memory;
12c. the rest of the model families (``families_phase``), each at its
   published width with random weights from seed 0, phi3-mini freed
   first: qwen3-moe-30b-a3b at full depth in bf16 (61 GB; the free
   device memory is checked first) through ``launch.serve.main`` (4
   requests of 32 + 16 tokens, 4 slots), one ``--serve-tokens`` request
   prefilled, promoted to 48 ``KVIndex`` layers and decoded 8 retrieval
   steps (each launching ``hntl_scan_single`` 48 times and
   ``torch.equal`` to its plain-scan twin), float32 decode against
   forward at 4 layers with no drops (top-k set differences and the
   published factor's drops counted); dbrx-132b in float32 at 2 and in
   bf16 at 4 of 40 layers; recurrentgemma-9b and rwkv6-1.6b at full depth:
   float32 decode against forward, 4 requests through 4 slots equal to
   each served alone (and the final recurrent states compared), prefills
   of 4,096 and 32,768 (rwkv6: 256 and 2,048) tokens with flat step times
   and state bytes (rwkv6's float32 check gated at 1 layer, measured at
   24 beside the card's row-count floor); whisper-base: a
   1,500-frame window decoded 32 tokens on exact cross-attention (float32,
   equal to the teacher-forced decode), then 65,536 frames sealed by
   ``build_cross_index`` (16 grains per head, 8 probed) and 16
   ``decode_step_retrieval`` steps, 6 scans each, each ``torch.equal`` to
   its plain twin, against exact cross-attention; times, profiles, the
   kernel at the two new shapes beside its bound, peak memory;
12d. training (``train_phase``), the families' models freed first: (a)
   phi3-mini at full width cut to 2 layers, float32, B=2 S=256: the
   card's ``Model.loss`` and every gradient against the same model's on
   the CPU (loss rtol 1e-5, each leaf within 1e-4 of its own max
   |g_cpu|); (b) a step over 4 microbatches against one over the whole
   batch: the accumulated gradients as in (a), the loss and parameters
   within ``tests/test_train.py``'s tolerances; (c) the tiny phi3-mini (2
   layers, vocab 128) through ``Trainer``: 40 steps on ``MarkovLM``, the
   loss falls by 0.5 and below ln 128; (d) ``launch.train.main`` on
   phi3-mini cut to 2 layers at full width, bf16, B=8 S=1024, in a
   temporary directory (its free space and the checkpoints' bytes
   printed, removed after): stopped by SIGTERM at step 10, resumed to
   20, every leaf (parameters and moments) against an uninterrupted
   20-step run (rtol 1e-3, atol 1e-4), and ``--lr nan`` raising
   ``FloatingPointError``; (e) phi3-mini-3.8b at its published width and
   depth, bf16, B=8 S=1024, 20 steps through ``init_state`` /
   ``make_train_step`` with finite losses: step ms, tokens/s, the
   optimizer's share (CUDA events), peak memory, and one more step
   profiled (busy share, top device ops); (f) qwen3-moe-30b-a3b at full
   width cut to 2 layers (router gradients finite and nonzero, 3 steps,
   aux > 0) and whisper-base at full width and depth (10 steps on
   1,500-frame inputs); training reaches no CUDA kernel of the port;
12e. training on a mesh (``mesh_phase``), every slot on the card: (a)
   phi3-mini-3.8b at full width and depth on a 2 x 2 ``make_host_mesh``
   under ``default_rules``, B=8 S=1024 with row 0's first sequence padded
   from token 512: the gate in float32 (the mesh's loss and every
   gradient against the one-slot step's on the same parameters: rtol
   1e-5, each leaf within 1e-4 of its own max |g|; the bf16 numbers
   logged), then 10 bf16 steps of the placed state (leaves whole, shards
   views): step ms, tokens/s, peak memory, a profiled step; (b)
   qwen2-vl-2b at full width and depth over 2 data slots: int8_ef's first
   reduced gradient within half its consensus scale of the exact mean,
   3 steps of each of ``none``, ``bf16`` and ``int8_ef`` timed with their
   wire bytes, and the reference's 12-step trajectory bounds at smoke
   width on 8 slots; (c) phi3-mini cut to 2 layers on a 4 x 2 mesh,
   saved, ``shrink_mesh`` to 4 slots, ``restore(shardings=)`` and
   ``remesh_train_state``: every leaf bit-equal, the next step finite,
   save and restore seconds; then each ``examples/torch_*.py`` on the
   card with its kernels' launches; ``python3 chip_train_controls.py``
   shows (a) and (b)'s gates fail on planted faults;
13. the kernel table as one JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import unittest.mock

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")

# H100 SXM published peaks (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
# int32 work runs on the CUDA cores; counted against the table's
# non-tensor-core rate (67 T operations/s), which no int32 rate exceeds.
CUDA_CORE_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def sync(torch, dev):
    """Wait for the device's queued work (nothing to wait for on the CPU,
    where the phases can be rehearsed)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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


#: Template arguments in the kernels' mangled names.
_MANGLED_TYPES = {"IsE": "int16", "IaE": "int8"}


def kernel_label(line):
    """A readable name for a ptxas "Compiling entry function" line."""
    for name in ("fused_scan_select_probe_kernel",
                 "fused_scan_select_merge_kernel",
                 "fused_scan_select_wide_merge_kernel",
                 "hntl_scan_single_kernel", "hntl_scan_kernel"):
        if name not in line:
            continue
        tail = line.split(name, 1)[1]
        if name == "fused_scan_select_wide_merge_kernel":
            return name + (" (chunk runs)" if "ILb1E" in tail else "")
        if "merge_kernel" in name:
            return name
        if name == "fused_scan_select_probe_kernel":
            # template flags of the kernel's <sketch, tenant, vec, runs>
            flags = tail.split("ILb")[-1].split("EEEv")[0].split("ELb")
            return name + " " + ", ".join(
                f"{k}={v}" for k, v in zip(("sketch", "tenant", "vec",
                                            "runs"), flags))
        coord = next((t for m, t in _MANGLED_TYPES.items()
                      if tail.startswith(m)), "?")
        return f"{name}<{coord}>"
    return line


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
                log("    ptxas: kernel " + kernel_label(line))
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
    # the per-probe kernel's schedule and the per-query merge: every pair
    # in one grain run; equal keys across probes (different grains and one
    # grain probed twice); L = cap < width; the scalar path (cap % 4 != 0);
    # killed pairs (ragged n_active, keep holes) inside the grains' runs
    "hot_grain": dict(hot_grain=True, q=64, p=16, g=64, k=32, cap=1664,
                      width=64, s=8),
    "ties_across_probes": dict(ties=True, q=32, p=8, g=5, k=32, cap=1100,
                               width=3000, s=8),
    "cap_below_width": dict(q=32, p=8, g=64, k=32, cap=200, width=1000,
                            s=8),
    "scalar_path_cap_1662": dict(q=64, p=16, g=64, k=32, cap=1662, width=64,
                                 s=8, tenants=3),
    "ragged_keep_holes": dict(q=128, p=16, g=8, k=32, cap=512, width=64,
                              s=8, ragged=True, keep_frac=0.5),
    # a tiered residency pass: a cold chunk's mini-plane of 64 grains and
    # the trailing all-invalid dummy grain, slack probes pointing at it
    # behind n_active, a power-of-two query subset
    "mini_plane_chunk": dict(mini_plane=True, q=128, p=8, g=65, k=32,
                             cap=1664, width=64, s=8),
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
        elif c.pop("ties", False):
            a = select_cases.tie_inputs(**c)
        elif c.pop("hot_grain", False):
            a = select_cases.hot_grain_inputs(i, **c)
        elif c.pop("mini_plane", False):
            a = select_cases.mini_plane_inputs(i, **c)
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
    # above the shared-memory carry: the tree merge in global scratch
    for label, (width, make) in select_cases.WIDE_CASES.items():
        a = make()
        args, kw = select_cases.split(
            a, lambda v: torch.from_numpy(v).to(dev))
        errs.append(hold(torch, fsel, args, kw, width, label))
        q_n, p_n, k = a["zq"].shape
        g_n, _, cap = a["coords"].shape
        log(f"  kernel == plain: {label} (Q={q_n} P={p_n} G={g_n} k={k} "
            f"cap={cap} s={a['sq'].shape[2] if 'sq' in a else 0} "
            f"width={width}, the wide merge) ok")
    # per-probe lists above it: each pair's sorted chunk runs, tree-merged
    for label, (width, make) in select_cases.LONG_LIST_CASES.items():
        a = make()
        args, kw = select_cases.split(
            a, lambda v: torch.from_numpy(v).to(dev))
        errs.append(hold(torch, fsel, args, kw, width, label))
        q_n, p_n, k = a["zq"].shape
        g_n, _, cap = a["coords"].shape
        log(f"  kernel == plain: {label} (Q={q_n} P={p_n} G={g_n} k={k} "
            f"cap={cap} s={a['sq'].shape[2] if 'sq' in a else 0} "
            f"width={width}{', ragged n_active' if 'n_active' in a else ''}"
            f", per-probe lists of {min(width, cap)} keys from chunk runs) "
            "ok")
    log("kernels: fused_scan_select (held against fused_scan_select_ref, "
        f"torch.equal on dists and rows, {len(errs)} cases, "
        f"{len(select_cases.WIDE_CASES) + len(select_cases.LONG_LIST_CASES)}"
        f" of them above the shared-memory carry of {fsel.SMEM_WIDTH} keys, "
        f"{len(select_cases.LONG_LIST_CASES)} with per-probe lists above "
        "it)")
    return max(errs)


#: One small launch of each kernel path: the probe kernel and the shared
#: merge (vector and scalar loads, ragged probes), the wide merge, the
#: chunk runs with their tree merge, and both scan kernels.
RACE_CASES = {
    "probe kernel + shared merge": (64, dict(q=4, p=4, g=6, k=8, cap=256,
                                             s=4, ragged=True)),
    "scalar loads + shared merge": (64, dict(q=2, p=3, g=4, k=4, cap=130,
                                             tenants=2)),
    "wide merge": (9000, dict(q=2, p=3, g=4, k=4, cap=4000)),
    "chunk runs + tree merges": (8400, dict(q=2, p=2, g=3, k=2, cap=8320,
                                            s=2, ragged=True)),
}


def race_phase(torch, np, dev):
    """Each kernel path launched once at a small shape and held to its
    plain version (``torch.equal``): the whole run under
    ``compute-sanitizer --tool racecheck`` / ``synccheck`` is the race
    check of the kernels."""
    from repro_torch.kernels import fused_select as fsel
    from repro_torch.kernels import hntl_scan as hs
    from repro_torch.kernels import ref
    from repro_torch.kernels import scan_cases as sc
    from repro_torch.kernels import select_cases

    for i, (label, (width, shape)) in enumerate(RACE_CASES.items()):
        args, kw = select_cases.split(
            select_cases.random_inputs(i, **shape),
            lambda v: torch.from_numpy(v).to(dev))
        hold(torch, fsel, args, kw, width, label)
        log(f"race case: fused_scan_select, {label} ({shape}, width "
            f"{width}) == plain")
    a = sc.panels(5, p=3, q=20, k=16, cap=200)
    conv = lambda v: torch.from_numpy(v).to(dev)  # noqa: E731
    for label, kern, plain, args in (
            ("hntl_scan", hs.hntl_scan, ref.hntl_scan_ref, sc.args(a, conv)),
            ("hntl_scan_single", hs.hntl_scan_single,
             ref.hntl_scan_single_ref,
             sc.args(sc.single(sc.panels(6, p=3, q=1, k=16, cap=200)),
                     conv))):
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"race case {label}: differs from "
              "its plain version")
        log(f"race case: {label} == plain")
    log(f"race cases: {len(RACE_CASES) + 2} launches, all equal to their "
        "plain versions")


def mixed_tile(sc, np, seed, coord_dtype):
    """Three 16-query tiles, each with one query at a limb count's edge of
    the batched kernel: -32768 and 32767 in tile 0 (2 limbs), one value of
    32768 in tile 1 (4 limbs; its neighbours fit int16) and -2^31 in the
    second panel, -128 and 127 in tile 2 (1 limb)."""
    int8 = coord_dtype == np.int8
    a = sc.panels(seed, p=2, q=40, k=32, cap=333,
                  coord_range=128 if int8 else 32768, coord_dtype=coord_dtype)
    z = a["zq"]
    z[0, 3, :4] = [-32768, 32767, -32768, 32767]
    z[0, 17, 5] = 32768
    z[1, 20, :] = -2 ** 31
    z[:, 32:, :] = np.clip(z[:, 32:, :], -128, 127)
    z[:, 32, :2] = [-128, 127]
    return a


def scan_cases(sc, np):
    """(label, form, inputs) of every case the scan kernels are held to."""
    cases = []
    for i, (p, q, k, cap) in enumerate(sc.SWEEP):
        cases.append((f"sweep P={p} Q={q} k={k} cap={cap}", "batched",
                      sc.panels(i, p=p, q=q, k=k, cap=cap)))
        cases.append((f"sweep pairs P={p * q} k={k} cap={cap}", "single",
                      sc.single(sc.panels(i, p=p * q, q=1, k=k, cap=cap))))
    for i, (p, k, cap) in enumerate(sc.SINGLE_SWEEP):
        cases.append((f"single sweep P={p} k={k} cap={cap}", "single",
                      sc.single(sc.panels(10 + i, p=p, q=1, k=k, cap=cap))))
    ext = sc.extremes(p=2, q=3, k=32, cap=200)
    wrap = dict(p=3, q=5, k=16, cap=333, zq_range=2 ** 31 - 1)
    int8 = dict(p=3, q=130, k=8, cap=333, coord_range=128,
                coord_dtype=np.int8)
    cases += [
        ("int32 extremes k=32", "batched", ext),
        ("int32 extremes k=32", "single", sc.single(sc.extremes(
            p=4, q=1, k=32, cap=200))),
        ("int32 wraparound", "batched", sc.panels(20, **wrap)),
        ("int32 wraparound", "single", sc.single(sc.panels(
            21, **{**wrap, "q": 1}))),
        ("all invalid", "batched", sc.panels(22, p=2, q=9, k=16, cap=256,
                                             valid_frac=0.0)),
        ("all invalid", "single", sc.single(sc.panels(
            23, p=5, q=1, k=16, cap=256, valid_frac=0.0))),
        ("int8 sketch panels s=8", "batched", sc.panels(24, **int8)),
        ("int8 sketch panels s=8", "single", sc.single(sc.panels(
            25, **{**int8, "p": 4096, "q": 1, "cap": 1664}))),
        ("HNTL-KV shape P=256 k=16 cap=4096", "single", sc.single(
            sc.panels(26, p=256, q=1, k=16, cap=4096, valid_frac=1.0))),
        ("gather-plane shape P=4096 k=32 cap=1664", "single", sc.single(
            sc.panels(27, p=4096, q=1, k=32, cap=1664, coord_range=4000))),
        ("main-path-like P=64 Q=128 k=32 cap=1664", "batched", sc.panels(
            28, p=64, q=128, k=32, cap=1664, coord_range=4000)),
        ("int8 panels, int32 wraparound", "batched", sc.panels(
            29, **{**int8, "q": 19, "zq_range": 2 ** 31 - 1})),
        ("tiles of 1, 2 and 4 limbs, int16", "batched",
         mixed_tile(sc, np, 30, np.int16)),
        ("tiles of 1, 2 and 4 limbs, int8", "batched",
         mixed_tile(sc, np, 31, np.int8)),
        ("k=64", "batched", sc.panels(32, p=2, q=17, k=64, cap=200)),
        ("k=192 (three staged chunks), wraparound", "batched", sc.panels(
            33, p=2, q=20, k=192, cap=140, zq_range=2 ** 31 - 1,
            coord_range=32768)),
        ("Q=1", "batched", sc.panels(34, p=3, q=1, k=32, cap=257)),
        ("Q=600 (five query groups)", "batched", sc.panels(
            35, p=2, q=600, k=16, cap=64)),
        ("k=12 int8 cap=131 (no vector access)", "batched", sc.panels(
            36, p=2, q=21, k=12, cap=131, coord_range=128,
            coord_dtype=np.int8)),
        ("P=65537 (two launches)", "batched", sc.panels(
            37, p=65537, q=1, k=8, cap=8)),
    ]
    return cases


def scan_kernel_phase(torch, np, dev):
    """Both scan kernels against their plain versions, torch.equal.
    Returns the largest absolute difference seen per form."""
    from repro_torch.kernels import hntl_scan as hs
    from repro_torch.kernels import ref
    from repro_torch.kernels import scan_cases as sc

    fns = {"batched": (hs.hntl_scan, ref.hntl_scan_ref),
           "single": (hs.hntl_scan_single, ref.hntl_scan_single_ref)}
    n = {"batched": 0, "single": 0}
    err = {"batched": 0.0, "single": 0.0}
    for label, form, a in scan_cases(sc, np):
        args = sc.args(a, lambda v: torch.from_numpy(v).to(dev))
        kern, plain = fns[form]
        before = kern.launches
        d = kern(*args)
        rd = plain(*args)
        sync(torch, dev)
        if dev.type == "cuda":
            check(kern.launches == before + 1, f"{form} {label}: not "
                  "launched")
        err[form] = max(err[form],
                        float((d.double() - rd.double()).abs().max()))
        check(torch.equal(d, rd), f"{form} {label}: kernel differs from "
              f"the plain version in {int((d != rd).sum())} entries")
        n[form] += 1
        log(f"  kernel == plain: {kern.__name__} {label} ({args[2].dtype}) "
            "ok")
    log(f"kernels: hntl_scan ({n['batched']} cases) and hntl_scan_single "
        f"({n['single']} cases) held against hntl_scan_ref / "
        "hntl_scan_single_ref, torch.equal")
    return err


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
    return dict(index=index, cfg=cfg, q=qt, truth=truth, launches=launches,
                recall=recall, search_s=timing, build_s=build_s,
                build_phases=info.seconds, peak=peak,
                index_bytes=tree_bytes(index), x=x)


# ---------------------------------------------------------------------------
# 5: kernel time at the main path's shape
# ---------------------------------------------------------------------------

def select_bound(torch, args, kw, width):
    """Least time for the work these inputs need: each probed panel byte
    read once, outputs written once; int32 ops of the slots scanned."""
    from repro_torch.core.scan import probe_alive

    gids, zq, rq, keep, coords, res, mask, rows, scale, res_scale = args
    keep = probe_alive(keep, kw.get("n_active"))    # killed pairs read none
    q_n, p_n, k = zq.shape
    cap = coords.shape[2]
    s = kw["sq"].shape[2] if "sq" in kw else 0
    probed = torch.unique(gids[keep].long())
    per_grain = cap * (2 * k + s + 4 + 1) + 12
    in_bytes = int(probed.numel()) * per_grain + sum(
        t.numel() * t.element_size() for t in (gids, zq, rq, keep)) \
        + (kw["sq"].numel() * 4 if s else 0)
    if kw.get("tenant_mask") is not None:   # a byte per (tenant, slot)
        ti = kw["tenant_ix"].long()[:, None].expand_as(gids)
        pairs = torch.unique(ti[keep] * coords.shape[0] + gids[keep].long())
        in_bytes += int(pairs.numel()) * cap + q_n * 4
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


#: Idle seconds before and after each profiled step of ``trace_calls``.
#: Without it, short kernels launched right at the start of the active
#: step were now and then missing from the trace (``chip_trace_margin.py``
#: counts such traces with and without it).
TRACE_MARGIN_S = 0.05


def trace_calls(torch, fn, reps, margin_s=TRACE_MARGIN_S):
    """The card's records (torch.profiler's key averages, CUDA only) of
    ``reps`` calls of ``fn``.  The trace records a warm-up step of
    ``reps`` calls first and keeps only the second step (the profiler's
    schedule): the first records of a fresh profiler trace can be lost.
    Each step starts and ends with ``margin_s`` seconds of idle card."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule

    trace = {}
    with tprofile(activities=[ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=1),
                  on_trace_ready=lambda p: trace.setdefault(
                      "evs", p.key_averages())) as prof:
        for _ in range(2):
            time.sleep(margin_s)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin_s)
            prof.step()
    return [e for e in trace.get("evs", [])
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(torch, fn, kernels, reps=20):
    """Device time per call of ``fn``, from torch.profiler (CUPTI) over
    ``reps`` calls (``trace_calls``): unlike CUDA events around
    back-to-back calls, it leaves out the host's launch time when the
    device work is shorter.

    Returns (ms, parts, traces): ms is all device work of a call, whatever
    launched it; parts maps each name in ``kernels`` to the device time
    per call of the kernels whose name holds it, and "other" to the rest.
    A trace that holds fewer than ``reps`` launches of a named kernel is
    incomplete (the profiler has dropped a record now and then): it is
    taken again, the run fails after five such traces, and ``traces``
    says how many were taken."""
    attempts = 5
    for attempt in range(1, attempts + 1):
        evs = trace_calls(torch, fn, reps)
        seen = {name: sum(e.count for e in evs if name in e.key)
                for name in kernels}
        short = {k: v for k, v in seen.items() if v < reps}
        if not short:
            break
        msg = (f"device_ms: the profiler saw {short} launches in {reps} "
               f"calls (trace {attempt} of {attempts})")
        check(attempt < attempts, msg)
        log(msg + "; tracing again")
    total = sum(e.self_device_time_total for e in evs) / reps / 1e3
    parts = {name: sum(e.self_device_time_total for e in evs
                       if name in e.key) / reps / 1e3 for name in kernels}
    parts["other"] = total - sum(parts.values())
    return total, parts, attempt


#: The kernels one ``fused_scan_select`` call launches, and what each part
#: of its device time is called in the log ("other": the schedule's
#: torch.where and torch.sort).  Above the shared-memory carry the merge
#: is the wide merge's ceil(log2 P) launches (``select_kernels``).
SELECT_KERNELS = ("fused_scan_select_probe_kernel",
                  "fused_scan_select_merge_kernel")
WIDE_SELECT_KERNELS = ("fused_scan_select_probe_kernel",
                       "fused_scan_select_wide_merge_kernel")
SELECT_PARTS = {"fused_scan_select_probe_kernel": "probe kernel",
                "fused_scan_select_merge_kernel": "merge kernel",
                "fused_scan_select_wide_merge_kernel": "wide merge kernels",
                "other": "schedule"}


def select_kernels(width):
    from repro_torch.kernels import fused_select as fsel

    return WIDE_SELECT_KERNELS if width > fsel.SMEM_WIDTH else SELECT_KERNELS


def time_select(torch, index, q, cfg, label, grain_mask=None,
                extra_mask=None):
    """fused_scan_select at one query batch of a search on ``index``:
    held against its plain version, then its CUPTI device time (every
    kernel the wrapper launches, each part beside it), CUDA events, the
    plain version's time and the bound.  ``grain_mask``/``extra_mask``
    are the routing pushdown and slot mask the search passes."""
    from repro_torch.core import int32_safe_qmax, planner, routing
    from repro_torch.kernels import fused_select as fsel

    gids, _ = routing.route(index.routing, q, cfg.nprobe,
                            grain_mask=grain_mask)
    width = min(max(cfg.pool, 10), cfg.nprobe * index.grains.cap)
    args, kw = planner.select_args(
        index, q, gids, cfg.envelope_frac,
        int32_safe_qmax(cfg.k, cfg.coord_bits), width=width,
        extra_mask=extra_mask)
    width = kw.pop("width")
    err = hold(torch, fsel, args, kw, width, label)
    for _ in range(3):
        fsel.fused_scan_select(*args, width=width, **kw)
    events_ms = time_events(torch, lambda: fsel.fused_scan_select(
        *args, width=width, **kw), 20)
    ms, parts, traces = device_ms(torch, lambda: fsel.fused_scan_select(
        *args, width=width, **kw), SELECT_KERNELS)
    fsel.fused_scan_select_ref(*args, width=width, **kw)
    plain_ms = time_events(torch, lambda: fsel.fused_scan_select_ref(
        *args, width=width, **kw), 3)
    bound_ms, bound_by, nbytes, ops = select_bound(torch, args, kw, width)
    q_n, p_n, k = args[1].shape
    at = (f"Q={q_n} P={p_n} G={args[4].shape[0]} k={k} "
          f"cap={args[4].shape[2]} s={kw['sq'].shape[2]} width={width}")
    log(f"fused_scan_select at {label} ({at}): {ms:.4f} ms per call "
        f"(CUPTI, every kernel the wrapper launches: "
        + ", ".join(f"{SELECT_PARTS[k]} {v:.4f}" for k, v in parts.items())
        + f"; CUDA events {events_ms:.4f} ms), plain "
        f"version {plain_ms:.4f} ms, bound {bound_ms:.4f} ms by "
        f"{bound_by} ({nbytes} bytes, {ops} int ops); library: none (no "
        "single PyTorch call computes a masked scan with a running top-W); "
        f"CUPTI traces taken {traces}")
    return dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, traces=traces,
                max_abs_err=err,
                parts={SELECT_PARTS[k]: v for k, v in parts.items()}, at=at)


def kernel_time_phase(torch, mp):
    return time_select(torch, mp["index"], mp["q"][:256], mp["cfg"],
                       "the main path's shape")


# ---------------------------------------------------------------------------
# 5-7: the "kernel" gather plane, ops.scan_batched, the scan kernels' times
# ---------------------------------------------------------------------------

def gather_plane_phase(torch, mp):
    """Mode A and Mode B on the "kernel" gather plane (hntl_scan_single):
    ids and dists equal to the "ref" plane's, recall, search time."""
    from repro_torch.core import search
    from repro_torch.core.flat import recall_at_k
    from repro_torch.kernels import hntl_scan as hs

    index, cfg, q = mp["index"], mp["cfg"], mp["q"]
    dev, nq = index.device, q.shape[0]
    hs.hntl_scan_single.launches = 0
    res = {m: search(index, q, cfg, topk=10, mode=m, scan_impl="kernel")
           for m in "AB"}
    sync(torch, dev)
    launches = hs.hntl_scan_single.launches
    log(f"gather plane \"kernel\": hntl_scan_single launches {launches} "
        f"(Mode A + Mode B, {nq} queries in batches of 256)")
    if dev.type == "cuda":
        check(launches > 0, "the kernel plane never launched "
              "hntl_scan_single")
    recall = {}
    for m in "AB":
        ref = search(index, q, cfg, topk=10, mode=m, scan_impl="ref")
        check(torch.equal(res[m].ids, ref.ids),
              f"kernel plane Mode {m}: ids differ from the ref plane "
              f"({int((res[m].ids != ref.ids).sum())} entries)")
        check(torch.equal(res[m].dists, ref.dists),
              f"kernel plane Mode {m}: dists differ from the ref plane")
        recall[m] = recall_at_k(res[m].ids, mp["truth"])
    log(f"gather plane \"kernel\" == \"ref\" (ids and dists, torch.equal);"
        f" recall@10 Mode A {recall['A']:.4f}, Mode B {recall['B']:.4f}")
    timing = {}
    for m in "AB":
        search(index, q, cfg, topk=10, mode=m, scan_impl="kernel")
        sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(3):
            search(index, q, cfg, topk=10, mode=m, scan_impl="kernel")
        sync(torch, dev)
        timing[m] = (time.perf_counter() - t0) / 3
        log(f"search Mode {m} on the \"kernel\" plane: "
            f"{timing[m] * 1e3:.3f} ms for {nq} queries (QPS "
            f"{nq / timing[m]:.1f}; the default \"fused\" plane: "
            f"{mp['search_s'][m] * 1e3:.3f} ms)")
    return dict(launches=launches, recall=recall, search_s=timing)


def gather_scan_args(torch, mp, nq=256):
    """The single-scan kernel's inputs of one gather-plane batch (the
    coordinate launch and the sketch launch), as ``scan_probed`` makes
    them."""
    from repro_torch.core import int32_safe_qmax, planner, routing

    index, cfg = mp["index"], mp["cfg"]
    g = index.grains
    q = mp["q"][:nq]
    gids, _ = routing.route(index.routing, q, cfg.nprobe)
    zq, rq, _, sq = planner._project_quantized(
        index, q, gids, cfg.envelope_frac,
        int32_safe_qmax(cfg.k, cfg.coord_bits))
    gl = gids.reshape(-1).long()
    pn, k, cap = gl.numel(), g.k, g.cap
    coords = (zq.reshape(pn, k), rq.reshape(pn), g.coords[gl], g.res[gl],
              g.valid[gl], g.scale[gl], g.res_scale[gl])
    s = sq.shape[-1]
    sketch = (sq.reshape(pn, s), torch.zeros_like(coords[1]), g.sketch[gl],
              torch.zeros_like(coords[3]), torch.ones_like(coords[4]),
              g.sketch_scale[gl], torch.ones_like(coords[5]))
    return coords, sketch


def scan_batched_phase(torch, mp, nq=128):
    """ops.scan_batched over every grain of the main path's index for nq
    of its queries, held against its plain version."""
    from repro_torch.core import int32_safe_qmax, quantize
    from repro_torch.core.types import BIG
    from repro_torch.kernels import hntl_scan as hs
    from repro_torch.kernels import ops

    index, cfg = mp["index"], mp["cfg"]
    g = index.grains
    q = mp["q"][:nq]
    vc = q[None, :, :] - g.mu[:, None, :]                  # [G, Q, d]
    z = torch.bmm(vc, g.basis)                             # [G, Q, k]
    sq = torch.bmm(vc, g.sketch_basis)                     # [G, Q, s]
    rq = torch.clamp(torch.sum(vc * vc, -1) - torch.sum(z * z, -1)
                     - torch.sum(sq * sq, -1), min=0.0).contiguous()
    del vc
    qeff = int32_safe_qmax(cfg.k, cfg.coord_bits)
    zq = quantize.quantize_coords(z, g.scale[:, None, None],
                                  qmax=qeff).to(torch.int32)
    sqq = quantize.quantize_coords(sq, g.sketch_scale[:, None, None],
                                   qmax=127).to(torch.int32)
    args = (zq, rq, g.coords, g.res, g.valid, g.scale, g.res_scale)
    kw = dict(sq=sqq, sketch=g.sketch, sketch_scale=g.sketch_scale)
    hs.hntl_scan.launches = 0
    d = ops.scan_batched(*args, **kw)
    sync(torch, index.device)
    launches = hs.hntl_scan.launches
    if index.device.type == "cuda":
        check(launches > 0, "ops.scan_batched never launched hntl_scan")
    dr = ops.scan_batched(*args, **kw, backend="ref")
    check(torch.equal(d, dr), "ops.scan_batched differs from its plain "
          f"version in {int((d != dr).sum())} entries")
    del dr
    gn, qn, cap = d.shape
    dead = d >= BIG / 2
    check(torch.equal(dead, (~g.valid)[:, None, :].expand_as(dead)),
          "ops.scan_batched: BIG on other slots than the invalid ones")
    check(bool(torch.isfinite(d).all()), "ops.scan_batched: non-finite")
    log(f"ops.scan_batched on the main path's index: G={gn} grains x "
        f"Q={qn} queries x cap={cap} (+ sketch s={sqq.shape[-1]}), "
        f"{d.numel() * 4} bytes out; hntl_scan launches {launches}; equal "
        "to its plain version (torch.equal), BIG exactly on invalid slots")
    del d
    return dict(args=args, sketch=(sqq, torch.zeros_like(rq), g.sketch,
                                   torch.zeros_like(g.res),
                                   torch.ones_like(g.valid), g.sketch_scale,
                                   torch.ones_like(g.sketch_scale)),
                launches=launches)


def scan_bound(args, queries):
    """Least time for one scan launch: each input read once and the
    output written once; per (query, slot) k multiply-adds (2 ops each,
    the cross-term form) plus the epilogue (6 ops)."""
    zq, rq, coords, res, valid, scale, res_scale = args
    p, k, cap = coords.shape
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + p * queries * cap * 4
    ops = p * queries * cap * (2 * k + 6)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / CUDA_CORE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def time_scan(torch, label, kern, plain, args, queries, reps=20):
    """Kernel time (CUPTI device time per launch, and CUDA events over
    back-to-back launches, after warm-up), plain-version time (CUDA
    events) and the bound, at one launch's inputs."""
    for _ in range(3):
        kern(*args)
    events_ms = time_events(torch, lambda: kern(*args), reps)
    ms, _, traces = device_ms(torch, lambda: kern(*args),
                              (kern.__name__ + "_kernel",))
    plain(*args)
    plain_ms = time_events(torch, lambda: plain(*args), 3)
    bound_ms, bound_by, nbytes, ops = scan_bound(args, queries)
    p, k, cap = args[2].shape
    log(f"{kern.__name__} at {label} (P={p} Q={queries} k={k} cap={cap} "
        f"{args[2].dtype}): kernel {ms:.4f} ms (CUPTI; CUDA events "
        f"{events_ms:.4f} ms), plain version "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes} bytes, {ops} ops); library: none (no single PyTorch "
        f"call computes an exact-int32 masked Block-SoA scan); CUPTI traces "
        f"taken {traces}")
    return dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, traces=traces)


def scan_time_phase(torch, mp, sb):
    from repro_torch.kernels import hntl_scan as hs
    from repro_torch.kernels import ref

    coords, sketch = gather_scan_args(torch, mp)
    out = {}
    out["gather_coords"] = time_scan(
        torch, "a gather-plane batch, coordinates", hs.hntl_scan_single,
        ref.hntl_scan_single_ref, coords, 1)
    out["gather_sketch"] = time_scan(
        torch, "a gather-plane batch, sketch", hs.hntl_scan_single,
        ref.hntl_scan_single_ref, sketch, 1)
    nq = sb["args"][0].shape[1]
    out["batched_coords"] = time_scan(
        torch, "ops.scan_batched over the index, coordinates", hs.hntl_scan,
        ref.hntl_scan_ref, sb["args"], nq, reps=5)
    out["batched_sketch"] = time_scan(
        torch, "ops.scan_batched over the index, sketch", hs.hntl_scan,
        ref.hntl_scan_ref, sb["sketch"], nq, reps=5)
    return out


# ---------------------------------------------------------------------------
# 8: HNTL-KV decode at phi3-mini-3.8b's attention width
# ---------------------------------------------------------------------------

#: Acceptance of retrieval against exact attention over the whole cache
#: (max abs error, see PERF.md), and against exact attention over the
#: retrieved tokens in float64: |out - oracle| <= 2^-8 |oracle| + 1e-5 per
#: output (the bf16 output rounds by at most 2^-9 of its value; 1e-5
#: covers the float32 sums near zero).
KV_ERR_WHOLE_CACHE = 0.6
KV_REL_ERR_RETRIEVED = 2.0 ** -8
KV_ABS_ERR_RETRIEVED = 1e-5


def clustered_cache(torch, dev, *, tokens, extra, kv, hd, cap, dtype, gen,
                    chunk=32768):
    """[1, tokens + extra, KV, hd] keys and values on the card: one centre
    (N(0, 1) x 1.5) per cap-token grain, shared by the heads, plus
    0.15 N(0, 1) noise per head (``benchmarks/hntl_kv_decode.py``'s
    generator at these shapes); values N(0, 1).  The ``extra`` slots are
    left for the decode steps.  Returns (k_all, v_all, centres)."""
    centres = torch.randn(tokens // cap, hd, generator=gen, device=dev) * 1.5
    k_all = torch.zeros((1, tokens + extra, kv, hd), dtype=dtype, device=dev)
    v_all = torch.zeros_like(k_all)
    for t0 in range(0, tokens, chunk):
        n = min(chunk, tokens - t0)
        cen = centres[torch.arange(t0, t0 + n, device=dev) // cap]
        noise = torch.randn((n, kv, hd), generator=gen, device=dev)
        k_all[0, t0:t0 + n] = (cen[:, None, :] + 0.15 * noise).to(dtype)
        v_all[0, t0:t0 + n] = torch.randn((n, kv, hd), generator=gen,
                                          device=dev).to(dtype)
    return k_all, v_all, centres


def retrieved_oracle(torch, H, q, idx, cfg, k_all, v_all, q_pos):
    """Exact attention in float64 over the tokens the retrieval keeps (its
    valid pool + the live tail), taken through the plain scan; and the
    share of exact whole-cache softmax mass those tokens hold."""
    b, _, hq, hd = q.shape
    kv = idx.centroids.shape[1]
    gq = hq // kv
    s, t = idx.sealed_len, q_pos + 1
    qh = q[:, 0].to(torch.float32).reshape(b, kv, gq, hd)
    log_c, _, _, tpos = H._retrieve_pool(qh, idx, cfg, scan_backend="ref")
    ok = log_c > H.NEG_INF / 2                             # [B,KV,gq,C]
    tail = torch.arange(s, t, device=q.device)
    toks = torch.cat([tpos, tail.expand(b, kv, gq, -1)], dim=-1)
    keep = torch.cat([ok, torch.ones(b, kv, gq, tail.numel(),
                                     dtype=torch.bool, device=q.device)], -1)
    bi = torch.arange(b, device=q.device)[:, None, None, None]
    ki = torch.arange(kv, device=q.device)[None, :, None, None]
    kk = k_all[bi, toks, ki].double()
    vv = v_all[bi, toks, ki].double()
    lg = torch.einsum("bkgh,bkgth->bkgt", qh.double() * hd ** -0.5, kk)
    lg = torch.where(keep, lg, -torch.inf)
    out = torch.einsum("bkgt,bkgth->bkgh", torch.softmax(lg, -1), vv)
    # exact softmax mass on those tokens (float32, the whole cache)
    sc = torch.einsum("bkgh,btkh->bkgt", qh * hd ** -0.5,
                      k_all[:, :t].to(torch.float32))
    pm = torch.softmax(sc, dim=-1)
    mass = torch.where(keep, torch.gather(pm, -1, toks), 0.0).sum(-1)
    return out.reshape(b, 1, hq, hd), mass


def hntl_kv_phase(torch, dev, *, tokens, steps=8, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.core import tree_bytes
    from repro_torch.kernels import hntl_scan as hs
    from repro_torch.models import hntl_attention as H

    cfg = get_config("phi3-mini-3.8b")
    dt = cfg.compute_dtype
    kv, hq, hd, cap = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim, cfg.kv_cap
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    k_all, v_all, centres = clustered_cache(
        torch, dev, tokens=tokens, extra=steps, kv=kv, hd=hd, cap=cap,
        dtype=dt, gen=gen)
    sync(torch, dev)
    log(f"HNTL-KV: {cfg.name} attention width (Hq={hq} KV={kv} hd={hd}; "
        f"kt={cfg.kv_kt} cap={cap} nprobe={cfg.kv_nprobe} pool="
        f"{cfg.kv_pool} tail={cfg.kv_tail}), B=1, sealed context {tokens} "
        f"tokens ({tokens // cap} grains per KV head), {dt} cache made on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    idx = H.build_kv_index(k_all[:, :tokens], v_all[:, :tokens], cfg,
                           device=dev)
    sync(torch, dev)
    build_s = time.perf_counter() - t0
    raw = tree_bytes(idx.k_raw) + tree_bytes(idx.v_raw)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"HNTL-KV build: {build_s:.2f} s; index bytes {tree_bytes(idx)} "
        f"(raw tier {raw}, grains {tree_bytes(idx) - raw}); peak device "
        f"memory during the build {peak} bytes")

    touched = cfg.kv_nprobe * cap + cfg.kv_pool + cfg.kv_tail
    rows = []
    hs.hntl_scan_single.launches = 0
    for i in range(steps):
        q_pos = tokens + i
        q = (centres[centres.shape[0] // 2] + 0.05 * torch.randn(
            (1, 1, hq, hd), generator=gen, device=dev)).to(dt)
        k_new = torch.randn((1, 1, kv, hd), generator=gen, device=dev).to(dt)
        v_new = torch.randn((1, 1, kv, hd), generator=gen, device=dev).to(dt)
        k_all[:, q_pos] = k_new[:, 0]
        v_all[:, q_pos] = v_new[:, 0]
        pos = torch.full((1,), q_pos, dtype=torch.int64, device=dev)
        before = hs.hntl_scan_single.launches
        sync(torch, dev)
        t0 = time.perf_counter()
        out, new_idx = H.retrieval_decode_attention(q, k_new, v_new, idx,
                                                    pos, cfg)
        sync(torch, dev)
        t_r = time.perf_counter() - t0
        n_launch = hs.hntl_scan_single.launches - before
        t0 = time.perf_counter()
        exact = H.reference_decode_attention(
            q, k_all[:, :q_pos + 1], v_all[:, :q_pos + 1], pos, cfg)
        sync(torch, dev)
        t_e = time.perf_counter() - t0
        plain, _ = H.retrieval_decode_attention(q, k_new, v_new, idx, pos,
                                                cfg, scan_backend="ref")
        check(torch.equal(out, plain), f"HNTL-KV step {i}: the kernel path "
              "differs from the plain scan's")
        oracle, mass = retrieved_oracle(torch, H, q, idx, cfg, k_all, v_all,
                                        q_pos)
        err = float((out.float() - exact.float()).abs().max())
        diff = (out.double() - oracle).abs()
        err_ret = float(diff.max())
        check(bool((diff <= KV_REL_ERR_RETRIEVED * oracle.abs()
                    + KV_ABS_ERR_RETRIEVED).all()),
              f"HNTL-KV step {i}: retrieval differs from exact attention "
              "over its own tokens by more than the bf16 output's rounding")
        check(bool(torch.isfinite(out.float()).all())
              and out.shape == (1, 1, hq, hd), f"HNTL-KV step {i}: bad out")
        rows.append(dict(err=err, err_retrieved=err_ret, retrieval_s=t_r,
                         exact_s=t_e, launches=n_launch,
                         mass=float(mass.mean())))
        log(f"  step {i}: q_pos={q_pos} max|retrieval - exact| {err:.6f}, "
            f"max|retrieval - exact over the retrieved tokens (f64)| "
            f"{err_ret:.6f}, exact softmax mass on them "
            f"{float(mass.mean()):.4f} (min {float(mass.min()):.4f}); "
            f"retrieval {t_r * 1e3:.3f} ms, exact {t_e * 1e3:.3f} ms; "
            f"tokens touched {touched} of {q_pos + 1}; hntl_scan_single "
            f"launches {n_launch}")
        idx = new_idx
    launches = hs.hntl_scan_single.launches
    if on_card:
        check(launches > 0, "HNTL-KV decode never launched "
              "hntl_scan_single")
    check(torch.equal(idx.tail_k[0, :steps], k_all[0, tokens:tokens + steps]),
          "HNTL-KV: the tail does not hold the appended keys")
    worst = max(r["err"] for r in rows)
    worst_ret = max(r["err_retrieved"] for r in rows)
    check(worst <= KV_ERR_WHOLE_CACHE, f"HNTL-KV: retrieval is {worst} from "
          f"exact attention (threshold {KV_ERR_WHOLE_CACHE})")
    mid = sorted(r["retrieval_s"] for r in rows)[steps // 2]
    mid_e = sorted(r["exact_s"] for r in rows)[steps // 2]
    log(f"HNTL-KV decode: {steps} steps, max error {worst:.6f} against "
        f"exact attention (threshold {KV_ERR_WHOLE_CACHE}), {worst_ret:.6f} "
        f"against exact attention over the retrieved tokens (bound 2^-8 "
        f"|x| + {KV_ABS_ERR_RETRIEVED}); median step retrieval "
        f"{mid * 1e3:.3f} ms, "
        f"exact {mid_e * 1e3:.3f} ms; tokens touched {touched} of "
        f"{tokens} ({tokens / touched:.1f}x fewer); hntl_scan_single "
        f"launches {launches}")
    qh = q[:, 0].to(torch.float32).reshape(1, kv, hq // kv, hd)
    _, _, scan_args = H._probe(qh, idx, cfg)
    return dict(launches=launches, rows=rows, scan_args=scan_args, idx=idx,
                cfg=cfg, step=(q, k_new, v_new, pos), build_s=build_s,
                k_all=k_all, v_all=v_all)


# ---------------------------------------------------------------------------
# 9: where a search's device time goes
# ---------------------------------------------------------------------------

def profile(torch, label, fn, wall_s, top=8):
    """torch.profiler (CUPTI) over ``fn``: device time by kernel, and
    device time over the unprofiled wall time ``wall_s`` of the same work
    as the busy share."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    wall_us = wall_s * 1e6
    if not dev_us:
        log(f"profile ({label}): the profiler saw no device time "
            "(not measured)")
        return None
    log(f"profile ({label}): device {dev_us / 1e3:.3f} ms over "
        f"{wall_us / 1e3:.3f} ms of unprofiled wall, busy share "
        f"{dev_us / wall_us:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.self_device_time_total / dev_us:6.1%} x{e.count:<4d} "
            f"{e.key[:90]}")
    return dict(device_ms=dev_us / 1e3, busy=dev_us / wall_us,
                by_kernel={e.key: e.self_device_time_total / 1e3
                           for e in kernels})


def profile_phase(torch, mp, gp, kvp):
    """One Mode A and one Mode B search on the default plane; one Mode B
    search on the "kernel" gather plane; one HNTL-KV decode step."""
    from repro_torch.core import search
    from repro_torch.models import hntl_attention as H

    index, cfg, q = mp["index"], mp["cfg"], mp["q"]
    profile(torch, f"Mode A + Mode B, {q.shape[0]} queries each",
            lambda: [search(index, q, cfg, topk=10, mode=m) for m in "AB"],
            sum(mp["search_s"].values()))
    profile(torch, f"Mode B on the \"kernel\" plane, {q.shape[0]} queries",
            lambda: search(index, q, cfg, topk=10, mode="B",
                           scan_impl="kernel"), gp["search_s"]["B"])
    step = kvp["step"]
    wall = sorted(r["retrieval_s"] for r in kvp["rows"])[len(kvp["rows"]) // 2]
    profile(torch, "one HNTL-KV decode step",
            lambda: H.retrieval_decode_attention(*step[:3], kvp["idx"],
                                                 step[3], kvp["cfg"]), wall)


# ---------------------------------------------------------------------------
# 9b: the mixed-precision cascade on a density index
# ---------------------------------------------------------------------------


def cascade_budgets(nprobe, cap, pool):
    """The cascade phase's budget settings: lossless (b1 = P * cap), the
    README's (4096, 64), and ``benchmarks/cascade.py``'s rule (3/5 of the
    probed slots, b2 = pool)."""
    rule = (nprobe * cap * 3 // 5, pool)
    return {"None": None, "(4096, 64)": (4096, 64), str(rule): rule}


class _CaptureCascade:
    """While installed, the first call of the "cascade" plane's runner
    keeps a copy of its inputs, and the first stage-1 select keeps its
    inputs and output (the survivors ``fs`` stage 2 starts from)."""

    def __init__(self, torch):
        self.torch = torch
        self.runner = self.stage1 = None

    def _copy(self, v):
        return v.clone() if isinstance(v, self.torch.Tensor) else v

    def __enter__(self):
        from repro_torch.core import cascade, scanplane

        self.reg, self.mod = scanplane._REGISTRY, cascade
        self.plane, self.fsel = self.reg["cascade"], cascade.fused_scan_select

        def runner(*args, **kw):
            if self.runner is None:
                self.runner = ([self._copy(a) for a in args],
                               {k: self._copy(v) for k, v in kw.items()})
            return self.plane.runner(*args, **kw)

        def stage1(*args, **kw):
            out = self.fsel(*args, **kw)
            if self.stage1 is None:
                self.stage1 = ([self._copy(a) for a in args],
                               {k: self._copy(v) for k, v in kw.items()},
                               [self._copy(t) for t in out])
            return out

        self.reg["cascade"] = dataclasses.replace(self.plane, runner=runner)
        cascade.fused_scan_select = stage1
        return self

    def __exit__(self, *exc):
        self.reg["cascade"] = self.plane
        self.mod.fused_scan_select = self.fsel


def tie_aware_equal(torch, got, want, wide, label, *, pool=None):
    """``got`` equals ``want`` (two searches of the same queries) except
    where candidates tie exactly in approximate distance, which the two
    order differently.  ``wide``: ``want``'s plane in Mode A with one
    candidate more than compared (11 for a top 10, or ``pool`` + 1 in Mode
    B).  Mode A (``pool`` None): dists ``torch.equal``; an id may differ
    only where its distance occurs twice among the query's ``wide``
    candidates.  Mode B: a query whose pool ends in a tie (its
    ``pool``-th and next candidate at one distance) may re-rank other
    candidates; every other query equals ``want`` bit for bit.  Returns
    the number of positions (Mode A) or queries (Mode B) a tie excused."""
    wd = wide.dists
    if pool is None:
        check(torch.equal(got.dists, want.dists), f"{label}: dists differ")
        diff = got.ids != want.ids
        hits = (got.dists[:, :, None] == wd[:, None, :]).sum(-1)   # [Q, k]
        check(not bool((diff & (hits < 2)).any()), f"{label}: ids differ "
              f"where no tie falls ({int((diff & (hits < 2)).sum())} "
              "entries)")
        return int(diff.sum())
    tie = wd[:, pool - 1] == wd[:, pool]                             # [Q]
    same = torch.logical_and(torch.all(got.ids == want.ids, dim=1),
                             torch.all(got.dists == want.dists, dim=1))
    check(bool((same | tie).all()), f"{label}: {int((~same & ~tie).sum())} "
          "queries differ without a tie at their pool's end")
    return int((~same).sum())


def time_select_call(torch, fsel, args, kw, width, label,
                     what="  stage 1, "):
    """One select call captured from a search (a cascade's stage 1, a
    coalesced tenant window's batch): held to its plain version, then
    CUPTI, CUDA events, the plain version's time and the bound."""
    err = hold(torch, fsel, args, kw, width, label)
    run = lambda: fsel.fused_scan_select(*args, width=width, **kw)  # noqa
    for _ in range(3):
        run()
    events_ms = time_events(torch, run, 10)
    ms, parts, traces = device_ms(torch, run, select_kernels(width), reps=10)
    fsel.fused_scan_select_ref(*args, width=width, **kw)
    plain_ms = time_events(torch, lambda: fsel.fused_scan_select_ref(
        *args, width=width, **kw), 3)
    bound_ms, bound_by, nbytes, ops = select_bound(torch, args, kw, width)
    q_n, p_n, k = args[1].shape
    at = (f"Q={q_n} P={p_n} G={args[4].shape[0]} k={k} "
          f"cap={args[4].shape[2]} s={kw['sq'].shape[2]} width={width}")
    log(f"{what}fused_scan_select at {label} ({at}): {ms:.4f} ms per "
        "call (CUPTI: " + ", ".join(f"{SELECT_PARTS[k]} {v:.4f}"
                                    for k, v in parts.items())
        + f"; CUDA events {events_ms:.4f} ms), plain version "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes} bytes, {ops} int ops); CUPTI traces {traces}")
    return dict(ms=ms, events_ms=events_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, traces=traces,
                max_abs_err=err,
                parts={SELECT_PARTS[k]: v for k, v in parts.items()}, at=at)


def cascade_phase(torch, np, mp, dev):
    """The mixed-precision cascade at the paper's width: a density index
    (``bit_alloc="density"``: per-grain int4/int8 coordinates) over the
    main path's corpus, 1024 queries in Mode A and B through
    ``planner.search(scan_impl="cascade")`` at three budget settings (the
    select's counter zeroed just before each search, read just after),
    each held to "cascade_ref" (ids, and dists ``torch.equal``: stage 1 is
    bit for bit); at ``budgets=None`` also to "fused" (equal but for exact
    ties, counted); recall@10 against ``flat_search``; search times;
    every stage-1 call shape held to its plain version and timed (CUPTI,
    events, plain, bound), stage 2 timed alone; a profile; peak memory;
    the coordinate bytes at rest from ``layout.pack_coords_blob``."""
    from repro_torch.core import (HNTLConfig, build, int32_safe_qmax, layout,
                                  planner, quantize)
    from repro_torch.core import cascade
    from repro_torch.core.flat import flat_search, recall_at_k
    from repro_torch.kernels import fused_select as fsel

    x, qt, n = mp["x"], mp["q"], mp["x"].shape[0]
    nq = qt.shape[0]
    cfg = dataclasses.replace(mp["cfg"], bit_alloc="density")
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    sync(torch, dev)
    t0 = time.perf_counter()
    index, info = build(x, cfg, device=dev)
    sync(torch, dev)
    build_s = time.perf_counter() - t0
    g = index.grains
    qm = g.qmaxg.cpu().numpy()
    n4, n8 = int((qm == quantize.INT4_QMAX).sum()), int(
        (qm == quantize.INT8_QMAX).sum())
    blob, _, widths = layout.pack_coords_blob(g.coords, g.qmaxg)
    fixed_blob, _, _ = layout.pack_coords_blob(g.coords, None)
    main_blob, _, _ = layout.pack_coords_blob(mp["index"].grains.coords, None)
    bpv = {"density": blob.size / n, "same panels at int16":
           fixed_blob.size / n, "fixed index (main path)": main_blob.size / n}
    log(f"cascade: density index over the main path's corpus (n={n}, "
        f"d=768, k=32, s=8, G={cfg.n_grains}, cap={info.cap}), build "
        f"{build_s:.2f} s; {n4} grains int4, {n8} int8; coordinate bytes "
        "per vector at rest (layout.pack_coords_blob): " + ", ".join(
            f"{k} {v:.2f}" for k, v in bpv.items())
        + " (density / fixed index "
        f"{bpv['density'] / bpv['fixed index (main path)']:.4f})")
    del fixed_blob, main_blob, blob

    kw0 = dict(nprobe=cfg.nprobe, pool=cfg.pool, topk=10,
               envelope_frac=cfg.envelope_frac,
               qeff=int32_safe_qmax(cfg.k, cfg.coord_bits))
    truth = flat_search(index.raw, qt, topk=10).ids
    settings = cascade_budgets(cfg.nprobe, g.cap, cfg.pool)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out = dict(build_s=build_s, bytes_per_vector=bpv, int4=n4, int8=n8,
               settings={}, launches=0)
    fused = {m: planner.search(index, qt, mode=m, scan_impl="fused", **kw0)
             for m in "AB"}
    for name, budgets in settings.items():
        row = dict(budgets=budgets, launches={}, recall={}, ms={})
        for m in "AB":
            kw = dict(kw0, mode=m, budgets=budgets)
            fsel.fused_scan_select.launches = 0
            got = planner.search(index, qt, scan_impl="cascade", **kw)
            sync(torch, dev)
            row["launches"][m] = fsel.fused_scan_select.launches
            out["launches"] += row["launches"][m]
            if dev.type == "cuda":
                check(row["launches"][m] == -(-nq // planner.QUERY_BATCH),
                      f"cascade {name} Mode {m}: fused_scan_select launched "
                      f"{row['launches'][m]} times")
            ref = planner.search(index, qt, scan_impl="cascade_ref", **kw)
            check(torch.equal(got.ids, ref.ids) and torch.equal(
                got.dists, ref.dists), f"cascade {name} Mode {m}: differs "
                  f"from cascade_ref ({int((got.ids != ref.ids).sum())} ids)")
            check(got.ids.shape == (nq, 10)
                  and bool(torch.isfinite(got.dists).all())
                  and bool((got.ids[:, 0] >= 0).all()),
                  f"cascade {name} Mode {m}: bad result")
            row["recall"][m] = recall_at_k(got.ids, truth)
            if budgets is None:
                wide = planner.search(
                    index, qt, scan_impl="fused",
                    **dict(kw0, mode="A", topk=11 if m == "A"
                           else cfg.pool + 1,
                           pool=cfg.pool + (m == "B")))
                row[f"ties {m}"] = tie_aware_equal(
                    torch, got, fused[m], wide,
                    f"cascade {name} Mode {m} vs fused",
                    pool=None if m == "A" else cfg.pool)
            planner.search(index, qt, scan_impl="cascade", **kw)
            sync(torch, dev)
            t0 = time.perf_counter()
            for _ in range(2):
                planner.search(index, qt, scan_impl="cascade", **kw)
            sync(torch, dev)
            row["ms"][m] = (time.perf_counter() - t0) / 2 * 1e3
        log(f"cascade budgets={name}: == cascade_ref (ids, dists "
            f"torch.equal), Mode A and B"
            + (f"; == fused except exact ties (Mode A: {row['ties A']} "
               f"positions, Mode B: {row['ties B']} queries)"
               if budgets is None else "")
            + f"; fused_scan_select launches {row['launches']}; recall@10 "
            f"vs flat_search: Mode A {row['recall']['A']:.4f}, Mode B "
            f"{row['recall']['B']:.4f}; Mode A {row['ms']['A']:.3f} ms (QPS "
            f"{nq / row['ms']['A'] * 1e3:.1f}), Mode B {row['ms']['B']:.3f} "
            f"ms (QPS {nq / row['ms']['B'] * 1e3:.1f}) per {nq} queries "
            "(host clock, ends in a synchronise)")
        out["settings"][name] = row
    fused_ms = {}
    for m in "AB":
        t0 = time.perf_counter()
        for _ in range(2):
            planner.search(index, qt, mode=m, scan_impl="fused", **kw0)
        sync(torch, dev)
        fused_ms[m] = (time.perf_counter() - t0) / 2 * 1e3
    out["fused"] = dict(ms=fused_ms, recall={
        m: recall_at_k(fused[m].ids, truth) for m in "AB"})
    log(f"fused plane on the same density index: recall@10 Mode A "
        f"{out['fused']['recall']['A']:.4f}, Mode B "
        f"{out['fused']['recall']['B']:.4f}; Mode A {fused_ms['A']:.3f} ms, "
        f"Mode B {fused_ms['B']:.3f} ms per {nq} queries")
    if dev.type == "cuda":
        out["peak"] = torch.cuda.max_memory_allocated(dev) - base
        log(f"cascade peak device memory {out['peak']} bytes above the "
            f"{base} held when the phase began (max_memory_allocated; the "
            "density index included)")

    # every stage-1 call shape: held to its plain version and timed; stage
    # 2 alone on the captured survivors
    out["stage1"], out["stage2"] = {}, {}
    for name, budgets in settings.items():
        with _CaptureCascade(torch) as cap:
            planner.search(index, qt[:planner.QUERY_BATCH], mode="A",
                           scan_impl="cascade", budgets=budgets,
                           **dict(kw0, topk=10))
        args, kw, (_, fs) = cap.stage1
        kw = dict(kw)
        width = kw.pop("width")
        if dev.type != "cuda":
            out["stage1"][name] = dict(max_abs_err=hold(
                torch, fsel, args, kw, width, f"stage 1 at {name}"))
            continue
        out["stage1"][name] = time_select_call(torch, fsel, args, kw,
                                               width,
                                          f"budgets={name}")
        rargs, rkw = cap.runner
        rkw = dict(rkw)
        w, b = rkw.pop("width"), rkw.pop("budgets", None)
        b2 = w if b is None else max(1, min(b[1], w, fs.shape[1]))
        gids, zq, rq, keep, coords, res, mask, rows, scale, res_scale = rargs

        def stage2(fs=fs, rkw=rkw, w=w, b2=b2):
            return cascade._stage2_select(
                fs, gids, zq, rq, coords, res, rows, scale, res_scale,
                rkw.get("sq"), rkw.get("sketch"), rkw.get("sketch_scale"),
                width=w, b2=b2)

        stage2()
        s2_ms, _, _ = device_ms(torch, stage2, (), reps=5)
        whole_ms, _, _ = device_ms(
            torch, lambda: cap.plane.runner(*rargs, width=w, budgets=b,
                                            **rkw), (), reps=5)
        out["stage2"][name] = dict(ms=s2_ms, select_ms=whole_ms)
        log(f"  stage 2 at budgets={name} (b1={fs.shape[1]}, b2={b2}, one "
            f"{args[1].shape[0]}-query batch): {s2_ms:.4f} ms device time "
            f"(CUPTI), of {whole_ms:.4f} ms for the whole cascade select "
            "(stage 1, its inputs and stage 2)")
        del cap, args, kw, fs, rargs, rkw
    if dev.type == "cuda":
        wall = out["settings"]["None"]["ms"]["A"] / 1e3
        out["profile"] = profile(
            torch, f"one cascade search, Mode A, budgets=None, {nq} queries",
            lambda: planner.search(index, qt, mode="A", scan_impl="cascade",
                                   **kw0), wall, top=10)
    del index
    return out


# ---------------------------------------------------------------------------
# 9c: the select past its 8,192-key per-probe list, at the search level
# ---------------------------------------------------------------------------

#: A density index of this many of the main path's rows in grains of
#: this many rows on average (16 grains at full size; fewer in a short
#: run) holds grains of more than 8,192 rows (cap > SMEM_WIDTH); the
#: fused plane's pool there.
LONG_INDEX_ROWS = 262_144
LONG_GRAIN_ROWS = 16_384
LONG_POOL = 10_000


def long_list_phase(torch, np, mp, dev):
    """The select past its per-probe list of 8,192 keys in a search: a
    density index over the first 262,144 rows of the main path's corpus
    in 16 grains (cap above ``SMEM_WIDTH``), 256 queries through
    ``planner.search`` with ``scan_impl="cascade"`` at ``budgets=None``
    (stage 1 at b1 = P * cap, Mode A and B) and with "fused" at pool
    10,000 (Mode A), each equal to "cascade_ref" / "fused_ref" (ids and
    dists, ``torch.equal``), the select's counter zeroed just before each
    search and read just after; each search's select held to its plain
    version and timed (CUPTI, events, plain, bound); peak memory."""
    from repro_torch.core import build, int32_safe_qmax, planner
    from repro_torch.kernels import fused_select as fsel

    x = mp["x"][:LONG_INDEX_ROWS]
    qt = mp["q"][:planner.QUERY_BATCH]
    cfg = dataclasses.replace(mp["cfg"], bit_alloc="density",
                              n_grains=max(2, len(x) // LONG_GRAIN_ROWS))
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    sync(torch, dev)
    t0 = time.perf_counter()
    index, info = build(x, cfg, device=dev)
    sync(torch, dev)
    build_s = time.perf_counter() - t0
    cap = index.grains.cap
    check(cap > fsel.SMEM_WIDTH, f"long lists: cap {cap} is not above "
          f"{fsel.SMEM_WIDTH}")
    sizes = index.routing.sizes.cpu().numpy()
    log(f"long lists: density index over {len(x)} rows of the main path's "
        f"corpus, G={cfg.n_grains}, cap={cap} (grains of {int(sizes.min())}"
        f"..{int(sizes.max())} rows), build {build_s:.2f} s")
    kw0 = dict(nprobe=cfg.nprobe, topk=10, envelope_frac=cfg.envelope_frac,
               qeff=int32_safe_qmax(cfg.k, cfg.coord_bits))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = {"cascade, budgets=None": ("cascade", "cascade_ref", cfg.pool,
                                      "AB"),
            f"fused, pool={LONG_POOL}": ("fused", "fused_ref", LONG_POOL,
                                         "A")}
    out = dict(cap=cap, build_s=build_s, launches=0, searches={})
    for name, (impl, ref_impl, pool, modes) in runs.items():
        for m in modes:
            kw = dict(kw0, pool=pool, mode=m)
            fsel.fused_scan_select.launches = 0
            got = planner.search(index, qt, scan_impl=impl, **kw)
            sync(torch, dev)
            n = fsel.fused_scan_select.launches
            out["launches"] += n
            if dev.type == "cuda":
                check(n == 1, f"long lists, {name} Mode {m}: "
                      f"fused_scan_select launched {n} times")
            want = planner.search(index, qt, scan_impl=ref_impl, **kw)
            check(torch.equal(got.ids, want.ids)
                  and torch.equal(got.dists, want.dists),
                  f"long lists, {name} Mode {m}: differs from {ref_impl} "
                  f"({int((got.ids != want.ids).sum())} ids)")
            check(got.ids.shape == (qt.shape[0], 10)
                  and bool(torch.isfinite(got.dists).all())
                  and bool((got.ids[:, 0] >= 0).all()),
                  f"long lists, {name} Mode {m}: bad result")
            out["searches"][f"{name} Mode {m}"] = n
    if dev.type == "cuda":
        out["peak"] = torch.cuda.max_memory_allocated(dev) - base
    log(f"long lists: {', '.join(out['searches'])} == "
        "cascade_ref / fused_ref (ids and dists, torch.equal), one "
        "fused_scan_select launch each; peak device memory "
        f"{out.get('peak', 'not measured')} bytes above the {base} held "
        "when the phase began (the index included)")

    # each search's select: captured, held to its plain version, timed
    with _CaptureCascade(torch) as cc:
        planner.search(index, qt, mode="A", scan_impl="cascade",
                       **dict(kw0, pool=cfg.pool))
    with _CaptureSelect(torch) as cs:
        planner.search(index, qt, mode="A", scan_impl="fused",
                       **dict(kw0, pool=LONG_POOL))
    calls = {"cascade stage 1, budgets=None": cc.stage1[:2],
             f"fused plane, pool={LONG_POOL}": cs.calls[0]}
    del cc, cs
    out["timing"] = {}
    for label, (args, kw) in calls.items():
        kw = dict(kw)
        width = kw.pop("width")
        if dev.type != "cuda":
            out["timing"][label] = dict(max_abs_err=hold(
                torch, fsel, args, kw, width, label))
            continue
        out["timing"][label] = time_select_call(
            torch, fsel, args, kw, width,
            f"{label}, per-probe lists of {min(width, cap)} keys")
    del index, calls
    return out


# ---------------------------------------------------------------------------
# 10: the vector store (VectorStore add/seal/delete/upsert/search)
# ---------------------------------------------------------------------------

def hold_store_result(torch, res, kw, label, *, xl, dead_t, tg, tsv, qt):
    """A store search's result: shape, finite, no deleted gid, Mode B
    dists the live vectors' exact distances (rtol 1e-5: a superseded
    version fails it), the filters obeyed."""
    ids, d = res.ids, res.dists
    check(ids.shape == (qt.shape[0], 10) and bool(torch.isfinite(d).all()),
          f"{label}: bad result shape or non-finite dists")
    check(not bool(torch.isin(ids.long(), dead_t).any()),
          f"{label}: a deleted gid was returned")
    ok = ids >= 0
    check(bool(ok[:, 0].all()), f"{label}: a query found nothing")
    at = torch.clamp(ids, min=0).long()
    if kw["mode"] == "B":
        exact = (xl[at] - qt[:, None, :]).square_().sum(-1)
        check(torch.allclose(d[ok], exact[ok], rtol=1e-5, atol=0.0),
              f"{label}: dists are not the live vectors' exact distances")
    if "tag_mask" in kw:
        check(bool((tg[at] & kw["tag_mask"])[ok].all()),
              f"{label}: a row outside tag_mask")
    if "ts_range" in kw:
        lo, hi = kw["ts_range"]
        check(bool(((tsv[at] >= lo) & (tsv[at] < hi))[ok].all()),
              f"{label}: a row outside ts_range")


#: The store phase's searches: the unfiltered modes, then Mode B under a
#: tag filter and a timestamp filter.
STORE_SEARCHES = {"A": dict(mode="A"), "B": dict(mode="B"),
                  "B tag_mask=0b0101": dict(mode="B", tag_mask=0b0101),
                  "B ts_range=(0.25, 0.75)": dict(mode="B",
                                                  ts_range=(0.25, 0.75))}


def store_phase(torch, np, dev, *, n=1_004_096, segments=8, nq=1024,
                grains=128):
    """The store's read and mutation path at the main path's widths: all
    but a tail of 4096 rows (fewer for a short run) added in ``segments``
    chunks that each seal (one segment of ``grains`` grains per chunk), the
    tail left in the memtable; 1% of the
    sealed gids deleted and ~0.1% upserted with jittered copies; 1024
    queries in Mode A, Mode B and Mode B under a tag and a timestamp
    filter through ``VectorStore.search`` on the default plane.  Held to
    the "fused_ref" plane's ids, to the live vectors' exact distances
    and, on 256 queries, the "kernel" plane to the "ref" plane."""
    from repro_torch.core import HNTLConfig, VectorStore, planner
    from repro_torch.core import store as store_mod
    from repro_torch.core.flat import flat_search, recall_at_k
    from repro_torch.data import synthetic
    from repro_torch.kernels import fused_select as fsel
    from repro_torch.kernels import hntl_scan as hs

    on_card = dev.type == "cuda"
    tail = min(4096, n // segments // 4)
    sealed = n - tail
    per_seg = sealed // segments
    t0 = time.perf_counter()
    x = synthetic.anisotropic_manifold(n=n, d=768, intrinsic=24, seed=0)
    q = synthetic.queries_from(x, nq=nq)
    row = np.arange(n)
    tags = (1 << (row % 4)).astype(np.uint32)
    ts = (row / n).astype(np.float32)
    log(f"store data: anisotropic_manifold n={n} d=768 intrinsic=24 seed=0, "
        f"{nq} queries, {time.perf_counter() - t0:.2f} s on the host")
    cfg = HNTLConfig(d=768, k=32, s=8, block=128, n_grains=grains,
                     nprobe=16, pool=64)
    if on_card:
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    st = VectorStore(cfg, seal_threshold=per_seg, device=dev)
    seal_s = []
    for lo in range(0, segments * per_seg, per_seg):
        sync(torch, dev)
        t0 = time.perf_counter()
        st.add(x[lo:lo + per_seg], tags=tags[lo:lo + per_seg],
               ts=ts[lo:lo + per_seg])
        sync(torch, dev)
        seal_s.append(time.perf_counter() - t0)
    st.add(x[segments * per_seg:], tags=tags[segments * per_seg:],
           ts=ts[segments * per_seg:])
    check(st.n_segments == segments, f"store: {st.n_segments} segments, "
          f"expected {segments}")
    rng = np.random.default_rng(1)
    n_del, n_up = segments * per_seg // 100, segments * per_seg // 976
    pick = rng.choice(segments * per_seg, n_del + n_up, replace=False)
    dead, up = pick[:n_del], pick[n_del:]
    x_up = x[up] + 0.01 * rng.standard_normal((n_up, 768)).astype(
        np.float32)
    check(st.delete(dead) == n_del, "store: delete count")
    st.upsert(up, x_up, tags=tags[up], ts=ts[up])
    mem_rows = len(st.snapshot().mem)
    n_live = st.n_live()
    check(n_live == n - n_del, f"store: n_live {n_live} != {n - n_del}")
    log(f"store: {segments} segments of {per_seg} rows, G={grains} each "
        f"(cap {[s.index.grains.cap for s in st._segments]}); seal seconds "
        f"sum {sum(seal_s):.2f}, largest {max(seal_s):.2f} "
        f"({' '.join(f'{v:.2f}' for v in seal_s)}); memtable {mem_rows} "
        f"rows; deleted {n_del}, upserted {n_up}; n_live {n_live} of "
        f"{st.n_vectors} physical rows")

    qt = torch.from_numpy(q).to(dev)
    # ---- the store's path: counters zeroed just before, read just after --
    real_stack, stack_s = store_mod.stack_segments, []

    def timed_stack(segs):
        sync(torch, dev)
        t = time.perf_counter()
        out = real_stack(segs)
        sync(torch, dev)
        stack_s.append(time.perf_counter() - t)
        return out

    store_mod.stack_segments = timed_stack
    fsel.fused_scan_select.launches = 0
    hs.hntl_scan_single.launches = 0
    res, per_search = {}, {}
    try:
        for label, kw in STORE_SEARCHES.items():
            before = fsel.fused_scan_select.launches
            res[label] = st.search(qt, topk=10, **kw)
            sync(torch, dev)
            per_search[label] = fsel.fused_scan_select.launches - before
    finally:
        store_mod.stack_segments = real_stack
    launches = fsel.fused_scan_select.launches
    log(f"store path launches: fused_scan_select {per_search} (total "
        f"{launches}); first search's stack {stack_s[0]:.3f} s")
    if on_card:
        want = -(-nq // 256)
        check(all(v == want for v in per_search.values()),
              f"store: fused_scan_select launches per search {per_search}, "
              f"expected {want} each (one per 256-query batch)")

    # ---- held against the plain plane, the live vectors and brute force --
    xl = torch.from_numpy(x).to(dev)
    xl[torch.from_numpy(up).to(dev)] = torch.from_numpy(x_up).to(dev)
    dead_t = torch.from_numpy(dead).to(dev)
    tg = torch.from_numpy(tags.astype(np.int64)).to(dev)
    tsv = torch.from_numpy(ts).to(dev)
    for label, kw in STORE_SEARCHES.items():
        ref = st.search(qt, topk=10, scan_impl="fused_ref", **kw)
        ids = res[label].ids
        check(torch.equal(ids, ref.ids), f"store {label}: ids differ from "
              f"the fused_ref plane ({int((ids != ref.ids).sum())} entries)")
        hold_store_result(torch, res[label], kw, f"store {label}", xl=xl,
                          dead_t=dead_t, tg=tg, tsv=tsv, qt=qt)
    alive = np.ones(n, bool)
    alive[dead] = False
    alive_t = torch.from_numpy(np.nonzero(alive)[0]).to(dev)
    truth = alive_t[flat_search(xl[alive_t], qt, topk=10).ids.long()]
    recall = {m: recall_at_k(res[m].ids, truth) for m in "AB"}
    check(recall["B"] >= recall["A"], "store: Mode B recall below Mode A's")
    log(f"store == fused_ref plane (ids, 4 searches); no deleted gid; Mode B "
        f"dists == the live vectors' exact distances (rtol 1e-5); recall@10 "
        f"vs flat_search over the {n_live} live rows: Mode A "
        f"{recall['A']:.4f}, Mode B {recall['B']:.4f}")
    cascade = store_cascade(torch, st, qt, xl, dead_t, tg, tsv, truth,
                            "store cascade")
    del xl

    timing = {}
    for label, kw in STORE_SEARCHES.items():
        st.search(qt, topk=10, **kw)
        sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(3):
            st.search(qt, topk=10, **kw)
        sync(torch, dev)
        timing[label] = (time.perf_counter() - t0) / 3
        log(f"store search {label}: {timing[label] * 1e3:.3f} ms for {nq} "
            f"queries, QPS {nq / timing[label]:.1f} (host clock, ends in a "
            "synchronise)")

    # the same searches with the memtable left out of the manifest: the
    # split of a search's time between the sealed plane and the memtable
    sealed_only = dataclasses.replace(st.snapshot(), mem_n=0)
    for m in "AB":
        st.search(qt, topk=10, mode=m, manifest=sealed_only)
        sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(3):
            st.search(qt, topk=10, mode=m, manifest=sealed_only)
        sync(torch, dev)
        timing[f"{m} sealed only"] = (time.perf_counter() - t0) / 3
        log(f"store search {m}, sealed segments only (memtable left out of "
            f"the manifest): {timing[f'{m} sealed only'] * 1e3:.3f} ms for "
            f"{nq} queries")

    out = dict(launches=launches, per_search=per_search, recall=recall,
               search_s=timing, seal_s=seal_s, stack_s=stack_s[0],
               n_live=n_live, mem_rows=mem_rows, cascade=cascade)
    if on_card:
        entry = st._stacked_for(tuple(st._segments))
        plane = st._live_plane(entry, st.snapshot(), time.time())
        extra, grain_ok = planner._mixed_recall_mask(
            plane.index.grains, None, None, live=plane.live)
        out["select"] = time_select(torch, plane.index, qt[:256], cfg,
                                    "the store's shape", grain_mask=grain_ok,
                                    extra_mask=extra)
        del entry, plane, extra, grain_ok
        out["profile"] = profile(
            torch, f"store search Mode A + Mode B, {nq} queries each",
            lambda: [st.search(qt, topk=10, mode=m) for m in "AB"],
            timing["A"] + timing["B"])
        out["profile_sealed"] = profile(
            torch, "store search Mode A + Mode B, sealed segments only",
            lambda: [st.search(qt, topk=10, mode=m, manifest=sealed_only)
                     for m in "AB"],
            timing["A sealed only"] + timing["B sealed only"])

    # ---- the "kernel" gather plane through the store ----------------------
    q256 = qt[:256]
    hs.hntl_scan_single.launches = 0
    got = st.search(q256, topk=10, mode="B", scan_impl="kernel")
    sync(torch, dev)
    out["kernel_launches"] = hs.hntl_scan_single.launches
    want = st.search(q256, topk=10, mode="B", scan_impl="ref")
    check(torch.equal(got.ids, want.ids), "store: the kernel plane's ids "
          f"differ from the ref plane's ({int((got.ids != want.ids).sum())} "
          "entries)")
    if on_card:
        check(out["kernel_launches"] > 0, "store: the kernel plane never "
              "launched hntl_scan_single")
        peak = torch.cuda.max_memory_allocated(dev)
        out["peak"], out["base"] = peak, base
        log(f"store peak device memory (max_memory_allocated) {peak} bytes, "
            f"{peak - base} above the {base} bytes held when the phase "
            "began")
    log(f"store \"kernel\" plane == \"ref\" plane (ids, {q256.shape[0]} "
        f"queries, Mode B); hntl_scan_single launches "
        f"{out['kernel_launches']}")
    # the tenancy phase's base: the store as it stands (its 5,120-row
    # memtable), before the half-memtable rows
    out["branch"] = st.branch()
    out["half"] = half_memtable(torch, np, st, qt, x, tags, ts, dead_t,
                                per_seg, rng)
    # what the lifecycle phase goes on with: the store and the live vectors
    out["state"] = dict(st=st, qt=qt, x=x, tags=tags, ts=ts, up=up,
                        x_up=x_up, dead=dead, cfg=cfg, recall=recall,
                        truth=truth)
    return out


#: The README's budget setting, used on the stores.
STORE_CASCADE_BUDGETS = (4096, 64)


def store_cascade(torch, st, qt, xl, dead, tg, tsv, truth, label):
    """The cascade on a store at ``STORE_CASCADE_BUDGETS``: the store
    phase's searches (counter zeroed just before each, read just after),
    each equal to "cascade_ref" (ids and dists, ``torch.equal``), free of
    deleted gids, the filters obeyed, Mode B dists the live vectors'
    exact distances (rtol 1e-5); recall@10 and times."""
    from repro_torch.core.flat import recall_at_k
    from repro_torch.kernels import fused_select as fsel

    dev, nq = qt.device, qt.shape[0]
    b = STORE_CASCADE_BUDGETS
    per, res = {}, {}
    for name, kw in STORE_SEARCHES.items():
        fsel.fused_scan_select.launches = 0
        got = st.search(qt, topk=10, scan_impl="cascade", budgets=b, **kw)
        sync(torch, dev)
        per[name] = fsel.fused_scan_select.launches
        ref = st.search(qt, topk=10, scan_impl="cascade_ref", budgets=b,
                        **kw)
        ids, d = got.ids, got.dists
        check(torch.equal(ids, ref.ids) and torch.equal(d, ref.dists),
              f"{label} {name}: differs from cascade_ref "
              f"({int((ids != ref.ids).sum())} ids)")
        check(ids.shape == (nq, 10) and bool(torch.isfinite(d).all())
              and bool((ids[:, 0] >= 0).all()), f"{label} {name}: bad result")
        check(not bool(torch.isin(ids.long(), dead).any()),
              f"{label} {name}: a deleted gid was returned")
        ok = ids >= 0
        at = torch.clamp(ids, min=0).long()
        if kw["mode"] == "B":
            exact = (xl[at] - qt[:, None, :]).square_().sum(-1)
            check(torch.allclose(d[ok], exact[ok], rtol=1e-5, atol=0.0),
                  f"{label} {name}: dists are not the live vectors' exact "
                  "distances")
        if "tag_mask" in kw:
            check(bool((tg[at] & kw["tag_mask"])[ok].all()),
                  f"{label} {name}: a row outside tag_mask")
        if "ts_range" in kw:
            lo, hi = kw["ts_range"]
            check(bool(((tsv[at] >= lo) & (tsv[at] < hi))[ok].all()),
                  f"{label} {name}: a row outside ts_range")
        res[name] = got
    if dev.type == "cuda":
        check(all(v > 0 for v in per.values()),
              f"{label}: a cascade search launched no select ({per})")
    recall = {m: recall_at_k(res[m].ids, truth) for m in "AB"}
    ms = {}
    for m in "AB":
        t0 = time.perf_counter()
        for _ in range(2):
            st.search(qt, topk=10, mode=m, scan_impl="cascade", budgets=b)
        sync(torch, dev)
        ms[m] = (time.perf_counter() - t0) / 2 * 1e3
    log(f"{label}: scan_impl=\"cascade\", budgets={b}: == cascade_ref "
        f"(ids, dists torch.equal, {len(per)} searches); no deleted gid; "
        f"filters obeyed; Mode B dists == the live vectors' exact distances "
        f"(rtol 1e-5); fused_scan_select launches {per}; recall@10 Mode A "
        f"{recall['A']:.4f}, Mode B {recall['B']:.4f}; Mode A "
        f"{ms['A']:.3f} ms, Mode B {ms['B']:.3f} ms per {nq} queries (host "
        "clock, ends in a synchronise)")
    return dict(launches=sum(per.values()), per_search=per, recall=recall,
                ms=ms)


def half_memtable(torch, np, st, qt, x, tags, ts, dead_t, per_seg, rng):
    """The store's searches at a memtable of half the seal threshold (the
    average fill under steady ingest): jittered copies of sealed rows added
    under new gids until the memtable holds ``per_seg // 2`` rows.  Mode B
    held to the "fused_ref" plane's ids; times and a profile of Mode A + B.
    """
    from repro_torch.kernels import fused_select as fsel

    dev, nq, n_seg = qt.device, qt.shape[0], st.n_segments
    fill = per_seg // 2 - len(st.snapshot().mem)
    x_new = x[:fill] + 0.01 * rng.standard_normal(
        (fill, x.shape[1])).astype(np.float32)
    new_ids = st.add(x_new, tags=tags[:fill], ts=ts[:fill])
    mem_rows = len(st.snapshot().mem)
    check(mem_rows == per_seg // 2 and st.n_segments == n_seg,
          f"store half memtable: {mem_rows} rows in {st.n_segments} "
          "segments")
    res, launches = {}, {}
    for m in "AB":
        before = fsel.fused_scan_select.launches
        res[m] = st.search(qt, topk=10, mode=m)
        sync(torch, dev)
        launches[m] = fsel.fused_scan_select.launches - before
        ids = res[m].ids
        check(ids.shape == (nq, 10) and bool(torch.isfinite(
            res[m].dists).all()) and bool((ids[:, 0] >= 0).all()),
            f"store half memtable {m}: bad result")
        check(not bool(torch.isin(ids.long(), dead_t).any()),
              f"store half memtable {m}: a deleted gid was returned")
        check(dev.type != "cuda" or launches[m] == -(-nq // 256),
              f"store half memtable {m}: {launches[m]} fused_scan_select "
              "launches")
    ref = st.search(qt, topk=10, mode="B", scan_impl="fused_ref")
    check(torch.equal(res["B"].ids, ref.ids), "store half memtable: ids "
          "differ from the fused_ref plane "
          f"({int((res['B'].ids != ref.ids).sum())} entries)")
    timing = {}
    for m in "AB":
        t0 = time.perf_counter()
        for _ in range(3):
            st.search(qt, topk=10, mode=m)
        sync(torch, dev)
        timing[m] = (time.perf_counter() - t0) / 3
        log(f"store search {m} at a memtable of {mem_rows} rows (half the "
            f"seal threshold): {timing[m] * 1e3:.3f} ms for {nq} queries, "
            f"QPS {nq / timing[m]:.1f} (host clock, ends in a synchronise); "
            f"fused_scan_select launches {launches[m]}")
    log(f"store half memtable: Mode B ids == fused_ref plane; no deleted "
        f"gid")
    out = dict(mem_rows=mem_rows, search_s=timing, launches=launches,
               new_ids=new_ids, x_new=x_new)
    if dev.type == "cuda":
        out["profile"] = profile(
            torch, f"store search Mode A + Mode B at a memtable of "
            f"{mem_rows} rows, {nq} queries each",
            lambda: [st.search(qt, topk=10, mode=m) for m in "AB"],
            timing["A"] + timing["B"])
        out["peak"] = torch.cuda.max_memory_allocated(dev)
        log(f"store peak device memory after the half-memtable searches "
            f"(max_memory_allocated) {out['peak']} bytes")
    return out


# ---------------------------------------------------------------------------
# 10b: multi-tenant serving (serve.tenancy) on a branch of the store
# ---------------------------------------------------------------------------

#: The tenancy phase's registry and traffic: tenants of 1,536 private docs
#: each (1,024 force-sealed at the memtable budget, 512 left in the
#: memtable), an LRU of 24 live tenants, and windows of 32 requests per
#: tenant in three groups (Mode A, Mode B, Mode B under a tag filter).
TENANTS = 32
TENANT_DOCS = 1536
TENANT_BUDGET = 1024
TENANT_MAX_LIVE = 24
TENANT_REQUESTS = 32
TENANT_GROUPS = (dict(mode="A"), dict(mode="B"),
                 dict(mode="B", tag_mask=0b0101))
#: The windows after the default one: the cascade at the README's
#: budgets, and adaptive routing at ``benchmarks/routing_adaptive.py``'s
#: margin.
TENANT_VARIANTS = {"cascade": dict(scan_impl="cascade", budgets=(4096, 64)),
                   "adaptive": dict(adaptive=True, probe_margin=0.35)}
#: Coalesced ids may differ from a solo search's only where the solo's
#: candidates tie this closely at a routing or pool boundary.
TIE_RTOL = 1e-5


def tenant_center(np, t, d):
    """``benchmarks/serve_load.py``'s ``_tenant_center``: a point unique to
    tenant t, 200 along axis t (the corpus rows have norm ~35)."""
    v = np.zeros(d, np.float32)
    v[t % d] = 200.0 * (1 + t // d)
    return v


class _Tenants:
    """The registry's tenants as a brute-force view: each tenant's private
    docs, its deletes (shared and own) and its upserts of shared gids, on
    the device, to price any (query, gid) against the tenant's own
    version of the row."""

    def __init__(self, torch, np, reg, xb, base_dead, corpus_q, *, tenants,
                 docs, seed=2):
        dev = xb.device
        self.torch, self.xb, self.docs = torch, xb, docs
        self.names = [f"tenant{t:02d}" for t in range(tenants)]
        self.n0 = reg.base._next_id
        d = xb.shape[1]
        rng = np.random.default_rng(seed)
        taken = np.zeros(xb.shape[0], bool)
        taken[list(reg.base._live_seq)] = True    # the base's own mutations
        free = np.flatnonzero(~taken[:self.n0])
        pick = rng.choice(free, tenants * (64 + 32), replace=False)
        self.priv, self.priv_h, self.dead, self.up, self.up_vec = \
            [], [], [], [], []
        self.shared_dead = []
        budget = reg.memtable_budget
        for t, name in enumerate(self.names):
            st = reg.get(name)
            # corpus rows moved to the tenant's far point: the corpus's
            # shape, so the tenant's grains fit its docs as well
            rows = torch.from_numpy(rng.choice(self.n0, docs)).to(dev)
            priv = tenant_center(np, t, d)[None] + xb[rows].cpu().numpy()
            ptags = (1 << (np.arange(docs) % 4)).astype(np.uint32)
            pts = rng.random(docs).astype(np.float32)
            ids = np.concatenate([st.add(priv[lo:lo + budget],
                                         tags=ptags[lo:lo + budget],
                                         ts=pts[lo:lo + budget])
                                  for lo in range(0, docs, budget)])
            check(ids[0] == self.n0 and len(st.snapshot().mem)
                  == docs % budget, f"tenancy: {name}'s private writes")
            mine = pick[t * 96:(t + 1) * 96]
            shared, up = mine[:64], mine[64:]
            own = np.r_[ids[:8], ids[budget:budget + 8]]
            check(st.delete(np.r_[shared, own]) == 80,
                  f"tenancy: {name}'s delete count")
            x_up = (xb[torch.from_numpy(up).to(dev)].cpu().numpy()
                    + 0.01 * rng.standard_normal((32, d))).astype(
                        np.float32)
            st.upsert(up, x_up)
            self.priv.append(torch.from_numpy(priv).to(dev))
            self.priv_h.append(priv)
            self.shared_dead.append(shared)
            self.dead.append(torch.from_numpy(
                np.r_[base_dead, shared, own]).to(dev))
            order = np.argsort(up)
            self.up.append(torch.from_numpy(up[order]).to(dev))
            self.up_vec.append(torch.from_numpy(x_up[order]).to(dev))
        self.corpus_q = corpus_q
        self.rng = rng
        # the shared-row probes' queries (own deletes, another tenant's
        # deletes, the old versions of its upserts), on the host
        self.probe_q = [xb[torch.from_numpy(np.r_[
            self.shared_dead[t][:2], self.shared_dead[(t + 1) % tenants][2:4],
            self.up[t][:2].cpu().numpy()]).to(dev)].cpu().numpy()
            for t in range(tenants)]

    def window(self, np, requests):
        """A window of ``requests`` per tenant, tenant-interleaved: the
        first half jittered copies of the tenant's live private docs, the
        second half from the corpus, of which the Mode B slots (j % 3 ==
        1) probe, in pairs: rows the tenant deleted, rows another tenant
        deleted (still visible here) and the old versions of rows it
        upserted.  Returns (requests, per-request facts)."""
        from repro_torch.serve import RetrievalRequest

        rng, docs, n_t = self.rng, self.docs, len(self.names)
        reqs, facts = [], []
        probes = [j for j in range(requests // 2, requests) if j % 3 == 1]
        for j in range(requests):
            for t, name in enumerate(self.names):
                kw = TENANT_GROUPS[j % 3]
                fact = {"tenant": t, "kind": "corpus"}
                if j < requests // 2:
                    i = int(rng.integers(8, docs - 8))
                    i += 8 * (i >= TENANT_BUDGET)     # skip the own deletes
                    q = self.priv_h[t][i] + 0.01 * rng.standard_normal(
                        self.priv_h[t].shape[1]).astype(np.float32)
                    fact = {"tenant": t, "kind": "private",
                            "gid": self.n0 + i}
                elif j in probes[:6]:
                    k = probes.index(j)
                    if k < 2:
                        g = int(self.shared_dead[t][k])
                    elif k < 4:
                        g = int(self.shared_dead[(t + 1) % n_t][k])
                    else:
                        g = int(self.up[t][k - 4])
                    q = self.probe_q[t][k]
                    fact = {"tenant": t, "gid": g, "kind": (
                        "own delete", "other's delete", "old version")[k // 2]}
                else:
                    q = self.corpus_q[(t * requests + j) % len(
                        self.corpus_q)]
                reqs.append(RetrievalRequest(
                    rid=len(reqs), tenant=name, q=np.asarray(q, np.float32),
                    topk=10, mode=kw["mode"], tag_mask=kw.get("tag_mask")))
                facts.append(fact)
        return reqs, facts

    def exact(self, t, ids, q):
        """Exact distances [R, k] from queries q [R, d] to the tenant's own
        version of each gid in ids [R, k] (its upsert, its private doc or
        the shared row)."""
        torch = self.torch
        safe = ids.long().clamp(min=0)
        base = self.xb[safe.clamp(max=self.n0 - 1)]
        priv = self.priv[t][(safe - self.n0).clamp(0, self.docs - 1)]
        v = torch.where((safe < self.n0)[..., None], base, priv)
        up = self.up[t]
        pos = torch.searchsorted(up, safe).clamp(max=up.numel() - 1)
        hit = up[pos] == safe
        v = torch.where(hit[..., None], self.up_vec[t][pos], v)
        return (v - q[:, None, :]).square_().sum(-1)


def check_tenant_window(torch, np, tv, reqs, facts, label):
    """The isolation checks of one window: no gid a tenant deleted; Mode B
    dists equal to the tenant's own version of each row (rtol 1e-5: a row
    of another tenant under the same gid, or a superseded version, fails
    it); Mode A rows of a private-doc query within 20,000 of the query
    (another tenant's docs lie ~80,000 away, the corpus ~40,000) and no
    private gid for a corpus query.  Returns the counts (cross-tenant,
    deleted, superseded), which must be zero, and the shares of Mode B
    queries whose aimed-at row came first: a private doc (at least 0.8:
    a tenant's private grains are few and near), a shared row another
    tenant deleted, and the new version for a query at the old one
    (``check_shared_rows`` checks their visibility; whether the search
    finds them is the ANN's recall)."""
    dev = tv.xb.device
    counts = {"cross-tenant": 0, "deleted": 0, "superseded": 0}
    aimed = collections.defaultdict(lambda: [0, 0])
    for t in range(len(tv.names)):
        rows = [i for i, f in enumerate(facts) if f["tenant"] == t]
        ids = torch.stack([reqs[i].result.ids for i in rows]).long()
        d = torch.stack([reqs[i].result.dists for i in rows])
        q = torch.from_numpy(np.stack([reqs[i].q for i in rows])).to(dev)
        ok = ids >= 0
        counts["deleted"] += int((torch.isin(ids, tv.dead[t]) & ok).sum())
        exact = tv.exact(t, ids, q)
        mode_b = torch.tensor([reqs[i].mode == "B" for i in rows],
                              device=dev)[:, None]
        bad = ok & mode_b & ~torch.isclose(d, exact, rtol=1e-5, atol=1e-6)
        private = ids >= tv.n0
        counts["superseded"] += int((bad & torch.isin(ids, tv.up[t])).sum())
        counts["cross-tenant"] += int((bad & ~torch.isin(ids, tv.up[t]))
                                      .sum())
        kind = [facts[i]["kind"] for i in rows]
        near = torch.tensor([k == "private" for k in kind],
                            device=dev)[:, None]
        counts["cross-tenant"] += int((ok & ~mode_b & near & (d >= 2e4))
                                      .sum())
        counts["cross-tenant"] += int((ok & ~near & private).sum())
        for r, i in enumerate(rows):
            f = facts[i]
            if reqs[i].mode == "B" and reqs[i].tag_mask is None \
                    and f["kind"] in ("private", "other's delete",
                                      "old version"):
                aimed[f["kind"]][0] += int(ids[r, 0]) == f["gid"]
                aimed[f["kind"]][1] += 1
    check(all(v == 0 for v in counts.values()), f"{label}: {counts}")
    first = {k: v[0] / max(v[1], 1) for k, v in aimed.items()}
    check(first.get("private", 1.0) >= 0.8, f"{label}: the aimed-at private "
          f"doc came first in {aimed['private']} Mode B queries")
    return dict(counts, first=first)


def check_shared_rows(np, reg, tv, now, label):
    """The tenant bitmaps of the union plane at the shared rows the
    tenants deleted and upserted: a row is hidden from the tenant that
    deleted it (or upserted its gid: the old version) and visible to the
    next tenant, which did neither.  Returns the rows checked."""
    union = reg.union_segments()
    entry = reg.base._plane_entry_for(union)
    ids = np.asarray(entry["ids_host"]).reshape(-1)
    slot_of = np.full(entry["row_gid"].shape[0], -1, np.int64)
    slot_of[ids[ids >= 0]] = np.flatnonzero(ids >= 0)
    shared_end = entry["offsets"][reg.base.n_segments]
    gid_of = entry["row_gid"][:shared_end]
    n_t = len(tv.names)
    checked = 0
    for t in range(n_t):
        u = (t + 1) % n_t
        bm_t, bm_u = (reg._tenant_bitmap(
            entry, union, reg.get(tv.names[i]).snapshot(), now).reshape(-1)
            for i in (t, u))
        gids = np.r_[tv.shared_dead[t], tv.up[t].cpu().numpy()]
        rows = np.flatnonzero(np.isin(gid_of, gids))
        slots = slot_of[rows]
        check(len(rows) == len(gids) and (slots >= 0).all()
              and not bm_t[slots].any() and bm_u[slots].all(),
              f"{label}: a shared row {tv.names[t]} deleted or upserted is "
              f"visible to it, or hidden from {tv.names[u]}")
        checked += len(rows)
    return checked


def solo_parity(torch, np, reg, tv, reqs, cfg, label, now):
    """Each coalesced request against its tenant's own ``search`` of the
    same query with the same knobs (the tenants' planes stacked one at a
    time, dropped after).

    On the card a row's float bits may change with the batch's shape
    (the projection's GEMVs, routing's GEMM over another grain count), and
    a quantized query coordinate then flips by one step now and then, so
    a Mode A (approximate) distance moves by up to some delta, measured
    here as the largest |coalesced - solo| Mode A distance over the
    requests whose ids agree.  Ids must be equal, except where the solo's
    routing distances at nprobe lie within ``TIE_RTOL`` of each other,
    or its approximate candidate distances at the pool's end (Mode B) or
    within its top 10 and the next (Mode A) lie within ``TIE_RTOL`` plus
    2 delta; fewer than 1% of the requests may be excused.  Mode B dists
    (the exact re-rank) of agreeing requests to rtol/atol 1e-5.  Returns
    (requests compared, excused, excused at ``TIE_RTOL`` alone, max
    |dist diff| in Mode A and B)."""
    from repro_torch.core import planner, routing

    worst, differing = {"A": 0.0, "B": 0.0}, []
    for t, name in enumerate(tv.names):
        st = reg.get(name)
        rows = [i for i, r in enumerate(reqs) if r.tenant == name]
        for kw in TENANT_GROUPS:
            sel = [i for i in rows if reqs[i].mode == kw["mode"]
                   and reqs[i].tag_mask == kw.get("tag_mask")]
            q = np.stack([reqs[i].q for i in sel])
            solo = st.search(q, topk=10, now=now, **kw)
            got_i = torch.stack([reqs[i].result.ids for i in sel])
            got_d = torch.stack([reqs[i].result.dists for i in sel])
            same = torch.all(got_i == solo.ids, dim=1)
            m = kw["mode"]
            if bool(same.any()):
                want = solo.dists[same]
                diff = (got_d[same] - want).abs()
                worst[m] = max(worst[m], float(diff.max()))
                check(m == "A" or bool(torch.allclose(
                    got_d[same], want, rtol=1e-5, atol=1e-5)),
                      f"{label}: {name}'s Mode B dists differ from its "
                      f"solo search by {float(diff.max())}")
            for r in torch.nonzero(~same).flatten().tolist():
                # the solo's routing and candidate distances at the
                # boundaries, while its plane is cached
                qr = torch.from_numpy(q[r:r + 1]).to(tv.xb.device)
                man = st.snapshot()
                plane = st._live_plane(st._stacked_for(man.segments), man,
                                       now)
                _, gok = planner._mixed_recall_mask(
                    plane.index.grains, kw.get("tag_mask"), None,
                    live=plane.live)
                _, d2 = routing.route(plane.index.routing, qr,
                                      cfg.nprobe + 1, grain_mask=gok)
                wide = st.search(q[r:r + 1], topk=cfg.pool + 1, mode="A",
                                 pool=cfg.pool + 1, now=now,
                                 tag_mask=kw.get("tag_mask")).dists[0]
                differing.append((name, sel[r], m, d2[0].tolist(),
                                  wide.tolist(), got_i[r].tolist(),
                                  solo.ids[r].tolist()))
        st._stack_cache.clear()           # one solo plane at a time
        st._probe_traffic.clear()

    def tie(a, b, slack):
        return abs(a - b) <= TIE_RTOL * max(abs(a), abs(b)) + slack

    excused = strict = 0
    for name, rid, m, d2, wd, got, want in differing:
        at = [cfg.pool - 1] if m == "B" else range(10)
        route = tie(d2[cfg.nprobe - 1], d2[cfg.nprobe], 0.0)
        check(route or any(tie(wd[i], wd[i + 1], 2 * worst["A"])
                           for i in at),
              f"{label}: {name}'s request {rid} (Mode {m}) differs from "
              f"its solo search without a tie ({got} vs {want})")
        strict += route or any(tie(wd[i], wd[i + 1], 0.0) for i in at)
        excused += 1
    check(excused < 0.01 * len(reqs), f"{label}: {excused} of {len(reqs)} "
          "requests excused by ties (1% allowed)")
    return len(reqs), excused, strict, worst


def replay_window(reg, reqs, now, **kw):
    """The same requests again, as new ones, through
    ``coalesced_retrieve`` with ``kw``."""
    from repro_torch.serve import RetrievalRequest, coalesced_retrieve

    again = [RetrievalRequest(rid=r.rid, tenant=r.tenant, q=r.q,
                              topk=r.topk, mode=r.mode, tag_mask=r.tag_mask)
             for r in reqs]
    return coalesced_retrieve(reg, again, now=now, **kw)


def same_results(torch, a, b, label):
    """Two windows' results equal request by request (``torch.equal``)."""
    bad = sum(not (torch.equal(x.result.ids, y.result.ids)
                   and torch.equal(x.result.dists, y.result.dists))
              for x, y in zip(a, b))
    check(bad == 0, f"{label}: {bad} requests differ")


def launches_by_group(reqs):
    """Select launches one window needs: per (mode, topk, filter) group,
    ceil(padded rows / 256)."""
    from repro_torch.serve import tenancy

    groups = collections.Counter((r.mode, r.topk, r.tag_mask, r.ts_range)
                                 for r in reqs)
    return {g: -(-tenancy.pad_rows(n) // 256) for g, n in groups.items()}


def tenancy_phase(torch, np, dev, branch, *, xb, base_dead, corpus_q, cfg,
                  tenants=TENANTS, docs=TENANT_DOCS,
                  requests=TENANT_REQUESTS):
    """Multi-tenant serving on a branch of the store phase's store (its
    memtable tail sealed by the registry): ``TenantRegistry(branch,
    memtable_budget=1024, max_live=24)`` with ``tenants`` tenants, each
    writing ``docs`` private docs around its own far point, deleting 64
    shared gids and 16 of its own and upserting 32 shared gids; windows
    of ``requests`` requests per tenant through ``coalesced_retrieve``:
    a warm-up, then the default window (counters zeroed just before,
    read just after) held for isolation, to "fused_ref" (``torch.equal``)
    and to each tenant's solo search; zero re-stacks and the select's
    launches by group; the same window on the cascade and with adaptive
    routing; times, a breakdown of the host's share, a profile and the
    select with its tenant stream against its plain version and bound.
    ``xb``: the base rows as the branch sees them, on the device."""
    from repro_torch.core import store as store_mod
    from repro_torch.core.types import tree_bytes
    from repro_torch.kernels import fused_select as fsel
    from repro_torch.serve import TenantRegistry, coalesced_retrieve
    from repro_torch.serve import tenancy

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    now = time.time()
    if on_card:
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    sync(torch, dev)
    t0 = time.perf_counter()
    reg = TenantRegistry(branch, memtable_budget=TENANT_BUDGET,
                         max_live=TENANT_MAX_LIVE)
    tv = _Tenants(torch, np, reg, xb, base_dead, corpus_q, tenants=tenants,
                  docs=docs)
    sync(torch, dev)
    setup_s = time.perf_counter() - t0
    log(f"tenancy: TenantRegistry(branch of the store, memtable_budget="
        f"{TENANT_BUDGET}, max_live={TENANT_MAX_LIVE}), {tenants} tenants "
        f"of {docs} private docs (a forced seal each, {docs % TENANT_BUDGET}"
        f" left in the memtable), 64 shared and 16 own deletes and 32 "
        f"shared upserts each; {setup_s:.2f} s; {reg.n_live} live, "
        f"{tenants - reg.n_live} frozen")

    def run(**kw):
        reqs, facts = tv.window(np, requests)
        coalesced_retrieve(reg, reqs, now=now, **kw)
        return reqs, facts

    warm, _ = run()                       # the union plane, the bitmaps
    sync(torch, dev)
    union = reg.union_segments()
    entry = branch._plane_entry_for(union)
    plane = entry["plane"]
    g_n, cap = plane.index.grains.ids.shape
    n_req = tenants * requests
    log(f"tenancy union plane: {len(union)} segments ({branch.n_segments} "
        f"shared, the rest private), {g_n} grains x cap {cap}, "
        f"{tree_bytes(plane.index)} bytes on the device; tenant bitmap "
        f"{tenants} x {g_n} x {cap} = {tenants * g_n * cap} bytes per group;"
        f" {reg.n_live} live tenants, their memtables now "
        f"{sum(len(s._mem) for s in reg._live.values())} rows (every "
        "tenant was frozen once, which sealed its memtable)")

    # ---- the default window: counters zeroed just before, read after ----
    stacks = []
    real_stack = store_mod.stack_segments
    store_mod.stack_segments = lambda *a, **k: stacks.append(1) or \
        real_stack(*a, **k)
    fsel.fused_scan_select.launches = 0
    try:
        reqs, facts = run()
        sync(torch, dev)
    finally:
        store_mod.stack_segments = real_stack
    launches = fsel.fused_scan_select.launches
    want = launches_by_group(reqs)
    check(not stacks, f"tenancy: {len(stacks)} re-stacks after warm-up")
    if on_card:
        check(launches == sum(want.values()), f"tenancy: {launches} select "
              f"launches, expected {sum(want.values())} ({want})")
    counts = check_tenant_window(torch, np, tv, reqs, facts, "tenancy fused")
    shared = check_shared_rows(np, reg, tv, now, "tenancy")
    same_results(torch, reqs, replay_window(reg, reqs, now,
                                            scan_impl="fused_ref"),
                 "tenancy: coalesced fused vs fused_ref")
    n_cmp, excused, strict, worst = solo_parity(torch, np, reg, tv, reqs,
                                                cfg, "tenancy solo", now)
    log(f"tenancy window ({n_req} requests, {tenants} tenants, 3 groups): "
        f"{counts}; {shared} shared rows hidden from the tenant that "
        f"deleted or upserted them and visible to the next (its bitmap); "
        f"== fused_ref (ids, dists torch.equal); vs solo: "
        f"{n_cmp} compared, {excused} excused by ties ({strict} within "
        f"rtol {TIE_RTOL} alone), max |dist diff| by mode {worst}; "
        f"re-stacks 0; fused_scan_select launches {launches} (by group "
        f"{list(want.values())})")
    out = dict(launches=launches, counts=counts, excused=excused,
               excused_strict=strict,
               solo_max_diff=worst, union_grains=g_n, cap=cap,
               bitmap_bytes=tenants * g_n * cap, setup_s=setup_s)

    # ---- the cascade and adaptive windows --------------------------------
    out["variants"] = {}
    for name, kw in TENANT_VARIANTS.items():
        saved = traffic_copy(branch)
        fsel.fused_scan_select.launches = 0
        got, facts_v = run(**kw)
        sync(torch, dev)
        n_l = fsel.fused_scan_select.launches
        after = traffic_copy(branch)
        branch._probe_traffic = saved
        plain = {"cascade": dict(kw, scan_impl="cascade_ref")}.get(
            name, dict(kw, scan_impl="fused_ref"))
        same_results(torch, got, replay_window(reg, got, now, **plain),
                     f"tenancy {name} vs {plain['scan_impl']}")
        branch._probe_traffic = after
        c = check_tenant_window(torch, np, tv, got, facts_v, f"tenancy {name}")
        if on_card:
            check(n_l >= sum(launches_by_group(got).values()),
                  f"tenancy {name}: {n_l} select launches")
        out["variants"][name] = dict(launches=n_l, counts=c)
        log(f"tenancy {name} window ({kw}): {c}; == {plain['scan_impl']} "
            f"(torch.equal); fused_scan_select launches {n_l}")

    # ---- the default window over the 4-shard mesh ------------------------
    out["sharded"] = sharded_window(torch, np, dev, reg, tv, reqs, facts,
                                    want, now)
    drop_sharded(branch)

    # ---- times: uninstrumented windows, then the host's share ------------
    ms = []
    for _ in range(3):
        reqs_t, _ = tv.window(np, requests)
        sync(torch, dev)
        t0 = time.perf_counter()
        coalesced_retrieve(reg, reqs_t, now=now)
        sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    out["window_ms"] = ms
    log(f"tenancy window: {' '.join(f'{v:.3f}' for v in ms)} ms per "
        f"{n_req} requests (host clock, ends in a synchronise); QPS "
        f"{n_req / (min(ms) / 1e3):.1f} at the fastest")
    reqs_t, _ = tv.window(np, requests)
    with _Timed(torch, dev, tenancy.TenantRegistry, "_tenant_bitmap") as bm, \
            _Timed(torch, dev, store_mod, "_to_device") as h2d, \
            _Timed(torch, dev, store_mod.VectorStore,
                   "_search_memtable") as mem, \
            _Timed(torch, dev, tenancy, "_finalize") as fin:
        sync(torch, dev)
        t0 = time.perf_counter()
        coalesced_retrieve(reg, reqs_t, now=now)
        sync(torch, dev)
        wall = (time.perf_counter() - t0) * 1e3
    mans = [reg.get(n).snapshot() for n in tv.names]
    t0 = time.perf_counter()
    np.stack([reg._tenant_bitmap(entry, union, m, now) for m in mans])
    stack_s = time.perf_counter() - t0
    parts = {"tenant bitmaps (cached)": sum(bm.calls),
             "stack of one group's bitmaps": stack_s,
             "H2D (pinned copies)": sum(h2d.calls),
             "memtable scans": sum(mem.calls), "finalize": sum(fin.calls)}
    out["host_ms"] = {k: v * 1e3 for k, v in parts.items()}
    log(f"tenancy window, instrumented (each part synchronised): {wall:.3f}"
        f" ms; " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                             parts.items())
        + f" ({len(bm.calls)} bitmap lookups, {len(h2d.calls)} copies, "
        f"{len(mem.calls)} memtable scans, {len(fin.calls)} finalizes; the "
        "stack of one group's bitmaps timed apart, once); re-stacks 0")
    if on_card:
        out["profile"] = profile(
            torch, f"one coalesced window, {n_req} requests",
            lambda: coalesced_retrieve(reg, tv.window(np, requests)[0],
                                       now=now), min(ms) / 1e3)
        with _CaptureSelect(torch) as cap_sel:
            coalesced_retrieve(reg, tv.window(np, requests)[0], now=now)
            sync(torch, dev)
        args, kw = cap_sel.calls[0]
        kw = dict(kw)
        width = kw.pop("width")
        out["select"] = time_select_call(
            torch, fsel, args, kw, width, "the coalesced tenant window "
            "(the first group's first batch, tenant stream on)", what="")
        del cap_sel
    if on_card:
        out["peak"] = torch.cuda.max_memory_allocated(dev) - held
        log(f"tenancy peak device memory {out['peak']} bytes above the "
            f"{held} held when the phase began (max_memory_allocated)")
    log(f"tenancy phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def sharded_window(torch, np, dev, reg, tv, reqs, facts, want, now):
    """The tenancy phase's default window again over a 4-shard mesh (the
    union plane sharded, every tenant bitmap placed along the grain
    axis): select launches 4 x the single plane's per group (counter
    zeroed just before, read just after), ``torch.equal`` to the same
    mesh's "fused_ref", the isolation checks; against the single-device
    window the requests whose ids agree are counted, and the Mode B ones
    whose sharded distances are no farther at any rank (per-shard knobs
    probe more grains in all, so ids need not agree); the window's time.
    """
    from repro_torch.kernels import fused_select as fsel

    mesh = sharded_mesh(torch, 4)
    sync(torch, dev)
    t0 = time.perf_counter()
    replay_window(reg, reqs, now, mesh=mesh)    # sharded union + bitmaps
    sync(torch, dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    fsel.fused_scan_select.launches = 0
    got = replay_window(reg, reqs, now, mesh=mesh)
    sync(torch, dev)
    launches = fsel.fused_scan_select.launches
    if dev.type == "cuda":
        check(launches == 4 * sum(want.values()), f"tenancy sharded: "
              f"{launches} select launches, expected 4 x {want}")
    same_results(torch, got, replay_window(reg, reqs, now, mesh=mesh,
                                           scan_impl="fused_ref"),
                 "tenancy sharded: coalesced fused vs fused_ref")
    counts = check_tenant_window(torch, np, tv, got, facts,
                                 "tenancy sharded")
    equal = sum(bool(torch.equal(a.result.ids, b.result.ids))
                for a, b in zip(got, reqs))
    mode_b = [(a, b) for a, b in zip(got, reqs) if b.mode == "B"]
    no_farther = sum(bool((a.result.dists <= b.result.dists * (1 + 1e-5)
                           + 1e-5).all()) for a, b in mode_b)
    t0 = time.perf_counter()
    replay_window(reg, reqs, now, mesh=mesh)
    sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    log(f"tenancy window over 4 shards ({len(reqs)} requests): {counts}; "
        f"== fused_ref on the mesh (torch.equal); select launches "
        f"{launches}; ids equal to the single-device window's in {equal} "
        f"of {len(reqs)} requests, Mode B no farther at any rank in "
        f"{no_farther} of {len(mode_b)}; {ms:.3f} ms per window (the first,"
        f" which shards the union and builds the bitmaps, {first_ms:.3f} "
        "ms)")
    return dict(launches=launches, counts=counts, equal=equal,
                no_farther=no_farther, mode_b=len(mode_b), ms=ms,
                first_ms=first_ms)


def paged_tenancy(torch, np, st, xb, qt, budget, dead, label, *, tenants=8,
                  docs=TENANT_DOCS, requests=32):
    """Tenancy on the paged plane: a registry over a branch of the cold
    store, ``tenants`` tenants as in ``tenancy_phase``, one window of
    ``requests`` requests each all-warm and then under ``budget`` (twice:
    the second on the elected hot set); every paged result equal to the
    all-warm one (ids and dists, ``torch.equal``), isolation held."""
    from repro_torch.kernels import fused_select as fsel
    from repro_torch.serve import TenantRegistry

    dev = qt.device
    t_phase = time.perf_counter()
    now = time.time()
    branch = st.branch()
    branch.device_budget = None
    reg = TenantRegistry(branch, memtable_budget=TENANT_BUDGET,
                         max_live=TENANT_MAX_LIVE)
    tv = _Tenants(torch, np, reg, xb, dead, qt.cpu().numpy(),
                  tenants=tenants, docs=docs, seed=4)
    reqs, facts = tv.window(np, requests)

    warm = replay_window(reg, reqs, now)
    sync(torch, dev)
    counts = check_tenant_window(torch, np, tv, warm, facts, f"{label} warm")
    check_shared_rows(np, reg, tv, now, label)
    branch.device_budget = budget
    fsel.fused_scan_select.launches = 0
    for rnd in range(2):
        same_results(torch, replay_window(reg, reqs, now), warm,
                     f"{label}: round {rnd} against the all-warm window")
    launches = fsel.fused_scan_select.launches
    stats = branch.residency_stats()
    check(dev.type != "cuda" or launches > 0, f"{label}: no select launch")
    log(f"{label}: {tenants} tenants, {len(reqs)} requests, union "
        f"{len(reg.union_segments())} segments ({stats['n_grains']} grains, "
        f"{stats['hot_grains']} hot at budget {budget}): paged == all-warm "
        f"(ids, dists torch.equal, 2 rounds); isolation {counts}; "
        f"fused_scan_select launches {launches} (paged, 2 rounds); "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, counts=counts, stats=stats)


# ---------------------------------------------------------------------------
# 11: the store's lifecycle (VectorStore.compact / grain_health / maintain)
# ---------------------------------------------------------------------------

#: The lifecycle phase's searches: the unfiltered modes and Mode B under a
#: tag filter.
LIFECYCLE_SEARCHES = {k: STORE_SEARCHES[k]
                      for k in ("A", "B", "B tag_mask=0b0101")}

#: maintain()'s drift threshold in the lifecycle phase.  On this corpus a
#: grain spans ~24 latent dimensions of similar variance, so deleting the
#: rows on one side of its mean moves the live mean by far less than the
#: default 0.25 of the survivors' variance; the phase prints the ratio it
#: reaches and repairs at this threshold.
LIFECYCLE_DRIFT_RATIO = 0.01


class _Timed:
    """Wall time of every call of ``module.name`` (a function of a module
    or a method of a class) while installed (the device synchronised
    before and after each call)."""

    def __init__(self, torch, dev, module, name):
        self.torch, self.dev, self.module, self.name = torch, dev, module, name
        self.real = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kw):
        sync(self.torch, self.dev)
        t0 = time.perf_counter()
        out = self.real(*args, **kw)
        sync(self.torch, self.dev)
        self.calls.append(time.perf_counter() - t0)
        return out

    def __get__(self, obj, objtype=None):
        """Installed on a class, it times a method: bound to ``obj``."""
        return self if obj is None else functools.partial(self, obj)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def lifecycle_searches(torch, np, st, qt, xl, alive, tg, label):
    """The lifecycle phase's searches on the store as it stands: 1024
    queries in Mode A, Mode B and Mode B under a tag filter (the select's
    counter zeroed just before, read just after; stacks timed), each held
    to the "fused_ref" plane's ids, free of dead gids, Mode B dists equal
    to the live vectors' exact distances (rtol 1e-5), the tag filter obeyed
    (``tg``: the tag of every gid); recall@10 against
    exact search over the live rows; ms and QPS per mode; a profile of
    Mode A + B on the card."""
    from repro_torch.core import store as store_mod
    from repro_torch.core.flat import flat_search, recall_at_k
    from repro_torch.kernels import fused_select as fsel

    dev, nq = qt.device, qt.shape[0]
    on_card = dev.type == "cuda"
    mem_rows = len(st.snapshot().mem)
    res, per_search = {}, {}
    with _Timed(torch, dev, store_mod, "stack_segments") as stacks:
        fsel.fused_scan_select.launches = 0
        for name, kw in LIFECYCLE_SEARCHES.items():
            before = fsel.fused_scan_select.launches
            res[name] = st.search(qt, topk=10, **kw)
            sync(torch, dev)
            per_search[name] = fsel.fused_scan_select.launches - before
        launches = fsel.fused_scan_select.launches
    if on_card:
        want = -(-nq // 256)
        check(all(v == want for v in per_search.values()),
              f"{label}: fused_scan_select launches per search "
              f"{per_search}, expected {want} each")
    dead = torch.nonzero(~alive).flatten()
    for name, kw in LIFECYCLE_SEARCHES.items():
        ref = st.search(qt, topk=10, scan_impl="fused_ref", **kw)
        ids, d = res[name].ids, res[name].dists
        check(torch.equal(ids, ref.ids), f"{label} {name}: ids differ from "
              f"the fused_ref plane ({int((ids != ref.ids).sum())} entries)")
        check(ids.shape == (nq, 10) and bool(torch.isfinite(d).all())
              and bool((ids[:, 0] >= 0).all()),
              f"{label} {name}: bad result")
        check(not bool(torch.isin(ids.long(), dead).any()),
              f"{label} {name}: a deleted gid was returned")
        if kw["mode"] == "B":
            ok = ids >= 0
            exact = (xl[torch.clamp(ids, min=0).long()]
                     - qt[:, None, :]).square_().sum(-1)
            check(torch.allclose(d[ok], exact[ok], rtol=1e-5, atol=0.0),
                  f"{label} {name}: dists are not the live vectors' exact "
                  "distances")
        if "tag_mask" in kw:
            check(bool((tg[torch.clamp(ids, min=0).long()] & kw["tag_mask"])
                       [ids >= 0].all()), f"{label} {name}: a row outside "
                  "tag_mask")
    live = torch.nonzero(alive).flatten()
    truth = live[flat_search(xl[live], qt, topk=10).ids.long()]
    recall = {m: recall_at_k(res[m].ids, truth) for m in "AB"}
    timing = {}
    for m in "AB":
        t0 = time.perf_counter()
        for _ in range(3):
            st.search(qt, topk=10, mode=m)
        sync(torch, dev)
        timing[m] = (time.perf_counter() - t0) / 3
    log(f"{label}: {st.n_segments} segments, G "
        f"{[s.index.grains.n_grains for s in st._segments]}, cap "
        f"{[s.index.grains.cap for s in st._segments]}; ids == fused_ref "
        f"plane ({len(res)} searches); no deleted gid; Mode B dists == the "
        f"live vectors' exact distances (rtol 1e-5); fused_scan_select "
        f"launches {per_search}; first search's stack "
        f"{stacks.calls[0] if stacks.calls else 0.0:.3f} s "
        f"({len(stacks.calls)} stacks); recall@10 vs flat_search over "
        f"{int(alive.sum())} live rows: Mode A {recall['A']:.4f}, Mode B "
        f"{recall['B']:.4f}; memtable {mem_rows} rows: Mode A "
        f"{timing['A'] * 1e3:.3f} ms (QPS {nq / timing['A']:.1f}), Mode B "
        f"{timing['B'] * 1e3:.3f} ms (QPS {nq / timing['B']:.1f}) per {nq} "
        "queries (host clock, ends in a synchronise)")
    # the sealed plane's share: the same searches without the memtable
    sealed_only = dataclasses.replace(st.snapshot(), mem_n=0)
    for m in "AB":
        t0 = time.perf_counter()
        for _ in range(3):
            st.search(qt, topk=10, mode=m, manifest=sealed_only)
        sync(torch, dev)
        timing[f"{m} sealed only"] = (time.perf_counter() - t0) / 3
    log(f"{label}, sealed segments only (memtable left out of the "
        f"manifest): Mode A {timing['A sealed only'] * 1e3:.3f} ms, Mode B "
        f"{timing['B sealed only'] * 1e3:.3f} ms per {nq} queries")
    out = dict(launches=launches, per_search=per_search, recall=recall,
               search_s=timing, stacks=stacks.calls, mem_rows=mem_rows)
    if on_card:
        out["profile"] = profile(
            torch, f"{label}: store search Mode A + Mode B, {nq} queries "
            "each", lambda: [st.search(qt, topk=10, mode=m) for m in "AB"],
            timing["A"] + timing["B"])
        out["profile_sealed"] = profile(
            torch, f"{label}: store search Mode A + Mode B, sealed segments "
            "only", lambda: [st.search(qt, topk=10, mode=m,
                                       manifest=sealed_only) for m in "AB"],
            timing["A sealed only"] + timing["B sealed only"])
    return out


def design_repairs(torch, np, seg, rng, per=8):
    """Gids to delete in one merged segment so that maintain() has each
    repair to make: every live row of ``per`` grains (retire), 90% of the
    rows of ``per`` others (underfull: merge), and for ``per`` more the
    rows on the negative side of the grain's mean along its first basis
    vector (drift: refit).  Grains are drawn from those of at least 64
    rows.  Returns ({kind: grain indices}, gids to delete)."""
    g = seg.index.grains
    ids = g.ids.cpu().numpy()
    valid = g.valid.cpu().numpy()
    gid_of = seg.global_ids()
    big = np.flatnonzero(valid.sum(axis=1) >= 64)
    per = min(per, len(big) // 4)
    pick = rng.choice(big, 3 * per, replace=False)
    grains = dict(retire=np.sort(pick[:per]), merge=np.sort(pick[per:2 * per]),
                  refit=np.sort(pick[2 * per:]))
    kill = []
    for gi in grains["retire"]:
        kill.append(gid_of[ids[gi][valid[gi]]])
    for gi in grains["merge"]:
        rows = ids[gi][valid[gi]]
        kill.append(gid_of[rng.choice(rows, int(0.9 * len(rows)),
                                      replace=False)])
    from repro_torch.core.maintenance import raw_rows

    raw = raw_rows(seg)                 # warm: the device tier; cold: file
    for gi in grains["refit"]:
        rows = ids[gi][valid[gi]]
        p = ((raw(rows) - g.mu[gi]) @ g.basis[gi][:, 0]).cpu().numpy()
        kill.append(gid_of[rows[p < 0]])
    return grains, np.concatenate(kill)


def lifecycle_phase(torch, np, dev, st, *, qt, x, tags, up, x_up, dead,
                    new_ids, x_new, recall_5120, seed=2):
    """The store's lifecycle on the store the store phase built (8 sealed
    segments, a memtable at half the seal threshold): ``compact()`` with
    its defaults (8 -> 2 segments, dead rows reclaimed, the maintenance
    pass a no-op); the searches on the compacted plane; deletes designed
    to retire, merge and refit grains of one merged segment, read back
    through ``grain_health()``; ``maintain()``; the searches again, and
    256 queries through the "kernel" plane held to "ref"."""
    from repro_torch.core import MaintenancePolicy
    from repro_torch.core import index as index_mod
    from repro_torch.core import maintenance
    from repro_torch.core import store as store_mod
    from repro_torch.kernels import hntl_scan as hs

    on_card = dev.type == "cuda"
    if on_card:
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    n, d = x.shape
    n_total = n + len(new_ids)
    check(np.array_equal(new_ids, np.arange(n, n_total)),
          "lifecycle: the half-memtable rows' gids are not n, n+1, ...")
    # the live vector of every gid, on the card
    xl = torch.empty((n_total, d), dtype=torch.float32, device=dev)
    xl[:n] = torch.from_numpy(x).to(dev)
    xl[torch.from_numpy(up).to(dev)] = torch.from_numpy(x_up).to(dev)
    xl[n:] = torch.from_numpy(x_new).to(dev)
    alive = torch.ones(n_total, dtype=torch.bool, device=dev)
    alive[torch.from_numpy(dead).to(dev)] = False
    tg = torch.from_numpy(np.concatenate(
        [tags, tags[:n_total - n]]).astype(np.int64)).to(dev)
    out = {}
    n_live = st.n_live()
    check(n_live == int(alive.sum()), f"lifecycle: n_live {n_live} != "
          f"{int(alive.sum())}")

    out["before_compact"] = lifecycle_searches(
        torch, np, st, qt, xl, alive, tg, "store before compact")

    # ---- 1: compact --------------------------------------------------------
    seg_rows = [s.n for s in st._segments]
    epochs = st.maintenance_epochs
    maintain_calls = []
    real_maintain = st.maintain

    def timed_maintain(**kw):
        sync(torch, dev)
        t0 = time.perf_counter()
        rep = real_maintain(**kw)
        sync(torch, dev)
        maintain_calls.append((time.perf_counter() - t0, rep))
        return rep

    st.maintain = timed_maintain
    try:
        with _Timed(torch, dev, index_mod, "build") as builds:
            sync(torch, dev)
            t0 = time.perf_counter()
            merges = st.compact()
            sync(torch, dev)
            compact_s = time.perf_counter() - t0
    finally:
        del st.maintain
    check(merges == 2 and st.n_segments == 2,
          f"compact: {merges} merges to {st.n_segments} segments, expected "
          "2 merges to 2 segments")
    check(st.n_live() == n_live, f"compact: n_live {st.n_live()} != "
          f"{n_live}")
    sealed_rows = sum(s.n for s in st._segments)
    sealed_live = n_live - len(st.snapshot().mem)
    check(sealed_rows == sealed_live, f"compact: {sealed_rows} physical "
          f"sealed rows, {sealed_live} live: dead rows were not reclaimed")
    m_s, m_rep = maintain_calls[0]
    check(not m_rep.changed and st.maintenance_epochs == epochs,
          f"compact: the maintenance pass changed the merged segments "
          f"({m_rep.summary()})")
    out["compact"] = dict(merges=merges, seconds=compact_s,
                          build_s=builds.calls, maintain_s=m_s,
                          grains=[s.index.grains.n_grains
                                  for s in st._segments],
                          cap=[s.index.grains.cap for s in st._segments],
                          rows=[s.n for s in st._segments])
    log(f"compact: {merges} merges, {len(seg_rows)} -> {st.n_segments} "
        f"segments ({sum(seg_rows)} -> {sealed_rows} physical sealed rows, "
        f"all live), {compact_s:.2f} s in all; merge builds "
        f"{' '.join(f'{v:.2f}' for v in builds.calls)} s; merged segments "
        f"{out['compact']['rows']} rows, G {out['compact']['grains']}, cap "
        f"{out['compact']['cap']}; maintenance pass {m_s:.3f} s "
        f"({m_rep.summary()}, no change); n_live {n_live}")

    # ---- 2: search the compacted store -------------------------------------
    out["after_compact"] = lifecycle_searches(
        torch, np, st, qt, xl, alive, tg, "store after compact")
    log(f"recall@10 of the store phase (8 segments, memtable 5,120 rows): "
        f"Mode A {recall_5120['A']:.4f}, Mode B {recall_5120['B']:.4f}")

    # ---- 3: deletes designed to trip each repair ---------------------------
    rng = np.random.default_rng(seed)
    seg0, seg1 = st._segments
    grains, kill = design_repairs(torch, np, seg0, rng)
    check(st.delete(kill) == len(kill), "lifecycle: delete count")
    alive[torch.from_numpy(kill).to(dev)] = False
    policy = MaintenancePolicy(drift_ratio=LIFECYCLE_DRIFT_RATIO)
    sync(torch, dev)
    t0 = time.perf_counter()
    health = st.grain_health()
    sync(torch, dev)
    health_s = time.perf_counter() - t0
    h = health[0]
    built = seg0.index.grains.valid.sum(dim=1).cpu().numpy()
    ratio = h["drift2"] / np.maximum(h["var_live"], 1e-30)
    flagged = dict(
        retire=h["live_cnt"][grains["retire"]] == 0,
        merge=(h["live_cnt"][grains["merge"]]
               < policy.underfull_frac * built[grains["merge"]]),
        refit=(h["drift2"][grains["refit"]]
               > policy.drift_ratio * h["var_live"][grains["refit"]] + 1e-8))
    check(all(v.all() for v in flagged.values()),
          f"grain_health: designed grains not flagged {flagged}")
    at_default = int((ratio[grains["refit"]] > 0.25).sum())
    log(f"grain_health: {health_s:.2f} s for {len(health)} segments; "
        f"{len(kill)} rows deleted in segment {seg0.seg_id}: retire "
        f"{grains['retire'].tolist()} (live 0), merge "
        f"{grains['merge'].tolist()} (live "
        f"{h['live_cnt'][grains['merge']].tolist()} of built "
        f"{built[grains['merge']].tolist()}), refit "
        f"{grains['refit'].tolist()} (drift2 / var_live "
        f"{' '.join(f'{v:.4f}' for v in ratio[grains['refit']])}; "
        f"{at_default} above the default drift_ratio 0.25, all above "
        f"{LIFECYCLE_DRIFT_RATIO}); every designed grain flagged")

    # ---- 4: maintain -------------------------------------------------------
    epochs = st.maintenance_epochs
    with contextlib.ExitStack() as stack:
        parts = {name: stack.enter_context(
            _Timed(torch, dev, maintenance, name))
            for name in ("grain_stats", "_plan_segment", "_encode_groups",
                         "_assemble_segment")}
        sync(torch, dev)
        t0 = time.perf_counter()
        rep = st.maintain(policy=policy)
        sync(torch, dev)
        maintain_s = time.perf_counter() - t0
    r0 = rep.segments[0]
    per = len(grains["retire"])
    copied = {a for a, _ in r0.unchanged}
    kept = sorted(copied & set(np.concatenate(list(grains.values()))
                               .tolist()))
    # an underfull grain that became another's merge target is repacked
    # rather than merged away, so merges may fall short of the design
    check(rep.total("retires") >= per and rep.total("merges") >= 1
          and rep.total("refits") >= per and not kept,
          f"maintain: {rep.summary()}; designed grains left untouched "
          f"{kept}; expected at least {per} retires and refits, merges, "
          "and every designed grain repaired")
    check(st.maintenance_epochs == epochs + 1, "maintain: epoch count")
    check(st._segments[1] is seg1 and not rep.segments[1].changed,
          "maintain: the healthy segment did not come back by identity")
    new0 = st._segments[0]
    og, ng = seg0.index.grains, new0.index.grains
    oi = torch.tensor([a for a, _ in r0.unchanged], device=dev)
    ni = torch.tensor([b for _, b in r0.unchanged], device=dev)
    for f in ("coords", "res", "sketch", "ids", "valid", "basis", "mu",
              "scale", "res_scale", "sketch_basis", "sketch_scale", "tags",
              "ts", "qmaxg"):
        a, b = getattr(og, f), getattr(ng, f)
        check((a is None) == (b is None) and (a is None or torch.equal(
            a[oi], b[ni])), f"maintain: untouched grains' {f} changed")
    check(torch.equal(seg0.index.routing.sizes[oi],
                      new0.index.routing.sizes[ni]),
          "maintain: untouched grains' routing sizes changed")
    # every live sealed gid sits in exactly one valid slot
    slots = []
    for s in st._segments:
        ids = s.index.grains.ids.cpu().numpy()
        valid = s.index.grains.valid.cpu().numpy()
        slots.append(s.global_ids()[ids[valid]])
    slots = np.concatenate(slots)
    alive_h = alive.cpu().numpy()
    live_slots = slots[alive_h[slots]]
    sealed_live = np.concatenate([s.global_ids() for s in st._segments])
    sealed_live = sealed_live[alive_h[sealed_live]]
    check(len(np.unique(live_slots)) == len(live_slots)
          and np.array_equal(np.sort(live_slots), np.sort(sealed_live)),
          "maintain: the valid slots are not a bijection onto the live "
          "sealed rows")
    secs = {name: sum(p.calls) for name, p in parts.items()}
    out["maintain"] = dict(seconds=maintain_s, parts=secs,
                           health_s=health_s, report=rep.summary(),
                           grains=[s.index.grains.n_grains
                                   for s in st._segments],
                           unchanged=len(r0.unchanged),
                           drift_over_var=ratio[grains["refit"]].tolist())
    log(f"maintain: {maintain_s:.2f} s ({rep.summary()}; segment "
        f"{seg0.seg_id}: {r0.grains_before} -> {r0.grains_after} grains, "
        f"{len(r0.unchanged)} copied bit-identical; segment {seg1.seg_id} "
        f"by identity); stats {secs['grain_stats']:.3f} s, plan "
        f"{secs['_plan_segment']:.3f} s, encode "
        f"{secs['_encode_groups']:.3f} s, assemble "
        f"{secs['_assemble_segment']:.3f} s; the live set is a bijection "
        "onto the valid slots")
    la = lifecycle_searches(torch, np, st, qt, xl, alive, tg,
                            "store after maintain")
    check(len(la["stacks"]) == 1, f"maintain: {len(la['stacks'])} re-stacks "
          "at the next searches, expected 1")
    out["after_maintain"] = la

    q256 = qt[:256]
    hs.hntl_scan_single.launches = 0
    got = st.search(q256, topk=10, mode="B", scan_impl="kernel")
    sync(torch, dev)
    out["kernel_launches"] = hs.hntl_scan_single.launches
    want = st.search(q256, topk=10, mode="B", scan_impl="ref")
    check(torch.equal(got.ids, want.ids), "store after maintain: the "
          "kernel plane's ids differ from the ref plane's "
          f"({int((got.ids != want.ids).sum())} entries)")
    check(not on_card or out["kernel_launches"] > 0, "store after maintain: "
          "the kernel plane never launched hntl_scan_single")
    log(f"store after maintain: \"kernel\" plane == \"ref\" plane (ids, "
        f"{q256.shape[0]} queries, Mode B); hntl_scan_single launches "
        f"{out['kernel_launches']}")
    if on_card:
        out["peak"] = torch.cuda.max_memory_allocated(dev) - base
        log(f"lifecycle peak device memory {out['peak']} bytes above the "
            f"{base} bytes held when the phase began (max_memory_allocated)")
    return out


# ---------------------------------------------------------------------------
# 12: serving beyond device memory: the cold raw tier, tiered residency
# ---------------------------------------------------------------------------

TIERED_SEARCHES = STORE_SEARCHES


class _CaptureSelect:
    """While installed, the "fused" scan plane's runner keeps a copy of
    the inputs of every call (the registry's entry swapped, so every
    plane that resolves to "fused" goes through it)."""

    def __init__(self, torch):
        self.torch = torch
        self.calls = []

    def __enter__(self):
        from repro_torch.core import scanplane

        self.reg = scanplane._REGISTRY
        self.plane = self.reg["fused"]
        self.reg["fused"] = dataclasses.replace(self.plane, runner=self)
        return self

    def __call__(self, *args, **kw):
        def copy(v):
            return v.clone() if isinstance(v, self.torch.Tensor) else v

        self.calls.append(([copy(a) for a in args],
                           {k: copy(v) for k, v in kw.items()}))
        return self.plane.runner(*args, **kw)

    def __exit__(self, *exc):
        self.reg["fused"] = self.plane


def cold_searches(torch, np, st, qt, xl, alive, tg, tsv, label):
    """The all-warm plane of the cold store (``device_budget=None``):
    Mode A, B, B under a tag filter and B under a ts filter (the select's
    counter zeroed just before, read just after), each held to the
    "fused_ref" plane's ids, free of dead gids, Mode B dists equal to the
    live vectors' exact distances (rtol 1e-5), the filters obeyed;
    recall@10 against exact search over the live rows."""
    from repro_torch.core.flat import flat_search, recall_at_k
    from repro_torch.kernels import fused_select as fsel

    dev, nq = qt.device, qt.shape[0]
    st.device_budget = None
    res, per = {}, {}
    fsel.fused_scan_select.launches = 0
    for name, kw in TIERED_SEARCHES.items():
        before = fsel.fused_scan_select.launches
        res[name] = st.search(qt, topk=10, **kw)
        sync(torch, dev)
        per[name] = fsel.fused_scan_select.launches - before
    launches = fsel.fused_scan_select.launches
    if dev.type == "cuda":
        check(all(v == -(-nq // 256) for v in per.values()),
              f"{label}: fused_scan_select launches per search {per}")
    dead = torch.nonzero(~alive).flatten()
    for name, kw in TIERED_SEARCHES.items():
        ref = st.search(qt, topk=10, scan_impl="fused_ref", **kw)
        ids = res[name].ids
        check(torch.equal(ids, ref.ids), f"{label} {name}: ids differ from "
              f"the fused_ref plane ({int((ids != ref.ids).sum())} entries)")
        hold_store_result(torch, res[name], kw, f"{label} {name}", xl=xl,
                          dead_t=dead, tg=tg, tsv=tsv, qt=qt)
    live = torch.nonzero(alive).flatten()
    truth = live[flat_search(xl[live], qt, topk=10).ids.long()]
    recall = {m: recall_at_k(res[m].ids, truth) for m in "AB"}
    ms = {}
    for m in "AB":
        t0 = time.perf_counter()
        for _ in range(2):
            st.search(qt, topk=10, mode=m)
        sync(torch, dev)
        ms[m] = (time.perf_counter() - t0) / 2 * 1e3
    log(f"{label}, all-warm plane of the cold store: {st.n_segments} "
        f"segments; ids == fused_ref plane ({len(res)} searches); no deleted "
        f"gid; Mode B dists == the live vectors' exact distances (rtol "
        f"1e-5); fused_scan_select launches {per}; recall@10 vs flat_search "
        f"over {int(alive.sum())} live rows: Mode A {recall['A']:.4f}, Mode "
        f"B {recall['B']:.4f}; Mode A {ms['A']:.3f} ms (QPS "
        f"{nq / ms['A'] * 1e3:.1f}), Mode B {ms['B']:.3f} ms (QPS "
        f"{nq / ms['B'] * 1e3:.1f}) per {nq} queries (host clock, ends in a "
        "synchronise)")
    return dict(res=res, launches=launches, per_search=per, recall=recall,
                ms=ms)


def paged_searches(torch, np, st, qt, warm, budget, label, *, all_hot=False):
    """The same store under ``device_budget=budget``: two warm-up
    searches, ``update_residency()``, then the four searches (the select's
    counter zeroed just before, read just after), each equal to the
    all-warm plane's ids and dists (``torch.equal``); times per mode."""
    from repro_torch.kernels import fused_select as fsel

    dev, nq = qt.device, qt.shape[0]
    st.device_budget = budget
    for m in "BA":
        st.search(qt, topk=10, mode=m)
    st.update_residency()
    sync(torch, dev)
    before_stats = st.residency_stats()
    per = {}
    fsel.fused_scan_select.launches = 0
    for name, kw in TIERED_SEARCHES.items():
        before = fsel.fused_scan_select.launches
        got = st.search(qt, topk=10, **kw)
        sync(torch, dev)
        per[name] = fsel.fused_scan_select.launches - before
        want = warm["res"][name]
        check(torch.equal(got.ids, want.ids), f"{label} {name}: paged ids "
              f"differ from the all-warm plane's "
              f"({int((got.ids != want.ids).sum())} entries)")
        check(torch.equal(got.dists, want.dists), f"{label} {name}: paged "
              "dists differ from the all-warm plane's")
    launches = fsel.fused_scan_select.launches
    stats = st.residency_stats()
    if dev.type == "cuda":
        check(all(v > 0 for v in per.values()),
              f"{label}: a paged search launched no select ({per})")
    if all_hot:
        check(stats["hot_grains"] == stats["n_grains"]
              and stats["chunk_dispatches"]
              == before_stats["chunk_dispatches"],
              f"{label}: the whole tier is hot, yet cold chunks were "
              f"staged ({before_stats} -> {stats})")
    ms = {}
    for m in "AB":
        t0 = time.perf_counter()
        for _ in range(2):
            st.search(qt, topk=10, mode=m)
        sync(torch, dev)
        ms[m] = (time.perf_counter() - t0) / 2 * 1e3
    staged = stats["staged_bytes"] - before_stats["staged_bytes"]
    chunks = stats["chunk_dispatches"] - before_stats["chunk_dispatches"]
    log(f"{label}: device_budget {budget} bytes -> {stats['hot_grains']} of "
        f"{stats['n_grains']} grains hot ({stats['hot_bytes']} bytes at "
        f"{stats['panel_bytes_per_grain']} per grain, hot epoch "
        f"{stats['hot_epochs']}); paged == all-warm (ids and dists, "
        f"torch.equal, {len(per)} searches); fused_scan_select launches "
        f"{per}; those searches staged {chunks} cold chunks, {staged} bytes; "
        f"Mode A {ms['A']:.3f} ms (QPS {nq / ms['A'] * 1e3:.1f}), Mode B "
        f"{ms['B']:.3f} ms (QPS {nq / ms['B'] * 1e3:.1f}) per {nq} queries "
        "(host clock, ends in a synchronise)")
    return dict(launches=launches, per_search=per, ms=ms, stats=stats,
                staged=staged, chunks=chunks)


def paged_cascade(torch, st, qt, xl, alive, tg, tsv, budget, label):
    """The cascade on the cold store: on its all-warm plane at
    ``STORE_CASCADE_BUDGETS`` (``store_cascade``; the cold Mode B re-ranks
    min(pool, b2) rows), then paged under ``budget``: at ``budgets=None``
    every paged search equals the all-warm cascade's but for exact ties
    (``tie_aware_equal``), at ``STORE_CASCADE_BUDGETS``, which act on each
    pass, it equals the paged "cascade_ref" (``torch.equal``)."""
    from repro_torch.core.flat import flat_search
    from repro_torch.kernels import fused_select as fsel

    dev, nq, pool = qt.device, qt.shape[0], st.cfg.pool
    dead = torch.nonzero(~alive).flatten()
    live = torch.nonzero(alive).flatten()
    truth = live[flat_search(xl[live], qt, topk=10).ids.long()]
    st.device_budget = None
    out = dict(warm=store_cascade(torch, st, qt, xl, dead, tg, tsv, truth,
                                  f"{label}, all-warm plane"))
    warm = {m: st.search(qt, topk=10, mode=m, scan_impl="cascade")
            for m in "AB"}
    wide = {"A": st.search(qt, topk=11, mode="A", scan_impl="cascade"),
            "B": st.search(qt, topk=pool + 1, pool=pool + 1, mode="A",
                           scan_impl="cascade")}
    st.device_budget = budget
    for m in "BA":
        st.search(qt, topk=10, mode=m, scan_impl="cascade")
    sync(torch, dev)
    b = STORE_CASCADE_BUDGETS
    per, ties, ms = {}, {}, {}
    for m in "AB":
        for budgets in (None, b):
            kw = dict(topk=10, mode=m, scan_impl="cascade", budgets=budgets)
            key = f"{m} budgets={budgets}"
            fsel.fused_scan_select.launches = 0
            t0 = time.perf_counter()
            got = st.search(qt, **kw)
            sync(torch, dev)
            ms[key] = (time.perf_counter() - t0) * 1e3
            per[key] = fsel.fused_scan_select.launches
            if budgets is None:
                ties[m] = tie_aware_equal(
                    torch, got, warm[m], wide[m],
                    f"{label} paged budgets=None Mode {m} vs all-warm",
                    pool=None if m == "A" else pool)
            else:
                ref = st.search(qt, **dict(kw, scan_impl="cascade_ref"))
                check(torch.equal(got.ids, ref.ids)
                      and torch.equal(got.dists, ref.dists),
                      f"{label} paged {key}: differs from the paged "
                      f"cascade_ref ({int((got.ids != ref.ids).sum())} ids)")
            check(not bool(torch.isin(got.ids.long(), dead).any()),
                  f"{label} paged {key}: a deleted gid was returned")
            if m == "B":
                ok = got.ids >= 0
                exact = (xl[torch.clamp(got.ids, min=0).long()]
                         - qt[:, None, :]).square_().sum(-1)
                check(torch.allclose(got.dists[ok], exact[ok], rtol=1e-5,
                                     atol=0.0), f"{label} paged {key}: "
                      "dists are not the live vectors' exact distances")
    if dev.type == "cuda":
        check(all(v > 0 for v in per.values()),
              f"{label}: a paged cascade search launched no select ({per})")
    log(f"{label}, paged at {budget} bytes: budgets=None == the all-warm "
        f"cascade but for exact ties (Mode A {ties['A']} positions, Mode B "
        f"{ties['B']} queries); budgets={b} (per pass) == the paged "
        f"cascade_ref (torch.equal); no deleted gid; Mode B dists exact; "
        f"fused_scan_select launches {per}; first-call ms per {nq} queries "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    out.update(launches=sum(per.values()), per_search=per, ties=ties, ms=ms)
    return out


def host_fill_ms(fn):
    """Host time spent assembling staged chunks (``TieredPlane._fill``)
    during ``fn()``: (ms, chunks)."""
    from repro_torch.core import residency

    real, spent = residency.TieredPlane._fill, []

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        out = real(self, *a, **kw)
        spent.append(time.perf_counter() - t0)
        return out

    residency.TieredPlane._fill = timed
    try:
        fn()
    finally:
        residency.TieredPlane._fill = real
    return sum(spent) * 1e3, len(spent)


def paged_select_times(torch, fsel, calls, reps=10):
    """The select launches of one paged search (``calls``: the captured
    inputs), each held to its plain version (``torch.equal``) and timed
    with CUDA events beside its plain version's time and its bound; then
    CUPTI device time per launch over ``reps`` replays of the whole
    sequence (every kernel the wrapper launches, the schedule included,
    over the launches the trace saw)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    runs, errs, events, plain, bounds, bytes_, ops = [], [], [], [], [], 0, 0
    for i, (args, kw) in enumerate(calls):
        kw = dict(kw)
        width = kw.pop("width")
        errs.append(hold(torch, fsel, args, kw, width, f"paged pass {i}"))

        def run(args=args, kw=kw, width=width):
            return fsel.fused_scan_select(*args, width=width, **kw)

        run()
        runs.append(run)
        events.append(time_events(torch, run, reps))
        plain.append(time_events(torch, lambda args=args, kw=kw, width=width:
                                 fsel.fused_scan_select_ref(
                                     *args, width=width, **kw), 1))
        b, _, nb, no = select_bound(torch, args, kw, width)
        bounds.append(b)
        bytes_, ops = bytes_ + nb, ops + no
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for run in runs:
                run()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {name: sum(e.count for e in evs if name in e.key)
            for name in SELECT_KERNELS}
    total = sum(e.self_device_time_total for e in evs) / 1e3
    launches = min(seen.values())
    check(launches > 0, "paged select: the profiler saw no select kernel")
    n = len(calls)
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = ops / CUDA_CORE_OPS_PER_S
    out = dict(launches_per_search=n, ms=total / launches,
               events_ms=sum(events) / n, plain_ms=sum(plain) / n,
               bound_ms=sum(bounds) / n,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               traces=1, max_abs_err=max(errs),
               at=f"{n} launches of one paged search: " + ", ".join(
                   f"Q={a[1].shape[0]} P={a[1].shape[1]} G={a[4].shape[0]}"
                   for a, _ in calls),
               seen=seen, search_ms=total / reps,
               search_bound_ms=sum(bounds))
    log(f"fused_scan_select on the paged plane: {n} launches per search, "
        f"each equal to its plain version (torch.equal); CUPTI "
        f"{out['ms']:.4f} ms per launch ({out['search_ms']:.4f} ms per "
        f"search, every kernel of the wrapper, {seen} launches seen in "
        f"{reps} replays), CUDA events {out['events_ms']:.4f} ms, plain "
        f"version {out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
        f"per launch by {out['bound_by']} ({out['search_bound_ms']:.4f} ms "
        f"per search); launches: {out['at']}")
    return out


#: Adaptive routing's margins: ``benchmarks/routing_adaptive.py``'s and
#: the config's default.
ADAPTIVE_MARGINS = (0.35, 1.0)


def traffic_copy(st):
    """The store's adaptive probe-traffic state, copied (the counters; the
    entries' segment tuples are shared), to run a search again from it."""
    return collections.OrderedDict(
        (k, dict(hit, wins=hit["wins"].copy(),
                 touches=hit["touches"].copy()))
        for k, hit in st._probe_traffic.items())


class _RecordBuckets:
    """While installed, keeps each adaptive search's plan (n_active) and
    its width buckets [(w, queries)] as the store makes them."""

    def __init__(self):
        self.plans = []

    def __enter__(self):
        from repro_torch.core import store as store_mod

        self.mod, self.real = store_mod, store_mod._width_buckets

        def record(n_active, nprobe):
            out = self.real(n_active, nprobe)
            self.plans.append((n_active.copy(),
                               [(w, len(sel)) for w, sel in out]))
            return out

        store_mod._width_buckets = record
        return self

    def __exit__(self, *exc):
        self.mod._width_buckets = self.real


def adaptive_phase(torch, np, st, qt, xl, alive, budget, label):
    """Adaptive routing (``search(adaptive=True)``, ``cfg.hub_size`` hubs)
    on the cold store over the skewed mix, at each margin of
    ``ADAPTIVE_MARGINS``, the traffic state cleared first:

    - all-warm (``device_budget=None``), Mode A and B: the select's
      counter zeroed just before, read just after, equal to the sum over
      the width buckets of ceil(queries / 256), each launch at its
      bucket's width; ids equal to the same adaptive search on
      "fused_ref" run from the same traffic state, no deleted gid, Mode B
      dists the live vectors' exact distances (rtol 1e-5);
    - ``adaptive=False`` and ``probe_margin=inf`` equal to the static
      search bit for bit;
    - paged at ``budget``, Mode A and B: equal to the all-warm adaptive
      search run from the same traffic state (ids and dists,
      ``torch.equal``), with equal ``probe_stats()``;
    - active probes per query (mean, p50, p99), ``hub_grains()``,
      recall@10 against exact search over the live rows (adaptive and
      static), ms per search (static and adaptive: warm Mode A and B,
      paged Mode A), select launches per search and the busy share.
    """
    from repro_torch.core import planner
    from repro_torch.core.flat import flat_search, recall_at_k
    from repro_torch.kernels import fused_select as fsel

    dev, nq, nprobe = qt.device, qt.shape[0], st.cfg.nprobe
    on_card = dev.type == "cuda"
    dead = torch.nonzero(~alive).flatten()
    live = torch.nonzero(alive).flatten()
    truth = live[flat_search(xl[live], qt, topk=10).ids.long()]
    out = dict(margins={}, launches=0, paged_launches=0)
    for margin in ADAPTIVE_MARGINS:
        row = dict(launches={}, paged_launches={}, ms={})
        st._probe_traffic.clear()
        st.device_budget = None
        akw = dict(topk=10, adaptive=True, probe_margin=margin)
        res = {}
        for m in "AB":
            before = traffic_copy(st)
            with _RecordBuckets() as rb, _CaptureSelect(torch) as cap:
                fsel.fused_scan_select.launches = 0
                got = st.search(qt, mode=m, **akw)
                sync(torch, dev)
                n = fsel.fused_scan_select.launches
            (na, buckets), = rb.plans
            widths = [w for w, c in buckets
                      for _ in range(-(-c // planner.QUERY_BATCH))]
            seen = [a[1].shape[1] for a, _ in cap.calls]
            del cap
            if on_card:               # the CPU's default plane is "ref"
                check(n == len(widths), f"{label} {margin} Mode {m}: "
                      f"{n} select launches, expected {len(widths)} (the "
                      f"buckets {buckets})")
                check(seen == widths, f"{label} {margin} Mode {m}: launches "
                      f"at widths {seen}, expected the buckets' {widths}")
            row["launches"][m] = n
            out["launches"] += n
            after = traffic_copy(st)
            st._probe_traffic = before
            want = st.search(qt, mode=m, scan_impl="fused_ref", **akw)
            st._probe_traffic = after
            ids, d = got.ids, got.dists
            check(torch.equal(ids, want.ids), f"{label} {margin} Mode {m}: "
                  f"ids differ from the fused_ref plane "
                  f"({int((ids != want.ids).sum())} entries)")
            row[f"dists equal {m}"] = bool(torch.equal(d, want.dists))
            check(ids.shape == (nq, 10) and bool(torch.isfinite(d).all())
                  and bool((ids[:, 0] >= 0).all()),
                  f"{label} {margin} Mode {m}: bad result")
            check(not bool(torch.isin(ids.long(), dead).any()),
                  f"{label} {margin} Mode {m}: a deleted gid was returned")
            if m == "B":
                ok = ids >= 0
                at = torch.clamp(ids, min=0).long()
                exact = (xl[at] - qt[:, None, :]).square_().sum(-1)
                check(torch.allclose(d[ok], exact[ok], rtol=1e-5, atol=0.0),
                      f"{label} {margin} Mode B: dists are not the live "
                      "vectors' exact distances")
            res[m] = got
            row["buckets " + m] = buckets
            row["active " + m] = dict(
                mean=float(na.mean()), p50=float(np.percentile(na, 50)),
                p99=float(np.percentile(na, 99)))
        # bit-identity of adaptive=False and of an infinite margin
        static = {}
        for m in "AB":
            static[m] = st.search(qt, topk=10, mode=m)
            for kw in (dict(adaptive=False),
                       dict(adaptive=True, probe_margin=float("inf"))):
                got = st.search(qt, topk=10, mode=m, **kw)
                check(torch.equal(got.ids, static[m].ids)
                      and torch.equal(got.dists, static[m].dists),
                      f"{label} {margin} Mode {m}: {kw} differs from the "
                      "static search")
        # the paged plane, from the same traffic state as all-warm, its
        # hot set elected under ``budget`` (a new budget applies from the
        # next election)
        st.device_budget = budget
        st.update_residency()
        hot = st.residency_stats()["hot_grains"]
        for m in "AB":
            before = traffic_copy(st)
            st.device_budget = None
            want = st.search(qt, mode=m, **akw)
            stats = st.probe_stats()
            st._probe_traffic = before
            st.device_budget = budget
            fsel.fused_scan_select.launches = 0
            got = st.search(qt, mode=m, **akw)
            sync(torch, dev)
            row["paged_launches"][m] = fsel.fused_scan_select.launches
            out["paged_launches"] += row["paged_launches"][m]
            check(torch.equal(got.ids, want.ids)
                  and torch.equal(got.dists, want.dists),
                  f"{label} {margin} Mode {m}: paged differs from all-warm "
                  f"({int((got.ids != want.ids).sum())} ids)")
            check(st.probe_stats() == stats, f"{label} {margin} Mode {m}: "
                  f"paged probe_stats {st.probe_stats()} != all-warm {stats}")
        row["hubs"] = st.hub_grains().tolist()
        row["probe_stats"] = st.probe_stats()
        row["recall"] = {f"{m} {k}": recall_at_k(r[m].ids, truth)
                         for k, r in (("adaptive", res), ("static", static))
                         for m in "AB"}

        def timed(fn, reps=2):
            fn()
            sync(torch, dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync(torch, dev)
            return (time.perf_counter() - t0) / reps * 1e3

        for plane, b, modes in (("warm", None, "AB"), ("paged", budget, "A")):
            st.device_budget = b
            if b is not None:
                st.update_residency()
            for m in modes:
                for kind, kw in (("static", dict(topk=10)), ("adaptive", akw)):
                    row["ms"][f"{plane} {m} {kind}"] = timed(
                        lambda kw=kw, m=m: st.search(qt, mode=m, **kw))
        if on_card:
            for plane, b in (("warm", None), ("paged", budget)):
                st.device_budget = b
                row[f"profile {plane}"] = profile(
                    torch, f"one adaptive search, margin {margin}, Mode A, "
                    f"{plane}, {nq} queries",
                    lambda: st.search(qt, mode="A", **akw),
                    row["ms"][f"{plane} A adaptive"] / 1e3, top=8)
        st.device_budget = None
        act = row["active A"]
        log(f"{label}, probe_margin {margin}, hub_size {st.cfg.hub_size}: "
            f"active probes per query of {nprobe} mean {act['mean']:.3f}, "
            f"p50 {act['p50']:.0f}, p99 {act['p99']:.0f} (Mode A's plan); "
            f"buckets (width, queries) {row['buckets A']}; select launches "
            f"per search all-warm {row['launches']} (== sum over the "
            f"buckets of ceil(queries / 256), each at its bucket's width), "
            f"paged {row['paged_launches']}; ids == fused_ref from the same "
            f"traffic (dists torch.equal: A {row['dists equal A']}, B "
            f"{row['dists equal B']}); adaptive=False and probe_margin=inf "
            f"== static bit for bit; paged at {budget} bytes ({hot} grains "
            f"hot) == all-warm (ids, dists torch.equal; probe_stats equal); "
            f"hub_grains "
            f"{row['hubs']}; probe_stats {row['probe_stats']}; recall@10 "
            "vs exact search over the live rows: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row["recall"].items())
            + f"; ms per {nq} queries (host clock, ends in a synchronise): "
            + ", ".join(f"{k} {v:.3f}" for k, v in row["ms"].items()))
        out["margins"][margin] = row
    return out


def tiered_round(torch, np, st, qt, xl, alive, tg, tsv, budgets, label):
    """The all-warm plane of the cold store, then the paged plane at every
    budget, each paged search equal to the all-warm one."""
    warm = cold_searches(torch, np, st, qt, xl, alive, tg, tsv, label)
    paged = {}
    for name, b in budgets.items():
        paged[name] = paged_searches(torch, np, st, qt, warm, b,
                                     f"{label}, paged at {name}",
                                     all_hot=name == "more than the tier")
    return dict(warm=warm, paged=paged)


def _raw_files(cold_dir):
    return sorted(f for f in os.listdir(cold_dir) if f.endswith(".raw"))


def skewed_queries(np, synthetic, segments, x, nq, hot_frac=0.8):
    """The tiered phase's skewed mix: ``hot_frac`` of the queries are
    jittered copies (``queries_from``) of rows in 128 of the store's grains
    (one in 8 for a short run), chosen by ``default_rng(3)``; the rest
    ``queries_from`` over the whole corpus.  Returns (queries, hot query
    count, hot grains, grains)."""
    grains = [(si, gi) for si, s in enumerate(segments)
              for gi in range(s.index.grains.n_grains)]
    pick = np.random.default_rng(3).choice(
        len(grains), min(128, len(grains) // 8), replace=False)
    rows = []
    for i in pick:
        si, gi = grains[i]
        ids = segments[si].index.grains.ids[gi].cpu().numpy()
        rows.append(segments[si].global_ids()[ids[ids >= 0]])
    n_hot = int(round(hot_frac * nq))
    q = np.concatenate([
        synthetic.queries_from(x[np.concatenate(rows)], nq=n_hot, seed=3),
        synthetic.queries_from(x, nq=nq - n_hot)])
    return q, n_hot, len(pick), len(grains)


def tiered_phase(torch, np, dev, *, n=1_000_000, nq=1024, segments=8,
                 grains=128, seed=0):
    """Serving beyond device memory at the main path's widths: a cold store
    (``cold_tier=True``, ``residency_interval=8``, ``prefetch_grains=64``)
    of ``n`` rows sealed in ``segments`` chunks, 1% of them deleted; 1024
    queries in a skewed mix (80% jittered copies of rows in 128 of the
    grains, 20% over the whole corpus).  The all-warm plane of the cold
    store is held to "fused_ref", the live vectors and brute force; then
    the same store under ``device_budget`` 0, 25% of the panel tier and
    more than all of it must return the all-warm ids and dists exactly;
    again after more deletes, after ``compact()`` (merged cold files
    written, the replaced ones unlinked) and after ``maintain()`` (a
    repaired child shares its parent's cold file, which outlives the
    parent).  Its cold directory is removed at the end, on failure too."""
    cold_dir = tempfile.mkdtemp(prefix="tiered_phase_")
    try:
        need = 2 * n * 768 * 4 + (1 << 30)
        free = shutil.disk_usage(cold_dir).free
        check(free >= need, f"tiered phase: {free} bytes free in {cold_dir}, "
              f"needs {need} (the cold files twice while compaction writes "
              "the merged ones, and the panel files)")
        log(f"tiered phase: cold directory {cold_dir}, {free} bytes free "
            f"({need} needed)")
        return _tiered_phase(torch, np, dev, cold_dir, n=n, nq=nq,
                             segments=segments, grains=grains, seed=seed)
    finally:
        shutil.rmtree(cold_dir, ignore_errors=True)


def _tiered_phase(torch, np, dev, cold_dir, *, n, nq, segments, grains,
                  seed):
    from repro_torch.core import HNTLConfig, MaintenancePolicy, VectorStore
    from repro_torch.core import store as store_mod
    from repro_torch.data import synthetic
    from repro_torch.kernels import fused_select as fsel

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    per_seg = n // segments
    n = per_seg * segments
    t0 = time.perf_counter()
    x = synthetic.anisotropic_manifold(n=n, d=768, intrinsic=24, seed=seed)
    row = np.arange(n)
    tags = (1 << (row % 4)).astype(np.uint32)
    ts = (row / n).astype(np.float32)
    log(f"tiered data: anisotropic_manifold n={n} d=768 intrinsic=24 "
        f"seed={seed}, {time.perf_counter() - t0:.2f} s on the host")
    cfg = HNTLConfig(d=768, k=32, s=8, block=128, n_grains=grains,
                     nprobe=16, pool=64)
    if on_card:
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    st = VectorStore(cfg, seal_threshold=per_seg, device=dev, cold_tier=True,
                     cold_dir=cold_dir, residency_interval=8,
                     prefetch_grains=64)
    seal_s = []
    with _Timed(torch, dev, store_mod.index_mod, "build") as builds, \
            _Timed(torch, dev, store_mod, "_write_cold_file") as writes:
        for lo in range(0, n, per_seg):
            sync(torch, dev)
            t0 = time.perf_counter()
            st.add(x[lo:lo + per_seg], tags=tags[lo:lo + per_seg],
                   ts=ts[lo:lo + per_seg])
            sync(torch, dev)
            seal_s.append(time.perf_counter() - t0)
    check(st.n_segments == segments and not st.snapshot().mem,
          f"tiered: {st.n_segments} segments, expected {segments} and an "
          "empty memtable")
    check(all(s.index.raw is None and os.path.exists(s.cold_path)
              for s in st._segments), "tiered: a sealed segment is not cold")
    log(f"tiered store: {segments} cold segments of {per_seg} rows, G "
        f"{[s.index.grains.n_grains for s in st._segments]}, cap "
        f"{[s.index.grains.cap for s in st._segments]}; seal seconds sum "
        f"{sum(seal_s):.2f} ({' '.join(f'{v:.2f}' for v in seal_s)}): "
        f"build {sum(builds.calls):.2f} "
        f"({' '.join(f'{v:.2f}' for v in builds.calls)}), cold write "
        f"{sum(writes.calls):.2f} "
        f"({' '.join(f'{v:.2f}' for v in writes.calls)}); "
        f"{len(_raw_files(cold_dir))} cold files, "
        f"{sum(os.path.getsize(s.cold_path) for s in st._segments)} bytes")

    memory = {}

    def resident(label):
        """Device bytes held now above the phase's start."""
        if on_card:
            sync(torch, dev)
            memory[label] = torch.cuda.memory_allocated(dev) - base

    resident("segments (cold: panels and frames)")
    rng = np.random.default_rng(1)
    n_del = n // 100
    dead = rng.choice(n, n_del, replace=False)
    check(st.delete(dead) == n_del, "tiered: delete count")
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[torch.from_numpy(dead).to(dev)] = False

    q, n_hot_q, n_hot_g, n_g = skewed_queries(np, synthetic, st._segments, x,
                                              nq)
    qt = torch.from_numpy(q).to(dev)
    xl = torch.from_numpy(x).to(dev)
    tg = torch.from_numpy(tags.astype(np.int64)).to(dev)
    tsv = torch.from_numpy(ts).to(dev)
    log(f"tiered traffic: {nq} queries, {n_hot_q} jittered copies of rows "
        f"in {n_hot_g} of {n_g} grains (default_rng(3)), "
        f"{nq - n_hot_q} over the whole corpus; {n_del} rows deleted")
    out = {}
    resident("+ the check's live vectors, queries, tags and ts")

    # ---- 1-2: the all-warm plane, then the budgets ------------------------
    warm = cold_searches(torch, np, st, qt, xl, alive, tg, tsv,
                         "tiered: cold store")
    out["cold_sharded"] = cold_sharded(torch, np, st, qt, xl, alive,
                                       "tiered: cold store, sharded")
    resident("+ the all-warm plane of the cold store (stacked panels, "
             "frames, liveness)")
    st._rerank_stats.update(store_mod._new_rerank_stats())
    st.search(qt, topk=10, mode="B")
    sync(torch, dev)
    rr = st._rerank_stats
    h2d_ms = sum(a.elapsed_time(b) for a, b in rr["h2d"])
    log(f"cold Mode B re-rank, one all-warm search of {nq} queries: "
        f"{rr['calls']} gathers of {rr['rows']} rows, {rr['bytes']} bytes; "
        f"host gather {rr['host_s'] * 1e3:.3f} ms (memmaps -> pinned "
        f"buffer), H2D {h2d_ms:.3f} ms (CUDA events)")
    out["rerank"] = dict(rows=rr["rows"], bytes=rr["bytes"],
                         host_ms=rr["host_s"] * 1e3, h2d_ms=h2d_ms)
    zero = paged_searches(torch, np, st, qt, warm, 0,
                          "tiered: paged at budget 0")
    resident("+ the tiered plane at budget 0 (frames, routing, row maps, "
             "staging buffers)")
    per_grain = zero["stats"]["panel_bytes_per_grain"]
    g_n = zero["stats"]["n_grains"]
    budgets = {"budget 0": 0, "25% of the tier": g_n * per_grain // 4,
               "more than the tier": 2 * g_n * per_grain}
    first = dict(warm=warm, paged={"budget 0": zero})
    for name in list(budgets)[1:]:
        first["paged"][name] = paged_searches(
            torch, np, st, qt, warm, budgets[name],
            f"tiered: paged at {name}", all_hot=name == "more than the tier")
        resident(f"+ the hot set at {name}")
    out["memory"] = memory
    if on_card:
        log("tiered device memory held (memory_allocated above the phase's "
            "start, after each step): " + "; ".join(
                f"{k}: {v}" for k, v in memory.items()))
    out["first"] = first
    out["budgets"] = budgets
    out["adaptive"] = adaptive_phase(torch, np, st, qt, xl, alive,
                                     budgets["25% of the tier"],
                                     "tiered adaptive")
    out["cascade"] = paged_cascade(torch, st, qt, xl, alive, tg, tsv,
                                   budgets["25% of the tier"],
                                   "tiered cascade")
    out["tenancy"] = paged_tenancy(torch, np, st, xl, qt,
                                   budgets["25% of the tier"], dead,
                                   "tiered tenancy")

    # the select at the paged plane's shapes, and one paged search profiled
    st.device_budget = budgets["25% of the tier"]
    st.update_residency()
    st.search(qt, topk=10, mode="A")
    sync(torch, dev)
    with _CaptureSelect(torch) as cap:
        st.search(qt, topk=10, mode="A")
        sync(torch, dev)
    out["select_calls"] = len(cap.calls)
    shapes = [f"Q={a[1].shape[0]} P={a[1].shape[1]} G={a[4].shape[0]}"
              for a, _ in cap.calls]
    log(f"one paged search (Mode A, {nq} queries, 25% budget): "
        f"{len(cap.calls)} select launches ({', '.join(shapes)})")
    if on_card:
        out["select"] = paged_select_times(torch, fsel, cap.calls)
        del cap
        wall = first["paged"]["25% of the tier"]["ms"]["B"] / 1e3
        out["profile"] = profile(
            torch, f"one paged search, Mode B, {nq} queries, 25% budget",
            lambda: st.search(qt, topk=10, mode="B"), wall, top=10)
        out["profile_a"] = profile(
            torch, f"one paged search, Mode A, {nq} queries, 25% budget",
            lambda: st.search(qt, topk=10, mode="A"),
            first["paged"]["25% of the tier"]["ms"]["A"] / 1e3, top=10)
        out["peak_first"] = torch.cuda.max_memory_allocated(dev) - base
    out["fill"] = {}
    for name in ("budget 0", "25% of the tier"):
        st.device_budget = budgets[name]
        st.update_residency()
        st.search(qt, topk=10, mode="A")
        sync(torch, dev)
        t0 = time.perf_counter()
        fill_ms, fills = host_fill_ms(lambda: st.search(qt, topk=10,
                                                        mode="A"))
        sync(torch, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        out["fill"][name] = dict(fill_ms=fill_ms, chunks=fills,
                                 wall_ms=wall_ms)
        log(f"paged search at {name}, Mode A: host assembly of {fills} "
            f"staged chunks {fill_ms:.3f} ms (panel LRU or memmaps, and the "
            f"mask, into pinned buffers) of {wall_ms:.3f} ms wall")

    # ---- 3: more deletes ----------------------------------------------------
    more = rng.choice(np.flatnonzero(alive.cpu().numpy()), n_del,
                      replace=False)
    check(st.delete(more) == n_del, "tiered: second delete count")
    alive[torch.from_numpy(more).to(dev)] = False
    out["after_deletes"] = tiered_round(torch, np, st, qt, xl, alive, tg,
                                        tsv, budgets,
                                        "tiered after more deletes")

    # ---- 4: compact ---------------------------------------------------------
    before = _raw_files(cold_dir)
    old_paths = [s.cold_path for s in st._segments]
    st.device_budget = None
    sync(torch, dev)
    t0 = time.perf_counter()
    merges = st.compact()
    sync(torch, dev)
    compact_s = time.perf_counter() - t0
    check(merges == 2 and st.n_segments == 2, f"tiered compact: {merges} "
          f"merges to {st.n_segments} segments, expected 2 and 2")
    new_paths = [s.cold_path for s in st._segments]
    check(all(p not in old_paths and os.path.exists(p) for p in new_paths),
          "tiered compact: the merged segments' cold files were not written")
    check(sum(s.n for s in st._segments) == int(alive.sum()),
          "tiered compact: dead rows were not reclaimed")
    out["after_compact"] = tiered_round(torch, np, st, qt, xl, alive, tg,
                                        tsv, budgets, "tiered after compact")
    gc.collect()
    after = _raw_files(cold_dir)
    check(sorted(os.path.basename(p) for p in new_paths) == after,
          f"tiered compact: cold files on disk {after}, expected only the "
          f"merged segments' {new_paths}")
    log(f"tiered compact: {merges} merges in {compact_s:.2f} s, "
        f"{len(before)} -> {len(after)} cold files on disk once the "
        f"replaced segments were gone ({after})")
    out["compact_s"] = compact_s

    # ---- 5: maintain --------------------------------------------------------
    seg0 = st._segments[0]
    parent_path = seg0.cold_path
    _, kill = design_repairs(torch, np, seg0, np.random.default_rng(2))
    check(st.delete(kill) == len(kill), "tiered: designed delete count")
    alive[torch.from_numpy(kill).to(dev)] = False
    sync(torch, dev)
    t0 = time.perf_counter()
    rep = st.maintain(policy=MaintenancePolicy(
        drift_ratio=LIFECYCLE_DRIFT_RATIO))
    sync(torch, dev)
    maintain_s = time.perf_counter() - t0
    repaired = sum(rep.total(f) for f in ("splits", "merges", "retires",
                                          "refits"))
    child = st._segments[0]
    check(repaired >= 1 and child is not seg0, f"tiered maintain: nothing "
          f"repaired ({rep.summary()})")
    check(child.cold_path == parent_path, "tiered maintain: the repaired "
          "segment does not share its parent's cold file")
    del seg0
    out["after_maintain"] = tiered_round(torch, np, st, qt, xl, alive, tg,
                                         tsv, budgets,
                                         "tiered after maintain")
    gc.collect()
    check(os.path.exists(parent_path) and child.cold_path == parent_path,
          "tiered maintain: the shared cold file did not outlive its parent")
    log(f"tiered maintain: {maintain_s:.2f} s ({rep.summary()}); the child "
        f"shares {os.path.basename(parent_path)}, which outlived the parent "
        "segment")
    out["maintain_s"] = maintain_s
    out["seal_s"], out["build_s"], out["write_s"] = (seal_s, builds.calls,
                                                     writes.calls)
    rounds = [out["first"], out["after_deletes"], out["after_compact"],
              out["after_maintain"]]
    out["launches"] = {
        "cold store search (all-warm plane)":
        sum(r["warm"]["launches"] for r in rounds),
        "paged store search": sum(p["launches"] for r in rounds
                                  for p in r["paged"].values())}
    if on_card:
        out["peak"] = torch.cuda.max_memory_allocated(dev) - base
        log(f"tiered peak device memory {out['peak']} bytes above the {base} "
            f"held when the phase began (max_memory_allocated; "
            f"{out['peak_first']} by the end of the first budget round)")
    del st, xl
    log(f"tiered phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 10c: the grain-sharded search plane
# ---------------------------------------------------------------------------

#: Mode B recall@10 may fall this far below the 1-shard plane's on a
#: mesh: each shard's probes hold the single plane's probes in its slice,
#: but a shard's pool of ``pool`` may drop a candidate the single pool
#: kept when its extra grains bring closer approximate distances.
SHARD_RECALL_SLACK = 0.002
#: The sharded phase's meshes: name -> (grain shards, query rows).
SHARD_MESHES = {"1 shard": (1, 1), "2 shards": (2, 1), "4 shards": (4, 1),
                "8 shards": (8, 1), "2 x 4, shard_queries": (4, 2)}


def sharded_mesh(torch, shards, batch=1):
    """A (batch, shards) search mesh whose slots go round-robin over the
    cards: on one card every slot is ``cuda:0``."""
    from repro_torch.launch.mesh import make_search_mesh

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devs = ([f"cuda:{i % n}" for i in range(shards * batch)] if n
            else ["cpu"] * (shards * batch))
    return make_search_mesh(shards, batch=batch, devices=devs)


def ids_agree(torch, got, want, label, *, limit=0.01):
    """Two searches of the same queries whose float bits may differ (a
    shard routes over its own grain count, the projection's GEMVs run at
    another batch shape): the queries whose ids differ, and the largest
    |dist diff| where the ids agree (delta).  A differing query must hold
    the same distances within 2 delta + ``TIE_RTOL`` (a swap among
    near-equal candidates); at most ``limit`` of the queries may differ.
    Returns (queries differing, delta)."""
    same = torch.all(got.ids == want.ids, dim=1)
    delta = float((got.dists[same] - want.dists[same]).abs().max()) \
        if bool(same.any()) else 0.0
    bad = ~same
    if bool(bad.any()):
        gd, wd = got.dists[bad], want.dists[bad]
        slack = 2 * delta + TIE_RTOL * wd.abs()
        check(bool(((gd - wd).abs() <= slack).all()),
              f"{label}: {int(bad.sum())} queries' ids differ without a tie "
              f"(largest dist gap {float((gd - wd).abs().max())})")
    n_bad = int(bad.sum())
    check(n_bad <= limit * got.ids.shape[0], f"{label}: {n_bad} of "
          f"{got.ids.shape[0]} queries differ ({limit:.0%} allowed)")
    return n_bad, delta


def sharded_phase(torch, np, dev, st, *, xb, dead, tags, ts, truth):
    """The grain-sharded search plane on a branch of the store phase's
    store (its 5,120-row memtable kept): for each mesh of
    ``SHARD_MESHES`` (slots round-robin over the cards), 1024 queries in
    Mode A, B, B with a tag and B with a ts filter through
    ``VectorStore.search(mesh=)`` (the select's counter zeroed just before
    each, read just after: n_shards x the 256-query batches per shard),
    each ``torch.equal`` to the same mesh's "fused_ref" plane and held to
    the live vectors; 1 shard against the single-device search (ids, ties
    counted, the dist delta measured); recall@10 per shard count; times,
    the plane's bytes; then the exhaustive cut
    (``sharded_exhaustive``), and on the 4-shard mesh the cascade at
    (4096, 64), adaptive routing at 0.35 and the "kernel" plane; a
    profile and the per-shard select against its plain version and
    bound.  ``xb``: the live vectors (upserts applied) on the device."""
    from repro_torch.core.flat import recall_at_k
    from repro_torch.core.types import tree_bytes
    from repro_torch.kernels import fused_select as fsel
    from repro_torch.kernels import hntl_scan as hs

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    if on_card:
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    qt = truth["q"]
    nq = qt.shape[0]
    dead_t = torch.from_numpy(dead).to(dev)
    tg = torch.from_numpy(tags.astype(np.int64)).to(dev)
    tsv = torch.from_numpy(ts).to(dev)
    hold_kw = dict(xl=xb, dead_t=dead_t, tg=tg, tsv=tsv, qt=qt)
    segs = tuple(st._segments)
    single = {label: st.search(qt, topk=10, **kw)
              for label, kw in STORE_SEARCHES.items()}
    fused_bytes = tree_bytes(st._stacked_for(segs)["plane"])
    st._stack_cache.clear()
    log(f"sharded phase: {torch.cuda.device_count() if on_card else 0} "
        f"card(s); the store's {len(segs)} segments, "
        f"{sum(s.index.grains.n_grains for s in segs)} grains, "
        f"{st.n_vectors} rows ({len(st.snapshot().mem)} in the memtable); "
        f"the fused plane {fused_bytes} bytes")
    out = {"meshes": {}, "launches": {}, "fused_bytes": fused_bytes}
    recall_b = {}
    for name, (shards, batch) in SHARD_MESHES.items():
        mesh = sharded_mesh(torch, shards, batch)
        sq = batch > 1
        sync(torch, dev)
        t0 = time.perf_counter()
        entry = st._sharded_for(segs, mesh, "model")
        sync(torch, dev)
        build_s = time.perf_counter() - t0
        plane = entry["plane"]
        res, per = {}, {}
        fsel.fused_scan_select.launches = 0
        for label, kw in STORE_SEARCHES.items():
            before = fsel.fused_scan_select.launches
            res[label] = st.search(qt, topk=10, mesh=mesh, shard_queries=sq,
                                   **kw)
            sync(torch, dev)
            per[label] = fsel.fused_scan_select.launches - before
        launches = fsel.fused_scan_select.launches
        want = batch * shards * -(-(nq // batch) // 256)
        if on_card:
            check(all(v == want for v in per.values()),
                  f"sharded {name}: select launches per search {per}, "
                  f"expected {want} (shards x query rows x 256-query "
                  "batches)")
        for label, kw in STORE_SEARCHES.items():
            ref = st.search(qt, topk=10, mesh=mesh, shard_queries=sq,
                            scan_impl="fused_ref", **kw)
            got = res[label]
            check(torch.equal(got.ids, ref.ids) and torch.equal(
                got.dists, ref.dists), f"sharded {name} {label}: differs "
                f"from the fused_ref plane on the same mesh "
                f"({int((got.ids != ref.ids).sum())} ids)")
            hold_store_result(torch, got, kw, f"sharded {name} {label}",
                              **hold_kw)
        vs_single = None
        if shards == 1 and batch == 1:
            vs_single = {label: ids_agree(torch, res[label], single[label],
                                          f"sharded 1 shard vs single "
                                          f"device, {label}")
                         for label in STORE_SEARCHES}
        recall = {m: recall_at_k(res[m].ids, truth["ids"]) for m in "AB"}
        recall_b[name] = recall["B"]
        ms = {}
        for label, kw in STORE_SEARCHES.items():
            st.search(qt, topk=10, mesh=mesh, shard_queries=sq, **kw)
            sync(torch, dev)
            t0 = time.perf_counter()
            for _ in range(2):
                st.search(qt, topk=10, mesh=mesh, shard_queries=sq, **kw)
            sync(torch, dev)
            ms[label] = (time.perf_counter() - t0) / 2 * 1e3
        nbytes = plane.nbytes()
        layout = " ".join(f"[{','.join(str(d) for d in row)}]"
                          for row in mesh.devices)
        log(f"sharded {name}: slots {layout}; G_l={plane.g_local} grains "
            f"and {plane.rows_local} rows per shard; plane built and placed "
            f"in {build_s:.3f} s, {nbytes} bytes on the device(s) "
            f"({nbytes / fused_bytes:.3f} of the fused plane's); == "
            f"fused_ref ({len(res)} searches, ids and dists torch.equal); "
            f"no deleted gid, Mode B dists exact; select launches {per}; "
            f"recall@10 A {recall['A']:.4f} B {recall['B']:.4f}"
            + (f"; vs the single-device search (queries differing, max "
               f"|dist diff|): {vs_single}" if vs_single else "")
            + "; ms per " + f"{nq} queries: " + ", ".join(
                f"{k} {v:.3f} (QPS {nq / v * 1e3:.1f})"
                for k, v in ms.items()))
        out["meshes"][name] = dict(
            shards=shards, batch=batch, launches=launches, per_search=per,
            recall=recall, ms=ms, bytes=nbytes, build_s=build_s,
            vs_single=vs_single)
        out["launches"][f"sharded store search, {name}"] = launches
        del entry, plane, res
        st._stack_cache.clear()
        if on_card:
            torch.cuda.empty_cache()
    base_b = recall_b["1 shard"]
    check(all(v >= base_b - SHARD_RECALL_SLACK for v in recall_b.values()),
          f"sharded: Mode B recall@10 fell with the shard count {recall_b}"
          " (each shard probes its own top nprobe grains: a superset of "
          "the single plane's probes)")

    # ---- the 4-shard mesh: the kernel plane, cascade, adaptive ------------
    mesh4 = sharded_mesh(torch, 4)
    q256 = qt[:256]
    hs.hntl_scan_single.launches = 0
    got = st.search(q256, topk=10, mode="B", mesh=mesh4, scan_impl="kernel")
    sync(torch, dev)
    out["kernel_launches"] = hs.hntl_scan_single.launches
    want_k = st.search(q256, topk=10, mode="B", mesh=mesh4, scan_impl="ref")
    check(torch.equal(got.ids, want_k.ids), "sharded kernel plane: ids "
          "differ from the ref plane on the same mesh")
    if on_card:
        check(out["kernel_launches"] > 0, "sharded kernel plane: "
              "hntl_scan_single never launched")
    log(f"sharded 4 shards, \"kernel\" plane (256 queries, Mode B) == "
        f"\"ref\" plane (ids); hntl_scan_single launches "
        f"{out['kernel_launches']}")
    out["host_mesh"] = host_mesh_search(torch, st, qt, dev)
    out["launches"]["store search on make_host_mesh(1, 4)"] = \
        out["host_mesh"]["launches"]
    b = STORE_CASCADE_BUDGETS
    fsel.fused_scan_select.launches = 0
    casc = {m: st.search(qt, topk=10, mode=m, mesh=mesh4, scan_impl="cascade",
                         budgets=b) for m in "AB"}
    sync(torch, dev)
    out["launches"]["sharded cascade search (4 shards)"] = \
        fsel.fused_scan_select.launches
    for m in "AB":
        ref = st.search(qt, topk=10, mode=m, mesh=mesh4,
                        scan_impl="cascade_ref", budgets=b)
        check(torch.equal(casc[m].ids, ref.ids) and torch.equal(
            casc[m].dists, ref.dists), f"sharded cascade {m}: differs from "
            "cascade_ref")
        hold_store_result(torch, casc[m], {"mode": m},
                          f"sharded cascade {m}", **hold_kw)
    casc_recall = {m: recall_at_k(casc[m].ids, truth["ids"]) for m in "AB"}
    fsel.fused_scan_select.launches = 0
    adap = {m: st.search(qt, topk=10, mode=m, mesh=mesh4, adaptive=True,
                         probe_margin=0.35) for m in "AB"}
    sync(torch, dev)
    out["launches"]["sharded adaptive search (4 shards)"] = \
        fsel.fused_scan_select.launches
    for m in "AB":
        ref = st.search(qt, topk=10, mode=m, mesh=mesh4, adaptive=True,
                        probe_margin=0.35, scan_impl="fused_ref")
        check(torch.equal(adap[m].ids, ref.ids) and torch.equal(
            adap[m].dists, ref.dists), f"sharded adaptive {m}: differs "
            "from fused_ref")
        hold_store_result(torch, adap[m], {"mode": m},
                          f"sharded adaptive {m}", **hold_kw)
    adap_recall = {m: recall_at_k(adap[m].ids, truth["ids"]) for m in "AB"}
    log(f"sharded 4 shards: cascade {b} == cascade_ref (A, B; torch.equal),"
        f" recall@10 {casc_recall}, select launches "
        f"{out['launches']['sharded cascade search (4 shards)']}; adaptive "
        f"(margin 0.35, no hub mask) == fused_ref, recall@10 "
        f"{adap_recall}, select launches "
        f"{out['launches']['sharded adaptive search (4 shards)']}")
    out["cascade_recall"], out["adaptive_recall"] = casc_recall, adap_recall

    if on_card:
        wall = out["meshes"]["4 shards"]["ms"]["B"] / 1e3
        out["profile"] = profile(
            torch, f"sharded store search, 4 shards, Mode B, {nq} queries",
            lambda: st.search(qt, topk=10, mode="B", mesh=mesh4), wall)
        with _CaptureSelect(torch) as cap_sel:
            st.search(qt[:256], topk=10, mode="B", mesh=mesh4)
            sync(torch, dev)
        args, kw = cap_sel.calls[0]
        kw = dict(kw)
        width = kw.pop("width")
        out["select"] = time_select_call(
            torch, fsel, args, kw, width, "a shard of the 4-shard store "
            "search (shard 0, the first batch)", what="")
        del cap_sel
    st._stack_cache.clear()
    out["exhaustive"] = sharded_exhaustive(torch, np, dev)
    out["launches"]["sharded exhaustive search (d=768)"] = \
        out["exhaustive"]["launches"]
    if on_card:
        out["peak"] = torch.cuda.max_memory_allocated(dev) - held
        log(f"sharded peak device memory {out['peak']} bytes above the "
            f"{held} held when the phase began (max_memory_allocated)")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"sharded phase: {out['seconds']:.1f} s")
    return out


def host_mesh_search(torch, st, qt, dev):
    """Mesh phase (d): the store searched through ``make_host_mesh(1, 4)``
    on slots of ``dev`` (Mode A and B, the select's counter zeroed just
    before, read just after), ``torch.equal`` in ids and dists to the
    ``make_search_mesh(4)`` plane built anew (the plane cache cleared in
    between)."""
    from repro_torch.kernels import fused_select as fsel
    from repro_torch.launch.mesh import make_host_mesh, make_search_mesh

    host = make_host_mesh(1, 4, devices=[dev] * 4)
    st._stack_cache.clear()
    fsel.fused_scan_select.launches = 0
    got = {m: st.search(qt, topk=10, mode=m, mesh=host) for m in "AB"}
    sync(torch, dev)
    launches = fsel.fused_scan_select.launches
    st._stack_cache.clear()
    want = {m: st.search(qt, topk=10, mode=m, mesh=make_search_mesh(
        4, devices=[dev] * 4)) for m in "AB"}
    for m in "AB":
        check(torch.equal(got[m].ids, want[m].ids) and torch.equal(
            got[m].dists, want[m].dists), f"mesh (d) {m}: make_host_mesh(1,"
            " 4) differs from the make_search_mesh(4) plane")
    log(f"mesh (d): {qt.shape[0]} queries, Mode A and B through "
        f"make_host_mesh(1, 4) on {dev} slots == the make_search_mesh(4) "
        f"plane (ids and dists torch.equal); select launches {launches}")
    st._stack_cache.clear()
    return dict(launches=launches)


def sharded_exhaustive(torch, np, dev, *, segments=4, rows=4096, nq=64):
    """Exhaustive invariance at the paper's width: ``segments`` segments
    of ``rows`` rows (16 grains each) at d=768, 1% deleted, 64 queries at
    nprobe = every grain and a pool of every row: the ids at 1, 2, 4 and 8
    shards equal the fused plane's (ties counted), Mode A and B, each
    shard's "fused" ``torch.equal`` its "fused_ref" (the 1-shard pool is
    16,384 wide: the select's tree merge)."""
    from repro_torch.core import HNTLConfig, VectorStore
    from repro_torch.data import synthetic
    from repro_torch.kernels import fused_select as fsel

    t0 = time.perf_counter()
    n = segments * rows
    x = synthetic.anisotropic_manifold(n=n, d=768, intrinsic=24, seed=5)
    q = synthetic.queries_from(x, nq=nq)
    cfg = HNTLConfig(d=768, k=32, s=8, block=128, n_grains=16, nprobe=16,
                     pool=64)
    st = VectorStore(cfg, seal_threshold=rows, device=dev)
    for lo in range(0, n, rows):
        st.add(x[lo:lo + rows])
    check(st.n_segments == segments and all(
        s.index.grains.n_grains == 16 for s in st._segments),
        "sharded exhaustive: the store's layout")
    dead = np.random.default_rng(4).choice(n, n // 100, replace=False)
    st.delete(dead)
    dead_t = torch.from_numpy(dead).to(dev)
    qt = torch.from_numpy(q).to(dev)
    ex = dict(nprobe=segments * 16, pool=n)
    out = {"launches": 0, "differ": {}, "delta": {}}
    for m in "AB":
        base = st.search(qt, topk=10, mode=m, **ex)
        check(not bool(torch.isin(base.ids.long(), dead_t).any()),
              f"sharded exhaustive {m}: a deleted gid")
        for shards in (1, 2, 4, 8):
            mesh = sharded_mesh(torch, shards)
            before = fsel.fused_scan_select.launches
            got = st.search(qt, topk=10, mode=m, mesh=mesh, **ex)
            sync(torch, dev)
            out["launches"] += fsel.fused_scan_select.launches - before
            ref = st.search(qt, topk=10, mode=m, mesh=mesh,
                            scan_impl="fused_ref", **ex)
            check(torch.equal(got.ids, ref.ids) and torch.equal(
                got.dists, ref.dists), f"sharded exhaustive {m}, {shards} "
                "shards: fused differs from fused_ref")
            check(not bool(torch.isin(got.ids.long(), dead_t).any()),
                  f"sharded exhaustive {m}: a deleted gid")
            key = f"{m} {shards}"
            out["differ"][key], out["delta"][key] = ids_agree(
                torch, got, base, f"sharded exhaustive {m}, {shards} shards "
                "vs the fused plane")
            st._stack_cache.clear()
    log(f"sharded exhaustive (d=768, {segments} x {rows} rows, 16 grains "
        f"each, {n // 100} deleted, {nq} queries, nprobe {ex['nprobe']}, "
        f"pool {n}): ids == the fused plane at 1, 2, 4, 8 shards, Mode A "
        f"and B (queries differing {out['differ']}, max |dist diff| where "
        f"ids agree {out['delta']}); fused == fused_ref on every mesh; "
        f"select launches {out['launches']}; "
        f"{time.perf_counter() - t0:.1f} s")
    del st
    return out


def drop_sharded(st):
    """Drop a store's cached sharded planes (their device bytes go with
    them); its other planes stay cached."""
    for key in [k for k in st._stack_cache if k[0] == "sharded"]:
        del st._stack_cache[key]


def cold_sharded(torch, np, st, qt, xl, alive, label):
    """The cold store (no ``device_budget``) on the 4-shard mesh: Mode B
    with the host re-rank of each shard's whole pool, ``torch.equal`` to
    the sharded "fused_ref" plane, no deleted gid, dists the live vectors'
    exact distances; select launches counted; time."""
    from repro_torch.kernels import fused_select as fsel

    dev, nq = qt.device, qt.shape[0]
    st.device_budget = None
    mesh = sharded_mesh(torch, 4)
    st.search(qt[:1], topk=10, mode="B", mesh=mesh)     # place the plane
    fsel.fused_scan_select.launches = 0
    got = st.search(qt, topk=10, mode="B", mesh=mesh)
    sync(torch, dev)
    launches = fsel.fused_scan_select.launches
    ref = st.search(qt, topk=10, mode="B", mesh=mesh, scan_impl="fused_ref")
    check(torch.equal(got.ids, ref.ids) and torch.equal(got.dists,
                                                        ref.dists),
          f"{label}: differs from the sharded fused_ref plane")
    dead = torch.nonzero(~alive).flatten()
    hold_store_result(torch, got, {"mode": "B"}, label, xl=xl, dead_t=dead,
                      tg=None, tsv=None, qt=qt)
    if dev.type == "cuda":
        check(launches == 4 * -(-nq // 256), f"{label}: {launches} select "
              "launches")
    t0 = time.perf_counter()
    st.search(qt, topk=10, mode="B", mesh=mesh)
    sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    log(f"{label}: 4 shards, Mode B, {nq} queries: == sharded fused_ref "
        f"(torch.equal), no deleted gid, dists exact; select launches "
        f"{launches}; {ms:.3f} ms (each shard's whole pool re-ranked on "
        "the host)")
    drop_sharded(st)
    return dict(launches=launches, ms=ms)


# ---------------------------------------------------------------------------
# 12b: serving phi3-mini at its published width and depth
# ---------------------------------------------------------------------------

SERVE_ARCH = "phi3-mini-3.8b"
#: tests/test_models.py's decode-vs-forward tolerances (bf16 smoke models)
SERVE_TOL_PREFILL = 3e-2
SERVE_TOL_DECODE = 5e-2
#: float32 decode against forward at full width: the port's float32 parity
#: tolerance (tests/test_torch_models.py)
SERVE_TOL_F32 = 1e-4


class PlainScan:
    """Stands in for ``hntl_attention``'s ``ops`` while a decode step is
    run again for comparison: the scan on its plain version."""

    @staticmethod
    def scan_single(*args, backend=None):
        from repro_torch.kernels import ops

        return ops.scan_single(*args, backend="ref")


def within(torch, got, want, tol):
    """(max |got - want|, its median, max(|got - want| - tol |want|)) at
    rtol = atol = tol; numpy's ``assert_allclose`` rule holds when the
    last is at most tol."""
    d = (got.float() - want.float()).abs()
    return (float(d.max()), float(d.median()),
            float((d - tol * want.float().abs()).max()))


def decode_against_forward(torch, T, model, cfg, params, toks, dev):
    """``forward``'s logits over [B, 64] tokens against a 32-token
    ``prefill`` and 32 ``decode_step``s: max and median |difference| and
    the worst excess over rtol |x| (for prefill and over all steps).
    Beside them, how far the products depend on the row count alone:
    a 32-token ``forward`` against the same rows of the 64-token one
    ("rows"), and how many values of layer 0's MLP on [B, 32] rows
    differ from the same rows of it on [B, 64] ("mlp_differ")."""
    from repro_torch.core.index import full_fp32_matmul
    from repro_torch.models import ffn

    tf = T.logits_fn(params, cfg, T.forward(params, cfg, toks)[0])
    t32 = T.logits_fn(params, cfg,
                      T.forward(params, cfg, toks[:, :32])[0])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    h = torch.randn((toks.shape[0], 64, cfg.d_model), generator=gen,
                    device=dev).to(cfg.compute_dtype)
    with full_fp32_matmul():
        whole = ffn.mlp_apply(params.layers[0]["ffn"], h, cfg.mlp_kind)
        part = ffn.mlp_apply(params.layers[0]["ffn"], h[:, :32],
                             cfg.mlp_kind)
    rows = dict(rows=float((t32 - tf[:, :32]).abs().max()),
                mlp_differ=int((whole[:, :32] != part).sum()),
                mlp_values=part.numel())
    del t32, whole, part, h
    logits, caches = model.prefill(params, toks[:, :32], max_len=64)
    out = dict(zip(("prefill", "prefill_median", "prefill_excess"),
                   within(torch, logits, tf[:, 31], SERVE_TOL_F32
                          if cfg.dtype == "float32" else SERVE_TOL_PREFILL)))
    out.update(rows, decode=0.0, decode_median=0.0, decode_excess=-1.0)
    tol = SERVE_TOL_F32 if cfg.dtype == "float32" else SERVE_TOL_DECODE
    for t in range(32, 64):
        logits, caches = model.decode_step(params, toks[:, t], caches,
                                           torch.full((2,), t, device=dev))
        e, med, ex = within(torch, logits, tf[:, t], tol)
        out["decode"] = max(out["decode"], e)
        out["decode_median"] = max(out["decode_median"], med)
        out["decode_excess"] = max(out["decode_excess"], ex)
    return out


def serve_phase(torch, np, dev, *, long_tokens=32768, steps=16,
                docs=65536, smoke=False):
    """phi3-mini-3.8b at its published width and depth (``smoke``: its
    smoke config, for a rehearsal on the CPU), random bf16 weights drawn
    on the card from a seeded generator:

    1. ``repro_torch.launch.serve.main``: 8 requests of 64 tokens, 32 new
       tokens each, 4 slots, a ``docs``-row memory sidecar; every request
       done with 32 tokens, rids unique and in order, the sidecar's
       retrieval launched ``fused_scan_select`` (counter zeroed just
       before, read just after); tokens/s and engine ticks;
    2. decode against forward (2 x 64 tokens, prefill 32, decode 32):
       in float32 at the same width and depth within 1e-4, and in bf16
       measured against the reference's tolerances (the card's bf16
       products round a row differently at another row count, which 32
       layers amplify past them), and the engine against a manual
       greedy loop at its batch shape (2 slots, a 16-token prompt, 8 new
       tokens: equal tokens);
    3. one ``long_tokens`` request from a 32-token alphabet: prefill
       (``max_len`` = S + 64), one exact decode step on the linear caches,
       ``promote_to_retrieval(cache_len=S)``, then ``steps`` retrieval
       decode steps, each launching ``hntl_scan_single`` once per layer,
       with finite logits ``torch.equal`` to the same step through the
       plain scan; the first step's distance from the exact step's logits
       and top-5 overlap (measured, not gated); times, a profile of one
       step, the kernel at this shape beside its bound, index and cache
       bytes, peak memory above the phase's start."""
    import io
    import re

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import tree_bytes
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels import hntl_scan as hs
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.models import hntl_attention as H
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine, promote_to_retrieval

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    cfg = (get_smoke_config if smoke else get_config)(SERVE_ARCH)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    log(f"serve phase: {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, "
        f"{cfg.param_count()} parameters; {base} bytes held at its start")

    # ---- 1. the server, through its entry point ---------------------------
    argv = ["--arch", SERVE_ARCH, "--requests", "8", "--slots", "4",
            "--prompt-len", "64", "--max-new", "32", "--retrieval-docs",
            str(docs), "--seed", "0"]
    argv += ["--smoke"] if smoke else []
    argv += [] if on_card else ["--device", "cpu"]
    buf = io.StringIO()
    fs.fused_scan_select.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        reqs = serve.main(argv)
    sync(torch, dev)
    main_s = time.perf_counter() - t0
    sidecar = fs.fused_scan_select.launches
    text = buf.getvalue()
    for line in text.splitlines():
        log("  " + line)
    check(len(reqs) == 8 and all(r.done and len(r.out) == 32 for r in reqs),
          "serve: a request is not done with 32 tokens")
    check([r.rid for r in reqs] == list(range(8)),
          "serve: the rids are not unique and in order")
    if on_card:
        check(sidecar > 0, "serve: the sidecar's retrieval launched no "
              "fused_scan_select")
    m = re.search(r"\(([0-9.]+) tok/s, ([0-9]+) engine ticks\)", text)
    check(m is not None, "serve: no tokens/s line")
    tok_s, ticks = float(m.group(1)), int(m.group(2))
    log(f"serve: python -m repro_torch.launch.serve {' '.join(argv)}: 8 "
        f"requests done, {sum(len(r.out) for r in reqs)} tokens, "
        f"{tok_s} tok/s over {ticks} engine ticks (the launcher's clock "
        f"around run_to_completion); {main_s:.3f} s in all (init, memory "
        f"build); fused_scan_select launches by the sidecar {sidecar}")
    del reqs
    gc.collect()

    # ---- 2. full-width checks on the short path ---------------------------
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 64))).to(dev)
    dec = {}
    for dt in ("float32", cfg.dtype):
        c = dataclasses.replace(cfg, dtype=dt)
        m = get_model(c)
        p = m.init(0, device=dev)
        dec[dt] = decode_against_forward(torch, T, m, c, p, toks, dev)
        del m, p
        gc.collect()
    e = dec["float32"]
    check(e["prefill_excess"] <= SERVE_TOL_F32
          and e["decode_excess"] <= SERVE_TOL_F32, f"serve: float32 decode "
          f"against forward {e}, beyond {SERVE_TOL_F32} + {SERVE_TOL_F32} |x|")
    for dt, e in dec.items():
        tp, td = ((SERVE_TOL_F32, SERVE_TOL_F32) if dt == "float32"
                  else (SERVE_TOL_PREFILL, SERVE_TOL_DECODE))
        met = e["prefill_excess"] <= tp and e["decode_excess"] <= td
        log(f"serve: decode against forward, {dt} (2 x 64 tokens, prefill "
            f"32 then 32 steps): max |prefill - forward| "
            f"{e['prefill']:.6f} (median {e['prefill_median']:.6f}), max "
            f"|decode - forward| {e['decode']:.6f} (largest step median "
            f"{e['decode_median']:.6f}); tolerance {tp} / {td} + the same "
            f"|x|: {'met' if met else 'NOT met'}; the row count alone: a "
            f"32-token forward against the same rows of the 64-token one "
            f"{e['rows']:.6f}, layer 0's MLP on 32 rows against the same "
            f"rows of 64: {e['mlp_differ']} of {e['mlp_values']} values "
            f"differ"
            + (" (gated)" if dt == "float32" else
               " (measured, not gated: cuBLAS's bf16 products change a row's "
               "rounding with the row count, and 32 layers amplify it)"))
    model = get_model(cfg)
    sync(torch, dev)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"serve: init {init_s:.3f} s, weights {w_bytes} bytes")

    prompt = rng.integers(0, cfg.vocab, size=16)
    eng = ServeEngine(model, params, n_slots=2, max_len=64)
    caches = model.init_cache(2, 64, dev)
    buf_t, pos = np.zeros(2, np.int64), np.zeros(2, np.int64)
    for tok in prompt[:-1]:
        buf_t[:] = 0
        buf_t[0] = tok
        _, caches = model.decode_step(params, torch.from_numpy(buf_t).to(dev),
                                      caches, torch.from_numpy(pos).to(dev))
        pos[0] += 1
    buf_t[0] = prompt[-1]
    manual = []
    for _ in range(8):
        logits, caches = model.decode_step(
            params, torch.from_numpy(buf_t).to(dev), caches,
            torch.from_numpy(pos).to(dev))
        manual.append(int(logits[0].argmax()))
        pos[0] += 1
        buf_t[0] = manual[-1]
    req = eng.submit(prompt, max_new=8)
    eng.run_to_completion()
    check(req.done and req.out == manual, f"serve: the engine's tokens "
          f"{req.out} differ from the manual greedy loop's {manual}")
    log(f"serve: the engine equals a manual greedy loop at its batch shape "
        f"(2 slots, 16-token prompt, 8 new tokens): {manual}")
    del eng, caches

    # ---- 3. one long request on the HNTL-KV path --------------------------
    s = long_tokens
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 32, size=(1, s))).to(dev)
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, toks, max_len=s + 64)
    sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    lin_bytes = sum(tree_bytes(c["mixer"]["k"]) + tree_bytes(c["mixer"]["v"])
                    for c in caches)
    tok = logits.argmax(-1)
    pos = torch.full((1,), s, device=dev)
    exact_ms = []
    for _ in range(2):              # the second call is the one to read
        sync(torch, dev)
        t0 = time.perf_counter()
        l_exact, _ = model.decode_step(params, tok, caches, pos)
        sync(torch, dev)
        exact_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    prom = promote_to_retrieval(model, caches, cache_len=s)
    sync(torch, dev)
    promote_s = time.perf_counter() - t0
    del caches
    g = s // cfg.kv_cap
    check(len(prom) == cfg.n_layers
          and all(isinstance(c["mixer"], H.KVIndex)
                  and c["mixer"].n_grains == g for c in prom),
          f"serve: promote did not give {cfg.n_layers} KVIndex layers of "
          f"{g} grains")
    idx_bytes = sum(tree_bytes(c["mixer"]) for c in prom)
    raw_bytes = sum(tree_bytes(c["mixer"].k_raw) + tree_bytes(
        c["mixer"].v_raw) for c in prom)
    log(f"serve: one {s}-token request ({g} grains of {cfg.kv_cap} tokens "
        f"per KV head and layer): prefill {prefill_s:.3f} s, exact decode "
        f"step {exact_ms[1]:.3f} ms (first call {exact_ms[0]:.3f} ms), "
        f"promote {promote_s:.3f} s; linear caches {lin_bytes} bytes, "
        f"{cfg.n_layers} KVIndex layers {idx_bytes} bytes (raw tier "
        f"{raw_bytes}, a view of the linear caches; grains and tails "
        f"{idx_bytes - raw_bytes})")
    if cfg.kv_nprobe >= g:
        log(f"serve: kv_nprobe = {cfg.kv_nprobe} of {g} grains: every grain "
            "is probed, so this checks the model path, not routing's "
            "saving (phase 8 covers that at 524,288 tokens on one layer)")

    hs.hntl_scan_single.launches = 0
    rows, cur = [], prom
    for i in range(steps):
        p = torch.full((1,), s + i, device=dev)
        before = hs.hntl_scan_single.launches
        sync(torch, dev)
        t0 = time.perf_counter()
        lg, new = model.decode_step(params, tok, cur, p)
        sync(torch, dev)
        t_r = (time.perf_counter() - t0) * 1e3
        n = hs.hntl_scan_single.launches - before
        with unittest.mock.patch.object(H, "ops", PlainScan):
            plain, _ = model.decode_step(params, tok, cur, p)
        check(bool(torch.isfinite(lg).all()), f"serve: retrieval step {i}: "
              "logits not finite")
        check(torch.equal(lg, plain), f"serve: retrieval step {i}: the "
              "kernel path differs from the plain scan's")
        if on_card:
            check(n == cfg.n_layers, f"serve: retrieval step {i} launched "
                  f"hntl_scan_single {n} times, not {cfg.n_layers}")
        row = dict(ms=t_r, launches=n)
        if i == 0:
            row["err"] = float((lg.float() - l_exact.float()).abs().max())
            row["top5"] = len(set(torch.topk(lg[0], 5).indices.tolist())
                              & set(torch.topk(l_exact[0], 5).indices
                                    .tolist()))
            log(f"serve: first retrieval step against the exact step: max "
                f"|logit - exact logit| {row['err']:.6f}, top-5 overlap "
                f"{row['top5']} of 5 (measured, not gated: a random-init "
                "model attends near-uniformly)")
        rows.append(row)
        cur, tok = new, lg.argmax(-1)
        del plain
    launches = hs.hntl_scan_single.launches
    mid = sorted(r["ms"] for r in rows)[len(rows) // 2]
    log(f"serve: {steps} retrieval decode steps, median {mid:.3f} ms "
        f"(exact step {exact_ms[1]:.3f} ms); hntl_scan_single launches "
        f"{launches} ({[r['launches'] for r in rows]}), each step "
        "torch.equal to the plain scan's")
    out = dict(sidecar_launches=sidecar, launches=launches, tok_s=tok_s,
               ticks=ticks, init_s=init_s, prefill_s=prefill_s,
               promote_s=promote_s, exact_ms=exact_ms[1], retrieval_ms=mid,
               err=rows[0]["err"], top5=rows[0]["top5"],
               lin_bytes=lin_bytes, idx_bytes=idx_bytes)
    if on_card:
        p = torch.full((1,), s + steps, device=dev)
        out["profile"] = profile(
            torch, f"one retrieval decode step ({cfg.name}, "
            f"{cfg.n_layers} layers)",
            lambda: model.decode_step(params, tok, cur, p), mid / 1e3)
        first = cur[0]["mixer"]
        qh = first.centroids[:, :, :1].to(torch.float32)
        _, _, scan_args = H._probe(qh, first, cfg)
        out["scan"] = time_scan(
            torch, f"a {cfg.name} decode step's layer", hs.hntl_scan_single,
            ref.hntl_scan_single_ref, scan_args, 1)
        out["peak"] = torch.cuda.max_memory_allocated(dev) - base
        log(f"serve: peak device memory above the phase's start "
            f"{out['peak']} bytes")
    del prom, cur, params
    gc.collect()
    log(f"serve phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 12c: the rest of the model families
# ---------------------------------------------------------------------------

#: Free device bytes the full-depth qwen3-moe-30b-a3b needs: its 61.1e9
#: bytes of bf16 weights and ~10 GB for a 32,768-token prefill (3.2 GB of
#: caches, the expert slabs and the combine's float32 gather).
MOE_FREE_BYTES = 72e9


def state_bytes(tree) -> int:
    """Bytes of every tensor in a cache tree (lists, dicts, ``KVIndex``)."""
    from repro_torch.core import tree_bytes

    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(state_bytes(v) for v in tree)
    return tree_bytes(tree)


class RouterLog:
    """Wraps ``ffn.moe_apply`` while it is entered: each call's routing
    (the stable top-k expert set of every token, [B, S, K] sorted) and the
    (token, expert) pairs its capacity drops, recomputed from the call's
    inputs as the dispatch does."""

    def __init__(self, torch):
        from repro_torch.models import ffn

        self.torch, self.ffn, self.calls = torch, ffn, []
        self._orig = ffn.moe_apply

    def _call(self, params, x, *, top_k, capacity_factor=1.25,
              norm_topk=True):
        torch = self.torch
        b, s, d = x.shape
        e = params["router"].shape[1]
        probs = torch.softmax(x.reshape(-1, d).to(torch.float32)
                              @ params["router"], dim=-1)
        top_e = torch.sort(probs, dim=-1, descending=True,
                           stable=True).indices[:, :top_k]
        counts = torch.bincount(top_e.reshape(-1), minlength=e)
        cap = self.ffn._capacity(b * s, e, top_k, capacity_factor)
        self.calls.append(dict(
            sets=torch.sort(top_e, dim=-1).values.reshape(b, s, top_k),
            dropped=int(torch.clamp(counts - cap, min=0).sum()),
            pairs=b * s * top_k))
        return self._orig(params, x, top_k=top_k,
                          capacity_factor=capacity_factor,
                          norm_topk=norm_topk)

    def __enter__(self):
        self._patch = unittest.mock.patch.object(self.ffn, "moe_apply",
                                                 self._call)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)


def family_decode_check(torch, model, cfg, params, toks, n_prefill=32):
    """``forward``'s logits over ``toks`` [B, S] against an
    ``n_prefill``-token ``prefill`` and S - n_prefill ``decode_step``s:
    max |difference| and the worst excess over rtol |x|, at the float32
    tolerance.  Beside them the card's floor for the same function: an
    ``n_prefill``-token forward against the same rows of the S-token one
    ("rows"; only the products' row count differs).  For an MoE model
    also the (layer, token) rows whose top-k expert set differs between
    forward and decode."""
    from repro_torch.models import transformer as T

    s = toks.shape[1]
    dev = toks.device
    log_ = RouterLog(torch) if cfg.n_experts else contextlib.nullcontext()
    with log_:
        tf = T.logits_fn(params, cfg, T.forward(params, cfg, toks)[0])
        rows = float((T.logits_fn(params, cfg, T.forward(
            params, cfg, toks[:, :n_prefill])[0]) - tf[:, :n_prefill]).abs()
            .max())
        logits, caches = model.prefill(params, toks[:, :n_prefill],
                                       max_len=s)
        out = dict(zip(("prefill", "prefill_median", "prefill_excess"),
                       within(torch, logits, tf[:, n_prefill - 1],
                              SERVE_TOL_F32)))
        out.update(decode=0.0, decode_excess=-1.0, rows=rows)
        for t in range(n_prefill, s):
            logits, caches = model.decode_step(
                params, toks[:, t], caches,
                torch.full((toks.shape[0],), t, device=dev))
            e, _, ex = within(torch, logits, tf[:, t], SERVE_TOL_F32)
            out["decode"] = max(out["decode"], e)
            out["decode_excess"] = max(out["decode_excess"], ex)
    if cfg.n_experts:
        n = cfg.n_layers
        fwd, steps = log_.calls[:n], log_.calls[3 * n:]
        differ = 0
        for i, call in enumerate(steps):
            t, layer = n_prefill + i // n, i % n
            differ += int((call["sets"][:, 0]
                           != fwd[layer]["sets"][:, t]).any(-1).sum())
        out["set_rows_differ"] = differ
        out["set_rows"] = len(steps) * toks.shape[0]
        out["forward_dropped"] = sum(c["dropped"] for c in fwd)
    out["ok"] = (out["prefill_excess"] <= SERVE_TOL_F32
                 and out["decode_excess"] <= SERVE_TOL_F32)
    return out


def log_decode_check(name, e):
    extra = ""
    if "set_rows" in e:
        extra = (f"; top-k expert sets differ between forward and decode "
                 f"in {e['set_rows_differ']} of {e['set_rows']} (layer, "
                 f"token) rows; forward dropped {e['forward_dropped']} "
                 "pairs")
    log(f"families: {name} decode against forward (float32): max |prefill "
        f"- forward| {e['prefill']:.3g}, max |decode - forward| "
        f"{e['decode']:.3g}; tolerance {SERVE_TOL_F32} + the same |x|: "
        f"{'met' if e['ok'] else 'NOT met'}; the row count alone: a 32-token "
        f"forward against the same rows of the 64-token one "
        f"{e['rows']:.3g}{extra}")


def served_tokens(ServeEngine, model, params, prompts, n_slots, max_new,
                  max_len=64):
    """The tokens of ``prompts`` served through one ``n_slots`` engine,
    and the engine."""
    eng = ServeEngine(model, params, n_slots=n_slots, max_len=max_len)
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run_to_completion()
    check(all(r.done and len(r.out) == max_new for r in reqs),
          "families: a request is not done")
    return [r.out for r in reqs], eng


def slot_isolation(torch, name, ServeEngine, model, params, prompts,
                   max_new=8):
    """Each slot isolated: ``prompts`` through one engine of len(prompts)
    slots give each request the tokens it gets alone, through a fresh
    engine of the same slot count (the same batch shape, so a row's
    products round the same way).  A random model often repeats one
    token, so beside the tokens the recurrent state each request ends
    with (slot i together, slot 0 alone) is compared: its largest
    |difference| is reported."""
    n = len(prompts)
    together, eng = served_tokens(ServeEngine, model, params, prompts, n,
                                  max_new)
    alone, diff = [], 0.0
    for i, p in enumerate(prompts):
        out, solo = served_tokens(ServeEngine, model, params, [p], n,
                                  max_new)
        alone.append(out[0])
        for li in eng._recurrent:
            for part in ("mixer", "ffn"):
                for k, v in (eng.caches[li][part] or {}).items():
                    w = solo.caches[li][part][k]
                    diff = max(diff, float((v[i].float() - w[0].float())
                                           .abs().max()))
        del solo
    check(together == alone, f"families: {name}: {n} slots gave "
          f"{together}, each request alone {alone}")
    log(f"families: {name}: {n} requests through {n} slots equal each "
        f"served alone ({[t[:3] for t in together]}...); largest |difference|"
        f" of a request's final recurrent state, together against alone: "
        f"{diff}")
    return diff


def timed_steps(torch, dev, fn, steps):
    """Host ms of ``steps`` calls of ``fn`` (each ending in a
    synchronise): the median and the list."""
    ms = []
    for _ in range(steps):
        sync(torch, dev)
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[len(ms) // 2], ms


def free_card(torch, dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def init_model(torch, dev, cfg):
    """A model of ``cfg`` on ``dev`` (seed 0), timed."""
    from repro_torch.models import get_model

    model = get_model(cfg)
    sync(torch, dev)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    sync(torch, dev)
    return model, params, time.perf_counter() - t0


def retrieval_steps(torch, dev, step, steps, label, n_launch, on_card):
    """``steps`` calls of ``step(i, backend_plain)`` -> (logits, next):
    each kernel step launches ``hntl_scan_single`` ``n_launch`` times
    (counted per step) and ``torch.equal``s the same step through the
    plain scan.  Returns (median ms, launches, per-step rows)."""
    from repro_torch.kernels import hntl_scan as hs
    from repro_torch.models import hntl_attention as H

    rows = []
    for i in range(steps):
        before = hs.hntl_scan_single.launches
        sync(torch, dev)
        t0 = time.perf_counter()
        lg = step(i, False)
        sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        n = hs.hntl_scan_single.launches - before
        with unittest.mock.patch.object(H, "ops", PlainScan):
            plain = step(i, True)
        check(bool(torch.isfinite(lg).all()), f"families: {label} step {i}: "
              "logits not finite")
        check(torch.equal(lg, plain), f"families: {label} step {i}: the "
              "kernel path differs from the plain scan's")
        if on_card:
            check(n == n_launch, f"families: {label} step {i} launched "
                  f"hntl_scan_single {n} times, not {n_launch}")
        rows.append(dict(ms=ms, launches=n))
    mid = sorted(r["ms"] for r in rows)[len(rows) // 2]
    return mid, sum(r["launches"] for r in rows), rows


def moe_family(torch, np, dev, *, long_tokens, steps, smoke, on_card):
    """qwen3-moe-30b-a3b at full width and depth (bf16): the launcher, one
    long request on HNTL-KV, and float32 decode against forward at 4
    layers with no drops; then dbrx-132b cut in depth."""
    import io
    import re

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import hntl_scan as hs
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import hntl_attention as H
    from repro_torch.serve.engine import promote_to_retrieval

    arch = "qwen3-moe-30b-a3b"
    cfg = (get_smoke_config if smoke else get_config)(arch)
    out = {}
    free_card(torch, dev)
    if on_card:
        free, total = torch.cuda.mem_get_info(dev)
        need = 1.0e9 if smoke else MOE_FREE_BYTES
        check(free >= need, f"families: {arch} needs {need:.3g} free device "
              f"bytes ({cfg.param_count() * 2:.4g} of bf16 weights and a "
              f"{long_tokens}-token prefill); {free} of {total} are free")
        log(f"families: {free} of {total} device bytes free before "
            f"{arch} ({cfg.param_count()} parameters, "
            f"{cfg.active_param_count()} active)")

    # ---- the launcher: 4 requests of 32 + 16 tokens on 4 slots ----------
    argv = ["--arch", arch, "--requests", "4", "--slots", "4",
            "--prompt-len", "32", "--max-new", "16", "--seed", "0"]
    argv += ["--smoke"] if smoke else []
    argv += [] if on_card else ["--device", "cpu"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        reqs = serve.main(argv)
    sync(torch, dev)
    main_s = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log("  " + line)
    check(len(reqs) == 4 and all(r.done and len(r.out) == 16 for r in reqs),
          f"families: {arch}: a request is not done with 16 tokens")
    m = re.search(r"\(([0-9.]+) tok/s, ([0-9]+) engine ticks\)",
                  buf.getvalue())
    check(m is not None, "families: no tokens/s line")
    out["tok_s"], out["ticks"] = float(m.group(1)), int(m.group(2))
    log(f"families: python -m repro_torch.launch.serve {' '.join(argv)}: "
        f"4 requests done, {out['tok_s']} tok/s over {out['ticks']} engine "
        f"ticks (the launcher's clock around run_to_completion, 124 "
        f"prompt-feed steps before them); {main_s:.3f} s in all (init "
        "included)")
    del reqs
    free_card(torch, dev)

    # ---- one long request on HNTL-KV --------------------------------------
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    model, params, out["init_s"] = init_model(torch, dev, cfg)
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    s = long_tokens
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 32, size=(1, s))).to(dev)
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, toks, max_len=s + 64)
    sync(torch, dev)
    out["prefill_s"] = time.perf_counter() - t0
    tok = logits.argmax(-1)
    pos = torch.full((1,), s, device=dev)
    holder = {}

    def exact():
        holder["l"], _ = model.decode_step(params, tok, caches, pos)
    out["exact_ms"], _ = timed_steps(torch, dev, exact, 3)
    l_exact = holder.pop("l")
    t0 = time.perf_counter()
    prom = promote_to_retrieval(model, caches, cache_len=s)
    sync(torch, dev)
    out["promote_s"] = time.perf_counter() - t0
    out["lin_bytes"] = state_bytes([c["mixer"] for c in caches])
    del caches
    g = s // cfg.kv_cap
    check(len(prom) == cfg.n_layers and all(
        isinstance(c["mixer"], H.KVIndex) and c["mixer"].n_grains == g
        for c in prom), f"families: promote did not give {cfg.n_layers} "
          f"KVIndex layers of {g} grains")
    out["idx_bytes"] = state_bytes([c["mixer"] for c in prom])
    cur = {"c": prom, "tok": tok}

    def step(i, plain):
        lg, new = model.decode_step(params, cur["tok"], cur["c"],
                                    torch.full((1,), s + i, device=dev))
        if plain:                      # advance after the comparison
            cur["c"], cur["tok"] = new, lg.argmax(-1)
        elif i == 0:
            cur["first"] = lg
        return lg
    hs.hntl_scan_single.launches = 0
    out["retrieval_ms"], out["launches"], rows = retrieval_steps(
        torch, dev, step, steps, f"{arch} retrieval", cfg.n_layers, on_card)
    first = cur.pop("first")
    out["err"] = float((first.float() - l_exact.float()).abs().max())
    out["top5"] = len(set(torch.topk(first[0], 5).indices.tolist())
                      & set(torch.topk(l_exact[0], 5).indices.tolist()))
    log(f"families: {arch}: init {out['init_s']:.3f} s ({w_bytes} bytes "
        f"of weights); one {s}-token request: prefill {out['prefill_s']:.3f}"
        f" s, exact step {out['exact_ms']:.3f} ms, promote "
        f"{out['promote_s']:.3f} s to {cfg.n_layers} KVIndex layers of {g} "
        f"grains ({out['idx_bytes']} bytes, raw tier a view of the "
        f"{out['lin_bytes']} bytes of linear caches); {steps} retrieval "
        f"steps, median {out['retrieval_ms']:.3f} ms, hntl_scan_single "
        f"launches {out['launches']} ({[r['launches'] for r in rows]}), "
        f"each torch.equal to the plain scan's; first step against the "
        f"exact one: max |logit - exact| {out['err']:.4f}, top-5 overlap "
        f"{out['top5']} of 5 (measured, not gated)")
    if on_card:
        p = torch.full((1,), s + steps, device=dev)
        out["profile"] = profile(
            torch, f"one retrieval decode step ({arch}, {cfg.n_layers} "
            "layers)", lambda: model.decode_step(params, cur["tok"], cur["c"],
                                                 p),
            out["retrieval_ms"] / 1e3)
        idx0 = cur["c"][0]["mixer"]
        _, _, scan_args = H._probe(
            idx0.centroids[:, :, :1].to(torch.float32).expand(
                -1, -1, cfg.n_heads // cfg.n_kv_heads, -1).contiguous(),
            idx0, cfg)
        out["scan"] = time_scan(
            torch, f"a {arch} decode step's layer", hs.hntl_scan_single,
            ref.hntl_scan_single_ref, scan_args, 1)
        out["peak"] = torch.cuda.max_memory_allocated(dev)
        log(f"families: {arch} peak device memory {out['peak']} bytes")
    del prom, cur, params, model, first, l_exact, logits
    free_card(torch, dev)

    # ---- float32 decode against forward, depth cut, no drops -------------
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 64))).to(dev)
    c32 = dataclasses.replace(
        cfg, dtype="float32", n_layers=min(4, cfg.n_layers),
        capacity_factor=cfg.n_experts / cfg.moe_top_k)
    model, params, _ = init_model(torch, dev, c32)
    e = family_decode_check(torch, model, c32, params, toks)
    log_decode_check(f"{arch} at {c32.n_layers} of {cfg.n_layers} layers, "
                     f"capacity factor {c32.capacity_factor}", e)
    check(e["ok"], f"families: {arch} float32 decode against forward {e}")
    from repro_torch.models import transformer as T
    with RouterLog(torch) as rl:
        T.forward(params, dataclasses.replace(
            c32, capacity_factor=cfg.capacity_factor), toks)
    out["published_dropped"] = sum(c["dropped"] for c in rl.calls)
    out["published_pairs"] = sum(c["pairs"] for c in rl.calls)
    log(f"families: {arch} at the published capacity factor "
        f"{cfg.capacity_factor}: a 2 x 64-token forward drops "
        f"{out['published_dropped']} of {out['published_pairs']} (token, "
        f"expert) pairs over {c32.n_layers} layers")
    out["decode_check"] = e
    del model, params
    free_card(torch, dev)

    # ---- dbrx-132b: full width, depth cut ---------------------------------
    arch = "dbrx-132b"
    dcfg = (get_smoke_config if smoke else get_config)(arch)
    c32 = dataclasses.replace(dcfg, dtype="float32", n_layers=2,
                              capacity_factor=dcfg.n_experts
                              / dcfg.moe_top_k)
    model, params, init_s = init_model(torch, dev, c32)
    e = family_decode_check(torch, model, c32, params, toks % dcfg.vocab)
    log_decode_check(f"{arch} at 2 of {dcfg.n_layers} layers (init "
                     f"{init_s:.3f} s)", e)
    check(e["ok"], f"families: {arch} float32 decode against forward {e}")
    out["dbrx_check"] = e
    del model, params
    free_card(torch, dev)
    c16 = dataclasses.replace(dcfg, n_layers=4)
    model, params, init_s = init_model(torch, dev, c16)
    _, caches = model.prefill(params, toks[:1, :32] % dcfg.vocab, max_len=64)
    tok = torch.ones(1, dtype=torch.long, device=dev)

    def dstep():
        model.decode_step(params, tok, caches, torch.full((1,), 32,
                                                          device=dev))
    dstep()
    out["dbrx_step_ms"], _ = timed_steps(torch, dev, dstep, 5)
    log(f"families: {arch} bf16 at 4 of {dcfg.n_layers} layers: init "
        f"{init_s:.3f} s, B=1 decode step {out['dbrx_step_ms']:.3f} ms "
        "(median of 5)")
    del model, params, caches
    free_card(torch, dev)
    return out


def recurrent_families(torch, np, dev, *, rg_tokens, rwkv_tokens, steps,
                       smoke, on_card):
    """recurrentgemma-9b and rwkv6-1.6b at full width and depth: float32
    decode against forward, slot isolation in bf16, prefills of 1/8 of
    the long request and of all of it, with step times and the state's
    bytes at both."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.serve.engine import ServeEngine

    out = {}
    rng = np.random.default_rng(0)
    # rwkv6 is gated at one layer: at its random init the card's float32
    # products at another row count alone move its 24-layer logits by
    # ~1.3 (the "rows" floor, printed beside the full-depth run, which is
    # measured, not gated)
    for arch, long_s, gate_layers in (
            ("recurrentgemma-9b", rg_tokens, None),
            ("rwkv6-1.6b", rwkv_tokens, 1)):
        cfg = (get_smoke_config if smoke else get_config)(arch)
        r = out[arch] = {}
        toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                             size=(2, 64))).to(dev)
        for depth in ((gate_layers, cfg.n_layers) if gate_layers
                      else (cfg.n_layers,)):
            c32 = dataclasses.replace(cfg, dtype="float32", n_layers=depth)
            model, params, init_s = init_model(torch, dev, c32)
            e = family_decode_check(torch, model, c32, params, toks)
            gated = depth == (gate_layers or cfg.n_layers)
            log_decode_check(f"{arch} at {depth} of {cfg.n_layers} layers "
                             f"(init {init_s:.3f} s; "
                             f"{'gated' if gated else 'measured, not gated'})",
                             e)
            if gated:
                check(e["ok"], f"families: {arch} float32 decode against "
                      f"forward at {depth} layers {e}")
                r["decode_check"] = e
            else:
                r["decode_full_depth"] = e
            del model, params
            free_card(torch, dev)

        model, params, r["init_s"] = init_model(torch, dev, cfg)
        prompts = [rng.integers(0, cfg.vocab, size=16) for _ in range(4)]
        r["isolated"] = slot_isolation(torch, arch, ServeEngine, model,
                                       params, prompts)
        # step time and state bytes at two context lengths
        tok = torch.ones(1, dtype=torch.long, device=dev)
        short_s = max(cfg.kv_cap if smoke else 256, long_s // 8)
        for s in (short_s, long_s):
            ids = torch.from_numpy(rng.integers(0, cfg.vocab,
                                                size=(1, s))).to(dev)
            sync(torch, dev)
            t0 = time.perf_counter()
            _, caches = model.prefill(params, ids, max_len=s + 64)
            sync(torch, dev)
            prefill_s = time.perf_counter() - t0

            def step():
                model.decode_step(params, tok, caches,
                                  torch.full((1,), s, device=dev))
            step()
            ms, _ = timed_steps(torch, dev, step, steps)
            r[s] = dict(prefill_s=prefill_s, step_ms=ms,
                        state_bytes=state_bytes(caches))
            log(f"families: {arch} bf16, a {s}-token request: prefill "
                f"{prefill_s:.3f} s ({s / prefill_s:.1f} tokens/s), decode "
                f"step median {ms:.3f} ms of {steps}, state "
                f"{r[s]['state_bytes']} bytes")
        short, long_ = r[short_s], r[long_s]
        check(short["state_bytes"] == long_["state_bytes"],
              f"families: {arch}: the state grew with context "
              f"({short['state_bytes']} -> {long_['state_bytes']} bytes)")
        check(long_["step_ms"] <= 1.5 * short["step_ms"] + 1.0,
              f"families: {arch}: the step time grew with context "
              f"({short['step_ms']:.3f} -> {long_['step_ms']:.3f} ms)")
        if on_card:
            r["profile"] = profile(
                torch, f"one decode step ({arch}, {cfg.n_layers} layers, "
                f"{long_s}-token context)", step, long_["step_ms"] / 1e3)
        del model, params, caches
        free_card(torch, dev)
    return out


def whisper_family(torch, np, dev, *, window, long_frames, steps, smoke,
                   on_card):
    """whisper-base at full width: a 30 s window encoded and decoded
    exactly, then a long encoder memory on HNTL-KV cross-attention."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import hntl_scan as hs
    from repro_torch.kernels import ref
    from repro_torch.models import encdec as E
    from repro_torch.models import hntl_attention as H

    arch = "whisper-base"
    cfg = (get_smoke_config if smoke else get_config)(arch)
    out = {}
    rng = np.random.default_rng(2)
    # ---- one window, exact cross-attention, float32 against decode -------
    c32 = dataclasses.replace(cfg, dtype="float32")
    model, params, _ = init_model(torch, dev, c32)
    frames = torch.from_numpy(rng.standard_normal(
        (1, window, cfg.d_model)).astype(np.float32)).to(dev)
    mem = model.encode(params, frames)
    cross = E.build_cross_cache(params, c32, mem)
    sc = E.init_self_cache(c32, 1, dev)
    tok, toks, logit_rows = torch.zeros(1, dtype=torch.long, device=dev), \
        [], []
    for t in range(32):
        toks.append(tok)
        lg, sc = model.encdec_decode_step(params, tok, sc, cross,
                                          torch.full((1,), t, device=dev))
        logit_rows.append(lg)
        tok = lg.argmax(-1)
    forced = E.logits_fn(params, E.decode(params, c32, torch.stack(toks, 1),
                                          mem))
    e = within(torch, torch.stack(logit_rows, 1), forced, SERVE_TOL_F32)
    check(e[2] <= SERVE_TOL_F32, f"families: {arch} 32 exact decode steps "
          f"against the teacher-forced decode: {e}")
    log(f"families: {arch} (float32): {window} frames encoded, 32 greedy "
        f"tokens decoded on exact cross-attention, equal to the "
        f"teacher-forced decode within {SERVE_TOL_F32} (max |diff| "
        f"{e[0]:.3g})")
    del model, params, mem, cross, sc
    free_card(torch, dev)

    # ---- bf16: the window's step time, then the long memory --------------
    model, params, out["init_s"] = init_model(torch, dev, cfg)
    sync(torch, dev)
    t0 = time.perf_counter()
    mem = model.encode(params, frames.to(cfg.compute_dtype))
    sync(torch, dev)
    out["encode_window_s"] = time.perf_counter() - t0
    cross = E.build_cross_cache(params, cfg, mem)
    sc = E.init_self_cache(cfg, 1, dev)
    one = torch.ones(1, dtype=torch.long, device=dev)
    out["window_step_ms"], _ = timed_steps(
        torch, dev, lambda: model.encdec_decode_step(
            params, one, sc, cross, torch.zeros(1, dtype=torch.long,
                                                device=dev)), 8)
    del mem, cross
    long_x = torch.from_numpy(rng.standard_normal(
        (1, long_frames, cfg.d_model)).astype(np.float32)).to(dev) \
        .to(cfg.compute_dtype)
    sync(torch, dev)
    t0 = time.perf_counter()
    mem = model.encode(params, long_x)
    sync(torch, dev)
    out["encode_s"] = time.perf_counter() - t0
    del long_x
    t0 = time.perf_counter()
    idx = E.build_cross_index(params, cfg, mem)
    sync(torch, dev)
    out["index_s"] = time.perf_counter() - t0
    g = long_frames // cfg.kv_cap
    check(len(idx) == cfg.n_layers and all(
        isinstance(i, H.KVIndex) and i.n_grains == g for i in idx),
        f"families: {arch}: build_cross_index did not give "
        f"{cfg.n_layers} indexes of {g} grains")
    out["idx_bytes"] = state_bytes(idx)
    cross = E.build_cross_cache(params, cfg, mem)
    cur = {"sc": E.init_self_cache(cfg, 1, dev), "tok": one, "err": [],
           "top5": []}

    def step(i, plain):
        p = torch.full((1,), i, device=dev)
        lg, new = E.decode_step_retrieval(params, cfg, cur["tok"], cur["sc"],
                                          idx, p)
        if plain:                      # advance after the comparison
            exact, _ = model.encdec_decode_step(params, cur["tok"],
                                                cur["sc"], cross, p)
            cur["err"].append(float((lg.float() - exact.float()).abs()
                                    .max()))
            cur["top5"].append(len(
                set(torch.topk(lg[0], 5).indices.tolist())
                & set(torch.topk(exact[0], 5).indices.tolist())))
            cur["sc"], cur["tok"] = new, lg.argmax(-1)
        return lg
    hs.hntl_scan_single.launches = 0
    out["retrieval_ms"], out["launches"], rows = retrieval_steps(
        torch, dev, step, steps, f"{arch} retrieval cross-attention",
        cfg.n_layers, on_card)
    out["err"], out["top5"] = max(cur["err"]), min(cur["top5"])
    log(f"families: {arch} bf16: init {out['init_s']:.3f} s; a {window}"
        f"-frame window encoded in {out['encode_window_s']:.3f} s, exact "
        f"step {out['window_step_ms']:.3f} ms; {long_frames} frames "
        f"encoded in {out['encode_s']:.3f} s, build_cross_index "
        f"{out['index_s']:.3f} s ({cfg.n_layers} indexes of {g} grains per "
        f"head, kv_nprobe {cfg.kv_nprobe}; {out['idx_bytes']} bytes); "
        f"{steps} decode_step_retrieval steps, median "
        f"{out['retrieval_ms']:.3f} ms, hntl_scan_single launches "
        f"{out['launches']} ({[r['launches'] for r in rows]}), each "
        f"torch.equal to the plain scan's; against exact cross-attention: "
        f"max |logit - exact| {out['err']:.4f}, least top-5 overlap "
        f"{out['top5']} of 5 (measured, not gated)")
    if on_card:
        p = torch.full((1,), steps, device=dev)
        out["profile"] = profile(
            torch, f"one decode_step_retrieval ({arch}, {cfg.n_layers} "
            "layers)", lambda: E.decode_step_retrieval(
                params, cfg, cur["tok"], cur["sc"], idx, p),
            out["retrieval_ms"] / 1e3)
        qh = idx[0].centroids[:, :, :1].to(torch.float32)
        _, _, scan_args = H._probe(qh, idx[0], cfg)
        out["scan"] = time_scan(
            torch, f"a {arch} retrieval cross-attention layer",
            hs.hntl_scan_single, ref.hntl_scan_single_ref, scan_args, 1)
    del model, params, mem, idx, cross, cur
    free_card(torch, dev)
    return out


def families_phase(torch, np, dev, *, long_tokens=32768, steps=8,
                   rg_tokens=32768, rwkv_tokens=2048, window=1500,
                   whisper_frames=65536, smoke=False):
    """The rest of the model families, each at its published width (random
    weights from seed 0; ``smoke``: the smoke configs, for a rehearsal on
    the CPU): qwen3-moe-30b-a3b at full depth (the launcher, a
    ``long_tokens`` request promoted to HNTL-KV and ``steps`` retrieval
    steps, float32 decode against forward at 4 layers), dbrx-132b at 2
    and 4 of 40 layers, recurrentgemma-9b and rwkv6-1.6b at full depth
    (float32 decode against forward, slot isolation, long prefills), and
    whisper-base (a ``window``-frame window decoded exactly, a
    ``whisper_frames`` memory on HNTL-KV cross-attention)."""
    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    free_card(torch, dev)
    out = dict(moe=moe_family(torch, np, dev, long_tokens=long_tokens,
                              steps=steps, smoke=smoke, on_card=on_card))
    t_moe = time.perf_counter() - t_phase
    out["recurrent"] = recurrent_families(
        torch, np, dev, rg_tokens=rg_tokens, rwkv_tokens=rwkv_tokens,
        steps=16, smoke=smoke, on_card=on_card)
    t_rec = time.perf_counter() - t_phase - t_moe
    out["whisper"] = whisper_family(
        torch, np, dev, window=window, long_frames=whisper_frames,
        steps=2 * steps, smoke=smoke, on_card=on_card)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"families phase: {out['seconds']:.1f} s (MoE {t_moe:.1f} s, "
        f"recurrent {t_rec:.1f} s, whisper "
        f"{out['seconds'] - t_moe - t_rec:.1f} s)")
    return out


# ---------------------------------------------------------------------------
# 12d: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "phi3-mini-3.8b"
#: (a), (b) and (d) cut phi3-mini to this many layers at full width.
TRAIN_CUT_LAYERS = 2
#: (a): B x S; the card's loss against the CPU's (rtol), and each
#: gradient leaf within TRAIN_GRAD_TOL * its own max |g_cpu|.  (b) holds
#: the accumulated gradients to the whole batch's in the same way.
TRAIN_GRAD_SHAPE = (2, 256)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
#: (b): B x S; tests/test_train.py's tolerances for microbatch
#: equivalence (loss rtol, parameter rtol and atol) and resume (rtol,
#: atol).
TRAIN_MB_SHAPE = (4, 256)
TRAIN_MB_TOL = (2e-2, 5e-2, 4e-3)
TRAIN_RESUME_TOL = (1e-3, 1e-4)
#: (d) and (e): B x S, and the steps of (d)'s uninterrupted run and (e).
TRAIN_SHAPE = (8, 1024)
TRAIN_STEPS = 20
#: (f): qwen3-moe at full width cut to this many layers, B x S, steps;
#: whisper-base's B x tokens, frames and steps.
TRAIN_MOE = dict(layers=2, b=4, s=512, steps=3)
TRAIN_WHISPER = dict(b=4, s=128, frames=1500, steps=10)
#: Free device bytes (e) needs: 7.6 GB of bf16 parameters, 30.6 GB of
#: float32 moments, 15.3 GB of float32 gradients, activations and logits.
TRAIN_FREE_BYTES = 66e9


class TimedOptimizer:
    """An optimizer whose ``update`` is timed with CUDA events (each
    update ends in a synchronise: ms)."""

    def __init__(self, torch, opt):
        self.torch, self.opt, self.ms = torch, opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, *args):
        torch = self.torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.opt.update(*args)
        end.record()
        torch.cuda.synchronize()
        self.ms.append(start.elapsed_time(end))
        return out


def kernel_kinds(by_kernel: dict) -> dict:
    """Device ms by kind of kernel, from its name: float32 GEMMs (FFMA,
    off the tensor cores), other GEMMs (bf16 tensor cores), copies and
    casts, elementwise, reductions, the rest."""
    kinds = dict.fromkeys(("float32 GEMM", "bf16 GEMM", "copy/cast",
                           "elementwise", "reduction", "other"), 0.0)
    for key, ms in by_kernel.items():
        k = key.lower()
        if "gemm" in k or "nvjet" in k or "cutlass" in k:
            kind = "float32 GEMM" if ("f32f32" in k or "sgemm" in k
                                      or "ffma" in k) else "bf16 GEMM"
        elif "copy" in k:
            kind = "copy/cast"
        elif "elementwise" in k:
            kind = "elementwise"
        elif "reduce" in k or "softmax" in k or "norm" in k:
            kind = "reduction"
        else:
            kind = "other"
        kinds[kind] += ms
    return kinds


def train_leaves(state):
    """{name: tensor} of a train state: parameters and both moments."""
    out = {f"params.{k}": v.detach()
           for k, v in state.params.named_parameters()}
    for part in ("m", "v"):
        out.update({f"{part}.{k}": v
                    for k, v in state.opt_state[part].items()})
    return out


class GradCapture:
    """An optimizer that keeps a copy of the (float32, averaged)
    gradients each ``update`` is given."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, *args):
        self.grads = {k: v.clone() for k, v in grads.items()}
        return self.opt.update(grads, *args)


def card_model(torch, dev, copies=1):
    """phi3-mini at full width cut to TRAIN_CUT_LAYERS layers, float32:
    the model and ``copies`` identical parameter trees on ``dev`` (seed
    0)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CUT_LAYERS, dtype="float32")
    model = get_model(cfg)
    return cfg, model, [model.init(0, device=dev) for _ in range(copies)]


def worst_grad(got: dict, want: dict):
    """(the largest max |got - want| / (TRAIN_GRAD_TOL max |want|) over
    the leaves, its leaf).  A leaf whose ``want`` is all zero must be
    zero; a NaN counts as infinitely far."""
    worst, worst_name = 0.0, None
    for k, w in want.items():
        err = float((got[k].to(w.device) - w).abs().max())
        limit = TRAIN_GRAD_TOL * float(w.abs().max())
        ratio = err / limit if limit > 0 else (0.0 if err == 0 else
                                               float("inf"))
        if ratio != ratio:
            ratio = float("inf")
        if ratio > worst or worst_name is None:
            worst, worst_name = ratio, k
    return worst, worst_name


def train_grad_check(torch, np, dev):
    """(a) the loss and every gradient of phi3-mini cut to
    TRAIN_CUT_LAYERS layers (float32) on the card against the same
    model's on the CPU, both under ``full_fp32_matmul`` (the backward and
    remat's recomputation too)."""
    from repro_torch.core.index import full_fp32_matmul
    from repro_torch.data.tokens import MarkovLM

    b, s = TRAIN_GRAD_SHAPE
    cfg, model, (on_card, on_cpu) = card_model(torch, dev, 2)
    on_cpu = on_cpu.to("cpu")
    batch = MarkovLM(vocab=cfg.vocab, seed=0).batch(0, b, s)
    out = {}
    for params in (on_card, on_cpu):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        d = params.device
        t0 = time.perf_counter()
        with full_fp32_matmul():
            loss, _ = model.loss(params, {k: torch.from_numpy(v).to(d)
                                          for k, v in batch.items()})
            grads = torch.autograd.grad(loss, list(named.values()))
        sync(torch, d)
        out[d.type] = (float(loss.detach()), dict(zip(named, grads)),
                       time.perf_counter() - t0)
    loss_card, g_card, s_card = out[dev.type]
    loss_cpu, g_cpu, s_cpu = out["cpu"]
    worst, worst_name = worst_grad(g_card, g_cpu)
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log(f"train (a): {cfg.name} at {cfg.n_layers} layers, float32, B={b} "
        f"S={s}: loss card {loss_card:.7f} cpu {loss_cpu:.7f} (rel "
        f"{rel:.3g}, limit {TRAIN_LOSS_RTOL}); {len(g_cpu)} gradients, worst"
        f" |card - cpu| at {worst:.3g} of its limit ({worst_name}); card "
        f"{s_card:.2f} s, cpu {s_cpu:.2f} s")
    check(rel <= TRAIN_LOSS_RTOL, f"train (a): loss card {loss_card} cpu "
          f"{loss_cpu}")
    check(worst <= 1.0, f"train (a): gradient {worst_name} at {worst:.3g} "
          "of its limit")
    del on_card, on_cpu, g_card, g_cpu, out
    free_card(torch, dev)
    return dict(loss_rel=rel, grad_worst=worst, card_s=s_card, cpu_s=s_cpu)


def train_microbatches(torch, np, dev):
    """(b) one step over 4 microbatches against one over the whole batch:
    the float32 gradients the optimizer is given, leaf by leaf as in (a)
    (a first Adam step at eps 1e-8 moves each element by about lr
    whatever its gradient, so the parameters alone would pass a step
    that dropped or misweighted a microbatch), then the loss and the
    parameters within ``tests/test_train.py``'s tolerances."""
    from repro_torch.data.tokens import MarkovLM
    from repro_torch.optim.adamw import AdamW, constant
    from repro_torch.train.step import TrainState, make_train_step

    b, s = TRAIN_MB_SHAPE
    cfg, model, states = card_model(torch, dev, 2)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             MarkovLM(vocab=cfg.vocab, seed=2).batch(0, b, s).items()}
    out, grads = [], []
    for n, params in zip((1, 4), states):
        opt = GradCapture(AdamW(lr=constant(1e-3), max_grad_norm=None))
        state = TrainState(params.requires_grad_(True), opt.init(params), 0)
        state, metrics = make_train_step(model, opt, microbatches=n)(state,
                                                                     batch)
        out.append((float(metrics["loss"]), state))
        grads.append(opt.grads)
    g_worst, g_name = worst_grad(grads[1], grads[0])
    del grads
    loss_rtol, rtol, atol = TRAIN_MB_TOL
    rel = abs(out[0][0] - out[1][0]) / abs(out[0][0])
    worst, excess = 0.0, -1.0
    for (k, a), (_, c) in zip(out[0][1].params.named_parameters(),
                              out[1][1].params.named_parameters()):
        diff = (a.detach() - c.detach()).abs()
        worst = max(worst, float(diff.max()))
        excess = max(excess, float((diff - atol - rtol * c.detach().abs())
                                   .max()))
    log(f"train (b): microbatches=4 against 1 (B={b} S={s}, float32): "
        f"gradients worst |4 - 1| at {g_worst:.3g} of its limit ({g_name});"
        f" loss {out[1][0]:.6f} / {out[0][0]:.6f} (rel {rel:.3g}, limit "
        f"{loss_rtol}); parameters max |diff| {worst:.3g} (limit {atol} + "
        f"{rtol} |x|: {'met' if excess <= 0 else 'NOT met'})")
    check(g_worst <= 1.0, f"train (b): the accumulated gradient {g_name} "
          f"at {g_worst:.3g} of its limit")
    check(rel <= loss_rtol and excess <= 0, "train (b): microbatches=4 "
          "differs from 1 beyond tests/test_train.py's tolerances")
    del states, out
    free_card(torch, dev)
    return dict(grad_worst=g_worst, loss_rel=rel, param_max_diff=worst,
                param_excess=excess)


def train_convergence(torch, np, dev, tmp):
    """(c) ``tests/test_train.py::test_loss_decreases_on_markov_data`` on
    the card: 40 steps of the tiny phi3-mini (2 layers, vocab 128)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import MarkovLM
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_smoke_config(TRAIN_ARCH), n_layers=2,
                              vocab=128)
    data = MarkovLM(vocab=cfg.vocab, seed=0)
    trainer = Trainer(
        get_model(cfg), AdamW(lr=warmup_cosine(3e-3, 5, 60)),
        lambda step: {k: torch.from_numpy(v).to(dev)
                      for k, v in data.batch(step, 8, 32).items()},
        TrainerConfig(total_steps=40, ckpt_every=20, log_every=20,
                      ckpt_dir=os.path.join(tmp, "converge")), device=dev)
    t0 = time.perf_counter()
    trainer.run()
    wall = time.perf_counter() - t0
    losses = [h["loss"] for h in trainer.history]
    log(f"train (c): tiny {TRAIN_ARCH} (2 layers, vocab 128), 40 steps on "
        f"MarkovLM in {wall:.2f} s: loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        f" (needs < {losses[0] - 0.5:.4f} and < ln 128 = "
        f"{np.log(cfg.vocab):.4f})")
    check(losses[-1] < losses[0] - 0.5 and losses[-1] < np.log(cfg.vocab),
          f"train (c): loss {losses[0]} -> {losses[-1]}")
    return dict(first=losses[0], last=losses[-1], s=wall)


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def train_resume(torch, np, dev, tmp):
    """(d) ``launch.train.main`` on phi3-mini cut to TRAIN_CUT_LAYERS
    layers at full width (bf16): a run stopped by SIGTERM after
    TRAIN_STEPS // 2 steps (a periodic async save at TRAIN_STEPS // 4,
    the final save at TRAIN_STEPS // 2), resumed to TRAIN_STEPS, against
    an uninterrupted run in a fresh directory, every leaf; then the NaN
    guard."""
    import signal

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train

    cut = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CUT_LAYERS)
    (b, s), steps = TRAIN_SHAPE, TRAIN_STEPS
    layers, half = TRAIN_CUT_LAYERS, steps // 2
    orig_batch = launch_train.MarkovLM.batch

    def argv(d, every, extra=()):
        return ["--arch", TRAIN_ARCH, "--steps", str(steps), "--batch",
                str(b), "--seq", str(s), "--ckpt-dir", os.path.join(tmp, d),
                "--ckpt-every", str(every), "--device", str(dev), *extra]

    def preempted(self, step, *a, **kw):        # SIGTERM during step half-1
        if step == half - 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig_batch(self, step, *a, **kw)

    walls = {}
    with unittest.mock.patch.object(launch_train, "get_config",
                                    lambda arch: cut):
        t0 = time.perf_counter()
        with unittest.mock.patch.object(launch_train.MarkovLM, "batch",
                                        preempted):
            first = launch_train.main(argv("resume", steps // 4))
        walls["preempted"] = time.perf_counter() - t0
        check(first.step == half, f"train (d): the SIGTERM run stopped at "
              f"step {first.step}, not {half}")
        saved = sorted(os.listdir(os.path.join(tmp, "resume")))
        ckpt_bytes = dir_bytes(os.path.join(tmp, "resume", saved[-1]))
        del first
        free_card(torch, dev)
        t0 = time.perf_counter()
        resumed = launch_train.main(argv("resume", steps // 4))
        walls["resumed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        straight = launch_train.main(argv("straight", 1000))
        walls["straight"] = time.perf_counter() - t0
        check(resumed.step == straight.step == steps
              and resumed.opt_state["count"] == steps,
              f"train (d): steps {resumed.step} / {straight.step}")
        rtol, atol = TRAIN_RESUME_TOL
        got, want = train_leaves(resumed), train_leaves(straight)
        worst, excess, equal = 0.0, -1.0, 0
        for k, w in want.items():
            diff = (got[k].float() - w.float()).abs()
            worst = max(worst, float(diff.max()))
            excess = max(excess, float((diff - atol - rtol * w.float().abs())
                                       .max()))
            equal += int(torch.equal(got[k], w))
        log(f"train (d): {TRAIN_ARCH} at {layers} layers, bf16, B={b} "
            f"S={s}: SIGTERM at step {half} (saves {saved}, "
            f"{ckpt_bytes} bytes each), resumed to {steps}, against "
            f"{steps} straight: {equal} of {len(want)} leaves bit-equal, "
            f"max |diff| {worst:.3g} (limit {atol} + {rtol} |x|: "
            f"{'met' if excess <= 0 else 'NOT met'}); wall "
            + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
        check(excess <= 0, "train (d): the resumed run differs from the "
              "uninterrupted one beyond tests/test_train.py's tolerance")
        n_leaves = len(want)
        del resumed, straight, got, want
        free_card(torch, dev)
        try:
            launch_train.main(argv("nan", 1000, ("--lr", "nan")))
        except FloatingPointError as e:
            log(f"train (d): NaN guard: FloatingPointError ({e})")
        else:
            raise SmokeFailure("train (d): lr = nan did not raise "
                               "FloatingPointError")
    free_card(torch, dev)
    return dict(ckpt_bytes=ckpt_bytes, bit_equal=equal, leaves=n_leaves,
                max_diff=worst, walls=walls)


def train_full(torch, np, dev):
    """(e) phi3-mini-3.8b at its published width and depth (bf16)
    through ``init_state`` / ``make_train_step``: TRAIN_STEPS steps with
    finite losses; step ms, tokens/s, the optimizer's share, peak memory,
    then one more step profiled (busy share, top device ops)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import MarkovLM
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.step import init_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    (b, s), steps = TRAIN_SHAPE, TRAIN_STEPS
    free, total = torch.cuda.mem_get_info(dev)
    log(f"train (e): {free} of {total} device bytes free "
        f"({torch.cuda.memory_allocated(dev)} allocated)")
    check(free >= TRAIN_FREE_BYTES, f"train (e): {free} bytes free, "
          f"needs {TRAIN_FREE_BYTES:.0f}")
    torch.cuda.reset_peak_memory_stats(dev)
    model = get_model(cfg)
    data = MarkovLM(vocab=cfg.vocab, seed=0)
    t0 = time.perf_counter()
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i, b, s).items()}
               for i in range(steps + 1)]
    data_s = time.perf_counter() - t0
    opt = TimedOptimizer(torch, AdamW(lr=warmup_cosine(3e-4, 2, steps)))
    sync(torch, dev)
    t0 = time.perf_counter()
    state = init_state(model, opt, 0, dev)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state.params.parameters())
    step = make_train_step(model, opt)
    ms, losses = [], []
    for i in range(steps):
        sync(torch, dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        losses.append(float(metrics["loss"]))
        sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"train (e): losses {losses}")
    steady = sorted(ms[1:])
    mid = steady[len(steady) // 2]
    opt_ms = sorted(opt.ms[1:steps])[len(opt.ms[1:steps]) // 2]
    out = dict(params=n_params, init_s=init_s, data_s=data_s,
               first_ms=ms[0], step_ms=mid, step_ms_all=ms,
               tokens_per_s=b * s / (mid / 1e3), losses=losses,
               peak=torch.cuda.max_memory_allocated(dev), opt_ms=opt_ms,
               opt_share=opt_ms / mid)
    log(f"train (e): {cfg.name}, {cfg.n_layers} layers x {cfg.d_model}, "
        f"{n_params} parameters, {cfg.dtype}, remat {cfg.remat_policy}, "
        f"B={b} S={s}: init {init_s:.2f} s, data {data_s:.2f} s; step 1 "
        f"{ms[0]:.1f} ms, then median {mid:.1f} ms (min {steady[0]:.1f}, "
        f"max {steady[-1]:.1f}), {out['tokens_per_s']:.0f} tokens/s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, all finite; optimizer "
        f"{opt_ms:.1f} ms a step (share {out['opt_share']:.3f}); peak "
        f"device memory {out['peak']} bytes")
    box = {"state": state}

    def one():
        box["state"], _ = step(box["state"], batches[steps])
    out["profile"] = profile(torch, f"one {cfg.name} train step "
                             f"(B={b} S={s})", one, mid / 1e3, top=12)
    del box
    if out["profile"]:
        kinds = kernel_kinds(out["profile"]["by_kernel"])
        total = sum(kinds.values())
        log("train (e): the profiled step's device time by kind: "
            + ", ".join(f"{k} {v:.1f} ms ({v / total:.1%})"
                        for k, v in kinds.items()))
    del state, batches
    free_card(torch, dev)
    return out


def train_families(torch, np, dev):
    """(f) qwen3-moe-30b-a3b at full width cut in depth (bf16): its router
    gradients finite and nonzero, a few steps with finite losses and
    aux > 0; whisper-base at full width and depth: steps on 1,500-frame
    inputs, losses finite (sizes: TRAIN_MOE, TRAIN_WHISPER)."""
    from repro_torch.configs import get_config
    from repro_torch.core.index import full_fp32_matmul
    from repro_torch.data.tokens import MarkovLM
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, constant
    from repro_torch.train.step import (init_state, make_train_step,
                                        value_and_grad)

    out = {}
    moe_layers, moe_b, moe_s, moe_steps = (
        TRAIN_MOE[k] for k in ("layers", "b", "s", "steps"))
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              n_layers=moe_layers)
    model = get_model(cfg)
    opt = AdamW(lr=constant(1e-4))
    state = init_state(model, opt, 0, dev)
    data = MarkovLM(vocab=cfg.vocab, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in data.batch(i, moe_b, moe_s).items()}
               for i in range(moe_steps)]
    with full_fp32_matmul():
        _, metrics, grads = value_and_grad(model, state.params, batches[0])
    routers = {k: g for k, g in grads.items() if k.endswith("ffn.router")}
    del grads
    check(len(routers) == moe_layers and all(
        bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
        for g in routers.values()), "train (f): a router gradient is not "
        "finite and nonzero")
    step = make_train_step(model, opt)
    rows = []
    for i in range(moe_steps):
        sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        rows.append((float(m["loss"]), float(m["aux"]),
                     (time.perf_counter() - t0) * 1e3))
    check(all(np.isfinite(r[0]) and r[1] > 0 for r in rows),
          f"train (f): qwen3-moe steps {rows}")
    log(f"train (f): {cfg.name} at {moe_layers} layers x {cfg.d_model} "
        f"({cfg.n_experts} experts, top {cfg.moe_top_k}), bf16, B={moe_b} "
        f"S={moe_s}: router gradients max |g| "
        + ", ".join(f"{float(g.abs().max()):.3g}" for g in routers.values())
        + "; steps (loss, aux, ms) "
        + ", ".join(f"({r[0]:.4f}, {r[1]:.4f}, {r[2]:.1f})" for r in rows))
    out["moe"] = rows
    del state, batches, routers, model
    free_card(torch, dev)

    cfg = get_config("whisper-base")
    w_b, w_s, n_frames, w_steps = (
        TRAIN_WHISPER[k] for k in ("b", "s", "frames", "steps"))
    model = get_model(cfg)
    state = init_state(model, opt, 0, dev)
    step = make_train_step(model, opt)
    data = MarkovLM(vocab=cfg.vocab, seed=0)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(w_steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(i, w_b, w_s).items()}
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (w_b, n_frames, cfg.d_model)).astype(np.float32)).to(dev)
        sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        rows.append((float(m["loss"]), (time.perf_counter() - t0) * 1e3))
    check(all(np.isfinite(r[0]) for r in rows),
          f"train (f): whisper steps {rows}")
    mid = sorted(r[1] for r in rows[1:])[len(rows[1:]) // 2]
    log(f"train (f): {cfg.name} ({cfg.n_enc_layers} + {cfg.n_layers} "
        f"layers x {cfg.d_model}), bf16, B={w_b}, {n_frames} frames, "
        f"{w_s} tokens: loss {rows[0][0]:.4f} -> {rows[-1][0]:.4f}, all "
        f"finite; step median {mid:.1f} ms (first {rows[0][1]:.1f})")
    out["whisper"] = dict(losses=[r[0] for r in rows], step_ms=mid)
    del state, model
    free_card(torch, dev)
    return out


def train_phase(torch, np, dev):
    """Training on the card: (a) phi3-mini at full width cut in depth, in
    float32, loss and every gradient against the CPU's; (b) 4
    microbatches against 1; (c) the tiny model's convergence; (d)
    ``launch.train``'s resume and NaN guard with checkpoints in a
    temporary directory (removed after); (e) phi3-mini-3.8b at full
    width and depth; (f) qwen3-moe (cut in depth) and whisper-base."""
    t_phase = time.perf_counter()
    free_card(torch, dev)
    out = dict(grad=train_grad_check(torch, np, dev),
               microbatches=train_microbatches(torch, np, dev))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        usage = shutil.disk_usage(tmp)
        log(f"train: checkpoints under {tmp}: {usage.free} bytes free of "
            f"{usage.total}")
        out["convergence"] = train_convergence(torch, np, dev, tmp)
        out["resume"] = train_resume(torch, np, dev, tmp)
        log(f"train: the checkpoint directory held {dir_bytes(tmp)} bytes "
            "at the end")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["full"] = train_full(torch, np, dev)
    out["families"] = train_families(torch, np, dev)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"train phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 12e: training on a mesh
# ---------------------------------------------------------------------------

#: (a): phi3-mini-3.8b at full width and depth on a data x model mesh of
#: slots on the card, B x S, the steps timed, and where row 0's first
#: sequence is padded (labels -100 from this token on): a token mean over
#: the batch then differs from a mean of the rows' means.
MESH_GRID = (2, 2)
MESH_SHAPE = (8, 1024)
MESH_STEPS = 10
MESH_PAD_FROM = 512
#: Free device bytes (a) needs: 7.6 GB of bf16 parameters, 30.6 GB of
#: float32 moments, one 15.3 GB float32 gradient tree, one row's 7.6 GB
#: of bf16 gradients in flight, activations and logits.
MESH_FREE_BYTES = 70e9
#: (b): qwen2-vl-2b at full width and depth over this many data slots,
#: B x S, and the timed steps of each scheme; the 12-step trajectory at
#: smoke width (the reference's test: 8 slots, 16 x 16 batches, lr 3e-3,
#: int8_ef within 0.35 of exact, bf16 within 0.2, exact falling by 0.2).
MESH_COMP_ARCH = "qwen2-vl-2b"
MESH_COMP_SLOTS = 2
MESH_COMP_SHAPE = (8, 512)
MESH_COMP_STEPS = 3
MESH_TRAJ = dict(slots=8, steps=12, b=16, s=16, int8=0.35, bf16=0.2,
                 fall=0.2)
#: (c): phi3-mini at full width cut to TRAIN_CUT_LAYERS layers, bf16: a
#: (4, 2) mesh trained ``steps`` steps of B x S, saved, shrunk to ``keep``
#: slots with the model axis kept, restored and re-meshed, one more step.
MESH_ELASTIC = dict(grid=(4, 2), keep=4, b=8, s=256, steps=2)


def card_mesh(dev, data, model):
    """A (data, model) ``make_host_mesh`` whose slots all lie on ``dev``."""
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(data, model, devices=[dev] * (data * model))


def mesh_batch(torch, vocab, b, s, dev, *, seed=0, step=0, pad_from=None):
    from repro_torch.data.tokens import MarkovLM

    batch = {k: torch.from_numpy(v) for k, v in
             MarkovLM(vocab=vocab, seed=seed).batch(step, b, s).items()}
    if pad_from is not None:
        batch["labels"][0, pad_from:] = -100
    return {k: v.to(dev) for k, v in batch.items()}


def mesh_grad_check(torch, np, dev, dtype="float32", gate=True):
    """(a)'s gate: phi3-mini-3.8b at full width and depth (``dtype``) on
    the MESH_GRID mesh of ``dev`` slots: the first step's loss and every
    gradient from ``train.step.value_and_grad`` of the placed parameters
    (rows of 4 sequences, row 0 padded) against its one-slot value on
    the same parameters and batch (loss rtol TRAIN_LOSS_RTOL, each leaf
    within TRAIN_GRAD_TOL of its own max |g|).  In bf16 the numbers are
    logged, not gated: a bf16 gradient rounds each element to 2^-9 of
    itself, so a row count's other rounding moves the largest elements by
    ~4e-3 of max |g|."""
    from repro_torch.configs import get_config
    from repro_torch.core.index import full_fp32_matmul
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import get_model
    from repro_torch.train.step import value_and_grad

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype=dtype)
    model = get_model(cfg)
    b, s = MESH_SHAPE
    params = model.init(0, device=dev).requires_grad_(True)
    placed = shd.place_module(params, shd.default_rules(
        card_mesh(dev, *MESH_GRID)))
    batch = mesh_batch(torch, cfg.vocab, b, s, dev, pad_from=MESH_PAD_FROM)
    walls = {}
    sync(torch, dev)
    t0 = time.perf_counter()
    with full_fp32_matmul():
        l_mesh, _, g_mesh = value_and_grad(model, placed, batch)
    sync(torch, dev)
    walls["mesh"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with full_fp32_matmul():
        l_one, _, g_one = value_and_grad(model, params, batch)
    sync(torch, dev)
    walls["one"] = time.perf_counter() - t0
    worst, worst_name = worst_grad(g_mesh, g_one)
    l_mesh, l_one = float(l_mesh), float(l_one)
    rel = abs(l_mesh - l_one) / abs(l_one)
    log(f"mesh (a) gate, {dtype}: {cfg.name} {cfg.n_layers} layers x "
        f"{cfg.d_model}, {MESH_GRID[0]} x {MESH_GRID[1]} slots on {dev}, "
        f"B={b} S={s} (row 0 padded from token {MESH_PAD_FROM}): loss mesh "
        f"{l_mesh:.7f} one slot {l_one:.7f} (rel {rel:.3g}, limit "
        f"{TRAIN_LOSS_RTOL}); {len(g_one)} gradients, worst at {worst:.4g} "
        f"of its limit ({worst_name}); mesh {walls['mesh']:.2f} s, one slot "
        f"{walls['one']:.2f} s" + ("" if gate else " (logged, not gated)"))
    if gate:
        check(rel <= TRAIN_LOSS_RTOL, f"mesh (a): loss mesh {l_mesh} one "
              f"slot {l_one}")
        check(worst <= 1.0, f"mesh (a): gradient {worst_name} at "
              f"{worst:.3g} of its limit")
    del params, placed, g_mesh, g_one
    free_card(torch, dev)
    return dict(dtype=dtype, loss_mesh=l_mesh, loss_one=l_one, loss_rel=rel,
                grad_worst=worst, grad_worst_leaf=worst_name, walls=walls)


def mesh_train(torch, np, dev):
    """(a)'s steps: phi3-mini-3.8b at full width and depth, bf16, full
    remat, placed on the MESH_GRID mesh (parameters and moments by
    ``infer_param_specs``: on one card the leaves whole, shards views) and
    stepped MESH_STEPS times by ``make_train_step``: finite losses, step
    ms, tokens/s, peak memory, one more step profiled (busy share)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.step import (init_state, make_train_step,
                                        place_train_state)

    cfg = get_config(TRAIN_ARCH)
    (b, s), steps = MESH_SHAPE, MESH_STEPS
    free, total = torch.cuda.mem_get_info(dev)
    log(f"mesh (a): {free} of {total} device bytes free")
    check(free >= MESH_FREE_BYTES, f"mesh (a): {free} bytes free, "
          f"needs {MESH_FREE_BYTES:.0f}")
    torch.cuda.reset_peak_memory_stats(dev)
    model = get_model(cfg)
    rules = shd.default_rules(card_mesh(dev, *MESH_GRID))
    batches = [mesh_batch(torch, cfg.vocab, b, s, dev, step=i)
               for i in range(steps + 1)]
    opt = TimedOptimizer(torch, AdamW(lr=warmup_cosine(3e-4, 2, steps)))
    state = place_train_state(init_state(model, opt, 0, dev), rules)
    n_params = sum(p.numel() for p in state.params.parameters())
    n_views = sum(1 for p in state.params.parameters()
                  for c in rules.mesh.coords()
                  if p.shard(c).untyped_storage().data_ptr()
                  == p.pieces[0].tensor.untyped_storage().data_ptr())
    step = make_train_step(model, opt)
    ms, losses = [], []
    for i in range(steps):
        sync(torch, dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        losses.append(float(metrics["loss"]))
        sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"mesh (a): losses {losses}")
    mid = sorted(ms[1:])[len(ms[1:]) // 2]
    opt_ms = sorted(opt.ms[1:steps])[len(opt.ms[1:steps]) // 2]
    out = dict(params=n_params, step_ms=mid, step_ms_all=ms,
               tokens_per_s=b * s / (mid / 1e3), losses=losses,
               opt_ms=opt_ms, shard_views=n_views,
               peak=torch.cuda.max_memory_allocated(dev))
    log(f"mesh (a): {cfg.name}, {n_params} parameters, bf16, remat "
        f"{cfg.remat_policy}, {MESH_GRID[0]} data x {MESH_GRID[1]} model "
        f"slots on {dev} ({n_views} of "
        f"{len(list(state.params.parameters())) * rules.mesh.size} slot "
        f"shards views of their leaf), B={b} S={s}: step 1 {ms[0]:.1f} ms, "
        f"then median {mid:.1f} ms, {out['tokens_per_s']:.0f} tokens/s; loss"
        f" {losses[0]:.4f} -> {losses[-1]:.4f}, all finite; optimizer "
        f"{opt_ms:.1f} ms; peak device memory {out['peak']} bytes")
    box = {"state": state}

    def one():
        box["state"], _ = step(box["state"], batches[steps])
    out["profile"] = profile(torch, f"one {cfg.name} train step on a "
                             f"{MESH_GRID[0]} x {MESH_GRID[1]} mesh", one,
                             mid / 1e3, top=6)
    del box, state, batches
    free_card(torch, dev)
    return out


class GradOnly:
    """An optimizer that keeps the gradients it is given and updates
    nothing (so two steps start from the same parameters)."""

    def __init__(self):
        self.grads = None

    def init(self, params):
        return {}

    def update(self, grads, opt_state, params):
        self.grads = grads
        return params, opt_state, {}


def compression_gate(torch, np, dev):
    """(b)'s gate: qwen2-vl-2b at full width and depth over
    MESH_COMP_SLOTS data slots on ``dev``: int8_ef's first reduced
    gradient against the exact mean (scheme ``none``) from the same
    parameters.  Each element must lie within half the consensus scale of
    its group (the maximum over slots of max |g_slot| / 127, computed here
    from each slot's own gradient; + 1e-3 of it for float rounding): a
    slot quantizing with its own scale misses that."""
    from repro_torch.configs import get_config
    from repro_torch.core.index import full_fp32_matmul
    from repro_torch.distributed import compression
    from repro_torch.models import get_model
    from repro_torch.train.step import value_and_grad

    cfg = get_config(MESH_COMP_ARCH)
    model = get_model(cfg)
    n = MESH_COMP_SLOTS
    b, s = MESH_COMP_SHAPE
    params = model.init(0, device=dev).requires_grad_(True)
    mesh = card_mesh(dev, n, 1)
    batch = mesh_batch(torch, cfg.vocab, b, s, dev)
    groups = compression.scale_groups(cfg, [k for k, _ in
                                            params.named_parameters()])
    gmax = {}
    for i in range(n):
        with full_fp32_matmul():
            _, _, g = value_and_grad(model, params, {
                k: v[i * b // n:(i + 1) * b // n] for k, v in batch.items()})
        for key, names in groups.items():
            m = max(float(g[k].abs().max()) for k in names)
            gmax[key] = max(gmax.get(key, 0.0), m)
        del g
    got = {}
    for scheme in ("none", "int8_ef"):
        opt = GradOnly()
        step, init_err = compression.make_compressed_train_step(
            model, opt, mesh, scheme=scheme)
        err = init_err(params)
        step(params, {}, err, batch)
        got[scheme] = opt.grads
        del err, step
    worst, worst_key = 0.0, None
    for key, names in groups.items():
        scale = max(np.float32(gmax[key]) / np.float32(127.0), 1e-12)
        bound = scale * (0.5 + 1e-3)
        e = max(float((got["int8_ef"][k] - got["none"][k]).abs().max())
                for k in names)
        if e / bound > worst or worst_key is None:
            worst, worst_key = e / bound, key
    log(f"mesh (b) gate: {cfg.name}, int8_ef's first reduced gradient "
        f"over {n} slots (B={b} S={s}) against the exact mean: worst group "
        f"at {worst:.4g} of half its consensus scale ({worst_key}; "
        f"{len(groups)} groups)")
    check(worst <= 1.0, f"mesh (b): int8_ef gradient group {worst_key} at "
          f"{worst:.3g} of half its scale from the exact mean")
    del params, got
    free_card(torch, dev)
    return dict(worst=worst, worst_group=worst_key, groups=len(groups))


def compression_steps(torch, np, dev):
    """(b)'s steps: qwen2-vl-2b at full width and depth, bf16, over
    MESH_COMP_SLOTS data slots, MESH_COMP_STEPS AdamW steps of each scheme
    from seed 0: step ms, losses (finite), peak memory and the bytes each
    scheme puts on a wire per slot and step."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, constant

    cfg = get_config(MESH_COMP_ARCH)
    model = get_model(cfg)
    n = MESH_COMP_SLOTS
    b, s = MESH_COMP_SHAPE
    mesh = card_mesh(dev, n, 1)
    batches = [mesh_batch(torch, cfg.vocab, b, s, dev, step=i)
               for i in range(MESH_COMP_STEPS)]
    out = {}
    for scheme in compression.SCHEMES:
        torch.cuda.reset_peak_memory_stats(dev)
        params = model.init(0, device=dev).requires_grad_(True)
        n_params = sum(p.numel() for p in params.parameters())
        opt = AdamW(lr=constant(1e-4))
        st = opt.init(params)
        step, init_err = compression.make_compressed_train_step(
            model, opt, mesh, scheme=scheme)
        err = init_err(params)
        ms, losses = [], []
        for batch in batches:
            sync(torch, dev)
            t0 = time.perf_counter()
            params, st, err, loss = step(params, st, err, batch)
            losses.append(float(loss))
            sync(torch, dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(losses)), f"mesh (b) {scheme}: losses "
              f"{losses}")
        wire = n_params * compression.WIRE_BYTES[scheme]
        out[scheme] = dict(ms=ms, step_ms=sorted(ms[1:])[len(ms[1:]) // 2],
                           losses=losses, wire_bytes=wire,
                           peak=torch.cuda.max_memory_allocated(dev))
        log(f"mesh (b) {scheme}: {cfg.name}, {n_params} parameters, {n} "
            f"slots, B={b} S={s}: steps " + ", ".join(f"{t:.1f}" for t in ms)
            + f" ms; losses {', '.join(f'{x:.4f}' for x in losses)}; "
            f"{wire} bytes on a wire per slot and step; peak device memory "
            f"{out[scheme]['peak']} bytes")
        if scheme == "int8_ef":
            box = {"p": params, "st": st, "err": err}

            def one():
                box["p"], box["st"], box["err"], _ = step(
                    box["p"], box["st"], box["err"], batches[-1])
            out[scheme]["profile"] = profile(
                torch, f"one int8_ef step of {cfg.name} over {n} slots", one,
                out[scheme]["step_ms"] / 1e3, top=8)
            del box
        del params, st, err, step, opt
        free_card(torch, dev)
    return out


def compression_trajectory(torch, np, dev):
    """(b)'s trajectory: the reference's 12-step check on MESH_TRAJ's
    slots of ``dev`` at smoke width (phi3-mini, 2 layers, vocab 64)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import compression
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, constant

    t = MESH_TRAJ
    cfg = dataclasses.replace(get_smoke_config(TRAIN_ARCH), n_layers=2,
                              vocab=64)
    model = get_model(cfg)
    mesh = card_mesh(dev, t["slots"], 1)
    runs = {}
    for scheme in compression.SCHEMES:
        opt = AdamW(lr=constant(3e-3), max_grad_norm=None)
        params = model.init(0, device=dev).requires_grad_(True)
        st = opt.init(params)
        step, init_err = compression.make_compressed_train_step(
            model, opt, mesh, scheme=scheme)
        err = init_err(params)
        losses = []
        for i in range(t["steps"]):
            batch = mesh_batch(torch, cfg.vocab, t["b"], t["s"], dev, step=i)
            params, st, err, loss = step(params, st, err, batch)
            losses.append(float(loss))
        runs[scheme] = losses
    ex = runs["none"]
    d8 = abs(runs["int8_ef"][-1] - ex[-1])
    d16 = abs(runs["bf16"][-1] - ex[-1])
    log(f"mesh (b) trajectory, {t['steps']} steps on {t['slots']} slots: "
        f"exact {ex[0]:.4f} -> {ex[-1]:.4f}, int8_ef "
        f"{runs['int8_ef'][-1]:.4f} (|diff| {d8:.4f}, limit {t['int8']}), "
        f"bf16 {runs['bf16'][-1]:.4f} (|diff| {d16:.4f}, limit {t['bf16']})")
    check(ex[-1] < ex[0] - t["fall"], f"mesh (b): exact losses {ex}")
    check(d8 < t["int8"], f"mesh (b): int8_ef ends {d8} from exact")
    check(d16 < t["bf16"], f"mesh (b): bf16 ends {d16} from exact")
    free_card(torch, dev)
    return dict(losses=runs, int8_diff=d8, bf16_diff=d16)


def mesh_elastic(torch, np, dev, tmp):
    """(c): phi3-mini at full width cut to TRAIN_CUT_LAYERS layers, bf16,
    on a MESH_ELASTIC["grid"] mesh of ``dev`` slots: a few steps, a
    checkpoint in ``tmp``, ``shrink_mesh`` to ``keep`` slots,
    ``restore(shardings=)`` onto the smaller mesh and
    ``remesh_train_state``; every leaf bit-equal to the saved one, the next
    step finite; save and restore seconds."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.elastic import (remesh_train_state,
                                                 shrink_mesh)
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, constant
    from repro_torch.train.step import (init_state, make_train_step,
                                        state_shardings)

    e = MESH_ELASTIC
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_CUT_LAYERS)
    model = get_model(cfg)
    opt = AdamW(lr=constant(1e-4))
    mesh8 = card_mesh(dev, *e["grid"])
    step = make_train_step(model, opt)
    with shd.use_rules(shd.default_rules(mesh8)):
        state = init_state(model, opt, 0, dev)
        for i in range(e["steps"]):
            state, _ = step(state, mesh_batch(torch, cfg.vocab, e["b"],
                                              e["s"], dev, step=i))
    check(isinstance(state.params, shd.PlacedModule), "mesh (c): the state "
          "was not placed on the mesh")
    mgr = ckpt.CheckpointManager(tmp, keep_n=1)
    sync(torch, dev)
    t0 = time.perf_counter()
    mgr.save(state, step=e["steps"])
    save_s = time.perf_counter() - t0
    saved = {}
    ckpt._map_leaves(state, lambda name, leaf, _: saved.__setitem__(
        name, ckpt._to_host(leaf)[0]))
    del state
    free_card(torch, dev)
    mesh4 = shrink_mesh(list(mesh8.flat_devices())[:e["keep"]],
                        model_parallel=e["grid"][1])
    rules4 = shd.default_rules(mesh4)
    target = init_state(model, opt, 1, "meta")
    t0 = time.perf_counter()
    restored = mgr.restore(target, step=e["steps"],
                           shardings=state_shardings(target, rules4))
    restored = remesh_train_state(restored, mesh4, rules=rules4)
    sync(torch, dev)
    restore_s = time.perf_counter() - t0
    got = {}
    ckpt._map_leaves(restored, lambda name, leaf, _: got.__setitem__(
        name, ckpt._to_host(leaf)[0]))
    equal = sum(1 for k in saved if k in got and got[k].dtype ==
                saved[k].dtype and np.array_equal(got[k], saved[k]))
    check(equal == len(saved) == len(got), f"mesh (c): {equal} of "
          f"{len(saved)} leaves bit-equal after the cross-mesh restore")
    _, m = step(restored, mesh_batch(torch, cfg.vocab, e["b"], e["s"], dev,
                                     step=e["steps"]))
    loss = float(m["loss"])
    check(np.isfinite(loss), f"mesh (c): next step's loss {loss}")
    nbytes = dir_bytes(tmp)
    log(f"mesh (c): {cfg.name} cut to {cfg.n_layers} layers, bf16, "
        f"{e['grid'][0]} x {e['grid'][1]} -> {mesh4.shape['data']} x "
        f"{mesh4.shape['model']} slots on {dev}: saved {nbytes} bytes in "
        f"{save_s:.2f} s, restored and re-meshed in {restore_s:.2f} s; "
        f"{equal} of {len(saved)} leaves bit-equal; next step loss "
        f"{loss:.4f} (finite)")
    n_leaves = len(saved)
    del restored, saved, got
    free_card(torch, dev)
    return dict(save_s=save_s, restore_s=restore_s, bytes=nbytes,
                leaves=n_leaves, bit_equal=equal, loss=loss)


def examples_phase(torch, dev):
    """The port's examples (``examples/torch_*.py``) on the card at their
    own settings (train_lm cut to 20 steps on a 2 x 2 mesh), each
    kernel's launch counters zeroed just before and read just after."""
    import importlib.util

    from repro_torch.kernels import fused_select as fsel
    from repro_torch.kernels import hntl_scan as hs

    argv = {"quickstart": [], "counterfactual_branch": [],
            "distributed_search": [], "long_context_decode": [],
            "serve_retrieval": [],
            "train_lm": ["--host-mesh", "2,2", "--steps", "20"]}
    out = {}
    for name, args in argv.items():
        args = ["--device", str(dev)] + args
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", os.path.join(REPO, "examples",
                                            f"torch_{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_example_")
        try:
            if name == "train_lm":
                args = args + ["--ckpt-dir", tmp]
            fsel.fused_scan_select.launches = 0
            hs.hntl_scan_single.launches = 0
            t0 = time.perf_counter()
            mod.main(args)
            sync(torch, dev)
            wall = time.perf_counter() - t0
            out[name] = dict(select=fsel.fused_scan_select.launches,
                             single=hs.hntl_scan_single.launches, s=wall)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(f"example torch_{name}: {wall:.1f} s, fused_scan_select "
            f"launches {out[name]['select']}, hntl_scan_single launches "
            f"{out[name]['single']}")
        free_card(torch, dev)
    for name in ("quickstart", "counterfactual_branch", "distributed_search",
                 "serve_retrieval"):
        check(out[name]["select"] > 0, f"example {name}: fused_scan_select "
              "never launched")
    check(out["long_context_decode"]["single"] > 0, "example "
          "long_context_decode: hntl_scan_single never launched")
    return out


def mesh_phase(torch, np, dev):
    """Training on a mesh of slots on the card: (a) phi3-mini-3.8b at full
    width and depth on a 2 x 2 mesh, the gate in float32 (and the bf16
    gradients logged), then bf16 steps; (b) compressed data-parallel steps
    of qwen2-vl-2b at full width over 2 slots, the int8_ef gate, the three
    schemes timed, the 12-step trajectory at smoke width; (c) elastic
    re-mesh and cross-mesh restore; then the port's examples.  (d), search
    on ``make_host_mesh``, runs inside the sharded phase."""
    t_phase = time.perf_counter()
    free_card(torch, dev)
    out = dict(grad=mesh_grad_check(torch, np, dev),
               grad_bf16=mesh_grad_check(torch, np, dev, "bfloat16",
                                         gate=False),
               train=mesh_train(torch, np, dev),
               compression_gate=compression_gate(torch, np, dev),
               compression=compression_steps(torch, np, dev),
               trajectory=compression_trajectory(torch, np, dev))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        out["elastic"] = mesh_elastic(torch, np, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["examples"] = examples_phase(torch, dev)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"mesh phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------

def kernel_entry(name, source, replaces, launches, by_path, err, t, at):
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "launches_by_path": by_path, "max_abs_err": err, "ms": t["ms"],
             "events_ms": t["events_ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": None, "traces": t["traces"], "at": at}
    if "parts" in t:
        entry["ms_parts"] = t["parts"]
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=1024)
    ap.add_argument("--grains", type=int, default=1024)
    ap.add_argument("--kv-tokens", type=int, default=524_288,
                    help="sealed HNTL-KV context (a multiple of 4096)")
    ap.add_argument("--store-n", type=int, default=1_004_096,
                    help="rows of the store phase: 8 sealed segments and "
                    "a memtable tail of min(4096, n / 32) rows")
    ap.add_argument("--tier-n", type=int, default=1_000_000,
                    help="rows of the tiered phase's cold store: 8 sealed "
                    "segments, no memtable")
    ap.add_argument("--serve-tokens", type=int, default=32_768,
                    help="the serve phase's long request (a multiple of "
                    "4096): prefilled, promoted to HNTL-KV, decoded; the "
                    "families phase's qwen3-moe and recurrentgemma "
                    "requests take the same length")
    ap.add_argument("--race-cases", action="store_true",
                    help="only build the kernels and launch each path once "
                    "at a small shape, held to its plain version (the run "
                    "to put under compute-sanitizer), then exit")
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
    cuda = torch.device("cuda")
    if a.race_cases:
        race_phase(torch, np, cuda)
        return 0
    err_cases = kernel_phase(torch, cuda)
    err_scan = scan_kernel_phase(torch, np, cuda)
    mp = main_path(torch, np, n=a.n, nq=a.nq, grains=a.grains, dev=cuda)
    gp = gather_plane_phase(torch, mp)
    sb = scan_batched_phase(torch, mp)
    kt = kernel_time_phase(torch, mp)
    st = scan_time_phase(torch, mp, sb)
    kvp = hntl_kv_phase(torch, cuda, tokens=a.kv_tokens)
    from repro_torch.kernels import hntl_scan as hs
    from repro_torch.kernels import ref
    st["kv"] = time_scan(torch, "an HNTL-KV decode step", hs.hntl_scan_single,
                         ref.hntl_scan_single_ref, kvp["scan_args"], 1)
    profile_phase(torch, mp, gp, kvp)
    cp = cascade_phase(torch, np, mp, cuda)
    gc.collect()
    lp = long_list_phase(torch, np, mp, cuda)
    gc.collect()
    torch.cuda.empty_cache()
    batched_at = "P={} Q={} k={} cap={} int16 (the coordinate launch)".format(
        *sb["args"][0].shape[:2], *sb["args"][2].shape[1:])
    for big in ("k_all", "v_all", "idx", "scan_args", "step"):
        del kvp[big]            # free the card for the store phase
    del mp["index"], mp["x"], sb["args"], sb["sketch"]
    stp = store_phase(torch, np, cuda, n=a.store_n)
    state = stp.pop("state")
    xb = torch.from_numpy(state["x"]).to(cuda)
    xb[torch.from_numpy(state["up"]).to(cuda)] = torch.from_numpy(
        state["x_up"]).to(cuda)
    shp = sharded_phase(torch, np, cuda, stp["branch"], xb=xb,
                        dead=state["dead"], tags=state["tags"],
                        ts=state["ts"], truth=dict(q=state["qt"],
                                                   ids=state["truth"]))
    gc.collect()
    torch.cuda.empty_cache()
    tn = tenancy_phase(torch, np, cuda, stp.pop("branch"), xb=xb,
                       base_dead=state["dead"],
                       corpus_q=state["qt"].cpu().numpy(), cfg=state["cfg"])
    del xb
    gc.collect()
    torch.cuda.empty_cache()
    lc = lifecycle_phase(
        torch, np, cuda, state["st"], qt=state["qt"], x=state["x"],
        tags=state["tags"], up=state["up"], x_up=state["x_up"],
        dead=state["dead"], new_ids=stp["half"]["new_ids"],
        x_new=stp["half"]["x_new"], recall_5120=state["recall"])
    del state, stp["half"]
    gc.collect()
    torch.cuda.empty_cache()
    tp = tiered_phase(torch, np, cuda, n=a.tier_n)
    gc.collect()
    torch.cuda.empty_cache()
    sp = serve_phase(torch, np, cuda, long_tokens=a.serve_tokens)
    fp = families_phase(torch, np, cuda, long_tokens=a.serve_tokens,
                        rg_tokens=a.serve_tokens)
    trp = train_phase(torch, np, cuda)
    msp = mesh_phase(torch, np, cuda)
    log(f"peak device memory above each phase's start: warm store phase "
        f"(8 warm segments and a memtable) {stp['peak'] - stp['base']} "
        f"bytes, tiered phase (8 cold segments, paged) {tp['peak']} bytes, "
        f"serve phase (phi3-mini, {a.serve_tokens}-token request) "
        f"{sp['peak']} bytes, families phase (qwen3-moe-30b-a3b, "
        f"{a.serve_tokens}-token request) {fp['moe']['peak']} bytes in all, "
        f"train phase (phi3-mini-3.8b, B=8 S=1024) {trp['full']['peak']} "
        f"bytes in all, mesh phase (phi3-mini-3.8b on {MESH_GRID[0]} x "
        f"{MESH_GRID[1]} slots) {msp['train']['peak']} bytes in all")
    log(f"card: {smi}; total wall {time.perf_counter() - t_start:.1f} s")
    src = "src/repro_torch/kernels/csrc/"
    select_paths = {"search (fused plane)":
                    mp["launches"]["fused_scan_select"],
                    "store search (VectorStore.search)": stp["launches"],
                    "store search before compact":
                    lc["before_compact"]["launches"],
                    "store search after compact":
                    lc["after_compact"]["launches"],
                    "store search after maintain":
                    lc["after_maintain"]["launches"],
                    **tp["launches"],
                    "cascade search (one index, 3 budget settings)":
                    cp["launches"],
                    "store cascade search": stp["cascade"]["launches"],
                    "cold store cascade search (all-warm plane)":
                    tp["cascade"]["warm"]["launches"],
                    "paged cascade search": tp["cascade"]["launches"],
                    "adaptive store search (all-warm)":
                    tp["adaptive"]["launches"],
                    "paged adaptive store search":
                    tp["adaptive"]["paged_launches"],
                    "select at L > 8192": lp["launches"],
                    "coalesced tenant search": tn["launches"],
                    **{f"coalesced tenant search, {k}": v["launches"]
                       for k, v in tn["variants"].items()},
                    "paged coalesced tenant search":
                    tp["tenancy"]["launches"],
                    **shp["launches"],
                    "cold store search, 4 shards":
                    tp["cold_sharded"]["launches"],
                    "coalesced tenant search, 4 shards":
                    tn["sharded"]["launches"],
                    "serve sidecar retrieval": sp["sidecar_launches"],
                    **{f"example torch_{k}": v["select"]
                       for k, v in msp["examples"].items() if v["select"]}}
    single_paths = {"gather plane (kernel)": gp["launches"],
                    "HNTL-KV decode": kvp["launches"],
                    "store search, kernel plane": stp["kernel_launches"],
                    "store search after maintain, kernel plane":
                    lc["kernel_launches"],
                    "sharded store search, kernel plane (4 shards)":
                    shp["kernel_launches"],
                    "model decode, HNTL-KV (phi3-mini, 32 layers)":
                    sp["launches"],
                    "model decode, HNTL-KV (qwen3-moe, 48 layers)":
                    fp["moe"]["launches"],
                    "whisper retrieval cross-attention (6 layers)":
                    fp["whisper"]["launches"],
                    **{f"example torch_{k}": v["single"]
                       for k, v in msp["examples"].items() if v["single"]}}
    select_entry = kernel_entry(
        "fused_scan_select", src + "fused_select.cu",
        "src/repro/kernels/fused_select.py:179", sum(select_paths.values()),
        select_paths, max(err_cases, kt["max_abs_err"],
                          stp["select"]["max_abs_err"]), kt, kt["at"])
    select_entry["at_store"] = {k: v for k, v in stp["select"].items()
                                if k != "max_abs_err"}
    select_entry["at_paged"] = {k: v for k, v in tp["select"].items()
                                if k != "max_abs_err"}
    select_entry["at_tenancy"] = {k: v for k, v in tn["select"].items()
                                  if k != "max_abs_err"}
    select_entry["at_shard"] = {k: v for k, v in shp["select"].items()
                                if k != "max_abs_err"}
    select_entry["at_cascade_stage1"] = {
        k: {f: v for f, v in t.items() if f != "max_abs_err"}
        for k, t in cp["stage1"].items()}
    select_entry["at_wide_lists"] = {
        k: {f: v for f, v in t.items() if f != "max_abs_err"}
        for k, t in lp["timing"].items()}
    select_entry["max_abs_err"] = max(
        select_entry["max_abs_err"], tp["select"]["max_abs_err"],
        tn["select"]["max_abs_err"], shp["select"]["max_abs_err"],
        *(t["max_abs_err"] for t in cp["stage1"].values()),
        *(t["max_abs_err"] for t in lp["timing"].values()))
    single_entry = kernel_entry(
        "hntl_scan_single", src + "hntl_scan.cu",
        "src/repro/kernels/hntl_scan.py:166", sum(single_paths.values()),
        single_paths, err_scan["single"], st["kv"],
        "HNTL-KV decode step: P=256 k=16 cap=4096 int16")
    single_entry["at_model_decode"] = sp["scan"]
    single_entry["at_moe_decode"] = fp["moe"]["scan"]
    single_entry["at_whisper_cross"] = fp["whisper"]["scan"]
    log(json.dumps({"kernels": [
        select_entry,
        single_entry,
        kernel_entry("hntl_scan", src + "hntl_scan.cu",
                     "src/repro/kernels/hntl_scan.py:80", sb["launches"],
                     {"ops.scan_batched": sb["launches"]},
                     err_scan["batched"],
                     st["batched_coords"], batched_at)
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
