"""Serving launcher: batched decode with an optional retrieval sidecar.

This package's port of the JAX package's ``launch/serve.py``: every flag
of the reference, plus ``--device`` (default: the card).

On the card, phi3-mini at its published width (random weights from
``--seed``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
      --requests 8 --slots 4 --prompt-len 64 --max-new 32 \
      --retrieval-docs 65536

qwen3-moe-30b-a3b at its published width and depth (61 GB of bf16
weights, one 80 GB card):
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-30b-a3b --requests 4 --prompt-len 32 --max-new 16

Every decoder family serves (dense, MoE, hybrid RG-LRU, RWKV6, VLM); an
encoder-decoder (whisper-base) is refused, as the reference's launcher
refuses it.

On the CPU (smoke config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --smoke --device cpu --requests 4 --max-new 16

With the sidecar sharded over a search mesh (``--retrieval-shards N``):
without ``--device`` the mesh takes N cards; with it, N slots of that
device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core import HNTLConfig, scan_plane_names
from ..core.index import resolve_device
from ..core.store import VectorStore
from ..models import get_model
from ..serve.engine import ServeEngine
from .mesh import make_search_mesh


def _build_memory(n_docs: int, shards: int, seed: int, device,
                  device_budget=None, mesh_devices=None):
    """Demo document memory (random embeddings) + optional search mesh."""
    rng = np.random.default_rng(seed)
    d = 64
    store = VectorStore(HNTLConfig(d=d, k=16, s=0, n_grains=8, nprobe=4,
                                   pool=16, block=64),
                        seal_threshold=max(256, n_docs // 8),
                        device_budget=device_budget, device=device)
    store.add(rng.standard_normal((n_docs, d)).astype(np.float32))
    store.seal()
    mesh = make_search_mesh(shards, devices=mesh_devices) \
        if shards > 1 else None
    return store, mesh, rng.standard_normal((4, d)).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the model, caches and memory "
                         "(default: the card; 'cpu' runs the plain path)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--retrieval-docs", type=int, default=0,
                    help="attach a demo vector memory with N documents")
    ap.add_argument("--retrieval-shards", type=int, default=1,
                    help="grain-shard the memory over an N-way search mesh")
    ap.add_argument("--device-budget", type=int, default=0, metavar="BYTES",
                    help="tiered residency for the memory: keep at most "
                         "BYTES of grain panels device-resident, demote the "
                         "rest to a disk-backed cold tier paged in on probe "
                         "(0 = all-warm; single-device only, incompatible "
                         "with --retrieval-shards > 1)")
    ap.add_argument("--scan-impl", default=None,
                    choices=sorted(scan_plane_names()),
                    help="scan plane for retrieval (default: the select "
                         "kernel's \"fused\" plane on the card, \"ref\" on "
                         "the CPU)")
    ap.add_argument("--budgets", default=None, metavar="B1,B2",
                    help="per-stage survivor budgets for staged planes "
                         "(--scan-impl cascade): stage 1 keeps B1 probed "
                         "slots, stage 2 keeps B2 for the exact re-rank")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive query-time routing: per-query early "
                         "termination (distance-gap stopping rule) + "
                         "hub-aware probing")
    ap.add_argument("--probe-margin", default=None, metavar="M",
                    help="adaptive stopping-rule margin: probes within "
                         "(1+M)x the best grain's routing distance stay "
                         "active (requires --adaptive; 'inf' = static "
                         "nprobe; default: the store config's margin)")
    ap.add_argument("--min-probes", default=None, metavar="N",
                    help="probe floor per query under --adaptive (default: "
                         "the store config's floor)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="serve the memory multi-tenant: N namespaces with "
                         "private writes over the shared corpus, retrievals "
                         "coalesced into one fused dispatch per window")
    ap.add_argument("--tenant-budget", type=int, default=256,
                    help="per-tenant memtable row budget (overflow seals)")
    args = ap.parse_args(argv)
    budgets = None
    if args.budgets is not None:
        try:
            budgets = tuple(int(v) for v in args.budgets.split(","))
        except ValueError:
            raise SystemExit(f"--budgets expects B1,B2 ints, "
                             f"got {args.budgets!r}")
    # a bad adaptive knob combination fails at launch, not at the first
    # retrieval
    probe_margin = min_probes = None
    try:
        if args.probe_margin is not None:
            probe_margin = float(args.probe_margin)
        if args.min_probes is not None:
            min_probes = int(args.min_probes)
        from ..core.routing import check_probe_args
        check_probe_args(args.adaptive, probe_margin, min_probes)
    except ValueError as e:
        raise SystemExit(f"bad adaptive routing flags: {e}")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        raise SystemExit(
            f"{cfg.name} is an encoder-decoder: this launcher serves "
            "decoder-only models (drive enc-dec through Model.encode and "
            "Model.encdec_decode_step)")
    model = get_model(cfg)
    params = model.init(args.seed, device=dev)
    memory = memory_mesh = demo_q = None
    if args.device_budget < 0:
        raise SystemExit("--device-budget must be >= 0 bytes")
    if args.device_budget > 0 and args.retrieval_shards > 1:
        raise SystemExit(
            "--device-budget is single-device tiered residency; the sharded "
            "plane keeps every shard resident (drop one of the two flags)")
    if args.retrieval_docs > 0:
        memory, memory_mesh, demo_q = _build_memory(
            args.retrieval_docs, args.retrieval_shards, args.seed, dev,
            device_budget=args.device_budget or None,
            mesh_devices=None if args.device is None
            else [dev] * args.retrieval_shards)
    tenants = None
    if args.tenants > 0:
        if memory is None:
            raise SystemExit("--tenants requires --retrieval-docs > 0")
        from ..serve.tenancy import TenantRegistry
        tenants = TenantRegistry(memory, memtable_budget=args.tenant_budget)
    engine = ServeEngine(model, params, n_slots=args.slots,
                         max_len=args.max_len, temperature=args.temperature,
                         seed=args.seed, memory=memory,
                         memory_mesh=memory_mesh, scan_impl=args.scan_impl,
                         budgets=budgets, tenants=tenants,
                         adaptive=args.adaptive, probe_margin=probe_margin,
                         min_probes=min_probes)
    if memory is not None:
        res = engine.retrieve(demo_q, topk=4, mode="B")
        plane = ("sharded x%d" % args.retrieval_shards
                 if memory_mesh is not None else "single-device")
        if args.device_budget > 0:
            rs = memory.residency_stats()
            plane = (f"tiered ({rs['hot_grains']}/{rs['n_grains']} grains "
                     f"hot, {rs['staged_bytes']}B cold staged)")
        routing_lbl = "static"
        if args.adaptive:
            st = memory.probe_stats()
            m = (probe_margin if probe_margin is not None
                 else memory.cfg.probe_margin)
            routing_lbl = (f"adaptive (margin={m}, mean probes "
                           f"{st['mean_active']:.1f})"
                           if st["queries"] else "adaptive")
        print(f"[serve] retrieval sidecar: {memory.n_vectors} docs, "
              f"{plane} search plane, scan_impl="
              f"{args.scan_impl or 'auto'}, {routing_lbl} routing, "
              f"probe ids[0]={res.ids[0].tolist()}")
    if tenants is not None:
        # demo window: every tenant writes a few private docs, then one
        # coalesced flush serves one retrieval per tenant
        trng = np.random.default_rng(args.seed + 1)
        d = memory.cfg.d
        for t in range(args.tenants):
            engine.remember(trng.standard_normal((4, d)).astype(np.float32),
                            tenant=f"tenant{t}")
        pend = [engine.submit_retrieval(
            trng.standard_normal(d).astype(np.float32),
            tenant=f"tenant{t}", topk=4) for t in range(args.tenants)]
        done = engine.flush_retrievals()
        hits = sum(int((r.result.ids >= 0).sum()) for r in done)
        print(f"[serve] tenancy: {args.tenants} tenants coalesced into one "
              f"window ({len(pend)} requests, {hits} hits, budget="
              f"{args.tenant_budget})")

    rng = np.random.default_rng(args.seed)
    reqs = [engine.submit(rng.integers(0, cfg.vocab, size=args.prompt_len),
                          max_new=args.max_new)
            for _ in range(args.requests)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    engine.run_to_completion()
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in reqs)
    print(f"[serve] {len(reqs)} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s, {engine.steps} engine ticks)")
    for r in reqs[:2]:
        print(f"  req {r.rid}: {r.out[:8]}...")
    return reqs


if __name__ == "__main__":
    main()
