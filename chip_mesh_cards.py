#!/usr/bin/env python3
"""Training on a mesh whose slots lie on different cards (needs 4).

``chip_smoke.py`` runs every mesh on the slots of one card, where a
device holds each leaf whole.  Here the slots are four cards, so leaves
split into blocks on their cards and the step gathers them:

- gemma2-2b and qwen3-moe-30b-a3b (float32 smoke configs) on a 2 x 2
  ``make_host_mesh`` of cuda:0-3: one step equals the one-card step (loss
  rtol 1e-5, parameters within 1e-5, AdamW at eps 1e-3); gemma2's rows
  run tensor-parallel over their 2 model slots, qwen3-moe's
  expert-parallel;
- qwen3-moe-30b-a3b at full width on a 2 x 2 mesh of cuda:0-3,
  expert-parallel (each card one slot: its heads, vocab rows and 64 of
  the 128 experts of one capacity half; the rows' tokens and outputs
  cross cards): the float32 loss, aux and gradients of B x S = 8 x 1024
  at 2 layers against one card's (rtol 1e-5, each leaf within 1e-4 of
  its own max |g|); then bf16 steps at the deepest cut that leaves 8 GB
  free on every card (set from the peaks of two shallower cuts), the
  median of 5 steps with each card's peak and busy share, and at 2
  layers beside one card's step (dbrx-132b's one layer, ~50 GB of
  training state, fits no single card: it runs in the CPU tests and the
  dry-run only);
- phi3-mini-3.8b at full width and depth on a 1 x 4 mesh of cuda:0-3,
  tensor-parallel (each card a quarter of the heads, MLP and vocab): the
  float32 loss and gradients of B x S = 8 x 1024 against one card's (loss
  rtol 1e-5, each leaf within 1e-4 of its own max |g|), then bf16 steps
  timed beside the one-card step, each card's busy share profiled;
- int8_ef compression over 4 data slots, replicated on four cards
  (``compression.replicate``), equals the same on 4 slots of one card
  (3 steps: losses and parameters, max |diff| 1e-6);
- a 2 x 2 state on four cards saved, ``shrink_mesh`` to two cards,
  ``restore(shardings=)`` and ``remesh_train_state``: every leaf
  bit-equal, the next step finite.

Prints one JSON line, then ``MESH CARDS OK``; exits non-zero on a
failure or with fewer than 4 cards:

    python3 chip_mesh_cards.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")


def batch_of(torch, cfg, dev, step=0, b=8, s=16):
    from repro_torch.data.tokens import MarkovLM

    bt = {k: torch.from_numpy(v) for k, v in
          MarkovLM(vocab=cfg.vocab, seed=0).batch(step, b, s).items()}
    bt["labels"][1, 5:] = -100
    return {k: v.to(dev) for k, v in bt.items()}


def host(tree_leaf):
    from repro_torch.distributed import sharding as shd

    if isinstance(tree_leaf, shd.PlacedTensor):
        return tree_leaf.gather("cpu")
    return tree_leaf.detach().cpu()


def mesh_step(torch, devs, res):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, constant
    from repro_torch.train.step import (init_state, make_train_step,
                                        place_train_state)

    from repro_torch.train.step import execution

    home = torch.device(devs[0])
    for arch in ("gemma2-2b", "qwen3-moe-30b-a3b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        model = get_model(cfg)
        opt = AdamW(lr=constant(1e-3), eps=1e-3)
        batch = batch_of(torch, cfg, home)
        step = make_train_step(model, opt)
        one, m1 = step(init_state(model, opt, 0, home), batch)
        rules = shd.default_rules(make_host_mesh(2, 2, devices=devs))
        placed = place_train_state(init_state(model, opt, 0, home), rules)
        blocks = sum(1 for leaf in placed.params.parameters()
                     for p in leaf.pieces if p.slices is not None)
        mesh, m2 = step(placed, batch)
        want = dict(one.params.named_parameters())
        diff = max(float((host(p) - host(want[k])).abs().max())
                   for k, p in mesh.params.named_parameters())
        res[arch] = dict(execution=execution(model, rules),
                         loss_one=float(m1["loss"]),
                         loss_mesh=float(m2["loss"]), param_diff=diff,
                         block_pieces=blocks)
        print(arch, res[arch], flush=True)
        if not (abs(res[arch]["loss_mesh"] - res[arch]["loss_one"])
                <= 1e-5 * abs(res[arch]["loss_one"]) and diff <= 1e-5):
            raise SystemExit(f"{arch}: the mesh step differs")


#: phi3-mini on 1 x 4 cards: B x S, and the timed bf16 steps.
TP_SHAPE = (8, 1024)
TP_STEPS = 4


def busy_by_card(torch, fn, wall_s, n):
    """Each card's kernel time over ``fn`` (torch.profiler) over the
    unprofiled wall time ``wall_s`` of the same work; None where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [0.0] * n
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and 0 <= e.device_index < n:
            us[e.device_index] += e.self_device_time_total
    if not any(us):
        return None
    return [u / (wall_s * 1e6) for u in us]


def tensor_parallel_cards(torch, devs, res):
    import time

    from repro_torch.configs import get_config
    from repro_torch.core.index import full_fp32_matmul
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.step import (execution, init_state,
                                        make_train_step, place_train_state,
                                        value_and_grad)

    home = torch.device(devs[0])
    b, s = TP_SHAPE
    rules = shd.default_rules(make_host_mesh(1, 4, devices=devs))
    out = {}
    # the float32 gate: loss and every gradient against one card's
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), dtype="float32")
    model = get_model(cfg)
    out["execution"] = execution(model, rules)
    if out["execution"] != "tensor-parallel":
        raise SystemExit(f"phi3-mini on 1 x 4 runs {out['execution']}")
    params = model.init(0, device=home).requires_grad_(True)
    batch = batch_of(torch, cfg, home, b=b, s=s)
    with full_fp32_matmul():
        l1, _, g1 = value_and_grad(model, params, batch)
    placed = shd.place_module(params, rules)
    del params
    torch.cuda.empty_cache()
    with full_fp32_matmul():
        l2, _, g2 = value_and_grad(model, placed, batch)
    worst, leaf = 0.0, None
    for k, want in g1.items():
        got = g2[k].gather(home) if isinstance(g2[k], shd.PlacedTensor) \
            else g2[k].to(home)
        r = float((got - want).abs().max()) / (
            1e-4 * float(want.abs().max()))
        if r > worst:
            worst, leaf = r, k
    rel = abs(float(l2) - float(l1)) / abs(float(l1))
    out.update(loss_one=float(l1), loss_cards=float(l2), loss_rel=rel,
               grad_worst=worst, grad_worst_leaf=leaf)
    del g1, g2, placed
    torch.cuda.empty_cache()
    print("phi3-mini 1 x 4 gate", out, flush=True)
    if rel > 1e-5 or worst > 1.0:
        raise SystemExit("phi3-mini on 1 x 4 cards differs from one card")
    # bf16 steps: 1 x 4 cards against one card
    cfg = get_config("phi3-mini-3.8b")
    model = get_model(cfg)
    batches = [batch_of(torch, cfg, home, i, b, s)
               for i in range(TP_STEPS + 1)]
    for name, place in (("one card", False), ("1 x 4 cards", True)):
        opt = AdamW(lr=warmup_cosine(3e-4, 2, TP_STEPS))
        state = init_state(model, opt, 0, home)
        if place:
            state = place_train_state(state, rules)
            torch.cuda.empty_cache()
        step = make_train_step(model, opt)
        ms, losses = [], []
        for i in range(TP_STEPS):
            for d in devs:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            losses.append(float(m["loss"]))
            for d in devs:
                torch.cuda.synchronize(d)
            ms.append((time.perf_counter() - t0) * 1e3)
        mid = sorted(ms[1:])[len(ms[1:]) // 2]
        box = {"state": state}

        def one():
            box["state"], _ = step(box["state"], batches[TP_STEPS])
        busy = busy_by_card(torch, one, mid / 1e3, len(devs))
        peak = [torch.cuda.max_memory_allocated(d) for d in devs]
        out[name] = dict(step_ms=mid, step_ms_all=ms, losses=losses,
                         busy=busy, peak=peak)
        print(f"phi3-mini bf16, {name}: step median {mid:.1f} ms "
              f"(all {[round(x, 1) for x in ms]}), losses {losses}, busy "
              f"share by card {busy}, peak bytes by card {peak}",
              flush=True)
        if not all(abs(x) < 1e9 for x in losses):
            raise SystemExit(f"phi3-mini {name}: losses {losses}")
        del box, state, step
        torch.cuda.empty_cache()
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
    res["phi3_tensor_parallel"] = out


#: qwen3-moe on 2 x 2 cards: B x S, the float32 gate's depth, the steps
#: of each timed run (the first warms up), the free bytes each card keeps
#: at the deepest cut, and the two depths whose peaks set that cut.
EP_ARCH = "qwen3-moe-30b-a3b"
EP_SHAPE = (8, 1024)
EP_GATE_LAYERS = 2
EP_STEPS = 6
EP_FREE_BYTES = 8e9
EP_PROBE_LAYERS = (2, 4)


def _ep_steps(torch, devs, rules, n_layers, steps, profile):
    """bf16 steps of qwen3-moe cut to ``n_layers`` layers on ``rules``'
    mesh (None: one card): step ms (the median of all but the first),
    losses, each card's peak allocated and reserved bytes, busy share."""
    import time

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, warmup_cosine
    from repro_torch.train.step import TrainState, make_train_step

    home = torch.device(devs[0])
    cards = devs if rules is not None else devs[:1]
    b, s = EP_SHAPE
    cfg = dataclasses.replace(get_config(EP_ARCH), n_layers=n_layers)
    model = get_model(cfg)
    batches = [batch_of(torch, cfg, home, i, b, s) for i in range(steps + 1)]
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    opt = AdamW(lr=warmup_cosine(3e-4, 2, steps))
    params = model.init(0, device=home).requires_grad_(True)
    if rules is not None:
        params = shd.place_module(params, rules)
        torch.cuda.empty_cache()
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    del params
    step = make_train_step(model, opt)
    ms, losses = [], []
    for i in range(steps):
        for d in cards:
            torch.cuda.synchronize(d)
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        losses.append(float(m["loss"]))
        for d in cards:
            torch.cuda.synchronize(d)
        ms.append((time.perf_counter() - t0) * 1e3)
    mid = sorted(ms[1:])[len(ms[1:]) // 2]
    busy = None
    if profile:
        box = {"state": state}

        def one():
            box["state"], _ = step(box["state"], batches[steps])
        busy = busy_by_card(torch, one, mid / 1e3, len(cards))
        state = box.pop("state")
    out = dict(layers=n_layers, step_ms=mid, step_ms_all=ms, losses=losses,
               busy=busy,
               peak=[torch.cuda.max_memory_allocated(d) for d in cards],
               reserved=[torch.cuda.max_memory_reserved(d) for d in cards],
               total=[torch.cuda.mem_get_info(d)[1] for d in cards])
    out["free"] = [t - r for t, r in zip(out["total"], out["reserved"])]
    del state, step, batches
    torch.cuda.empty_cache()
    if not all(abs(x) < 1e9 for x in losses):
        raise SystemExit(f"qwen3-moe {n_layers} layers: losses {losses}")
    return out


def expert_parallel_cards(torch, devs, res):
    from repro_torch.configs import get_config
    from repro_torch.core.index import full_fp32_matmul
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.train.step import execution, value_and_grad

    home = torch.device(devs[0])
    b, s = EP_SHAPE
    rules = shd.default_rules(make_host_mesh(2, 2, devices=devs))
    out = {}
    # the float32 gate: loss, aux and every gradient against one card's
    cfg = dataclasses.replace(get_config(EP_ARCH), dtype="float32",
                              n_layers=EP_GATE_LAYERS)
    model = get_model(cfg)
    out["execution"] = execution(model, rules)
    if out["execution"] != "expert-parallel":
        raise SystemExit(f"qwen3-moe on 2 x 2 runs {out['execution']}")
    params = model.init(0, device=home).requires_grad_(True)
    batch = batch_of(torch, cfg, home, b=b, s=s)
    with full_fp32_matmul():
        l1, m1, g1 = value_and_grad(model, params, batch)
    placed = shd.place_module(params, rules)
    del params
    torch.cuda.empty_cache()
    with full_fp32_matmul():
        l2, m2, g2 = value_and_grad(model, placed, batch)
    worst, leaf = 0.0, None
    for k, want in g1.items():
        got = g2[k].gather(home) if isinstance(g2[k], shd.PlacedTensor) \
            else g2[k].to(home)
        r = float((got - want).abs().max()) / (
            1e-4 * float(want.abs().max()))
        if r > worst or leaf is None:
            worst, leaf = r, k
    rel = abs(float(l2) - float(l1)) / abs(float(l1))
    aux_rel = abs(float(m2["aux"]) - float(m1["aux"])) / abs(float(m1["aux"]))
    out.update(loss_one=float(l1), loss_cards=float(l2), loss_rel=rel,
               aux_one=float(m1["aux"]), aux_cards=float(m2["aux"]),
               aux_rel=aux_rel, grad_worst=worst, grad_worst_leaf=leaf)
    del g1, g2, placed
    torch.cuda.empty_cache()
    print("qwen3-moe 2 x 2 cards gate", out, flush=True)
    if rel > 1e-5 or aux_rel > 1e-5 or worst > 1.0:
        raise SystemExit("qwen3-moe on 2 x 2 cards differs from one card")
    # bf16: the peaks of two cuts set the deepest that keeps EP_FREE_BYTES
    probes = [_ep_steps(torch, devs, rules, n, 3, False)
              for n in EP_PROBE_LAYERS]
    (l_a, l_b), (p_a, p_b) = EP_PROBE_LAYERS, probes
    depth = None
    for i in range(len(devs)):
        per = (p_b["reserved"][i] - p_a["reserved"][i]) / (l_b - l_a)
        room = p_a["total"][i] - EP_FREE_BYTES - p_a["reserved"][i]
        n = l_a + int(room // max(per, 1.0))
        depth = n if depth is None else min(depth, n)
    depth = min(depth, get_config(EP_ARCH).n_layers)
    out["probes"] = probes
    for attempt in range(2):
        deep = _ep_steps(torch, devs, rules, depth, EP_STEPS, True)
        if min(deep["free"]) >= EP_FREE_BYTES:
            break
        depth -= 1
    out["deepest"] = deep
    print(f"qwen3-moe bf16, 2 x 2 cards, {depth} layers (deepest with "
          f"{EP_FREE_BYTES:.0f} bytes free per card): step median "
          f"{deep['step_ms']:.1f} ms (all "
          f"{[round(x, 1) for x in deep['step_ms_all']]}), losses "
          f"{deep['losses']}, busy share by card {deep['busy']}, peak "
          f"bytes by card {deep['peak']}, free bytes by card "
          f"{deep['free']}", flush=True)
    if min(deep["free"]) < EP_FREE_BYTES:
        raise SystemExit(f"qwen3-moe at {depth} layers leaves "
                         f"{min(deep['free'])} bytes free")
    for name, r in (("one card", None), ("2 x 2 cards", rules)):
        out[f"{EP_GATE_LAYERS} layers, {name}"] = o = _ep_steps(
            torch, devs, r, EP_GATE_LAYERS, EP_STEPS, True)
        print(f"qwen3-moe bf16, {EP_GATE_LAYERS} layers, {name}: step "
              f"median {o['step_ms']:.1f} ms (all "
              f"{[round(x, 1) for x in o['step_ms_all']]}), busy share by "
              f"card {o['busy']}, peak bytes by card {o['peak']}",
              flush=True)
    res["qwen3_moe_expert_parallel"] = out


def compression_cards(torch, devs, res):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import compression
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, constant

    home = torch.device(devs[0])
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              n_layers=2, vocab=64, dtype="float32")
    model = get_model(cfg)
    out = {}
    for name, slots in (("one card", [devs[0]] * 4), ("four cards", devs)):
        mesh = make_host_mesh(4, 1, devices=slots)
        opt = AdamW(lr=constant(3e-3), max_grad_norm=None, eps=1e-3)
        params = model.init(0, device=home).requires_grad_(True)
        st = opt.init(params)
        if name == "four cards":
            params = compression.replicate(params, mesh)
            st = {"m": compression.replicate(st["m"], mesh),
                  "v": compression.replicate(st["v"], mesh), "count": 0}
        step, init_err = compression.make_compressed_train_step(
            model, opt, mesh, scheme="int8_ef")
        err = init_err(params)
        losses = []
        for s in range(3):
            params, st, err, loss = step(params, st, err,
                                         batch_of(torch, cfg, home, s, 16))
            losses.append(float(loss))
        out[name] = (losses, {k: host(v)
                              for k, v in params.named_parameters()})
    a, b = out["one card"], out["four cards"]
    diff = max(float((a[1][k] - b[1][k]).abs().max()) for k in a[1])
    res["compression"] = dict(losses_one=a[0], losses_four=b[0],
                              param_diff=diff)
    print("compression", res["compression"], flush=True)
    if diff > 1e-6 or max(abs(x - y) for x, y in zip(a[0], b[0])) > 1e-6:
        raise SystemExit("compression on four cards differs")


def elastic_cards(torch, np, devs, res):
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.elastic import (remesh_train_state,
                                                 shrink_mesh)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamW, constant
    from repro_torch.train.step import (init_state, make_train_step,
                                        state_shardings)

    home = torch.device(devs[0])
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              n_layers=2, vocab=64, dtype="float32")
    model = get_model(cfg)
    opt = AdamW(lr=constant(1e-3))
    step = make_train_step(model, opt)
    with shd.use_rules(shd.default_rules(make_host_mesh(2, 2,
                                                        devices=devs))):
        state = init_state(model, opt, 0, home)
        for s in range(2):
            state, _ = step(state, batch_of(torch, cfg, home, s))
    tmp = tempfile.mkdtemp(prefix="chip_mesh_cards_")
    mgr = ckpt.CheckpointManager(tmp)
    mgr.save(state, step=2)
    saved, got = {}, {}
    ckpt._map_leaves(state, lambda n, leaf, _: saved.__setitem__(
        n, ckpt._to_host(leaf)[0]))
    mesh2 = shrink_mesh(devs[:2], model_parallel=2)
    rules2 = shd.default_rules(mesh2)
    target = init_state(model, opt, 1, "meta")
    restored = remesh_train_state(mgr.restore(
        target, step=2, shardings=state_shardings(target, rules2)), mesh2,
        rules=rules2)
    ckpt._map_leaves(restored, lambda n, leaf, _: got.__setitem__(
        n, ckpt._to_host(leaf)[0]))
    equal = sum(1 for k in saved if np.array_equal(saved[k], got[k]))
    _, m = step(restored, batch_of(torch, cfg, home, 2))
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    res["elastic"] = dict(bit_equal=equal, leaves=len(saved),
                          loss=float(m["loss"]))
    print("elastic", res["elastic"], flush=True)
    if equal != len(saved) or not np.isfinite(float(m["loss"])):
        raise SystemExit("the cross-card restore differs")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_mesh_cards: needs 4 CUDA cards", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    devs = [f"cuda:{i}" for i in range(4)]
    print("cards:", [torch.cuda.get_device_name(i) for i in range(4)])
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    res = {}
    mesh_step(torch, devs, res)
    tensor_parallel_cards(torch, devs, res)
    expert_parallel_cards(torch, devs, res)
    compression_cards(torch, devs, res)
    elastic_cards(torch, np, devs, res)
    print(json.dumps(res))
    print("MESH CARDS OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
