#!/usr/bin/env python3
"""Training on a mesh whose slots lie on different cards (needs 4).

``chip_smoke.py`` runs every mesh on the slots of one card, where a
device holds each leaf whole.  Here the slots are four cards, so leaves
split into blocks on their cards and the step gathers them:

- gemma2-2b and qwen3-moe-30b-a3b (float32 smoke configs) on a 2 x 2
  ``make_host_mesh`` of cuda:0-3: one step equals the one-card step (loss
  rtol 1e-5, parameters within 1e-5, AdamW at eps 1e-3);
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
        res[arch] = dict(loss_one=float(m1["loss"]),
                         loss_mesh=float(m2["loss"]), param_diff=diff,
                         block_pieces=blocks)
        print(arch, res[arch], flush=True)
        if not (abs(res[arch]["loss_mesh"] - res[arch]["loss_one"])
                <= 1e-5 * abs(res[arch]["loss_one"]) and diff <= 1e-5):
            raise SystemExit(f"{arch}: the mesh step differs")


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
    compression_cards(torch, devs, res)
    elastic_cards(torch, np, devs, res)
    print(json.dumps(res))
    print("MESH CARDS OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
