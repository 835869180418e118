"""Training launcher with fault tolerance.

This package's port of the JAX package's ``launch/train.py``: every flag
of the reference, plus ``--device`` (default: the card).  The model,
optimizer state and batches live on that device; the trainer
checkpoints to ``--ckpt-dir`` and resumes from its latest step (with no
``--ckpt-dir``, to a new temporary directory, so nothing is resumed).

On the card, phi3-mini at its published width and depth (random weights
from ``--seed``, Markov-chain tokens):
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
      --steps 20 --batch 8 --seq 1024 --ckpt-every 1000

On the CPU (smoke config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
      --smoke --device cpu --steps 20 --batch 8 --seq 64

``--host-mesh d,m`` trains on a data x model mesh (``make_host_mesh``)
under ``default_rules``, as the reference's launcher does: parameters and
moments split by the model's sharding rules, the batch over the d data
rows, the step equal to the one-device step (``train.step``).  With
``--device`` every slot is that device (the counterpart of forced host
devices: ``--device cpu --host-mesh 4,2`` runs on the CPU); without it
the mesh takes the first d x m cards and raises when there are fewer.
The launcher prints the step's execution (``train.step.execution``): the
dense attention-only decoders split their heads, MLP and vocab over the
model axis ("tensor-parallel"; ``--device cpu --host-mesh 1,4``), those
with experts their heads, vocab and experts ("expert-parallel": the
rows route the whole batch together; ``--arch qwen3-moe-30b-a3b --smoke
--device cpu --host-mesh 2,2``), the other families compute each data
row with the whole parameters ("row-gather": the model axis shards their
storage only).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core.index import resolve_device
from ..data.tokens import MarkovLM
from ..distributed import sharding as shd
from ..models import get_model
from ..optim.adamw import AdamW, warmup_cosine
from ..train.step import execution
from ..train.trainer import Trainer, TrainerConfig
from .mesh import make_host_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--device", default=None,
                    help="torch device of the model, optimizer state and "
                         "batches (default: the card; 'cpu' runs the plain "
                         "path)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from its latest "
                         "step (default: a new temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--host-mesh", default="1,1",
                    help="data,model axis sizes over local devices (all "
                         "on --device when it is given)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dm, tm = (int(x) for x in args.host_mesh.split(","))
    device = resolve_device(args.device)      # no card and no --device: raise
    mesh = make_host_mesh(dm, tm, devices=None if args.device is None
                          else [device] * (dm * tm))
    rules = shd.default_rules(mesh)
    device = mesh.flat_devices()[0]
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    optimizer = AdamW(lr=warmup_cosine(args.lr, min(50, args.steps // 10 + 1),
                                       args.steps))
    data = MarkovLM(vocab=cfg.vocab, seed=args.seed)
    print(f"[train] {cfg.name} on a {dm} x {tm} mesh: "
          f"{execution(model, rules)}")

    def data_fn(step):
        b = data.batch(step, args.batch, args.seq)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         microbatches=args.microbatches)
    with shd.use_rules(rules):
        trainer = Trainer(model, optimizer, data_fn, tcfg, seed=args.seed,
                          device=device)
        state = trainer.run()
    losses = [h["loss"] for h in trainer.history]
    if losses:
        print(f"[train] first loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
              f"(uniform = {np.log(cfg.vocab):.4f})")
    return state


if __name__ == "__main__":
    main()
