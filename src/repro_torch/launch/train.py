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

``--host-mesh`` other than ``1,1`` (a data x model mesh over local
devices, with the model's sharding rules) is not ported yet: it raises.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core.index import resolve_device
from ..data.tokens import MarkovLM
from ..models import get_model
from ..optim.adamw import AdamW, warmup_cosine
from ..train.trainer import Trainer, TrainerConfig


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
                    help="data,model axis sizes over local devices (only "
                         "1,1 is ported)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dm, tm = (int(x) for x in args.host_mesh.split(","))
    if (dm, tm) != (1, 1):
        raise ValueError(
            f"--host-mesh {args.host_mesh}: a data x model mesh needs "
            "make_host_mesh and the model sharding rules, which are not "
            "ported yet (ROADMAP Queue A item 11c); use --host-mesh 1,1")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    optimizer = AdamW(lr=warmup_cosine(args.lr, min(50, args.steps // 10 + 1),
                                       args.steps))
    data = MarkovLM(vocab=cfg.vocab, seed=args.seed)

    def data_fn(step):
        b = data.batch(step, args.batch, args.seq)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         microbatches=args.microbatches)
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
