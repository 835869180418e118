"""End-to-end run on the PyTorch port: train a gemma2-style LM on the
synthetic Markov corpus with the full substrate (sharding rules on a
``make_host_mesh`` mesh, AdamW + cosine, gradient accumulation, async
checkpoints, the fault-tolerant trainer).

Default size ~20M parameters; ``--full-100m`` for ~100M (same code path,
more FLOPs).  ``--host-mesh d,m`` trains on a d x m mesh of slots: every
slot on ``--device`` when it is given, else one card per slot (raising
when there are fewer cards than slots); the step equals the one-device
step.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu \
      --host-mesh 2,2 --steps 3 --batch 4 --seq 32
"""
import argparse

import numpy as np
import torch

from repro_torch.core.index import resolve_device
from repro_torch.data.tokens import MarkovLM
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LayerSpec, ModelConfig, get_model
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.train.trainer import Trainer, TrainerConfig


def config_20m():
    return ModelConfig(
        name="aperon-lm-20m", family="dense", n_layers=6, d_model=384,
        n_heads=6, n_kv_heads=2, head_dim=64, d_ff=1536, vocab=4096,
        pattern=(LayerSpec("attn", window=256), LayerSpec("attn")),
        mlp_kind="geglu", norm="rms", post_norm=True, embed_scale=True,
        attn_logit_cap=50.0, final_logit_cap=30.0, remat=False)


def config_100m():
    return ModelConfig(
        name="aperon-lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, head_dim=64, d_ff=3072, vocab=8192,
        pattern=(LayerSpec("attn", window=512), LayerSpec("attn")),
        mlp_kind="geglu", norm="rms", post_norm=True, embed_scale=True,
        attn_logit_cap=50.0, final_logit_cap=30.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the device of every slot (default: one card per "
                         "slot)")
    ap.add_argument("--host-mesh", default="1,1",
                    help="data,model axis sizes of the mesh")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "directory)")
    args = ap.parse_args(argv)
    dm, tm = (int(x) for x in args.host_mesh.split(","))
    device = resolve_device(args.device)      # no card and no --device: raise
    mesh = make_host_mesh(dm, tm, devices=None if args.device is None
                          else [device] * (dm * tm))
    device = mesh.flat_devices()[0]

    cfg = config_100m() if args.full_100m else config_20m()
    model = get_model(cfg)
    n_params = cfg.param_count()
    print(f"[train_lm] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps x {args.batch}x{args.seq} tokens")

    data = MarkovLM(vocab=cfg.vocab, seed=0, branch=8, temp=0.5)
    optimizer = AdamW(lr=warmup_cosine(args.lr, args.steps // 10,
                                       args.steps))

    def data_fn(step):
        b = data.batch(step, args.batch, args.seq)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    rules = shd.default_rules(mesh)
    tcfg = TrainerConfig(total_steps=args.steps,
                         ckpt_every=max(50, args.steps // 4),
                         ckpt_dir=args.ckpt_dir, log_every=10,
                         microbatches=args.microbatches)
    with shd.use_rules(rules):
        trainer = Trainer(model, optimizer, data_fn, tcfg, device=device)
        trainer.run()
    losses = [h["loss"] for h in trainer.history]
    if not losses:
        print("[train_lm] nothing to do (checkpoint already past "
              f"--steps {args.steps}; use a fresh --ckpt-dir to retrain)")
        return losses
    steady = [h["time_s"] for h in trainer.history[5:]] or \
        [h["time_s"] for h in trainer.history]
    print(f"[train_lm] loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(uniform {np.log(cfg.vocab):.3f}); "
          f"tokens/s ~ {args.batch * args.seq / np.mean(steady):.0f}")
    return losses


if __name__ == "__main__":
    main()
