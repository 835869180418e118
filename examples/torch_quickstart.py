"""Quickstart on the PyTorch port: build an HNTL index, search it in both
modes, check recall.  Runs on the card (the fused select kernel); pass
``--device cpu`` for the plain path.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import HNTLConfig, build, search
from repro_torch.core.flat import flat_search, recall_at_k
from repro_torch.core.index import resolve_device
from repro_torch.data import synthetic as syn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--n", type=int, default=20_000)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # corpus on a curved low-dimensional manifold (the paper's good case)
    x = syn.anisotropic_manifold(n=args.n, d=256, intrinsic=24, seed=0)
    queries = syn.queries_from(x, nq=64)

    cfg = HNTLConfig(d=256, k=24, s=8, n_grains=32, nprobe=8, pool=32)
    index, info = build(x, cfg, device=device)
    print(f"built on {device}: {cfg.n_grains} grains, cap={info.cap}, "
          f"local PCA variance captured = {info.var_captured_mean:.1%}")
    print(f"compact tier: {cfg.bytes_per_vector} B/vector "
          f"({info.bytes_compact/1e6:.1f} MB vs raw "
          f"{info.bytes_raw/1e6:.1f} MB)")

    q = torch.from_numpy(queries).to(device)
    truth = flat_search(torch.from_numpy(x).to(device), q, topk=10)
    res_a = search(index, q, cfg, topk=10, mode="A")
    res_b = search(index, q, cfg, topk=10, mode="B")
    rec = {"A": recall_at_k(res_a.ids, truth.ids),
           "B": recall_at_k(res_b.ids, truth.ids)}
    print(f"Mode A (self-contained) recall@10: {rec['A']:.3f}")
    print(f"Mode B (tiered re-rank) recall@10: {rec['B']:.3f}")
    return rec


if __name__ == "__main__":
    main()
