"""Distributed search plane on the PyTorch port: grain-sharded fused
search across a mesh of slots.

Shards a sealed vector store grain-wise over meshes of up to 8 slots,
searches it with shard-local route / scan / pool / re-rank and one top-k
merge, and checks the result against the single-device fused plane bit
for bit; then shards the query batch too on a (2 data x 4 model)
``make_host_mesh``.  A slot is a device: by default every slot is the
card (``["cuda:0"] * n``, the counterpart of the JAX package's forced
host devices); ``--device cpu`` puts every slot on the CPU.

  PYTHONPATH=src python examples/torch_distributed_search.py
"""
import argparse

import numpy as np

from repro_torch.core import HNTLConfig
from repro_torch.core.index import resolve_device
from repro_torch.core.store import VectorStore
from repro_torch.data import synthetic as syn
from repro_torch.launch.mesh import make_host_mesh, make_search_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the device of every slot (default: the card)")
    ap.add_argument("--n", type=int, default=16384)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n, d, seg_rows = args.n, 64, 2048
    cfg = HNTLConfig(d=d, k=16, s=0, n_grains=16, nprobe=8, pool=32,
                     block=64)
    store = VectorStore(cfg, seal_threshold=seg_rows, device=device)
    x = syn.clustered(n, d, n_clusters=32, seed=3)
    for lo in range(0, n, seg_rows):
        store.add(x[lo:lo + seg_rows])
    q = (x[rng.integers(0, n, 8)]
         + 0.05 * rng.standard_normal((8, d))).astype(np.float32)
    print(f"store on {device}: {store.n_vectors} vectors in "
          f"{store.n_segments} sealed segments")
    out = {}

    # Parity: under exhaustive knobs (probe every grain, pool every slot)
    # the sharded plane matches the single-device fused plane bit for bit
    # for any shard count.
    total_grains = sum(s.index.grains.n_grains for s in store._segments)
    ex = dict(nprobe=total_grains, pool=store.n_vectors * 2)
    base = store.search(q, topk=10, mode="B", **ex)
    for shards in (2, 4, 8):
        mesh = make_search_mesh(shards, devices=[device] * shards)
        res = store.search(q, topk=10, mode="B", mesh=mesh, **ex)
        agree = bool(np.array_equal(res.ids.cpu().numpy(),
                                    base.ids.cpu().numpy()))
        print(f"  {shards}-way mesh, exhaustive knobs: bit-for-bit match "
              f"with single-device: {agree}")
        assert agree
        out[f"{shards} shards"] = agree

    # Production knobs are per shard on the distributed plane (top-P
    # routing and the top-C re-rank pool run on each shard's slice), so
    # the probe set is a per-shard balanced cut; self-retrieval stays
    # exact while per-shard scan work shrinks.
    for shards in (1, 4, 8):
        mesh = make_search_mesh(shards, devices=[device] * shards) \
            if shards > 1 else None
        res = store.search(x[:32], topk=1, mode="B", mesh=mesh)
        acc = float(np.mean(res.ids.cpu().numpy()[:, 0] == np.arange(32)))
        print(f"  {shards}-way, nprobe={cfg.nprobe}/shard: self-retrieval "
              f"{acc:.2f}")
        out[f"self-retrieval {shards}"] = acc

    # Throughput scaling: also shard the query batch over the data axis.
    mesh = make_host_mesh(2, 4, devices=[device] * 8)
    res = store.search(q, topk=10, mode="B", mesh=mesh, shard_queries=True,
                       **ex)
    agree = bool(np.array_equal(res.ids.cpu().numpy(),
                                base.ids.cpu().numpy()))
    print(f"  (2 data x 4 model) mesh, queries batch-sharded: ids match: "
          f"{agree}")
    out["2 x 4"] = agree
    return out


if __name__ == "__main__":
    main()
