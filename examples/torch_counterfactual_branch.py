"""Aperon cognitive-impedance demo on the PyTorch port: zero-copy
branching and mixed recall.

An agent snapshots its memory, forks two counterfactual branches that each
ingest different hypothetical observations, and queries each world; all
sealed segments are shared by reference (no copies, no graph re-wiring).
Runs on the card; ``--device cpu`` for the plain path.

  PYTHONPATH=src python examples/torch_counterfactual_branch.py
"""
import argparse
import numpy as np

from repro_torch.core import HNTLConfig
from repro_torch.core.index import resolve_device
from repro_torch.core.store import VectorStore
from repro_torch.data import synthetic as syn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = HNTLConfig(d=64, k=16, s=0, n_grains=8, nprobe=8, pool=32,
                     block=64)
    # cold raw tier in a new temporary directory of the store's own
    agent = VectorStore(cfg, seal_threshold=1024, cold_tier=True,
                        device=device)

    base = syn.clustered(3000, 64, n_clusters=16, seed=0)
    t = np.linspace(0.0, 3.0, 3000, endpoint=False)
    agent.add(base, tags=[1] * 3000, ts=list(t))        # episodic memory
    agent.seal()
    print(f"agent memory: {agent.n_vectors} vectors, "
          f"{agent.n_segments} sealed segments")

    # ---- fork two counterfactual worlds (O(1), shared segments) ----------
    world_a = agent.branch()
    world_b = agent.branch()
    rng = np.random.default_rng(1)
    obs_a = rng.standard_normal((50, 64)).astype(np.float32) + 3.0
    obs_b = rng.standard_normal((50, 64)).astype(np.float32) - 3.0
    ids_a = world_a.add(obs_a, tags=[4] * 50, ts=[5.0] * 50)
    world_b.add(obs_b, tags=[8] * 50, ts=[5.0] * 50)
    assert world_a._segments[0] is agent._segments[0]   # zero-copy proof
    print("forked world_a / world_b; sealed segments shared by reference")

    # ---- each world sees its own hypothesis, parent sees neither ---------
    q = obs_a[:1]
    hit_a = int(world_a.search(q, topk=1, mode="B").ids[0, 0])
    hit_p = int(agent.search(q, topk=1, mode="B").ids[0, 0])
    print(f"world_a nearest: id {hit_a} (its own obs: {hit_a == ids_a[0]}); "
          f"parent nearest: id {hit_p} (pre-fork memory)")

    # ---- mixed recall: symbolic tag + time window inside the scan --------
    res = world_a.search(q, topk=3, mode="B", tag_mask=4)
    tagged = res.ids[0].tolist()
    print("tag-filtered (hypothetical-only) hits:", tagged)
    res2 = world_a.search(q, topk=3, mode="B", ts_range=(0.0, 3.0))
    timed = res2.ids[0].tolist()
    print("time-filtered (pre-fork-only) hits:", timed)
    return dict(hit_a=hit_a, own=int(ids_a[0]), hit_parent=hit_p,
                tagged=tagged, timed=timed)


if __name__ == "__main__":
    main()
