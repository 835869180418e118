"""Mutation interleavings on the port's store, against brute force.

The PyTorch twin of ``mutation_property.mutation_interleaving_check``:
``mutation_interleaving_check`` drives a port ``VectorStore`` on the CPU
through an interleaving of add/seal/delete/upsert/compact/maintain ops
while it keeps a brute-force model (gid -> live record), then asserts that
the search, with and without tag and ts filters, returns exactly the
brute-force top-k over the surviving live set.  ``compact`` and
``maintain`` must keep the live id set exactly: no resurrections, no
drops.

The knobs are exhaustive (every grain probed, a pool of every slot) and
``envelope_frac=1.0`` prunes no grain, so Mode B reduces to exact filtered
L2 over the live set.  Plain module (no hypothesis, no JAX): the test
runs it over a fixed list of seeded interleavings.

The cascade's twin (``scan_impl`` a staged plane, ``budgeted=True``):
budgets=(pool, pool) cover every live slot, so stage 1 prunes nothing
real and the result must still be the brute-force top-k; with
``device_budget`` set the store searches its tiered plane, where the
budgets act on each pass.

Adaptive routing's twin (``adaptive_margin``): a huge finite margin at
exhaustive nprobe keeps every valid grain active but still kills the
invalid (BIG-distance) probes, so the stable partition and the bucketed
dispatch run, and the result must still be the brute-force top-k
(``cold_tier=True`` for a store whose raw rows live in cold files).
"""
import numpy as np

from repro_torch.core import HNTLConfig, VectorStore

D = 16
NOW = 500.0                       # query-time clock (store clock pinned at 0)
OPS = ("add", "delete", "upsert", "seal", "compact", "maintain")


def _cfg(bit_alloc: str = "fixed"):
    return HNTLConfig(d=D, k=4, s=2, n_grains=2, nprobe=2, pool=64,
                      block=16, envelope_frac=1.0, bit_alloc=bit_alloc)


def interleaving(seed: int, n_ops: int = 12) -> tuple:
    """A seeded interleaving of ``n_ops`` ops (every op at least once
    when n_ops >= len(OPS))."""
    rng = np.random.default_rng(seed)
    ops = list(OPS) + list(rng.choice(OPS, size=max(0, n_ops - len(OPS))))
    return tuple(str(op) for op in rng.permutation(ops))


def mutation_interleaving_check(ops, seed: int, bit_alloc: str = "fixed",
                                scan_impl=None, budgeted: bool = False,
                                device_budget=None, cold_dir=None,
                                cold_tier: bool = False,
                                adaptive_margin=None):
    rng = np.random.default_rng(seed)
    store = VectorStore(_cfg(bit_alloc), seal_threshold=64,
                        clock=lambda: 0.0, device="cpu",
                        device_budget=device_budget, cold_dir=cold_dir,
                        cold_tier=cold_tier, prefetch_grains=1)
    model = {}                    # gid -> (vec, tag, ts, expire_at)

    def write(gids=None):
        n = 32 if gids is None else len(gids)
        vecs = rng.standard_normal((n, D)).astype(np.float32)
        tags = rng.integers(1, 4, size=n)
        ts = rng.uniform(0.0, 10.0, size=n)
        ttl = rng.uniform(100.0, 2000.0, size=n) \
            if rng.random() < 0.4 else None
        if gids is None:
            ids = store.add(vecs, tags=tags.tolist(), ts=ts.tolist(),
                            ttl=ttl)
        else:
            ids = store.upsert(gids, vecs, tags=tags.tolist(),
                               ts=ts.tolist(), ttl=ttl)
        exp = ttl if ttl is not None else np.full(n, np.inf)
        for i, g in enumerate(np.asarray(ids, np.int64).tolist()):
            model[g] = (vecs[i], int(tags[i]), float(ts[i]), float(exp[i]))

    write()
    for op in ops:
        if op == "add":
            write()
        elif op == "seal":
            store.seal()
        elif op == "compact":
            store.compact(fanin=2, now=NOW)
        elif op == "maintain":
            store.maintain(now=NOW)
        else:
            known = np.fromiter(sorted(model), np.int64, len(model))
            if not len(known):
                continue
            k = min(len(known), 12 if op == "delete" else 6)
            sel = rng.choice(known, size=k, replace=False)
            if op == "delete":
                store.delete(sel)
                for g in sel.tolist():
                    model.pop(g, None)
            else:
                write(gids=sel)

    live = [(g, v, tag, ts) for g, (v, tag, ts, exp)
            in sorted(model.items()) if exp > NOW]
    qs = [rng.standard_normal(D).astype(np.float32) for _ in range(2)]
    near = (live[int(rng.integers(len(live)))][1] if live
            else np.zeros(D, np.float32))
    qs.append(near + 0.01 * rng.standard_normal(D).astype(np.float32))
    q = np.stack(qs)

    total_grains = sum(s.index.grains.n_grains for s in store._segments)
    kw = dict(topk=5, mode="B", now=NOW, nprobe=max(total_grains, 1),
              pool=max(2 * store.n_vectors, 1), scan_impl=scan_impl)
    if budgeted:
        kw["budgets"] = (kw["pool"], kw["pool"])
    if adaptive_margin is not None:
        kw.update(adaptive=True, probe_margin=float(adaptive_margin))
    assert store.n_live(now=NOW) == len(live)
    for filt in ({}, {"tag_mask": 2}, {"ts_range": (2.0, 8.0)}):
        res = store.search(q, **kw, **filt)
        ids = res.ids.numpy()
        dists = res.dists.numpy()
        cand = [(g, v) for (g, v, tag, ts) in live
                if ("tag_mask" not in filt or (tag & filt["tag_mask"]) != 0)
                and ("ts_range" not in filt
                     or filt["ts_range"][0] <= ts < filt["ts_range"][1])]
        if not cand:
            assert (ids == -1).all(), (filt, ids)
            continue
        gs = np.fromiter((g for g, _ in cand), np.int64, len(cand))
        vs = np.stack([v for _, v in cand])
        d_all = np.sum((vs[None, :, :] - q[:, None, :]) ** 2, axis=-1)
        k_eff = min(5, len(cand))
        for qi in range(q.shape[0]):
            order = np.argsort(d_all[qi])[:k_eff]
            assert set(ids[qi, :k_eff].tolist()) \
                == set(gs[order].tolist()), \
                (filt, qi, ids[qi], gs[order], seed, ops)
            np.testing.assert_allclose(np.sort(dists[qi, :k_eff]),
                                       np.sort(d_all[qi][order]),
                                       rtol=1e-4, atol=1e-4)
            assert (ids[qi, k_eff:] == -1).all(), (filt, qi, ids[qi])
