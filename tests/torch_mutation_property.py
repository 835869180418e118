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

The sharded twins (``mesh=``, a ``launch.mesh.SearchMesh`` of CPU slots):
the same checks through ``search(mesh=...)`` and
``coalesced_retrieve(mesh=...)``, whose knobs are per shard (exhaustive
on every shard).

The tenancy twin (``tenant_interleaving_check``): tenants of a
``serve.tenancy.TenantRegistry`` run per-tenant add/delete/upsert/seal
and registry evictions (freeze and thaw through an LRU of 2), deletes and
upserts hitting shared base gids too; every coalesced window must return
each tenant's own brute-force top-k.  Its knobs stay exhaustive after
the window's own evictions: ``nprobe`` and ``pool`` exceed anything a
plane holds (the store clamps them), since hydrating one tenant of the
window can freeze another and seal its memtable into a new segment after
any count of grains was taken.
"""
import numpy as np

from repro_torch.core import HNTLConfig, VectorStore

D = 16
NOW = 500.0                       # query-time clock (store clock pinned at 0)
OPS = ("add", "delete", "upsert", "seal", "compact", "maintain")
TENANT_OPS = ("add", "delete", "upsert", "seal", "evict", "retrieve")

#: The JAX package's tenant property fails on this interleaving (seed 0,
#: warm): its window counts the union's grains before the window freezes
#: t1, whose memtable then seals into a segment its nprobe never reaches.
STALE_KNOBS_EXAMPLE = (("add", 1), ("add", 1), ("upsert", 1))

#: Knobs above any plane's grains and slots: exhaustive after any seal.
EXHAUSTIVE = 1 << 20


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
                                adaptive_margin=None, mesh=None):
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
    if mesh is not None:
        kw["mesh"] = mesh
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


# ---------------------------------------------------------------- tenancy
def tenant_interleaving(seed: int, n_ops: int = 10) -> tuple:
    """A seeded interleaving of (op, tenant) pairs over ``TENANT_OPS``."""
    rng = np.random.default_rng(seed)
    return tuple((str(rng.choice(TENANT_OPS)), int(rng.integers(4)))
                 for _ in range(n_ops))


def _assert_matches_oracle(req, model, seed, ops):
    """One coalesced result == brute-force L2 over the tenant's live set
    (the id set, and the dists to 1e-4)."""
    live = [(g, v) for g, (v, tag, ts, exp) in sorted(model.items())
            if exp > NOW]
    ids = req.result.ids.numpy()
    dists = req.result.dists.numpy()
    if not live:
        assert (ids == -1).all(), (req.tenant, ids, seed, ops)
        return
    gs = np.fromiter((g for g, _ in live), np.int64, len(live))
    vs = np.stack([v for _, v in live])
    d_all = np.sum((vs - req.q[None, :]) ** 2, axis=-1)
    k_eff = min(req.topk, len(live))
    order = np.argsort(d_all)[:k_eff]
    assert set(ids[:k_eff].tolist()) == set(gs[order].tolist()), \
        (req.tenant, ids, gs[order], seed, ops)
    np.testing.assert_allclose(np.sort(dists[:k_eff]), np.sort(d_all[order]),
                               rtol=1e-4, atol=1e-4)
    assert (ids[k_eff:] == -1).all(), (req.tenant, ids, seed, ops)


def tenant_interleaving_check(ops, seed: int, cold: bool = False,
                              cold_dir=None, n_tenants: int = 3,
                              scan_impl=None, mesh=None):
    """Coalesced multi-tenant retrieval against per-tenant brute force.

    ``n_tenants`` branches of one base run ``ops`` ((op, tenant) pairs of
    ``TENANT_OPS``) with max_live=2, so freeze and thaw always run;
    deletes and upserts also hit shared base gids (the tenant stops
    seeing the shared row, or sees only its own new version, while the
    others keep the original).  After every "retrieve" op and at the end,
    one coalesced window over all tenants at ``EXHAUSTIVE`` knobs must
    return each tenant's own brute-force top-k.
    """
    from repro_torch.serve.tenancy import (RetrievalRequest, TenantRegistry,
                                           coalesced_retrieve)
    rng = np.random.default_rng(seed)
    base = VectorStore(_cfg(), seal_threshold=64, cold_tier=cold,
                       cold_dir=cold_dir, clock=lambda: 0.0, device="cpu")
    vecs = rng.standard_normal((32, D)).astype(np.float32)
    tags = rng.integers(1, 4, size=32)
    ts = rng.uniform(0.0, 10.0, size=32)
    gids = base.add(vecs, tags=tags.tolist(), ts=ts.tolist())
    shared = {g: (vecs[i], int(tags[i]), float(ts[i]), np.inf)
              for i, g in enumerate(np.asarray(gids, np.int64).tolist())}
    reg = TenantRegistry(base, memtable_budget=16, max_live=2)
    names = [f"t{i}" for i in range(n_tenants)]
    models = {n: dict(shared) for n in names}

    def write(name, gids=None):
        st = reg.get(name)
        n = 8 if gids is None else len(gids)
        v = rng.standard_normal((n, D)).astype(np.float32)
        tg = rng.integers(1, 4, size=n)
        tv = rng.uniform(0.0, 10.0, size=n)
        ttl = rng.uniform(100.0, 2000.0, size=n) \
            if rng.random() < 0.4 else None
        if gids is None:
            ids = st.add(v, tags=tg.tolist(), ts=tv.tolist(), ttl=ttl)
        else:
            ids = st.upsert(gids, v, tags=tg.tolist(), ts=tv.tolist(),
                            ttl=ttl)
        exp = ttl if ttl is not None else np.full(n, np.inf)
        for i, g in enumerate(np.asarray(ids, np.int64).tolist()):
            models[name][g] = (v[i], int(tg[i]), float(tv[i]), float(exp[i]))

    def window():
        reqs = []
        for rid, name in enumerate(names):
            live = [v for v, _, _, e in models[name].values() if e > NOW]
            near = (live[int(rng.integers(len(live)))] if live
                    else np.zeros(D, np.float32))
            q = (near + 0.05 * rng.standard_normal(D)).astype(np.float32)
            reqs.append(RetrievalRequest(rid=rid, tenant=name, q=q,
                                         topk=5, mode="B"))
        coalesced_retrieve(reg, reqs, scan_impl=scan_impl, mesh=mesh,
                           nprobe=EXHAUSTIVE, pool=EXHAUSTIVE, now=NOW)
        for r in reqs:
            _assert_matches_oracle(r, models[r.tenant], seed, ops)

    for op, who in ops:
        name = names[who % n_tenants]
        if op == "add":
            write(name)
        elif op == "seal":
            reg.get(name).seal()
        elif op == "evict":
            reg.evict(name)
        elif op == "retrieve":
            window()
        else:
            known = np.fromiter(sorted(models[name]), np.int64,
                                len(models[name]))
            if not len(known):
                continue
            k = min(len(known), 8 if op == "delete" else 4)
            sel = rng.choice(known, size=k, replace=False)
            if op == "delete":
                reg.get(name).delete(sel)
                for g in sel.tolist():
                    models[name].pop(g, None)
            else:
                write(name, gids=sel)
    window()
