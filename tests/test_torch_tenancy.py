"""Multi-tenant serving in the port: ``repro_torch.serve``.

Twins of the JAX package's ``tests/test_tenancy.py`` (its sharded ones
are in ``test_torch_sharded.py``) on the CPU, at its sizes (d=16, k=4,
block=16):

- **registry lifecycle**: copy-on-write branches, the memtable budget's
  forced seal, argument checks, the LRU's freeze and thaw, explicit
  eviction, manifests across eviction, the union's order, maintenance.
- **coalesced == solo**: every coalesced request against its tenant's
  own ``search`` with the same knobs, on every plane that runs on the CPU
  ("ref", "kernel", "fused", "fused_ref", "cascade", "cascade_ref"), Mode
  A and B, and at default knobs.  The reference demands bit identity,
  which rests on XLA giving a row the same bits at any batch shape; torch
  promises no such thing (a matrix product's rows may change with the
  batch), so ids are held exactly and dists to rtol 1e-5, atol 1e-5.
  Where coalescing changes no shape (requests reordered inside one
  padded bucket, "fused" against "fused_ref"), results are
  ``torch.equal``.
- isolation (private rows, shared-gid deletes and upserts), filters and
  TTL, the empty store, mixed groups, the cold tier, batch-window
  determinism, padding buckets, zero re-stacks and one dispatch per
  group; the engine's sidecar; the twins of the tenancy cases of
  ``test_coldtier.py``, ``test_cascade.py``, ``test_adaptive.py`` and
  ``test_store_mutation.py``; the tenant interleaving property
  (``torch_mutation_property.tenant_interleaving_check``) against brute
  force; and, where JAX is installed, ``search_stacked`` and the store's
  fused dispatch with a tenant bitmap held to the JAX package's on a
  manifest carried across.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import HNTLConfig, VectorStore, planner
from repro_torch.core import store as store_mod
from repro_torch.serve import (RetrievalRequest, ServeEngine,
                               TenantRegistry, coalesced_retrieve)
from repro_torch.serve import tenancy

import torch_mutation_property as tmp

D = 16
PLANES = ["ref", "kernel", "fused", "fused_ref", "cascade", "cascade_ref"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one thread each, so a worker among several
    on a busy host does not spin a pool of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return HNTLConfig(d=D, k=4, s=0, n_grains=2, nprobe=2, pool=64,
                      block=16, envelope_frac=1.0, **kw)


def _base(n=96, cold=False, seed=0, cold_dir=None):
    rng = np.random.default_rng(seed)
    st = VectorStore(_cfg(), seal_threshold=32, cold_tier=cold,
                     cold_dir=cold_dir, clock=lambda: 0.0, device="cpu")
    st.add(rng.standard_normal((n, D)).astype(np.float32),
           tags=rng.integers(1, 4, size=n).tolist(),
           ts=rng.uniform(0.0, 10.0, size=n).tolist())
    return st, rng


def _exhaustive(reg):
    union = reg.union_segments()
    return dict(nprobe=max(sum(s.index.grains.n_grains for s in union), 1),
                pool=max(2 * sum(s.n for s in union) + 64, 1))


def _solo(reg, req, scan_impl=None, now=0.0, **knobs):
    return reg.get(req.tenant).search(
        req.q[None], topk=req.topk, mode=req.mode, tag_mask=req.tag_mask,
        ts_range=req.ts_range, scan_impl=scan_impl, now=now, **knobs)


def _assert_solo_parity(reg, reqs, scan_impl=None, now=0.0, **knobs):
    """Every coalesced result: its tenant's solo ids, dists to 1e-5."""
    for r in reqs:
        assert r.done and r.result is not None
        solo = _solo(reg, r, scan_impl=scan_impl, now=now, **knobs)
        assert torch.equal(r.result.ids, solo.ids[0]), (r.rid, r.tenant)
        torch.testing.assert_close(r.result.dists, solo.dists[0],
                                   rtol=1e-5, atol=1e-5)


def _populate(reg, rng, names, n_priv=40):
    """Private writes per tenant: a forced seal (budget 16 < n_priv),
    memtable rows left over, and two private deletes."""
    own = {}
    for t, name in enumerate(names):
        st = reg.get(name)
        own[name] = st.add(
            (10.0 * (t + 1) + rng.standard_normal((n_priv, D))
             ).astype(np.float32),
            tags=rng.integers(1, 4, size=n_priv).tolist(),
            ts=rng.uniform(0.0, 10.0, size=n_priv).tolist())
        st.delete(own[name][:2])
    return own


def _window(rng, names, n=8, topk=5, mode="B", **kw):
    return [RetrievalRequest(
        rid=i, tenant=names[i % len(names)],
        q=rng.standard_normal(D).astype(np.float32), topk=topk, mode=mode,
        **kw) for i in range(n)]


def _ids(r):
    return {int(i) for i in r.result.ids.tolist() if i >= 0}


# ---------------------------------------------------------------------------
# registry lifecycle
# ---------------------------------------------------------------------------


def test_branch_shares_segments_cow():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    n0 = base.n_segments
    a = reg.get("a")
    assert all(sa is sb for sa, sb in zip(a._segments, base._segments))
    a.add(rng.standard_normal((4, D)).astype(np.float32))
    a.seal()
    assert base.n_segments == n0
    assert a.n_segments == n0 + 1
    assert a.device == base.device


def test_budget_overflow_forces_seal_not_data_loss():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=8, max_live=4)
    st = reg.get("a")
    vecs = rng.standard_normal((30, D)).astype(np.float32)
    ids = st.add(vecs)
    assert st.n_segments > base.n_segments, "the budget must force a seal"
    assert len(st._mem) < 8
    res = st.search(vecs, topk=1, mode="B", **_exhaustive(reg))
    assert res.ids[:, 0].tolist() == ids.tolist()


def test_registry_arg_validation():
    base, _ = _base()
    with pytest.raises(ValueError):
        TenantRegistry(base, memtable_budget=0)
    with pytest.raises(ValueError):
        TenantRegistry(base, max_live=0)


def test_lru_eviction_bounds_live_and_thaws_bit_identical():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=2)
    own = _populate(reg, rng, ["a", "b"], n_priv=20)
    reg.get("a").seal(), reg.get("b").seal()
    q = rng.standard_normal((2, D)).astype(np.float32)
    before = reg.get("a").search(q, topk=6, mode="B")
    reg.get("c")
    reg.get("d")
    assert reg.n_live == 2
    after = reg.get("a").search(q, topk=6, mode="B")   # thawed
    assert torch.equal(before.ids, after.ids)
    assert torch.equal(before.dists, after.dists)
    got = set(after.ids.flatten().tolist()) - set(range(96)) - {-1}
    assert got <= set(own["a"].tolist())


def test_explicit_evict_and_rehydration_state():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    st = reg.get("a")
    st.add(rng.standard_normal((4, D)).astype(np.float32))
    tag, epoch, nid = st._cold_tag, st._epoch, st._next_id
    assert reg.evict("a") is True
    assert reg.evict("a") is False
    assert reg.evict("nope") is False
    st2 = reg.get("a")
    assert st2 is not st and st2.device == base.device
    assert st2._cold_tag == tag
    assert st2._epoch == epoch and st2._next_id == nid
    assert len(st2._mem) == 0                # the freeze sealed it


def test_evicted_tenants_manifest_stays_valid():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    st = reg.get("a")
    st.add(rng.standard_normal((6, D)).astype(np.float32))
    man = st.snapshot()
    q = rng.standard_normal((2, D)).astype(np.float32)
    before = st.search(q, topk=5, manifest=man)
    reg.evict("a")
    after = reg.get("a").search(q, topk=5, manifest=man)
    assert torch.equal(before.ids, after.ids)


def test_union_segments_stable_under_lru_access_order():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=8, max_live=4)
    for n in ["a", "b", "c"]:
        reg.get(n).add(rng.standard_normal((10, D)).astype(np.float32))
    u1 = reg.union_segments()
    reg.get("c"), reg.get("a"), reg.get("b")
    u2 = reg.union_segments()
    assert len(u1) == len(u2) and all(x is y for x, y in zip(u1, u2))
    assert len({id(s) for s in u1}) == len(u1)
    assert reg.tenants() == ("a", "b", "c")


def test_run_maintenance_off_serving_path():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=8, max_live=4)
    st = reg.get("a")
    ids = st.add(rng.standard_normal((24, D)).astype(np.float32))
    st.delete(ids[:20])
    rep = reg.run_maintenance(now=0.0)
    assert set(rep) == {"a"}
    reqs = _window(rng, ["a"], n=2)
    coalesced_retrieve(reg, reqs, **_exhaustive(reg))
    _assert_solo_parity(reg, reqs, **_exhaustive(reg))
    got = set().union(*(_ids(r) for r in reqs))
    assert not (got & set(ids[:20].tolist())), "maintenance resurrected"


# ---------------------------------------------------------------------------
# coalesced == solo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["A", "B"])
@pytest.mark.parametrize("plane", PLANES)
def test_coalesced_equals_solo_every_plane(mode, plane):
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    _populate(reg, rng, ["a", "b", "c"])
    reqs = _window(rng, ["a", "b", "c"], n=9, mode=mode)
    kn = _exhaustive(reg)
    coalesced_retrieve(reg, reqs, scan_impl=plane, **kn)
    _assert_solo_parity(reg, reqs, scan_impl=plane, **kn)


def test_coalesced_equals_solo_default_knobs():
    """Default knobs: routing picks the same grains per query whether or
    not other tenants ride the batch."""
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    _populate(reg, rng, ["a", "b"])
    reqs = _window(rng, ["a", "b"], n=6)
    coalesced_retrieve(reg, reqs)
    _assert_solo_parity(reg, reqs)


@pytest.mark.parametrize("mode", ["A", "B"])
def test_coalesced_fused_equals_fused_ref_bit_for_bit(mode):
    """The select plane against its plain version on the same coalesced
    window: the same shapes, so ``torch.equal``."""
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    _populate(reg, rng, ["a", "b", "c"])
    rng_q = np.random.default_rng(7)
    a = _window(rng_q, ["a", "b", "c"], n=11, mode=mode)
    rng_q = np.random.default_rng(7)
    b = _window(rng_q, ["a", "b", "c"], n=11, mode=mode)
    coalesced_retrieve(reg, a, scan_impl="fused")
    coalesced_retrieve(reg, b, scan_impl="fused_ref")
    for x, y in zip(a, b):
        assert torch.equal(x.result.ids, y.result.ids)
        assert torch.equal(x.result.dists, y.result.dists)


def test_cross_tenant_isolation_private_rows():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    own = _populate(reg, rng, ["a", "b"])
    # aimed at the OTHER tenant's private cluster: nothing of it may come
    # back, though its rows are the nearest in the union
    reqs = [RetrievalRequest(rid=0, tenant="a",
                             q=np.full(D, 20.0, np.float32), topk=8,
                             mode="B"),
            RetrievalRequest(rid=1, tenant="b",
                             q=np.full(D, 10.0, np.float32), topk=8,
                             mode="B")]
    coalesced_retrieve(reg, reqs, **_exhaustive(reg))
    for r in reqs:
        priv = _ids(r) - set(range(96))
        mine = set(own[r.tenant].tolist())
        assert priv <= mine, f"{r.tenant} leaked {sorted(priv - mine)[:4]}"


def _base_vecs(n=96, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    st = VectorStore(_cfg(), seal_threshold=32, clock=lambda: 0.0,
                     device="cpu")
    st.add(vecs)
    return st, rng, vecs


def test_shared_gid_delete_is_tenant_scoped():
    base, rng, vecs = _base_vecs()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    reg.get("a").delete([0, 1, 2])
    reg.get("b")
    reqs = [RetrievalRequest(rid=0, tenant="a", q=vecs[0], topk=4,
                             mode="B"),
            RetrievalRequest(rid=1, tenant="b", q=vecs[0], topk=4,
                             mode="B")]
    coalesced_retrieve(reg, reqs, **_exhaustive(reg))
    assert not ({0, 1, 2} & _ids(reqs[0])), "a sees its own deletes"
    assert int(reqs[1].result.ids[0]) == 0, "b still sees the shared row"


def test_shared_gid_upsert_shadows_only_in_writer():
    base, rng, vecs = _base_vecs()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    reg.get("b")
    orig = vecs[0]
    newv = (orig + 5.0).astype(np.float32)
    reg.get("a").upsert([0], newv[None])
    reqs = [RetrievalRequest(rid=0, tenant="a", q=newv, topk=1, mode="B"),
            RetrievalRequest(rid=1, tenant="b", q=newv, topk=1, mode="B"),
            RetrievalRequest(rid=2, tenant="b", q=orig, topk=1, mode="B")]
    coalesced_retrieve(reg, reqs, **_exhaustive(reg))
    assert int(reqs[0].result.ids[0]) == 0
    assert float(reqs[0].result.dists[0]) < 1e-3, "the writer's new version"
    assert float(reqs[2].result.dists[0]) < 1e-3, "b keeps the original"
    _assert_solo_parity(reg, reqs, **_exhaustive(reg))


def test_filters_and_ttl_through_coalesce():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    st = reg.get("a")
    # tag 8: the base's tags are 1..3, so tag_mask=8 selects this batch
    ids = st.add(rng.standard_normal((8, D)).astype(np.float32),
                 tags=[8] * 8, ts=[5.0] * 8, ttl=100.0)
    st.seal()
    reqs = [RetrievalRequest(rid=0, tenant="a",
                             q=rng.standard_normal(D).astype(np.float32),
                             topk=5, mode="B", tag_mask=8),
            RetrievalRequest(rid=1, tenant="a",
                             q=rng.standard_normal(D).astype(np.float32),
                             topk=5, mode="B", ts_range=(4.0, 6.0))]
    kn = _exhaustive(reg)
    coalesced_retrieve(reg, reqs, now=0.0, **kn)
    _assert_solo_parity(reg, reqs, now=0.0, **kn)
    got = _ids(reqs[0])
    assert got and got <= set(ids.tolist()), got
    late = [RetrievalRequest(rid=0, tenant="a",
                             q=rng.standard_normal(D).astype(np.float32),
                             topk=5, mode="B", tag_mask=8)]
    coalesced_retrieve(reg, late, now=500.0, **kn)
    assert (late[0].result.ids == -1).all(), "expired through the window"


def test_empty_store_returns_all_minus_one():
    st = VectorStore(_cfg(), seal_threshold=32, clock=lambda: 0.0,
                     device="cpu")
    reg = TenantRegistry(st, memtable_budget=8, max_live=2)
    reqs = [RetrievalRequest(rid=0, tenant="ghost",
                             q=np.zeros(D, np.float32), topk=3, mode="B")]
    coalesced_retrieve(reg, reqs)
    assert reqs[0].done and (reqs[0].result.ids == -1).all()
    assert reqs[0].result.ids.shape == (3,)


def test_mixed_topk_and_mode_groups_one_batch():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    _populate(reg, rng, ["a", "b"])
    kn = _exhaustive(reg)
    reqs = [RetrievalRequest(rid=0, tenant="a",
                             q=rng.standard_normal(D).astype(np.float32),
                             topk=3, mode="A"),
            RetrievalRequest(rid=1, tenant="b",
                             q=rng.standard_normal(D).astype(np.float32),
                             topk=7, mode="B"),
            RetrievalRequest(rid=2, tenant="a",
                             q=rng.standard_normal(D).astype(np.float32),
                             topk=7, mode="B", tag_mask=1)]
    coalesced_retrieve(reg, reqs, **kn)
    _assert_solo_parity(reg, reqs, **kn)
    assert [r.result.ids.shape[0] for r in reqs] == [3, 7, 7]


@pytest.mark.parametrize("cold", [False, True])
def test_cold_tier_coalesced_parity(cold, tmp_path):
    base, rng = _base(cold=cold, cold_dir=str(tmp_path))
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    _populate(reg, rng, ["a", "b"])
    reqs = _window(rng, ["a", "b"], n=6, mode="B")
    kn = _exhaustive(reg)
    coalesced_retrieve(reg, reqs, **kn)
    _assert_solo_parity(reg, reqs, **kn)
    assert all(s.cold_path is not None for s in reg.union_segments()) \
        == cold


def test_batch_window_determinism_order_and_slicing():
    """The same requests give each rid the same result however they
    arrive or are cut into windows: bit for bit where the padded bucket
    is the same (reordering inside one window), to 1e-5 where it is not
    (a 10-request window pads to 16 rows, its slices to 8)."""
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    _populate(reg, rng, ["a", "b", "c"])
    kn = _exhaustive(reg)

    def run(order, slices):
        reqs = _window(np.random.default_rng(3), ["a", "b", "c"], n=10)
        reqs = [reqs[i] for i in order]
        lo = 0
        for n in slices:
            coalesced_retrieve(reg, reqs[lo:lo + n], **kn)
            lo += n
        assert lo == len(reqs)
        return {r.rid: r.result for r in reqs}

    ref = run(list(range(10)), [10])
    for order, slices, same_shape in [
            (list(range(9, -1, -1)), [10], True),
            ([7, 2, 9, 0, 5, 1, 8, 3, 6, 4], [10], True),
            (list(range(10)), [3, 3, 4], False),
            ([7, 2, 9, 0, 5, 1, 8, 3, 6, 4], [1] * 10, False)]:
        got = run(order, slices)
        for rid, want in ref.items():
            assert torch.equal(got[rid].ids, want.ids), (rid, order)
            if same_shape:
                assert torch.equal(got[rid].dists, want.dists)
            else:
                torch.testing.assert_close(got[rid].dists, want.dists,
                                           rtol=1e-5, atol=1e-5)


def test_padding_buckets_do_not_perturb():
    """Batch sizes around the bucket boundary (1..10 over 8): padding
    rows carry tenant 0 and are dropped, never merged."""
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    _populate(reg, rng, ["a", "b"])
    kn = _exhaustive(reg)
    assert [tenancy.pad_rows(n) for n in (1, 8, 9, 17)] == [8, 8, 16, 32]
    for n in [1, 2, 7, 8, 9, 10]:
        reqs = _window(rng, ["a", "b"], n=n)
        coalesced_retrieve(reg, reqs, **kn)
        _assert_solo_parity(reg, reqs, **kn)


def test_zero_restacks_and_one_dispatch_per_group(monkeypatch):
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    _populate(reg, rng, ["a", "b"])
    coalesced_retrieve(reg, _window(rng, ["a", "b"], n=4))   # the plane
    count = {"stacks": 0, "dispatches": 0, "rows": []}
    real_stack, real_search = store_mod.stack_segments, \
        planner.search_stacked

    def stack(*a, **kw):
        count["stacks"] += 1
        return real_stack(*a, **kw)

    def search(stacked, q, **kw):
        count["dispatches"] += 1
        count["rows"].append(q.shape[0])
        return real_search(stacked, q, **kw)

    monkeypatch.setattr(store_mod, "stack_segments", stack)
    monkeypatch.setattr(planner, "search_stacked", search)
    for _ in range(3):
        reqs = (_window(rng, ["a", "b"], n=5, topk=5, mode="B")
                + _window(rng, ["b", "a"], n=3, topk=3, mode="A"))
        for i, r in enumerate(reqs):
            r.rid = i
        coalesced_retrieve(reg, reqs)
    assert count["stacks"] == 0, "the hot path re-stacked the union plane"
    assert count["dispatches"] == 6, count   # 2 groups x 3 windows
    assert count["rows"] == [8] * 6          # both groups pad to 8


# ---------------------------------------------------------------------------
# the engine's sidecar
# ---------------------------------------------------------------------------


def _engine(reg):
    eng = ServeEngine.__new__(ServeEngine)
    eng.memory = reg.base
    eng.tenants = reg
    eng.memory_mesh = None
    eng.scan_impl = None
    return eng


def test_engine_validates_before_dispatch():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    eng = _engine(reg)
    q = np.zeros(D, np.float32)
    for bad in [dict(topk=0), dict(topk=-1), dict(topk=True),
                dict(topk="4"), dict(mode="Z"), dict(mode="b")]:
        with pytest.raises(ValueError):
            eng.retrieve(q, **bad)
    with pytest.raises(ValueError):
        eng.retrieve(np.zeros(D + 1, np.float32))
    with pytest.raises(ValueError):
        eng.submit_retrieval(np.zeros((2, D), np.float32), tenant="a")
    no_mem = ServeEngine.__new__(ServeEngine)
    with pytest.raises(ValueError):
        no_mem.retrieve(q)
    no_ten = ServeEngine.__new__(ServeEngine)
    no_ten.memory = base
    with pytest.raises(ValueError):
        no_ten.retrieve(q, tenant="a")
    with pytest.raises(ValueError):
        no_ten.submit_retrieval(q, tenant="a")


def test_engine_empty_store_retrieval():
    st = VectorStore(_cfg(), seal_threshold=32, clock=lambda: 0.0,
                     device="cpu")
    reg = TenantRegistry(st, memtable_budget=8, max_live=2)
    eng = _engine(reg)
    res = eng.retrieve(np.zeros(D, np.float32), topk=4, tenant="ghost")
    assert res.ids.shape == (1, 4) and (res.ids == -1).all()
    res2 = eng.retrieve(np.zeros(D, np.float32), topk=4)
    assert (res2.ids == -1).all()


def test_engine_tenant_retrieve_matches_solo():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    eng = _engine(reg)
    eng.remember(rng.standard_normal((6, D)).astype(np.float32), tenant="a")
    q = rng.standard_normal((2, D)).astype(np.float32)
    res = eng.retrieve(q, topk=5, tenant="a")
    solo = reg.get("a").search(q, topk=5, mode="B")
    assert torch.equal(res.ids, solo.ids)
    torch.testing.assert_close(res.dists, solo.dists, rtol=1e-5, atol=1e-5)


def test_engine_submit_flush_windows():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    eng = _engine(reg)
    reqs = [eng.submit_retrieval(
        rng.standard_normal(D).astype(np.float32), tenant=f"t{i % 3}",
        topk=4) for i in range(7)]
    assert eng.flush_retrievals() == reqs
    assert all(r.done for r in reqs)
    assert eng.flush_retrievals() == []
    reqs2 = [eng.submit_retrieval(
        rng.standard_normal(D).astype(np.float32), tenant="t0", topk=4)
        for _ in range(5)]
    done = eng.flush_retrievals(max_batch=2)
    assert len(done) == 2 and all(r.done for r in done)
    assert not reqs2[2].done
    assert len(eng.flush_retrievals()) == 3
    rids = [r.rid for r in reqs + reqs2]
    assert len(set(rids)) == len(rids)


def test_engine_mutations_route_to_tenant():
    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    eng = _engine(reg)
    ids = eng.remember(rng.standard_normal((4, D)).astype(np.float32),
                       tenant="a")
    assert eng.evict(ids[:2], tenant="a") == 2
    newv = rng.standard_normal((1, D)).astype(np.float32)
    eng.refresh(ids[2:3], newv, tenant="a")
    res = eng.retrieve(newv[0], topk=1, tenant="a")
    assert int(res.ids[0, 0]) == int(ids[2])
    assert base._live_seq == {}
    assert reg.get("b")._live_seq == {}


def test_engine_validates_adaptive_flags_then_sets_memory_budget():
    """The reference's constructor checks, in its order; a refused
    engine touches no store, and an engine on a smoke model sets its
    ``memory_budget`` on the store."""
    import types

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    dummy = types.SimpleNamespace(cfg=None)
    with pytest.raises(ValueError, match="adaptive=True"):
        ServeEngine(dummy, None, probe_margin=0.25)
    with pytest.raises(ValueError, match="min_probes"):
        ServeEngine(dummy, None, adaptive=True, min_probes=0)
    with pytest.raises(ValueError, match="adaptive=True"):
        ServeEngine(dummy, None, probe_margin=0.25, memory_budget=-1)
    with pytest.raises(ValueError, match="memory_budget must be"):
        ServeEngine(dummy, None, memory_budget=True)
    with pytest.raises(ValueError, match="requires memory="):
        ServeEngine(dummy, None, memory_budget=1024)
    st, _ = _base()
    with pytest.raises(ValueError, match="adaptive=True"):
        ServeEngine(dummy, None, memory=st, memory_budget=1024,
                    probe_margin=0.25)
    assert st.device_budget is None
    model = get_model(get_smoke_config("phi3-mini-3.8b"))
    eng = ServeEngine(model, model.init(0, device="cpu"), n_slots=2,
                      max_len=32, memory=st, memory_budget=1024)
    assert st.device_budget == 1024 and eng.memory_budget == 1024
    assert eng.memory_residency() is not None


def test_engine_memory_eviction_api():
    eng = ServeEngine.__new__(ServeEngine)
    eng.memory = VectorStore(_cfg(), seal_threshold=64, clock=lambda: 0.0,
                             device="cpu")
    eng.memory_mesh = None
    docs = np.eye(4, D, dtype=np.float32)
    ids = eng.remember(docs, ttl=120.0)
    assert int(eng.retrieve(docs[:1], topk=1).ids[0, 0]) == int(ids[0])
    assert eng.evict(ids[:1]) == 1
    assert int(eng.retrieve(docs[:1], topk=1).ids[0, 0]) != int(ids[0])
    eng.refresh(ids[1:2], np.full((1, D), 2.5, np.float32))
    ref = eng.retrieve(np.full((1, D), 2.5, np.float32), topk=1)
    assert int(ref.ids[0, 0]) == int(ids[1])
    assert eng.memory_residency() is None
    eng.memory.device_budget = 0
    assert eng.memory_residency()["n_grains"] == 0


def test_mesh_stays_refused():
    """The sharded plane is ported: a coalesced window on a 2-shard CPU
    mesh equals the single-device window (ids exactly, dists to 1e-5)
    at exhaustive knobs, and only a mesh on other devices than the base
    store's is refused."""
    from repro_torch.launch.mesh import make_search_mesh

    base, rng = _base()
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    reg.get("a").add(rng.standard_normal((20, D)).astype(np.float32))
    reg.get("b").delete([0, 1, 2])
    kn = _exhaustive(reg)
    names = ["a", "b"]
    single = coalesced_retrieve(reg, _window(np.random.default_rng(4),
                                             names), **kn)
    sharded = coalesced_retrieve(
        reg, _window(np.random.default_rng(4), names),
        mesh=make_search_mesh(2, devices=["cpu"] * 2), **kn)
    for a, b in zip(single, sharded):
        assert torch.equal(a.result.ids, b.result.ids)
        np.testing.assert_allclose(a.result.dists.numpy(),
                                   b.result.dists.numpy(), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="do not match"):
        coalesced_retrieve(reg, _window(rng, ["a"], n=1),
                           mesh=make_search_mesh(1, devices=["cuda:0"]))


# ---------------------------------------------------------------------------
# twins of the tenancy cases of the other reference files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["A", "B"])
def test_paged_parity_tenants(mode, tmp_path):
    """Under a device_budget the coalesced window pages through the
    tiered plane (``_plane_entry_for``): ids and dists equal to the
    all-warm coalesced window's (``torch.equal``), on every budget."""
    r = np.random.default_rng(5)
    x = (r.standard_normal((512, D)) * 3.0).astype(np.float32)
    qs = (r.standard_normal((6, D)) * 3.0).astype(np.float32)
    tv = {t: (r.standard_normal((8, D)) * 3.0).astype(np.float32)
          for t in ("a", "b")}

    def serve(budget):
        st = VectorStore(HNTLConfig(d=D, k=4, s=2, block=16, n_grains=8,
                                    nprobe=4, pool=32),
                         seal_threshold=128, device="cpu",
                         device_budget=budget, residency_interval=4,
                         prefetch_grains=2, cold_dir=str(tmp_path))
        for lo in range(0, 512, 128):
            st.add(x[lo:lo + 128])
        st.delete(np.arange(0, 512, 7))
        reg = TenantRegistry(st, memtable_budget=64)
        for t in ("a", "b"):
            reg.get(t).add(tv[t])
            reg.get(t).seal()
        reg.get("a").delete([1, 2, 3])
        out = []
        for rnd in range(2):
            reqs = [RetrievalRequest(
                rid=i, tenant=("a", "b")[i % 2], q=qs[i], topk=4,
                mode=mode, tag_mask=None, ts_range=None)
                for i in range(len(qs))]
            coalesced_retrieve(reg, reqs)
            out.append(reqs)
        return out, st

    warm, _ = serve(None)
    for budget in (0, 8192, 10 ** 12):
        paged, st = serve(budget)
        for rw, rp in zip(warm, paged):
            for a, b in zip(rw, rp):
                assert torch.equal(a.result.ids, b.result.ids), budget
                assert torch.equal(a.result.dists, b.result.dists), budget
        assert st.residency_stats()["searches"] == 2
        if budget == 0:
            assert st.residency_stats()["chunk_dispatches"] > 0


def test_tenant_coalesced_equals_solo_cascade():
    rng = np.random.default_rng(3)
    cfg = HNTLConfig(d=16, k=4, s=0, n_grains=2, nprobe=2, pool=32,
                     block=16, envelope_frac=1.0, bit_alloc="density")
    base = VectorStore(cfg, seal_threshold=64, device="cpu")
    base.add(rng.standard_normal((96, 16)).astype(np.float32))
    reg = TenantRegistry(base, memtable_budget=32)
    for t in range(3):
        reg.get(f"t{t}").add(rng.standard_normal((8, 16)).astype(np.float32))
    qs = rng.standard_normal((6, 16)).astype(np.float32)
    for plane in ("cascade", "cascade_ref"):
        reqs = [RetrievalRequest(rid=i, tenant=f"t{i % 3}", q=qs[i],
                                 topk=4, mode="B") for i in range(6)]
        coalesced_retrieve(reg, reqs, scan_impl=plane, budgets=(64, 16),
                           nprobe=8, pool=64)
        for i, r in enumerate(reqs):
            solo = reg.get(r.tenant).search(
                qs[i], topk=4, mode="B", scan_impl=plane, budgets=(64, 16),
                nprobe=8, pool=64)
            assert torch.equal(r.result.ids, solo.ids[0]), (plane, i)
            torch.testing.assert_close(r.result.dists, solo.dists[0],
                                       rtol=1e-5, atol=1e-5)


def test_budget_validation_at_tenancy_level():
    rng = np.random.default_rng(4)
    base = VectorStore(HNTLConfig(d=16, k=4, s=0, n_grains=2, nprobe=2,
                                  pool=32, block=16), seal_threshold=64,
                       device="cpu")
    base.add(rng.standard_normal((64, 16)).astype(np.float32))
    reg = TenantRegistry(base)
    req = RetrievalRequest(rid=0, tenant="t0",
                           q=rng.standard_normal(16).astype(np.float32),
                           topk=8, mode="B")
    with pytest.raises(ValueError, match="< topk"):
        coalesced_retrieve(reg, [req], scan_impl="cascade_ref",
                           budgets=(32, 4))
    with pytest.raises(ValueError, match="not staged"):
        coalesced_retrieve(reg, [req], scan_impl="fused_ref",
                           budgets=(32, 16))


def test_tenant_coalesced_adaptive_identity():
    """inf is the static coalesced window bit for bit; a huge finite
    margin at exhaustive knobs runs the ragged path on the tenant-masked
    routing pass and keeps the same ids."""
    rng = np.random.default_rng(3)
    base = VectorStore(_cfg(), seal_threshold=64, device="cpu")
    base.add(rng.standard_normal((96, 16)).astype(np.float32))
    reg = TenantRegistry(base, memtable_budget=32)
    for t in range(3):
        reg.get(f"t{t}").add(rng.standard_normal((8, 16)).astype(np.float32))
    qs = rng.standard_normal((6, 16)).astype(np.float32)

    def run(**kw):
        reqs = [RetrievalRequest(rid=i, tenant=f"t{i % 3}", q=qs[i],
                                 topk=4, mode="B") for i in range(6)]
        coalesced_retrieve(reg, reqs, **kw)
        return reqs

    ex = dict(nprobe=8, pool=256)
    static = run(**ex)
    for rs in (run(adaptive=True, probe_margin=float("inf"), **ex),):
        for a, b in zip(static, rs):
            assert torch.equal(a.result.ids, b.result.ids)
            assert torch.equal(a.result.dists, b.result.dists)
    ragged = run(adaptive=True, probe_margin=1e30, **ex)
    union = tuple(id(s) for s in reg.union_segments())
    assert base._probe_traffic[union]["queries"] == 8    # one padded batch
    for a, b in zip(static, ragged):
        assert torch.equal(a.result.ids, b.result.ids), a.rid
        torch.testing.assert_close(a.result.dists, b.result.dists,
                                   rtol=1e-5, atol=1e-5)
    for r in ragged:
        solo = reg.get(r.tenant).search(r.q, topk=4, mode="B", adaptive=True,
                                        probe_margin=1e30, **ex)
        assert torch.equal(r.result.ids, solo.ids[0])


# ---------------------------------------------------------------------------
# the tenant interleaving property, against brute force
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("seed", range(5))
def test_tenant_interleaving_matches_bruteforce(seed, cold, tmp_path):
    ops = tmp.STALE_KNOBS_EXAMPLE if seed == 0 \
        else tmp.tenant_interleaving(seed)
    tmp.tenant_interleaving_check(ops, seed, cold=cold,
                                  cold_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# against the JAX package, on a manifest carried across
# ---------------------------------------------------------------------------


def _carried_tenant_case():
    """A JAX store's manifest, the port's copy, both stacked planes, and
    one random tenant bitmap [T, G, cap] with per-query rows."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import planner as jax_planner
    from repro.core.store import VectorStore as JaxStore
    from repro.core.store import stack_segments as jax_stack
    from repro_torch.interop import manifest_from_numpy

    import torch_parity as tp
    from test_torch_store import T0, _jax_store, _numpy_manifest

    jcfg = tp.jax_config(n_grains=4, nprobe=3, pool=24)
    jst, q = _jax_store(jcfg)
    man = jst.snapshot()
    pst = VectorStore(tp.port_config(jcfg), seal_threshold=128,
                      clock=lambda: T0, device="cpu")
    pman = manifest_from_numpy(_numpy_manifest(man), "cpu")
    rng = np.random.default_rng(11)
    tl = rng.random((3, *jax_stack(man.segments).index.grains.ids.shape)) \
        < 0.6
    ti = rng.integers(0, 3, size=q.shape[0]).astype(np.int32)
    return dict(jst=jst, man=man, pst=pst, pman=pman, q=q, tl=tl, ti=ti,
                jnp=jnp, jax_planner=jax_planner, jax_stack=jax_stack,
                JaxStore=JaxStore, T0=T0)


@pytest.fixture(scope="module")
def carried():
    return _carried_tenant_case()


@pytest.mark.parametrize("mode", ["A", "B"])
@pytest.mark.parametrize("plane", ["ref", "fused_ref"])
def test_search_stacked_tenant_mask_matches_jax(carried, plane, mode):
    c = carried
    jstacked = c["jax_stack"](c["man"].segments)
    pstacked = store_mod.stack_segments(c["pman"].segments)
    kw = dict(nprobe=5, pool=24, topk=5, mode=mode, scan_impl=plane)
    ref = c["jax_planner"].search_stacked(
        jstacked, c["jnp"].asarray(c["q"]), tenant_live=c["jnp"].asarray(
            c["tl"]), tenant_ix=c["jnp"].asarray(c["ti"]), **kw)
    got = planner.search_stacked(
        pstacked, torch.from_numpy(c["q"]),
        tenant_live=torch.from_numpy(c["tl"]),
        tenant_ix=torch.from_numpy(c["ti"]), **kw)
    assert np.array_equal(got.ids.numpy().astype(np.int64),
                          np.asarray(ref.ids, np.int64))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(ref.dists),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("mode", ["A", "B"])
def test_fused_dispatch_tenant_mask_matches_jax(carried, mode, adaptive):
    """``_search_segments_fused`` with the tenant pair on both stores
    (the manifest's own liveness applies as well)."""
    c = carried
    now = c["T0"] + 45.0
    kw = dict(topk=5, mode=mode, tag_mask=None, ts_range=None,
              scan_impl="fused_ref", nprobe=5, pool=24, route_mode="global",
              now=now, tenant_live=c["tl"], tenant_ix=c["ti"])
    if adaptive:
        kw.update(adaptive=True, probe_margin=0.5, min_probes=1)
    ref_ids, ref_d = c["jst"]._search_segments_fused(c["q"], c["man"], **kw)
    got_ids, got_d = c["pst"]._search_segments_fused(
        torch.from_numpy(c["q"]), c["pman"], budgets=None, **kw)
    assert np.array_equal(got_ids.numpy().astype(np.int64),
                          np.asarray(ref_ids, np.int64))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d),
                               rtol=1e-5, atol=1e-5)


def test_tenant_routing_pushdown_matches_jax(carried):
    """The per-query [Q, G] pushdown and the probe plan with tenants."""
    c = carried
    jstacked = c["jax_stack"](c["man"].segments)
    pstacked = store_mod.stack_segments(c["pman"].segments)
    jnp = c["jnp"]
    ref = c["jax_planner"].probe_plan(
        jstacked, jnp.asarray(c["q"]), nprobe=5, probe_margin=0.5,
        tenant_live=jnp.asarray(c["tl"]), tenant_ix=jnp.asarray(c["ti"]))
    got = planner.probe_plan(
        pstacked, torch.from_numpy(c["q"]), nprobe=5, probe_margin=0.5,
        tenant_live=torch.from_numpy(c["tl"]),
        tenant_ix=torch.from_numpy(c["ti"]))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("budget", [None, 0])
def test_coalesced_planes_equal_bruteforce(budget, tmp_path):
    """The all-warm and the paged coalesced planes at exhaustive knobs:
    each request's ids are its tenant's brute-force top-k over the live
    rows it sees, its dists their exact distances."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((192, D)).astype(np.float32)
    base = VectorStore(_cfg(), seal_threshold=64, clock=lambda: 0.0,
                       device="cpu", device_budget=budget,
                       cold_dir=str(tmp_path), prefetch_grains=1)
    base.add(x)
    reg = TenantRegistry(base, memtable_budget=16, max_live=2)
    rows = {n: dict(enumerate(x)) for n in "abc"}
    for t, n in enumerate("abc"):
        v = (3.0 * (t + 1) + rng.standard_normal((24, D))).astype(
            np.float32)
        for g, vec in zip(reg.get(n).add(v).tolist(), v):
            rows[n][g] = vec
        dead = rng.choice(192, 10, replace=False)
        reg.get(n).delete(dead)
        for g in dead.tolist():
            rows[n].pop(g)
    reqs = [RetrievalRequest(rid=i, tenant="abc"[i % 3],
                             q=(rng.standard_normal(D) * 2).astype(
                                 np.float32), topk=6, mode="B")
            for i in range(12)]
    coalesced_retrieve(reg, reqs, nprobe=1 << 20, pool=1 << 20)
    for r in reqs:
        gs = np.fromiter(rows[r.tenant], np.int64)
        vs = np.stack([rows[r.tenant][g] for g in gs])
        d = np.sum((vs - r.q[None]) ** 2, axis=1)
        order = np.argsort(d, kind="stable")[:6]
        assert set(r.result.ids.tolist()) == set(gs[order].tolist())
        np.testing.assert_allclose(np.sort(r.result.dists.numpy()),
                                   np.sort(d[order]), rtol=1e-4, atol=1e-4)
