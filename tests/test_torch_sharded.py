"""The grain-sharded search plane in the port, on the CPU.

Twins of the JAX package's ``tests/test_store_sharded.py`` (all 15), of
the sharded cases of ``test_cascade.py`` and ``test_scan_plane.py`` and
of the sharded tenancy cases of ``test_tenancy.py``.  The reference
forces 4 or 8 host devices in a subprocess; here one process drives a
``SearchMesh`` of repeated CPU slots (``make_search_mesh(n,
devices=["cpu"] * n)``), which runs the same per-shard pipeline and merge.

With exhaustive knobs (every grain probed, a pool of every slot) the
sharded plane reduces to exact filtered search, so its ids must equal the
single-device fused plane's for 1, 2, 3, 4 and 8 shards, warm and cold,
masked, under mutation and maintenance, with the queries split over a
(2, 4) mesh; dists to rtol and atol 1e-5 (equal bits here).  The sharded
plane is also held to brute force (the mutation and tenant properties),
every scan plane to the sharded "ref" plane, and the port's own rules
hold: the mesh never doubles up on cards in silence, its slots must match
the store's device, and N shards on one device share one plane.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import HNTLConfig, MaintenancePolicy, VectorStore
from repro_torch.core import planner
from repro_torch.core import store as store_mod
from repro_torch.core.store import shard_segments, stack_segments
from repro_torch.core.types import BIG
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import SearchMesh, make_search_mesh
from repro_torch.serve import (RetrievalRequest, ServeEngine,
                               TenantRegistry, coalesced_retrieve)

import torch_mutation_property as tmp

D, N_SEG, SEG_ROWS = 32, 8, 256
SHARDS = [1, 2, 3, 4, 8]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: on one thread, so a worker among several on
    a busy host does not spin a pool of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shards: int, batch: int = 1) -> SearchMesh:
    return make_search_mesh(shards, batch=batch,
                            devices=["cpu"] * (shards * batch))


def _cfg():
    return HNTLConfig(d=D, k=8, s=0, n_grains=4, nprobe=4, pool=SEG_ROWS,
                      block=32)


def _build(cold: bool = False, seed: int = 7, tmp_dir=None):
    rng = np.random.default_rng(seed)
    st = VectorStore(_cfg(), seal_threshold=SEG_ROWS, cold_tier=cold,
                     cold_dir=tmp_dir, device="cpu")
    x = rng.standard_normal((N_SEG * SEG_ROWS, D)).astype(np.float32)
    for i in range(N_SEG):
        st.add(x[i * SEG_ROWS:(i + 1) * SEG_ROWS],
               tags=[1 << (i % 3)] * SEG_ROWS, ts=[float(i)] * SEG_ROWS)
    assert st.n_segments == N_SEG and not st._mem
    q = (x[:6] + 0.01 * rng.standard_normal((6, D))).astype(np.float32)
    return st, x, q


def _exhaustive(st):
    return dict(nprobe=sum(s.index.grains.n_grains for s in st._segments),
                pool=st.n_vectors * 2)


def _assert_same(res, ref):
    assert torch.equal(res.ids.long(), ref.ids.long()), (res.ids, ref.ids)
    np.testing.assert_allclose(res.dists.numpy(), ref.dists.numpy(),
                               rtol=1e-5, atol=1e-5)


def _counting_stack(monkeypatch):
    calls = []
    real = store_mod.stack_segments

    def counting(segments, **kw):
        calls.append(len(tuple(segments)))
        return real(segments, **kw)

    monkeypatch.setattr(store_mod, "stack_segments", counting)
    return calls


def _sharded_entries(st):
    return [v[1] for k, v in st._stack_cache.items() if k[0] == "sharded"]


# ---------------------------------------------------------------------------
# Shard-aligned layout (host control plane)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARDS)
def test_shard_segments_layout_invariants(n_shards):
    """Grain axis padded to the shard count; every vector owned by exactly
    one shard; panel ids are in-slice local rows; gids cover the store."""
    st, x, q = _build(False)
    plane, perm = shard_segments(st._segments, n_shards)
    g = plane.index.grains
    assert g.n_grains % n_shards == 0
    assert plane.rows_total % n_shards == 0
    n_total = st.n_vectors
    live = perm[perm >= 0]
    assert len(live) == n_total and len(np.unique(live)) == n_total
    gids = plane.gid_of_row.numpy()
    assert sorted(gids[gids >= 0].tolist()) == list(range(n_total))
    g_local = g.n_grains // n_shards
    rows_local = plane.rows_total // n_shards
    ids, valid = g.ids.numpy(), g.valid.numpy()
    raw = plane.index.raw.numpy()
    for s in range(n_shards):
        ch = ids[s * g_local:(s + 1) * g_local]
        ok = valid[s * g_local:(s + 1) * g_local]
        assert (ch[ok] >= 0).all() and (ch[ok] < rows_local).all()
        assert (ch[~ok] == -1).all()
        orig = perm[s * rows_local:(s + 1) * rows_local]
        np.testing.assert_array_equal(raw[s * rows_local + ch[ok]],
                                      x[orig[ch[ok]]])
    assert int(plane.index.routing.sizes.sum()) == n_total
    assert plane.index.routing.centroids is g.mu


def test_shard_segments_preserves_stacked_totals():
    st, x, q = _build(False)
    stacked = stack_segments(st._segments)
    plane, perm = shard_segments(st._segments, 4)
    assert plane.index.grains.n_grains >= stacked.index.grains.n_grains
    assert int(plane.index.routing.sizes.sum()) \
        == int(stacked.index.routing.sizes.sum())


# ---------------------------------------------------------------------------
# Single-shard parity and refusals
# ---------------------------------------------------------------------------


def test_sharded_single_device_matches_fused():
    """One shard is the single-device plane, bit for bit (same routing
    table, same panels, the rows permuted)."""
    st, x, q = _build(False)
    kw = _exhaustive(st)
    mesh = cpu_mesh(1)
    for filt in ({}, dict(tag_mask=2), dict(tag_mask=1,
                                            ts_range=(3.0, 7.0))):
        fused = st.search(q, topk=10, mode="B", **filt, **kw)
        sharded = st.search(q, topk=10, mode="B", mesh=mesh, **filt, **kw)
        assert torch.equal(fused.ids, sharded.ids)
        assert torch.equal(fused.dists, sharded.dists)
    # at the default (per-shard) knobs too: one shard is the same plane
    for mode in "AB":
        fused = st.search(q, topk=10, mode=mode)
        sharded = st.search(q, topk=10, mode=mode, mesh=mesh)
        assert torch.equal(fused.ids, sharded.ids)
        assert torch.equal(fused.dists, sharded.dists)


def test_sharded_rejects_looped_and_per_segment():
    st, x, q = _build(False)
    mesh = cpu_mesh(1)
    with pytest.raises(ValueError, match="fused search plane"):
        st.search(q, mesh=mesh, fused=False)
    with pytest.raises(ValueError, match="routes per shard"):
        st.search(q, mesh=mesh, route_mode="per_segment")
    with pytest.raises(ValueError, match="grain_axis"):
        st.search(q, mesh=mesh, grain_axis="pod")
    with pytest.raises(ValueError, match="shard_queries"):
        st.search(q, mesh=cpu_mesh(2), shard_queries=True)
    with pytest.raises(ValueError, match="divide the query count"):
        st.search(q[:5], mesh=cpu_mesh(2, batch=2), shard_queries=True)


# ---------------------------------------------------------------------------
# Shard-count invariance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_shard_count_invariance_exhaustive(cold, tmp_path):
    """Sharded search over 1/2/3/4/8 shards equals the single-device fused
    plane under exhaustive knobs, masked and unmasked, with queries split
    over a (2, 4) mesh, and Mode A dists too."""
    st, x, q = _build(cold, tmp_dir=str(tmp_path))
    ex = _exhaustive(st)
    for filt in ({}, dict(tag_mask=2, ts_range=(1.0, 7.0))):
        base = st.search(q, topk=10, mode="B", **filt, **ex)
        for n in SHARDS:
            res = st.search(q, topk=10, mode="B", mesh=cpu_mesh(n),
                            **filt, **ex)
            _assert_same(res, base)
    base = st.search(q, topk=10, mode="B", **ex)
    res = st.search(q, topk=10, mode="B", mesh=cpu_mesh(4, batch=2),
                    shard_queries=True, **ex)
    _assert_same(res, base)
    ba = st.search(q, topk=10, mode="A", **ex)
    for n in (3, 4):
        _assert_same(st.search(q, topk=10, mode="A", mesh=cpu_mesh(n),
                               **ex), ba)


def test_sharded_memtable_and_default_knobs():
    """The memtable tail merges into sharded results, and default
    (per-shard) knobs still find exact duplicates."""
    from repro_torch.data import synthetic as syn

    cfg = HNTLConfig(d=32, k=8, s=0, n_grains=8, nprobe=8, pool=64,
                     block=32)
    st = VectorStore(cfg, seal_threshold=512, device="cpu")
    x = syn.clustered(4096, 32, n_clusters=16, seed=3)
    for lo in range(0, 4096, 512):
        st.add(x[lo:lo + 512])
    tail = np.full((3, 32), 7.5, np.float32) \
        + 0.1 * np.arange(3)[:, None].astype(np.float32)
    tail_ids = st.add(tail)                    # memtable, unsealed
    mesh = cpu_mesh(8)
    res = st.search(tail[:1], topk=2, mode="B", mesh=mesh)
    assert int(res.ids[0, 0]) == int(tail_ids[0])
    res2 = st.search(x[:16], topk=1, mode="B", mesh=mesh)
    assert (res2.ids[:, 0].numpy() == np.arange(16)).all()


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_shard_count_invariance_under_mutation(cold, tmp_path):
    """After deletes, upserts and TTL expiry the sharded plane equals the
    fused plane for every shard count, and a dead id never surfaces."""
    rng = np.random.default_rng(7)
    st = VectorStore(_cfg(), seal_threshold=SEG_ROWS, cold_tier=cold,
                     cold_dir=str(tmp_path), clock=lambda: 0.0,
                     device="cpu")
    x = rng.standard_normal((N_SEG * SEG_ROWS, D)).astype(np.float32)
    for i in range(N_SEG):
        st.add(x[i * SEG_ROWS:(i + 1) * SEG_ROWS],
               tags=[1 << (i % 3)] * SEG_ROWS, ts=[float(i)] * SEG_ROWS)
    q = (x[:6] + 0.01 * rng.standard_normal((6, D))).astype(np.float32)
    dead = np.arange(0, 2 * SEG_ROWS, 2)
    st.delete(dead)
    st.upsert([3 * SEG_ROWS + 1, 3 * SEG_ROWS + 2], x[:2] + 0.25)
    ttl_ids = st.add(np.full((4, D), 9.5, np.float32), ttl=10.0)
    ex = _exhaustive(st)
    for filt in ({}, dict(tag_mask=2, ts_range=(0.0, 3.0))):
        for mode in ("A", "B"):
            base = st.search(q, topk=10, mode=mode, now=20.0, **filt, **ex)
            bi = base.ids.numpy()
            assert not np.isin(bi, dead).any()
            assert not np.isin(bi, ttl_ids).any()
            for n in SHARDS:
                res = st.search(q, topk=10, mode=mode, now=20.0,
                                mesh=cpu_mesh(n), **filt, **ex)
                _assert_same(res, base)
                assert not np.isin(res.ids.numpy(), dead).any()


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_maintenance_shard_count_invariance(cold, tmp_path):
    """After a maintenance epoch (merges/refits/retires from biased
    deletes) the repaired plane is still shard-count invariant."""
    rng = np.random.default_rng(11)
    st = VectorStore(_cfg(), seal_threshold=SEG_ROWS, cold_tier=cold,
                     cold_dir=str(tmp_path), clock=lambda: 0.0,
                     device="cpu")
    x = rng.standard_normal((N_SEG * SEG_ROWS, D)).astype(np.float32)
    for i in range(N_SEG):
        st.add(x[i * SEG_ROWS:(i + 1) * SEG_ROWS],
               tags=[1 << (i % 3)] * SEG_ROWS, ts=[float(i)] * SEG_ROWS)
    dead = np.concatenate([np.flatnonzero(x[:, 0] > 0.3),
                           np.arange(0, SEG_ROWS)])
    st.delete(dead)
    rep = st.maintain()
    assert rep.changed and (rep.total("merges") + rep.total("refits")
                            + rep.total("retires")) > 0
    q = (x[np.flatnonzero(x[:, 0] <= 0.3)[:6]]
         + 0.01 * rng.standard_normal((6, D))).astype(np.float32)
    ex = _exhaustive(st)
    for filt in ({}, dict(tag_mask=2, ts_range=(0.0, 7.0))):
        for mode in ("A", "B"):
            base = st.search(q, topk=10, mode=mode, **filt, **ex)
            assert not np.isin(base.ids.numpy(), dead).any()
            for n in SHARDS:
                res = st.search(q, topk=10, mode=mode, mesh=cpu_mesh(n),
                                **filt, **ex)
                _assert_same(res, base)


def test_refit_only_epoch_reuses_placed_raw(monkeypatch):
    """A refit-only maintenance epoch keeps the row permutation, so the
    next sharded search places only the grain panels: the placed raw tier
    and id table are the previous plane's (identity), and neither field
    is placed again."""
    calls = _counting_stack(monkeypatch)
    placed = []
    real_field = shd.shard_plane_field

    def counting_field(arr, rules, field, **kw):
        placed.append(field)
        return real_field(arr, rules, field, **kw)

    monkeypatch.setattr(shd, "shard_plane_field", counting_field)
    monkeypatch.setattr(store_mod, "STACK_CACHE_ENTRIES", 4)
    st, x, q = _build(False)
    mesh = cpu_mesh(2)
    st.search(q[:1], topk=3, mode="B", mesh=mesh)
    assert len(calls) == 1
    assert {"raw", "gid_of_row", "coords"} <= set(placed)
    entry0 = _sharded_entries(st)[0]
    raw0 = entry0["plane"].field("raw")
    gid0 = entry0["plane"].field("gid_of_row")
    # a biased cut that strands live means but empties no grain (a
    # retired grain would move rows): refits only
    dead = np.flatnonzero(x[:, 0] > 0.8)
    st.delete(dead)
    rep = st.maintain(policy=MaintenancePolicy(underfull_frac=0.0,
                                               overfull_ratio=1e9))
    assert rep.changed and rep.total("refits") > 0
    assert rep.total("merges") == rep.total("splits") \
        == rep.total("retires") == 0
    assert all(s.slots_preserved for s in rep.segments)
    placed.clear()
    res = st.search(q[:1], topk=3, mode="B", mesh=mesh)
    assert len(calls) == 2                 # one re-stack for the epoch
    assert "raw" not in placed and "gid_of_row" not in placed
    assert "coords" in placed and "live" in placed
    entry1 = next(e for e in _sharded_entries(st) if e is not entry0)
    for a, b in zip(entry1["plane"].field("raw"), raw0):
        assert all(u is v for u, v in zip(a, b)), "raw tier was re-placed"
    for a, b in zip(entry1["plane"].field("gid_of_row"), gid0):
        assert all(u is v for u, v in zip(a, b)), "id table was re-placed"
    assert not np.isin(res.ids.numpy(), dead).any()


def test_sharded_mutation_interleaving_matches_bruteforce():
    """The mutation-interleaving property on a 4-shard mesh: random
    add/seal/delete/upsert/compact/maintain sequences, then sharded
    search equals brute-force L2 over the live set."""
    mesh = cpu_mesh(4)
    rng = np.random.default_rng(0)
    for trial in range(4):
        ops = [str(o) for o in rng.choice(tmp.OPS, size=6)]
        tmp.mutation_interleaving_check(ops, seed=trial,
                                        cold_tier=bool(trial % 2),
                                        mesh=mesh)


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_sharded_adaptive_identity(cold, tmp_path):
    """Adaptive routing per shard: ``probe_margin=inf`` is the static
    sharded search bit for bit, and a huge finite margin at exhaustive
    knobs (the ragged path, invalid probes killed in each shard's routing
    slice) agrees exactly; also with the queries split over (2, 4); plus
    the adaptive mutation oracle on the mesh."""
    st, x, q = _build(cold, tmp_dir=str(tmp_path))
    ex = _exhaustive(st)
    for n in (1, 4):
        mesh = cpu_mesh(n)
        for filt in ({}, dict(tag_mask=2, ts_range=(1.0, 7.0))):
            base = st.search(q, topk=10, mode="B", mesh=mesh, **filt, **ex)
            inf = st.search(q, topk=10, mode="B", mesh=mesh, adaptive=True,
                            probe_margin=float("inf"), **filt, **ex)
            assert torch.equal(inf.ids, base.ids)
            assert torch.equal(inf.dists, base.dists)
            huge = st.search(q, topk=10, mode="B", mesh=mesh, adaptive=True,
                             probe_margin=1e30, **filt, **ex)
            _assert_same(huge, base)
    mesh = cpu_mesh(4, batch=2)
    base = st.search(q, topk=10, mode="B", mesh=mesh, shard_queries=True,
                     **ex)
    res = st.search(q, topk=10, mode="B", mesh=mesh, shard_queries=True,
                    adaptive=True, probe_margin=1e30, **ex)
    _assert_same(res, base)
    tmp.mutation_interleaving_check(
        ("add", "seal", "delete", "upsert", "seal", "maintain"),
        seed=int(cold), cold_tier=cold, mesh=cpu_mesh(4),
        adaptive_margin=1e30)


def test_sharded_hub_mask_keeps_hubs_active():
    """The planner's ``hub_mask`` [G] is placed along the grain axis like
    the centroids: with every grain a hub, margin 0 keeps every probe
    active, so each shard's ragged pass is its static one."""
    st, x, q = _build(False)
    plane, _ = shard_segments(st._segments, 4)
    mesh = cpu_mesh(4)
    qt = torch.from_numpy(q)
    kw = dict(nprobe=3, pool=24, topk=10, mode="B")
    static = planner.search_stacked_sharded(plane, qt, mesh=mesh, **kw)
    hubs = torch.ones(plane.index.grains.n_grains, dtype=torch.bool)
    got = planner.search_stacked_sharded(plane, qt, mesh=mesh,
                                         probe_margin=0.0, hub_mask=hubs,
                                         **kw)
    assert torch.equal(got.ids, static.ids)
    assert torch.equal(got.dists, static.dists)
    lone = planner.search_stacked_sharded(plane, qt, mesh=mesh,
                                          probe_margin=0.0, **kw)
    assert not torch.equal(lone.ids, static.ids)   # the rule does cut


def test_sharded_delete_without_replacing_plane(monkeypatch):
    """A delete between two sharded searches re-places only the liveness
    field: no re-shard, no re-stack."""
    calls = _counting_stack(monkeypatch)
    st, x, q = _build(False)
    mesh = cpu_mesh(2)
    st.search(q[:1], topk=3, mode="B", mesh=mesh)
    assert len(calls) == 1
    st.delete([0])
    res = st.search(q[:1], topk=3, mode="B", mesh=mesh)
    assert len(calls) == 1
    assert not np.isin(res.ids.numpy(), [0]).any()


# ---------------------------------------------------------------------------
# Bounded plane cache (LRU)
# ---------------------------------------------------------------------------


def test_stack_cache_evicts_lru(monkeypatch):
    """More live manifests than cache entries: the LRU plane is dropped
    and rebuilt on next use; the cache never exceeds its bound."""
    calls = _counting_stack(monkeypatch)
    st, x, q = _build(False)           # default: 2 entries
    mans = []
    for i in range(3):
        st.add(np.full((SEG_ROWS, D), float(i), np.float32))
        mans.append(st.snapshot())
    for man in mans:
        st.search(q[:1], topk=1, mode="B", manifest=man)
    assert len(calls) == 3 and len(st._stack_cache) == 2
    st.search(q[:1], topk=1, mode="B", manifest=mans[2])
    assert len(calls) == 3
    st.search(q[:1], topk=1, mode="B", manifest=mans[0])
    assert len(calls) == 4
    assert len(st._stack_cache) == 2


def test_stack_cache_capacity_configurable(monkeypatch):
    """The LRU's bound is ``store.STACK_CACHE_ENTRIES`` (the JAX store's
    ``stack_cache_entries=``): at 1, two manifests evict each other."""
    calls = _counting_stack(monkeypatch)
    monkeypatch.setattr(store_mod, "STACK_CACHE_ENTRIES", 1)
    st, x, q = _build(False)
    man1 = st.snapshot()
    st.add(np.zeros((SEG_ROWS, D), np.float32))
    man2 = st.snapshot()
    for man in (man1, man2, man1):
        st.search(q[:1], topk=1, mode="B", manifest=man)
        assert len(st._stack_cache) == 1
    assert len(calls) == 3


def test_sharded_plane_cached_per_mesh(monkeypatch):
    """Fused and sharded planes of one manifest are separate entries;
    repeated sharded searches reuse the placed plane; another shard count
    is another entry."""
    calls = _counting_stack(monkeypatch)
    monkeypatch.setattr(store_mod, "STACK_CACHE_ENTRIES", 4)
    st, x, q = _build(False)
    kw = _exhaustive(st)
    st.search(q[:1], topk=1, mode="B", **kw)
    st.search(q[:1], topk=1, mode="B", mesh=cpu_mesh(2), **kw)
    st.search(q[:1], topk=1, mode="B", mesh=cpu_mesh(2), **kw)
    # one stack for the fused plane + one underneath shard_segments
    assert len(calls) == 2
    assert len(st._stack_cache) == 2
    st.search(q[:1], topk=1, mode="B", mesh=cpu_mesh(4), **kw)
    assert len(calls) == 3 and len(st._stack_cache) == 3


# ---------------------------------------------------------------------------
# Twins of the sharded cases of test_cascade.py and test_scan_plane.py
# ---------------------------------------------------------------------------

D_C, SEG_C, N_SEG_C = 24, 128, 2


def _aniso(n: int, rng) -> np.ndarray:
    """Clustered low-rank data: density mode actually assigns int4."""
    c = rng.standard_normal((4, D_C)).astype(np.float32) * 4
    a = rng.integers(0, 4, n)
    b = rng.standard_normal((4, D_C, 3)).astype(np.float32)
    z = rng.standard_normal((n, 3)).astype(np.float32)
    x = c[a] + np.einsum("nk,ndk->nd", z, b[a])
    return (x + 0.01 * rng.standard_normal((n, D_C))).astype(np.float32)


def _small_store(cold: bool, s: int, *, aniso: bool, seed: int,
                 bit_alloc: str = "fixed", tmp_dir=None):
    """``test_cascade.py``'s (aniso) and ``test_scan_plane.py``'s stores:
    2 segments of 128 rows, k=6, 4 grains each."""
    rng = np.random.default_rng(seed)
    cfg = HNTLConfig(d=D_C, k=6, s=s, n_grains=4, nprobe=4, pool=32,
                     block=32, bit_alloc=bit_alloc)
    st = VectorStore(cfg, seal_threshold=SEG_C, cold_tier=cold,
                     cold_dir=tmp_dir, device="cpu")
    n = N_SEG_C * SEG_C
    x = _aniso(n, rng) if aniso else \
        rng.standard_normal((n, D_C)).astype(np.float32)
    for i in range(N_SEG_C):
        st.add(x[i * SEG_C:(i + 1) * SEG_C], tags=[1 << i] * SEG_C,
               ts=[float(i)] * SEG_C)
    q = (x[:4] + 0.01 * rng.standard_normal((4, D_C))).astype(np.float32)
    return st, x, q


@pytest.mark.parametrize("bit_alloc", ["fixed", "density"])
def test_cascade_sharded_parity(bit_alloc, tmp_path):
    """Per-grain widths shard like every panel, and both cascade planes,
    budgeted and not, equal the sharded "ref" plane, masked and with
    tombstones (``test_cascade.py::test_sharded_parity_forced_4_devices``)."""
    mesh = cpu_mesh(4)
    for cold, s in ((False, 4), (True, 0)):
        st, x, q = _small_store(cold, s, aniso=True, seed=7,
                                bit_alloc=bit_alloc, tmp_dir=str(tmp_path))
        st.delete(np.arange(5))
        for case in (dict(), dict(tag_mask=2), dict(ts_range=(0.0, 1.0))):
            ref = st.search(q, topk=5, mode="B", scan_impl="ref",
                            mesh=mesh, **case)
            for backend in ("cascade", "cascade_ref"):
                _assert_same(st.search(q, topk=5, mode="B",
                                       scan_impl=backend, mesh=mesh,
                                       **case), ref)
        ref0 = st.search(q, topk=5, mode="B", scan_impl="ref", mesh=mesh)
        resb = st.search(q, topk=5, mode="B", scan_impl="cascade",
                         mesh=mesh, budgets=(4096, 32))
        _assert_same(resb, ref0)
        with pytest.raises(ValueError, match="b2"):
            st.search(q, topk=5, scan_impl="cascade", mesh=mesh,
                      budgets=(64, 4))


@pytest.mark.parametrize("bit_alloc", ["fixed", "density"])
def test_cascade_sharded_recall_by_construction(bit_alloc):
    """The cascade's mutation-oracle twin on a 4-shard mesh:
    budgets=(pool, pool) over an interleaving still equals brute force."""
    ops = ("add", "seal", "delete", "add", "seal", "maintain", "upsert")
    tmp.mutation_interleaving_check(ops, seed=3, bit_alloc=bit_alloc,
                                    scan_impl="cascade_ref", budgeted=True,
                                    mesh=cpu_mesh(4))


@pytest.mark.parametrize("kind", ["warm", "warm_sketch", "cold"])
def test_scan_planes_sharded_parity(kind, tmp_path):
    """Every scan plane that runs on the CPU ("kernel", "fused",
    "fused_ref", "auto") on a 4-shard mesh equals the sharded "ref"
    plane, masked and unmasked, with tombstones
    (``test_scan_plane.py::test_sharded_parity_forced_4_devices``)."""
    st, x, q = _small_store(kind == "cold", 4 if kind == "warm_sketch"
                            else 0, aniso=False, seed=5,
                            tmp_dir=str(tmp_path))
    st.delete(np.arange(5))
    mesh = cpu_mesh(4)
    for case in (dict(), dict(tag_mask=2), dict(ts_range=(0.0, 1.0))):
        ref = st.search(q, topk=5, mode="B", scan_impl="ref", mesh=mesh,
                        **case)
        for backend in ("kernel", "fused", "fused_ref", "auto"):
            _assert_same(st.search(q, topk=5, mode="B", scan_impl=backend,
                                   mesh=mesh, **case), ref)


# ---------------------------------------------------------------------------
# Twins of the sharded tenancy cases of test_tenancy.py
# ---------------------------------------------------------------------------


def _tenancy_cfg():
    return HNTLConfig(d=16, k=4, s=0, n_grains=2, nprobe=2, pool=64,
                      block=16, envelope_frac=1.0)


def _registry(cold, tmp_dir):
    rng = np.random.default_rng(0)
    base = VectorStore(_tenancy_cfg(), seal_threshold=32, cold_tier=cold,
                       cold_dir=tmp_dir, clock=lambda: 0.0, device="cpu")
    base.add(rng.standard_normal((96, 16)).astype(np.float32))
    reg = TenantRegistry(base, memtable_budget=16, max_live=4)
    for t, name in enumerate(["a", "b"]):
        st = reg.get(name)
        ids = st.add((10.0 * (t + 1)
                      + rng.standard_normal((40, 16))).astype(np.float32))
        st.delete(ids[:2])
    return reg


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_sharded_coalesced_parity(cold, tmp_path):
    """Coalesced retrieval over a 4-shard mesh equals the single-device
    coalesced window and each tenant's solo sharded search."""
    reg = _registry(cold, str(tmp_path))
    mesh = cpu_mesh(4)
    union = reg.union_segments()
    kn = dict(nprobe=sum(s.index.grains.n_grains for s in union),
              pool=2 * sum(s.n for s in union))

    def window(seed):
        rng = np.random.default_rng(seed)
        return [RetrievalRequest(
            rid=i, tenant=["a", "b"][i % 2],
            q=rng.standard_normal(16).astype(np.float32), topk=5,
            mode="B") for i in range(6)]

    fused = coalesced_retrieve(reg, window(1), **kn)
    shard = coalesced_retrieve(reg, window(1), mesh=mesh, **kn)
    for f, s in zip(fused, shard):
        assert torch.equal(f.result.ids, s.result.ids)
        np.testing.assert_allclose(f.result.dists.numpy(),
                                   s.result.dists.numpy(), rtol=1e-5,
                                   atol=1e-5)
        solo = reg.get(s.tenant).search(s.q[None], topk=5, mode="B",
                                        mesh=mesh, now=0.0, **kn)
        assert torch.equal(s.result.ids, solo.ids[0])
    # the "fused" plane's tenant stream equals its plain version there
    a = coalesced_retrieve(reg, window(2), mesh=mesh, scan_impl="fused",
                           **kn)
    b = coalesced_retrieve(reg, window(2), mesh=mesh,
                           scan_impl="fused_ref", **kn)
    for x, y in zip(a, b):
        assert torch.equal(x.result.ids, y.result.ids)
        assert torch.equal(x.result.dists, y.result.dists)


def test_sharded_tenant_property():
    """The tenant-interleaving property on a 4-shard mesh against each
    tenant's brute force."""
    rng = np.random.default_rng(5)
    for trial in range(2):
        n = int(rng.integers(4, 8))
        ops = [(tmp.TENANT_OPS[int(rng.integers(len(tmp.TENANT_OPS)))],
                int(rng.integers(4))) for _ in range(n)]
        tmp.tenant_interleaving_check(ops, seed=trial, cold=bool(trial),
                                      mesh=cpu_mesh(4))


def test_engine_memory_mesh_reaches_the_sharded_plane():
    """``ServeEngine(memory_mesh=)``'s sidecar: retrieve runs on the
    sharded plane and equals the single-device plane at exhaustive knobs
    (the config probes every grain and pools every row)."""
    rng = np.random.default_rng(3)
    eng = ServeEngine.__new__(ServeEngine)
    eng.memory = VectorStore(
        dataclasses.replace(_tenancy_cfg(), nprobe=64, pool=256),
        seal_threshold=32, clock=lambda: 0.0, device="cpu")
    eng.memory.add(rng.standard_normal((128, 16)).astype(np.float32))
    eng.memory_mesh = None
    q = rng.standard_normal((5, 16)).astype(np.float32)
    single = eng.retrieve(q, topk=4)
    eng.memory_mesh = cpu_mesh(2)
    sharded = eng.retrieve(q, topk=4)
    assert torch.equal(single.ids, sharded.ids)


# ---------------------------------------------------------------------------
# The port's own rules: meshes, devices, placement
# ---------------------------------------------------------------------------


def test_make_search_mesh_needs_cards_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="devices="):
        make_search_mesh(2)
    with pytest.raises(ValueError, match="devices= has 3"):
        make_search_mesh(2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match=">= 1"):
        make_search_mesh(0, devices=[])
    mesh = make_search_mesh(4, batch=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.axis_names == ("data", "model")
    assert mesh == cpu_mesh(4, batch=2) and hash(mesh) == hash(
        cpu_mesh(4, batch=2))
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    one = make_search_mesh(2, devices=["cuda:0", "cuda:1"])
    assert one.devices == ((torch.device("cuda", 0),
                            torch.device("cuda", 1)),)


def test_mesh_on_other_devices_than_the_store_raises():
    """A CPU store is never searched on CUDA slots (nor the reverse): the
    search refuses instead of moving the plane."""
    st, x, q = _build(False)
    bad = make_search_mesh(2, devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="do not match"):
        st.search(q, mesh=bad)
    mixed = make_search_mesh(2, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="do not match"):
        st.search(q, mesh=mixed)
    reg = TenantRegistry(st, memtable_budget=16)
    req = [RetrievalRequest(rid=0, tenant="a", q=q[0], topk=3, mode="B")]
    with pytest.raises(ValueError, match="do not match"):
        coalesced_retrieve(reg, req, mesh=bad)
    plane, _ = shard_segments(st._segments, 2)
    with pytest.raises(ValueError, match="do not match"):
        planner.search_stacked_sharded(plane, torch.from_numpy(q), mesh=bad,
                                       nprobe=4, pool=8, topk=3)
    assert not st._stack_cache or all(
        k[0] != "sharded" for k in st._stack_cache)


def test_shards_on_one_device_share_one_plane():
    """Eight shards on one device hold one plane: every shard's slice is
    a view of the layout's tensors, so the placement's bytes are the
    sharded layout's, not eight times them, and no copy is made."""
    st, x, q = _build(False)
    plane, _ = shard_segments(st._segments, 8)
    placed = shd.shard_search_plane(plane, shd.search_plane_rules(
        cpu_mesh(8)))
    assert placed.nbytes() == shd.shard_search_plane(
        plane, shd.search_plane_rules(cpu_mesh(1))).nbytes()
    raw = plane.index.raw
    for s, sl in enumerate(placed.slots[0]):
        assert sl.index.raw.untyped_storage().data_ptr() \
            == raw.untyped_storage().data_ptr()
        assert sl.index.raw.shape[0] == placed.rows_local
        assert torch.equal(sl.index.raw, raw[s * placed.rows_local:
                                             (s + 1) * placed.rows_local])
        assert sl.index.grains.n_grains == placed.g_local
        assert sl.index.routing.centroids is sl.index.grains.mu


def test_placement_copies_each_run_once_per_device(monkeypatch):
    """On slots of two devices, each device receives only its own shards'
    chunks, one copy per contiguous run ("meta" stands in for a second
    device), and a field already on a device is viewed, not copied."""
    copies = []
    real = shd._place

    def counting(t, dev):
        out = real(t, dev)
        if out is not t:
            copies.append((str(dev), tuple(t.shape)))
        return out

    monkeypatch.setattr(shd, "_place", counting)
    mesh = make_search_mesh(4, devices=["cpu", "cpu", "meta", "meta"])
    rules = shd.search_plane_rules(mesh)
    arr = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    out = shd.shard_plane_field(arr, rules, "coords")
    assert copies == [("meta", (4, 3))]          # shards 2 and 3: one run
    assert torch.equal(out[0][1], arr[2:4])
    assert out[0][3].device.type == "meta" and out[0][3].shape == (2, 3)
    copies.clear()
    mesh = make_search_mesh(4, devices=["cpu", "meta", "cpu", "meta"])
    out = shd.shard_plane_field(arr, shd.search_plane_rules(mesh), "raw")
    assert copies == [("meta", (2, 3)), ("meta", (2, 3))]
    # the tenant stack splits on dim 1, the tenant axis whole
    tl = torch.rand(3, 8, 5) < 0.5
    out = shd.shard_plane_field(tl, shd.search_plane_rules(cpu_mesh(4)),
                                "tenant_live", dim=1)
    assert out[0][2].shape == (3, 2, 5) and out[0][2].is_contiguous()
    assert torch.equal(out[0][2], tl[:, 4:6])
    # an axis the dim does not divide is replicated
    out = shd.shard_plane_field(torch.zeros(6, 2), shd.search_plane_rules(
        cpu_mesh(4)), "coords")
    assert all(t.shape == (6, 2) for t in out[0])


def test_shard_hot_sets_and_knobs():
    hot = shd.shard_hot_sets([0, 5, 7, 12, 15], 16, 4)
    assert [h.tolist() for h in hot] == [[0], [1, 3], [], [0, 3]]
    with pytest.raises(ValueError):
        shd.shard_hot_sets([0], 10, 4)
    with pytest.raises(ValueError):
        shd.shard_hot_sets([16], 16, 4)
    # per-shard clamps: probe to the slice, pool >= topk in Mode B
    assert planner.sharded_knobs(4, 3, 32, nprobe=16, pool=8, topk=10,
                                 mode="B") == (3, 10, 10, 10)
    assert planner.sharded_knobs(4, 3, 32, nprobe=16, pool=8, topk=10,
                                 mode="A") == (3, 8, 8, 10)
    assert planner.sharded_knobs(2, 1, 4, nprobe=1, pool=64, topk=10,
                                 mode="A") == (1, 4, 4, 8)


def test_padding_never_surfaces():
    """Dead padding grains and padding rows never come back: 3 shards of
    a 32-grain plane pad one grain, and a query far from every row with
    topk above the live rows fills the tail with -1 at BIG."""
    rng = np.random.default_rng(2)
    st = VectorStore(dataclasses.replace(_cfg(), envelope_frac=1.0),
                     seal_threshold=SEG_ROWS, device="cpu")
    x = rng.standard_normal((N_SEG * SEG_ROWS, D)).astype(np.float32)
    for i in range(N_SEG):
        st.add(x[i * SEG_ROWS:(i + 1) * SEG_ROWS])
    plane, perm = shard_segments(st._segments, 3)
    assert plane.index.grains.n_grains == 33 and (perm == -1).any()
    n_live = st.n_vectors
    res = st.search(x[:2], topk=n_live + 7, mode="B", mesh=cpu_mesh(3),
                    nprobe=64, pool=4 * n_live)
    ids = res.ids.numpy()
    assert sorted(ids[0, :n_live].tolist()) == list(range(n_live))
    assert (ids[:, n_live:] == -1).all()
    assert (res.dists[:, n_live:] >= BIG / 2).all()
    assert dataclasses.is_dataclass(plane)
