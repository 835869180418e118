"""The cold raw tier in the port.

- **Against the JAX cold store.**  A JAX store with ``cold_tier=True`` is
  carried across with ``interop.store_from_numpy`` (its raw rows copied
  into cold files of the port's own); both search the same segments: ids
  equal, dists within rtol 1e-5 and atol 1e-5, Mode A and B, fused and
  looped, with and without filters.
- **Against a warm store of the same segments**: a cold store's searches
  (the pool's rows read from the memmaps, re-ranked with the warm
  arithmetic) equal a warm store's bit for bit, also after compaction and
  maintenance (the CPU build is deterministic, so cold and warm stores
  sealed from the same rows hold the same segments).
- **Cold-file lifetimes**: twins of the first five tests of
  ``tests/test_cold_bugfixes.py`` (a failed seal or merge leaves no
  orphan, a failed construction keeps a shared file, the refcount is
  locked, the file is fsynced before the segment is visible), of
  ``test_store_stacked.py``'s ``test_branch_cold_files_do_not_collide``
  and ``test_compact_reclaims_unreferenced_cold_files``, and of
  ``test_maintenance.py``'s cold-file test, with deletes that do trip a
  repair (the reference's own deletes trip none; ROADMAP Queue C).
"""
import copy
import dataclasses
import gc
import glob
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import HNTLConfig, MaintenancePolicy, VectorStore
from repro_torch.core import store as store_mod
from repro_torch.core.flat import flat_search

D = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These stores run many small tensor ops: on one thread each, so a
    worker among several on a busy host does not spin a pool of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(n_grains=4, **kw):
    return HNTLConfig(d=D, k=4, s=2, block=16, n_grains=n_grains,
                      nprobe=n_grains, pool=16, **kw)


def _cold_files(st):
    return sorted(glob.glob(os.path.join(st.cold_dir, "*.raw")))


def _store(tmp_path, *, cold=True, rows=128, n_seg=4, seed=0, **kw):
    """A store of n_seg sealed segments with tags and ts, 5% deleted."""
    rng = np.random.default_rng(seed)
    n = rows * n_seg
    x = (rng.standard_normal((n, D)) * 3.0).astype(np.float32)
    tags = (1 << (np.arange(n) % 3)).astype(np.uint32)
    ts = (np.arange(n) / n).astype(np.float32)
    st = VectorStore(_cfg(**kw), seal_threshold=rows, device="cpu",
                     cold_tier=cold, cold_dir=str(tmp_path))
    for lo in range(0, n, rows):
        st.add(x[lo:lo + rows], tags=tags[lo:lo + rows], ts=ts[lo:lo + rows])
    st.delete(rng.choice(n, n // 20, replace=False))
    q = (rng.standard_normal((9, D)) * 3.0).astype(np.float32)
    return st, x, q


def _warm_twin(st):
    """A warm store holding the cold store's segments, the raw tier read
    from the cold files onto the device; the same mutation state."""
    warm = VectorStore(st.cfg, seal_threshold=st.seal_threshold,
                       device="cpu", clock=st._clock)
    warm._segments = [dataclasses.replace(
        s, index=dataclasses.replace(s.index, raw=torch.from_numpy(
            np.array(s.raw_vectors()))), cold_path=None)
        for s in st._segments]
    for name in ("_live_seq", "_epoch", "_next_id", "_next_seq",
                 "_next_seg"):
        v = getattr(st, name)
        setattr(warm, name, dict(v) if isinstance(v, dict) else v)
    return warm


SEARCHES = [dict(mode=m, **f) for m in "AB"
            for f in ({}, {"tag_mask": 0b101}, {"ts_range": (0.2, 0.7)})]


def _assert_equal(a, b, label=""):
    assert torch.equal(a.ids, b.ids), label
    assert torch.equal(a.dists, b.dists), label


# ---------------------------------------------------------------------------
# Against the JAX cold store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_cold_store_matches_the_jax_cold_store(fused, tmp_path):
    jax = pytest.importorskip("jax")
    from repro.core import HNTLConfig as JaxConfig
    from repro.core.store import VectorStore as JaxStore
    from repro_torch.interop import store_from_numpy

    rng = np.random.default_rng(5)
    n, rows = 512, 128
    x = (rng.standard_normal((n, D)) * 3.0).astype(np.float32)
    tags = (1 << (np.arange(n) % 3)).astype(np.uint32)
    ts = (np.arange(n) / n).astype(np.float32)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jst = JaxStore(JaxConfig(d=D, k=4, s=2, block=16, n_grains=4, nprobe=4,
                             pool=16), seal_threshold=rows, cold_tier=True,
                   cold_dir=str(jdir))
    for lo in range(0, n, rows):
        jst.add(x[lo:lo + rows], tags=tags[lo:lo + rows],
                ts=ts[lo:lo + rows])
    jst.delete(rng.choice(n, 30, replace=False))
    # a view of the JAX store whose segments' index leaves are numpy
    # arrays; the store keeps its own segments (and so its cold files)
    view = copy.copy(jst)
    view._segments = [dataclasses.replace(
        s, index=jax.tree.map(np.asarray, s.index)) for s in jst._segments]
    pst = store_from_numpy(view, "cpu", cold_dir=str(pdir))
    del view
    assert pst.cold_tier and len(pst._segments) == 4
    for ps, js in zip(pst._segments, jst._segments):
        assert ps.index.raw is None and ps.cold_path != js.cold_path
        assert os.path.dirname(ps.cold_path) == str(pdir)
        assert np.array_equal(np.asarray(ps.raw_vectors()),
                              np.asarray(js.raw_vectors()))
    q = (rng.standard_normal((7, D)) * 3.0).astype(np.float32)
    for kw in SEARCHES:
        ref = jst.search(q, topk=5, fused=fused, **kw)
        got = pst.search(q, topk=5, fused=fused, **kw)
        assert np.array_equal(got.ids.numpy().astype(np.int64),
                              np.asarray(ref.ids, np.int64)), kw
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(ref.dists),
                                   rtol=1e-5, atol=1e-5)
    # the two packages' files are apart: dropping one store's segments
    # leaves the other's files in place
    port_paths = [s.cold_path for s in pst._segments]
    jax_paths = [s.cold_path for s in jst._segments]
    del pst, ps
    gc.collect()
    assert not any(os.path.exists(p) for p in port_paths)
    assert all(os.path.exists(p) for p in jax_paths)


# ---------------------------------------------------------------------------
# Against a warm store of the same segments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["fused", "per_segment", "looped"])
def test_cold_store_equals_a_warm_store_of_the_same_segments(path,
                                                             tmp_path):
    st, _, q = _store(tmp_path)
    warm = _warm_twin(st)
    kw = {"fused": dict(), "per_segment": dict(route_mode="per_segment"),
          "looped": dict(fused=False)}[path]
    for s in SEARCHES:
        for plane in ("ref", "fused_ref"):
            _assert_equal(st.search(q, topk=5, scan_impl=plane, **kw, **s),
                          warm.search(q, topk=5, scan_impl=plane, **kw, **s),
                          f"{path} {plane} {s}")


def test_cold_and_warm_stores_stay_equal_through_compact_and_maintain(
        tmp_path):
    """Sealed from the same rows, a cold and a warm store hold the same
    segments; compaction (merged rows read from the memmaps) and
    maintenance (rows read from the memmaps) keep them equal."""
    cold, x, q = _store(tmp_path, rows=96, n_seg=4)
    warm, _, _ = _store(tmp_path, cold=False, rows=96, n_seg=4)
    for s in SEARCHES:
        _assert_equal(cold.search(q, topk=5, **s), warm.search(q, topk=5,
                                                               **s))
    for st in (cold, warm):
        assert st.compact(fanin=4) == 1 and st.n_segments == 1
    assert cold._segments[0].index.raw is None
    assert np.array_equal(np.asarray(cold._segments[0].raw_vectors()),
                          warm._segments[0].index.raw.numpy())
    for s in SEARCHES:
        _assert_equal(cold.search(q, topk=5, **s), warm.search(q, topk=5,
                                                               **s))
    seg = cold._segments[0]
    ids = seg.index.grains.ids.numpy()
    valid = seg.index.grains.valid.numpy()
    kill = seg.global_ids()[ids[0][valid[0]]]       # empty grain 0
    for st in (cold, warm):
        st.delete(kill)
        rep = st.maintain()
        assert rep.total("retires") >= 1
    assert cold._segments[0].cold_path == seg.cold_path
    for s in SEARCHES:
        _assert_equal(cold.search(q, topk=5, **s), warm.search(q, topk=5,
                                                               **s))


def test_cold_mode_b_equals_brute_force_at_exhaustive_knobs(tmp_path):
    st, x, q = _store(tmp_path, n_grains=4)
    alive = np.ones(len(x), bool)
    dead = np.array(sorted(g for g, s in st._live_seq.items() if s == -1))
    alive[dead] = False
    res = st.search(q, topk=5, mode="B", nprobe=64, pool=10 ** 6)
    live = np.flatnonzero(alive)
    truth = live[flat_search(torch.from_numpy(x[live]), torch.from_numpy(q),
                             topk=5).ids.numpy()]
    assert np.array_equal(res.ids.numpy(), truth)
    exact = ((x[res.ids.numpy()] - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(res.dists.numpy(), exact, rtol=1e-5)


def test_cold_rerank_counts_its_reads(tmp_path):
    st, _, q = _store(tmp_path)
    st.search(q, topk=5, mode="B")
    stats = st._rerank_stats
    assert stats["calls"] == 1 and 0 < stats["rows"] <= 9 * 16
    assert stats["bytes"] == stats["rows"] * D * 4 and stats["host_s"] > 0
    st.search(q, topk=5, mode="A")                   # no raw read
    assert st._rerank_stats["calls"] == 1


# ---------------------------------------------------------------------------
# Cold-file lifetimes (twins of tests/test_cold_bugfixes.py's first five)
# ---------------------------------------------------------------------------


def test_failed_seal_does_not_orphan_cold_file(tmp_path):
    rng = np.random.default_rng(0)
    st = VectorStore(_cfg(), seal_threshold=64, cold_tier=True,
                     cold_dir=str(tmp_path), device="cpu")
    st.add(rng.standard_normal((64, D)).astype(np.float32))
    assert len(_cold_files(st)) == 1          # the auto-seal wrote seg 0
    st.add(rng.standard_normal((40, D)).astype(np.float32))
    orig = store_mod.Segment

    def exploding_segment(*a, **kw):
        raise RuntimeError("mid-construction failure")

    store_mod.Segment = exploding_segment
    try:
        with pytest.raises(RuntimeError, match="mid-construction"):
            st.seal()
    finally:
        store_mod.Segment = orig
    assert len(_cold_files(st)) == 1
    leaked = [p for p in store_mod._COLD_REFS
              if p.startswith(str(tmp_path))
              and p not in {s.cold_path for s in st._segments}]
    assert not leaked


def test_failed_merge_does_not_orphan_cold_file(tmp_path):
    rng = np.random.default_rng(1)
    st = VectorStore(_cfg(), seal_threshold=32, cold_tier=True,
                     cold_dir=str(tmp_path), device="cpu")
    for _ in range(4):
        st.add(rng.standard_normal((32, D)).astype(np.float32))
    assert len(_cold_files(st)) == 4
    orig = store_mod.Segment

    def exploding_segment(*a, **kw):
        raise RuntimeError("mid-merge failure")

    store_mod.Segment = exploding_segment
    try:
        with pytest.raises(RuntimeError, match="mid-merge"):
            st.compact(fanin=4, maintain=False)
    finally:
        store_mod.Segment = orig
    assert len(_cold_files(st)) == 4          # the sources survive


def test_failed_construction_keeps_shared_file(tmp_path):
    rng = np.random.default_rng(2)
    st = VectorStore(_cfg(), seal_threshold=64, cold_tier=True,
                     cold_dir=str(tmp_path), device="cpu")
    st.add(rng.standard_normal((64, D)).astype(np.float32))
    path = st._segments[0].cold_path
    with pytest.raises(RuntimeError):
        with store_mod._cold_construction(path):
            raise RuntimeError("derived child failed")
    assert os.path.exists(path)
    assert store_mod._COLD_REFS[path] == 1


def test_cold_refs_mutation_is_locked(tmp_path):
    path = str(tmp_path / "cold_lock_probe.raw")
    with open(path, "wb") as f:
        f.write(b"\0" * 64)

    class Holder:                     # object() cannot be weakly referenced
        pass

    n_threads, n_iter = 8, 200
    holders = [[Holder() for _ in range(n_iter)] for _ in range(n_threads)]
    barrier = threading.Barrier(n_threads)

    def worker(i):
        barrier.wait()
        for h in holders[i]:
            store_mod._reclaim_cold_on_gc(h, path)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert store_mod._COLD_REFS[path] == n_threads * n_iter
    holders.clear()
    gc.collect()
    assert path not in store_mod._COLD_REFS
    assert not os.path.exists(path)


def test_cold_file_fsynced_before_manifest_visibility(tmp_path, monkeypatch):
    synced_at = []
    real_fsync = os.fsync
    st = VectorStore(_cfg(), seal_threshold=1 << 30, cold_tier=True,
                     cold_dir=str(tmp_path), device="cpu")

    def recording_fsync(fd):
        real_fsync(fd)
        synced_at.append(len(st._segments))

    monkeypatch.setattr(store_mod.os, "fsync", recording_fsync)
    x = np.random.default_rng(3).standard_normal((64, D)).astype(np.float32)
    st.add(x)
    seg = st.seal()
    assert seg is not None and seg.cold_path is not None
    assert synced_at and all(n == 0 for n in synced_at)
    mm = np.memmap(seg.cold_path, dtype=np.float32, mode="r", shape=(64, D))
    np.testing.assert_array_equal(np.asarray(mm), x)


# ---------------------------------------------------------------------------
# Branches, compaction and maintenance (twins of the reference's tests)
# ---------------------------------------------------------------------------


def test_branch_cold_files_do_not_collide(tmp_path):
    rng = np.random.default_rng(11)
    st, _, _ = _store(tmp_path)
    child = st.branch()
    a = rng.standard_normal((128, D)).astype(np.float32)
    b = rng.standard_normal((128, D)).astype(np.float32)
    child.add(a)                                   # both seal seg_id N
    st.add(b)
    assert child._segments[-1].cold_path != st._segments[-1].cold_path
    np.testing.assert_array_equal(child._segments[-1].raw_vectors(), a)
    np.testing.assert_array_equal(st._segments[-1].raw_vectors(), b)


def test_compact_reclaims_unreferenced_cold_files(tmp_path):
    st, _, q = _store(tmp_path)
    st.search(q, topk=5, mode="B")                 # a cached plane too
    old_paths = [s.cold_path for s in st._segments]
    man = st.snapshot()                            # pins the old segments
    st.compact(fanin=4)
    gc.collect()
    assert all(os.path.exists(p) for p in old_paths)
    del man
    st._stack_cache.clear()                        # drop cached refs too
    gc.collect()
    assert not any(os.path.exists(p) for p in old_paths)
    assert all(os.path.exists(s.cold_path) for s in st._segments)
    assert _cold_files(st) == sorted(s.cold_path for s in st._segments)


def test_cold_tier_maintenance_shares_and_keeps_the_cold_file(tmp_path):
    """A repaired child shares its parent's cold file, which outlives the
    parent; the deletes empty one grain and hollow out another, so the
    repair really happens (unlike the reference's own twin)."""
    st, x, q = _store(tmp_path, rows=512, n_seg=1)
    seg = st._segments[0]
    path = seg.cold_path
    ids = seg.index.grains.ids.numpy()
    valid = seg.index.grains.valid.numpy()
    rows0, rows1 = ids[0][valid[0]], ids[1][valid[1]]
    st.delete(seg.global_ids()[np.concatenate([rows0, rows1[3:]])])
    rep = st.maintain()
    assert rep.changed and rep.total("retires") >= 1
    assert rep.total("merges") + rep.total("refits") >= 1
    child = st._segments[0]
    assert child is not seg and child.cold_path == path
    assert store_mod._COLD_REFS[path] == 2
    del seg
    st._stack_cache.clear()
    gc.collect()
    assert os.path.exists(path), "cold file reclaimed while still in use"
    assert store_mod._COLD_REFS[path] == 1
    warm = _warm_twin(st)
    for s in SEARCHES:
        _assert_equal(st.search(q, topk=5, **s), warm.search(q, topk=5, **s))
    del child
    st._segments = []
    st._stack_cache.clear()
    gc.collect()
    assert not os.path.exists(path)


def test_maintenance_reads_the_cold_rows(tmp_path, monkeypatch):
    """grain_health and maintain on a cold segment read its rows from the
    memmap (the segment has no raw tier on the device) and equal the warm
    twin's statistics."""
    st, _, _ = _store(tmp_path, rows=256, n_seg=2)
    warm = _warm_twin(st)
    for a, b in zip(st.grain_health(), warm.grain_health()):
        for k in ("live_cnt", "captured", "best", "drift2", "var_live"):
            assert np.array_equal(a[k], b[k]), k


def test_policy_drift_repair_on_a_cold_store(tmp_path):
    """A one-sided cut of a grain trips a refit at a low drift ratio; the
    repaired cold store equals its warm twin."""
    st, x, q = _store(tmp_path, rows=512, n_seg=1)
    seg = st._segments[0]
    g = seg.index.grains
    rows = g.ids[2][g.valid[2]].numpy()
    p = ((torch.from_numpy(np.asarray(seg.raw_vectors())[rows]) - g.mu[2])
         @ g.basis[2][:, 0]).numpy()
    st.delete(seg.global_ids()[rows[p < 0]])
    warm = _warm_twin(st)
    policy = MaintenancePolicy(drift_ratio=0.01)
    r_cold, r_warm = st.maintain(policy=policy), warm.maintain(policy=policy)
    assert r_cold.summary() == r_warm.summary() and r_cold.changed
    for s in SEARCHES:
        _assert_equal(st.search(q, topk=5, **s), warm.search(q, topk=5, **s))


# ---------------------------------------------------------------------------
# Adaptive routing on the cold tier: results, and the traffic entries'
# hold on cold files (twins of tests/test_cold_bugfixes.py's bugfix 3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["A", "B"])
def test_cold_adaptive_search_equals_a_warm_store(mode, tmp_path):
    """Each width bucket's Mode A pool re-ranked from the cold files, in
    the bucket's batches: the warm store's adaptive search bit for bit,
    through a sequence of searches (the hub set forms), with equal probe
    stats."""
    st, _, q = _store(tmp_path, hub_size=2)
    warm = _warm_twin(st)
    for margin in (0.3, 0.1, 0.1):
        kw = dict(topk=5, mode=mode, adaptive=True, probe_margin=margin)
        _assert_equal(st.search(q, **kw), warm.search(q, **kw), margin)
    assert st.probe_stats() == warm.probe_stats()
    assert st.probe_stats()["mean_active"] < st.cfg.nprobe
    assert np.array_equal(st.hub_grains(), warm.hub_grains())


def _four_seals(tmp_path, **kw):
    rng = np.random.default_rng(4)
    st = VectorStore(_cfg(hub_size=1, **kw), seal_threshold=64,
                     device="cpu", cold_tier=True, cold_dir=str(tmp_path))
    for _ in range(4):
        st.add(rng.standard_normal((64, D)).astype(np.float32))
    q = rng.standard_normal((8, D)).astype(np.float32)
    return st, q


def test_probe_traffic_purged_on_compact(tmp_path, monkeypatch):
    """compact() after adaptive traffic: the traffic LRU no longer pins
    the replaced segments, so their cold files go once the plane cache
    turns over."""
    monkeypatch.setattr(store_mod, "STACK_CACHE_ENTRIES", 1)
    st, q = _four_seals(tmp_path)
    old_paths = [s.cold_path for s in st._segments]
    assert len(old_paths) == 4 and all(os.path.exists(p) for p in old_paths)
    st.search(q, topk=4, adaptive=True)
    assert len(st._probe_traffic) == 1
    st.compact(fanin=4, maintain=False)
    assert st.n_segments == 1
    assert not [hit for hit in st._probe_traffic.values()
                if any(s.cold_path in old_paths for s in hit["segments"])]
    st.search(q, topk=4, adaptive=True)     # re-stacks; LRU(1) evicts
    gc.collect()
    assert not any(os.path.exists(p) for p in old_paths)
    assert os.path.exists(st._segments[0].cold_path)


def test_probe_traffic_kept_for_live_subset(tmp_path):
    """seal() only appends: an entry whose segments are all still live
    survives the purge."""
    st, q = _four_seals(tmp_path)
    st.search(q, topk=4, adaptive=True)
    key = tuple(id(s) for s in st._segments)
    assert key in st._probe_traffic
    st.add(np.random.default_rng(5).standard_normal((64, D))
           .astype(np.float32))
    st._purge_probe_traffic()
    assert key in st._probe_traffic


def test_probe_traffic_purged_on_maintain(tmp_path):
    """maintain() that replaces a segment drops the traffic entries that
    pin the old one; the new segment set starts from zero counters."""
    st, q = _four_seals(tmp_path)
    st.search(q, topk=4, adaptive=True)
    seg = st._segments[0]
    ids = seg.index.grains.ids.numpy()
    valid = seg.index.grains.valid.numpy()
    st.delete(seg.global_ids()[ids[0][valid[0]]])       # empty one grain
    rep = st.maintain()
    assert rep.total("retires") >= 1 and st._segments[0] is not seg
    assert not [hit for hit in st._probe_traffic.values()
                if any(s is seg for s in hit["segments"])]
    assert st.probe_stats()["queries"] == 0
    assert all((h["route_wins"] == 0).all() for h in st.grain_health())
