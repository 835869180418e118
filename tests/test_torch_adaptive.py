"""Adaptive query-time routing in the port, against the JAX package's.

- **Against the JAX package** (the same numpy inputs): the stopping rule
  ``routing.adaptive_prefix`` (random routing distances, the hub set,
  ``min_probes``, and a probe exactly on the threshold, fed the same gd2:
  ``(1 + margin)`` rounds as JAX rounds it), ``planner.probe_plan``
  (gids, n_active, wins and touches, exact) on a JAX store's stacked plane
  carried across, and ``VectorStore.search(adaptive=True)`` on a JAX store
  carried across with ``interop.store_from_numpy``, warm and cold, over a
  sequence of searches (so hubs form): ids equal, dists within rtol 1e-5
  and atol 1e-5 (the planner's parity tolerance), then ``hub_grains()``,
  ``probe_stats()`` and ``grain_health()``'s counters equal.  Before
  plans are compared, no routing distance may sit within 1e-4 of the
  threshold (``torch_parity.assert_clear_probe_margins``): the two
  packages' f32 routing matmuls may differ by an ulp.
- **The port alone**: twins of the reference's 15 store-level tests
  (``tests/test_adaptive.py``, all but the tenancy and serving-engine
  ones, whose twins are in ``test_torch_tenancy.py``), on the "ref", "kernel",
  "fused" and "fused_ref" planes and the cascades, warm and cold:
  ``adaptive=False`` and ``probe_margin=inf`` are the static plane bit for
  bit, a huge finite margin at exhaustive knobs equals the static
  exhaustive search, the rule's unit contract, validation, and the traffic
  counters, hub set and LRU bound; and the bucketed dispatch runs one
  ``search_stacked`` per power-of-two width bucket, none of the narrow
  ones at the static width.
"""
import copy
import dataclasses

import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import HNTLConfig as JaxConfig
from repro.core import planner as jax_planner
from repro.core import routing as jax_routing
from repro.core.store import VectorStore as JaxStore
from repro_torch.core import HNTLConfig, VectorStore, planner, routing
from repro_torch.core import store as store_mod
from repro_torch.core.types import BIG
from repro_torch.interop import store_from_numpy

import torch_mutation_property as tmp
import torch_parity as tp

D, SEG_ROWS, N_SEG = 24, 128, 3
BACKENDS = ["ref", "kernel", "fused", "fused_ref"]
CASCADES = ["cascade", "cascade_ref"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: on one thread, so a worker among several on
    a busy host does not spin a pool of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CFG = dict(d=D, k=6, s=0, n_grains=4, nprobe=4, pool=32, block=32,
            hub_size=2)


def _data():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N_SEG * SEG_ROWS, D)).astype(np.float32)
    q = (x[:5] + 0.01 * rng.standard_normal((5, D))).astype(np.float32)
    return x, q


def _fill(st, x):
    for i in range(N_SEG):
        st.add(x[i * SEG_ROWS:(i + 1) * SEG_ROWS],
               tags=[1 << (i % 3)] * SEG_ROWS, ts=[float(i)] * SEG_ROWS)
    assert st.n_segments == N_SEG and not st._mem
    return st


def _build(cold: bool, cold_dir=None):
    x, q = _data()
    st = VectorStore(HNTLConfig(**_CFG), seal_threshold=SEG_ROWS,
                     device="cpu", cold_tier=cold,
                     cold_dir=None if cold_dir is None else str(cold_dir))
    return _fill(st, x), x, q


def _exhaustive(st):
    return dict(nprobe=sum(s.index.grains.n_grains for s in st._segments),
                pool=st.n_vectors * 2)


@pytest.fixture(scope="module", params=["warm", "cold"])
def store(request, tmp_path_factory):
    return _build(request.param == "cold",
                  tmp_path_factory.mktemp("adaptive_cold"))


def _assert_same(res, ref, exact_dists: bool = False):
    assert torch.equal(res.ids, ref.ids)
    if exact_dists:
        assert torch.equal(res.dists, ref.dists)
    else:
        np.testing.assert_allclose(res.dists.numpy(), ref.dists.numpy(),
                                   rtol=1e-5, atol=1e-5)


def _assert_like_jax(port, ref):
    assert np.array_equal(port.ids.numpy().astype(np.int64),
                          np.asarray(ref.ids, np.int64))
    np.testing.assert_allclose(port.dists.numpy(), np.asarray(ref.dists),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# against the JAX package: the rule, the plan, the store
# ---------------------------------------------------------------------------


def _jax_prefix(gids, gd2, margin, **kw):
    if kw.get("hub_mask") is not None:
        kw["hub_mask"] = jnp.asarray(kw["hub_mask"])
    g, n = jax_routing.adaptive_prefix(jnp.asarray(gids), jnp.asarray(gd2),
                                       margin=margin, **kw)
    return np.asarray(g), np.asarray(n)


def _port_prefix(gids, gd2, margin, **kw):
    if kw.get("hub_mask") is not None:
        kw["hub_mask"] = torch.from_numpy(kw["hub_mask"])
    g, n = routing.adaptive_prefix(torch.from_numpy(gids),
                                   torch.from_numpy(gd2), margin=margin,
                                   **kw)
    assert g.dtype == torch.int32 and n.dtype == torch.int32
    return g.numpy(), n.numpy()


@pytest.mark.parametrize("margin, min_probes, hubs", [
    (0.0, 1, False), (0.35, 1, True), (1.0, 2, False), (1.0, 1, True)])
def test_adaptive_prefix_matches_jax(margin, min_probes, hubs):
    rng = np.random.default_rng(int(margin * 100) + min_probes)
    q_n, p_n, g_n = 64, 8, 40
    gids = np.stack([rng.permutation(g_n)[:p_n]
                     for _ in range(q_n)]).astype(np.int32)
    gd2 = np.sort(rng.uniform(0.5, 4.0, size=(q_n, p_n)), axis=1) \
        .astype(np.float32)
    gd2[rng.random((q_n, p_n)) < 0.1] = BIG             # masked grains
    gd2 = np.sort(gd2, axis=1)
    tp.assert_clear_probe_margins(gd2, margin)
    hub = (rng.random(g_n) < 0.2) if hubs else None
    kw = dict(min_probes=min_probes, hub_mask=hub)
    jg, jn = _jax_prefix(gids, gd2, margin, **dict(kw))
    pg, pn = _port_prefix(gids, gd2, margin, **dict(kw))
    assert np.array_equal(pn, jn) and np.array_equal(pg, jg)
    if margin > 0:
        assert 1 < pn.mean() < p_n                      # a real mix


def test_probe_on_the_threshold_rounds_as_jax():
    """A probe exactly at (1 + margin) * lead in f32 stays active in both
    packages, one ulp above it is killed in both: the Python float
    (1 + margin) meets the f32 lead the same way."""
    lead = np.float32(1.7)
    for margin in (0.35, 1.0, 0.1):
        at = np.float32(np.float32(1.0 + margin) * lead)
        above = np.nextafter(at, np.float32(np.inf))
        gd2 = np.array([[lead, at, above, above * 2]], np.float32)
        gids = np.arange(4, dtype=np.int32)[None, :]
        jg, jn = _jax_prefix(gids, gd2, margin)
        pg, pn = _port_prefix(gids, gd2, margin)
        assert jn.tolist() == pn.tolist() == [2]
        assert np.array_equal(jg, pg)


def _jax_store(cold, cold_dir):
    x, q = _data()
    st = JaxStore(JaxConfig(**_CFG), seal_threshold=SEG_ROWS,
                  cold_tier=cold, cold_dir=str(cold_dir) if cold else None)
    return _fill(st, x), q


def _carry(jst, cold_dir):
    view = copy.copy(jst)
    view._segments = [dataclasses.replace(
        s, index=jax.tree.map(np.asarray, s.index)) for s in jst._segments]
    return store_from_numpy(view, "cpu", cold_dir=str(cold_dir))


def _port_plane(st):
    man = st.snapshot()
    entry = st._stacked_for(man.segments)
    return man, st._live_plane(entry, man, st._clock())


def test_probe_plan_matches_jax(tmp_path):
    jst, q = _jax_store(False, None)
    pst = _carry(jst, tmp_path)
    man = jst.snapshot()
    jplane = jst._live_plane(jst._stacked_for(man.segments, None), man,
                             jst._clock())
    _, pplane = _port_plane(pst)
    qt = torch.from_numpy(q)
    nprobe = 8
    _, gd2 = routing.route(pplane.index.routing, qt, nprobe)
    hub = np.zeros(pplane.index.routing.n_grains, bool)
    hub[[1, 6]] = True
    for margin, minp, h in ((0.5, 1, None), (0.3, 2, hub),
                            (float("inf"), 1, None)):
        if not np.isinf(margin):
            tp.assert_clear_probe_margins(gd2.numpy(), margin)
        want = jax_planner.probe_plan(
            jplane, jnp.asarray(q), nprobe=nprobe, probe_margin=margin,
            min_probes=minp, hub_mask=None if h is None else jnp.asarray(h))
        got = planner.probe_plan(
            pplane, qt, nprobe=nprobe, probe_margin=margin, min_probes=minp,
            hub_mask=None if h is None else torch.from_numpy(h))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w))
    static, _ = planner.static_route(pplane.index.routing, qt, nprobe=nprobe)
    assert torch.equal(got[0], static)               # inf: the static plan


@pytest.mark.parametrize("kind", ["warm", "cold"])
def test_adaptive_store_search_matches_jax(kind, tmp_path):
    """Three adaptive searches in a row (the hub set forms from the first
    one's traffic), on a JAX store carried across: equal results, then
    equal hub sets, probe stats and grain_health counters."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jst, q = _jax_store(kind == "cold", jdir)
    pst = _carry(jst, pdir)
    _, pplane = _port_plane(pst)
    _, gd2 = routing.route(pplane.index.routing, torch.from_numpy(q), 4)
    tp.assert_clear_probe_margins(gd2.numpy(), 0.5)
    for mode in ("A", "B", "B"):
        kw = dict(topk=5, mode=mode, scan_impl="fused_ref", adaptive=True,
                  probe_margin=0.5)
        _assert_like_jax(pst.search(q, **kw), jst.search(q, **kw))
    assert np.array_equal(pst.hub_grains(), jst.hub_grains())
    assert pst.hub_grains().size > 0
    assert pst.probe_stats() == jst.probe_stats()
    for ph, jh in zip(pst.grain_health(), jst.grain_health()):
        for name in ("route_wins", "touches"):
            assert np.array_equal(ph[name], np.asarray(jh[name])), name


# ---------------------------------------------------------------------------
# the port alone: bit-identity, the huge finite margin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["A", "B"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_margin_inf_bit_identical_to_static(store, backend, mode):
    st, x, q = store
    ref = st.search(q, topk=5, mode=mode, scan_impl=backend)
    res = st.search(q, topk=5, mode=mode, scan_impl=backend,
                    adaptive=True, probe_margin=float("inf"))
    _assert_same(res, ref, exact_dists=True)
    off = st.search(q, topk=5, mode=mode, scan_impl=backend, adaptive=False)
    _assert_same(off, ref, exact_dists=True)


@pytest.mark.parametrize("mode", ["A", "B"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_huge_margin_exhaustive_identity(store, backend, mode):
    """A huge finite margin runs the ragged machinery (invalid probes
    killed, the stable partition, the bucketed dispatch) but keeps every
    valid grain active: the static exhaustive plane's result."""
    st, x, q = store
    kw = dict(topk=5, mode=mode, scan_impl=backend, **_exhaustive(st))
    ref = st.search(q, **kw)
    res = st.search(q, adaptive=True, probe_margin=1e30, **kw)
    _assert_same(res, ref)


@pytest.mark.parametrize("impl", CASCADES)
def test_huge_margin_cascade_identity(store, impl):
    st, x, q = store
    ex = _exhaustive(st)
    kw = dict(topk=5, mode="B", scan_impl=impl,
              budgets=(ex["pool"], ex["pool"]), **ex)
    _assert_same(st.search(q, adaptive=True, probe_margin=1e30, **kw),
                 st.search(q, **kw))


@pytest.mark.parametrize("filt", [dict(tag_mask=2),
                                  dict(ts_range=(0.0, 2.0))])
def test_huge_margin_identity_under_predicates(store, filt):
    st, x, q = store
    kw = dict(topk=5, mode="B", **_exhaustive(st), **filt)
    _assert_same(st.search(q, adaptive=True, probe_margin=1e30, **kw),
                 st.search(q, **kw))


def test_adaptive_recall_by_construction_seeded(tmp_path):
    """Through add/seal/delete/upsert/compact/maintain, an adaptive search
    with a huge finite margin still equals brute force exactly."""
    for ops, seed, cold in [
            (("add", "seal", "delete", "upsert", "seal"), 5, False),
            (("seal", "delete", "maintain", "add", "compact"), 9, True),
            (("add", "add", "seal", "seal", "delete", "maintain"), 17,
             False)]:
        tmp.mutation_interleaving_check(
            ops, seed, cold_tier=cold, cold_dir=str(tmp_path),
            adaptive_margin=1e30)


def test_buckets_run_at_their_own_width(monkeypatch):
    """One ``search_stacked`` per power-of-two width bucket, at its width
    (never the static width for a narrower bucket), each with its slice of
    one plan."""
    st, x, q = _build(False)
    q = np.concatenate([q, x[200:240] + 0.3])
    calls = []
    real = planner.search_stacked

    def spy(stacked, qb, **kw):
        calls.append((qb.shape[0], kw["nprobe"], kw["probe_plan"]))
        return real(stacked, qb, **kw)

    monkeypatch.setattr(store_mod.planner, "search_stacked", spy)
    st.search(q, topk=5, adaptive=True, probe_margin=0.2, nprobe=8)
    stats = st.probe_stats()
    assert stats["queries"] == q.shape[0]
    widths = [w for _, w, _ in calls]
    assert len(set(widths)) == len(widths) > 1
    assert sum(n for n, _, _ in calls) == q.shape[0]
    for n, w, (gids, na) in calls:
        assert gids.shape == (n, w) and na.shape == (n,)
        assert int(na.max()) <= w and (w == 1 or int(na.max()) > w // 2)
    assert sum(int(na.sum()) for _, _, (_, na) in calls) \
        == stats["active_probes"]


# ---------------------------------------------------------------------------
# the stopping rule's unit contract
# ---------------------------------------------------------------------------


def _prefix(gd2, margin, **kw):
    gd2 = np.asarray(gd2, np.float32)
    gids = np.tile(np.arange(gd2.shape[1], dtype=np.int32),
                   (gd2.shape[0], 1))
    return _port_prefix(gids, gd2, margin, **kw)


def test_distance_gap_rule_and_stable_partition():
    g, n = _prefix([[1.0, 1.5, 10.0, 12.0]], margin=1.0)
    assert n.tolist() == [2]
    assert g[0].tolist() == [0, 1, 2, 3]
    g, n = _prefix([[1.0, 5.0, 1.8, 6.0]], margin=1.0)
    assert n.tolist() == [2]
    assert g[0].tolist() == [0, 2, 1, 3]


def test_hub_always_probed():
    hub = np.zeros(4, bool)
    hub[2] = True
    g, n = _prefix([[1.0, 1.5, 50.0, 60.0]], margin=1.0, hub_mask=hub)
    assert n.tolist() == [3]
    assert g[0].tolist() == [0, 1, 2, 3]
    g, n = _prefix([[1.0, 1.5, BIG, 60.0]], margin=1.0, hub_mask=hub)
    assert n.tolist() == [2]


def test_min_probes_floor():
    g, n = _prefix([[1.0, 50.0, 60.0, 70.0]], margin=0.0, min_probes=3)
    assert n.tolist() == [3]
    g, n = _prefix([[BIG, BIG, BIG, BIG]], margin=0.0)
    assert n.tolist() == [1]


def test_invalid_grains_killed():
    g, n = _prefix([[1.0, BIG, 1.5, BIG]], margin=1.0)
    assert n.tolist() == [2]
    assert g[0].tolist() == [0, 2, 1, 3]


def test_per_query_independence():
    g, n = _prefix([[1.0, 1.2, 9.0, 9.5],
                    [1.0, 9.0, 9.2, 9.5]], margin=0.5)
    assert n.tolist() == [2, 1]


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def test_check_probe_args_errors():
    with pytest.raises(ValueError, match="adaptive=True"):
        routing.check_probe_args(False, 0.5)
    with pytest.raises(ValueError, match=">= 0"):
        routing.check_probe_args(True, float("nan"))
    with pytest.raises(ValueError, match=">= 0"):
        routing.check_probe_args(True, -0.1)
    with pytest.raises(ValueError, match="min_probes"):
        routing.check_probe_args(True, 0.5, 0)
    with pytest.raises(ValueError, match="min_probes"):
        routing.check_probe_args(True, 0.5, True)
    routing.check_probe_args(True, float("inf"), 2)


def test_search_rejects_bad_adaptive_combinations(store):
    st, x, q = store
    with pytest.raises(ValueError, match="adaptive=True"):
        st.search(q, topk=5, probe_margin=0.5)
    with pytest.raises(ValueError, match="fused"):
        st.search(q, topk=5, adaptive=True, fused=False)
    with pytest.raises(ValueError, match="global"):
        st.search(q, topk=5, adaptive=True, route_mode="per_segment")


# ---------------------------------------------------------------------------
# traffic counters, hub set, health
# ---------------------------------------------------------------------------


def test_traffic_accumulates_only_under_adaptive():
    st, x, q = _build(False)
    st.search(q, topk=5, mode="B")
    st.search(q, topk=5, mode="B", adaptive=True, probe_margin=float("inf"))
    assert st.probe_stats() == {"queries": 0, "active_probes": 0,
                                "mean_active": 0.0}
    assert st.hub_grains().size == 0
    assert all((h["route_wins"] == 0).all() and (h["touches"] == 0).all()
               for h in st.grain_health())

    st.search(q, topk=5, mode="B", adaptive=True, probe_margin=0.5)
    stats = st.probe_stats()
    assert stats["queries"] == q.shape[0]
    assert stats["active_probes"] >= q.shape[0]
    assert stats["mean_active"] >= 1.0

    health = st.grain_health()
    wins = np.concatenate([h["route_wins"] for h in health])
    touches = np.concatenate([h["touches"] for h in health])
    assert wins.sum() == q.shape[0]
    assert touches.sum() == stats["active_probes"]

    hubs = st.hub_grains()
    assert 0 < hubs.size <= st.cfg.hub_size


def test_hub_set_probed_by_every_query_end_to_end():
    st, x, q = _build(False)
    st.search(q, topk=5, mode="B", adaptive=True, probe_margin=0.5)
    hubs = st.hub_grains()
    assert hubs.size > 0
    man, stacked = _port_plane(st)
    traffic = st._traffic_for(man.segments, stacked.index.routing.n_grains)
    hub = st._hub_mask_host(traffic)
    nprobe = sum(s.index.grains.n_grains for s in st._segments)
    gids, n_active, _, _ = planner.probe_plan(
        stacked, torch.from_numpy(q), nprobe=nprobe, probe_margin=0.0,
        min_probes=1, hub_mask=torch.from_numpy(hub))
    gids, n_active = gids.numpy(), n_active.numpy()
    for qi in range(q.shape[0]):
        active = set(gids[qi, :n_active[qi]].tolist())
        assert set(hubs.tolist()) <= active, (qi, hubs, active)


def test_probe_traffic_cache_is_bounded():
    st, x, q = _build(False)
    st.search(q[:1], topk=3, mode="B", adaptive=True, probe_margin=0.5)
    limit = max(4, store_mod.STACK_CACHE_ENTRIES)
    for _ in range(limit + 3):
        st._traffic_for((object(),), 4)
    assert len(st._probe_traffic) <= limit
