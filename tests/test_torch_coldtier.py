"""Tiered residency in the port: the paged search against the all-warm
plane, bit for bit.

The contract (the JAX package's ``tests/test_coldtier.py``): with
``device_budget=`` set, the grain panels go to one panel file and only
the elected hot set stays on the device, yet every search returns ids
and dists equal (``torch.equal``) to the same store searched all-warm.
The port computes routing and the projection once per search, in the
all-warm plane's batches, so this holds for every filter: the JAX package
fails its own ``ts_range`` Mode A case (``test_paged_parity_filters[A]``,
ROADMAP Queue C), which ``test_paged_parity_filters`` runs here.

Twins of the reference's cases, on the port's own stores (built the same
way twice, on the CPU, where a build is deterministic): budgets 0, mid
and huge in Mode A and B; tag, ts and joint filters; the "ref",
"fused_ref" and "kernel" planes; the cold raw tier; deletes, upserts and
compaction; re-election, the size-seeded hot set, knob validation, branch
propagation and the panel file's lifetime; adaptive routing (paged
equals all-warm through a sequence of searches, with equal probe stats
and traffic counters); tenancy (a per-query tenant bitmap through the
paged plane equals the all-warm one).  The residency helpers are held to
the JAX package's on the same inputs.
"""
import gc
import glob
import os

import numpy as np
import pytest
import torch

from repro_torch.core import HNTLConfig, VectorStore, layout, planner
from repro_torch.core import residency
from repro_torch.core.store import stack_segments
from repro_torch.kernels import fused_select, select_cases

D, N, SEG, Q = 16, 512, 128, 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These stores run many small tensor ops: on one thread each, so a
    worker among several on a busy host does not spin a pool of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# 0: every grain pages; 8192: a few grains hot (~1.5 KB of panels per
# grain at this shape); huge: all hot, the paged path with no cold chunk
BUDGETS = {"zero": 0, "mid": 8192, "huge": 10 ** 12}


def _cfg(**kw):
    return HNTLConfig(d=D, k=4, s=2, block=16, n_grains=8, nprobe=4,
                      pool=32, **kw)


def _data(seed=0):
    r = np.random.default_rng(seed)
    vecs = (r.standard_normal((N, D)) * 3.0).astype(np.float32)
    tags = ((np.arange(N) % 2) + 1).astype(np.uint32)        # 1 / 2
    ts = np.linspace(0.0, 100.0, N).astype(np.float32)
    qs = (r.standard_normal((Q, D)) * 3.0).astype(np.float32)
    return vecs, tags, ts, qs


def _build(budget, tmp_path, *, cold=False, seed=0, **store_kw):
    vecs, tags, ts, qs = _data(seed)
    st = VectorStore(_cfg(), seal_threshold=SEG, device="cpu",
                     device_budget=budget, residency_interval=4,
                     prefetch_grains=2, cold_dir=str(tmp_path),
                     cold_tier=cold, **store_kw)
    for i in range(0, N, SEG):
        st.add(vecs[i:i + SEG], tags=tags[i:i + SEG], ts=ts[i:i + SEG])
    st.seal()
    return st, qs


def _pair(budget, tmp_path, **kw):
    """(all-warm store, tiered store) over the same data."""
    oracle, qs = _build(None, tmp_path, **kw)
    tiered, _ = _build(budget, tmp_path, **kw)
    return oracle, tiered, qs


def _assert_same(r0, r1, label=""):
    assert torch.equal(r0.ids, r1.ids), label
    assert torch.equal(r0.dists, r1.dists), label


# ------------------------------------------------------------ parity matrix


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("mode", ["A", "B"])
def test_paged_parity(budget, mode, tmp_path):
    oracle, tiered, qs = _pair(BUDGETS[budget], tmp_path)
    for _ in range(2):            # the 2nd round hits the hot-plane cache
        _assert_same(oracle.search(qs, topk=5, mode=mode),
                     tiered.search(qs, topk=5, mode=mode),
                     f"{budget}/{mode}")
    st = tiered.residency_stats()
    assert st["paged_queries"] == 2 * Q and st["searches"] == 2
    if budget == "huge":
        assert st["hot_grains"] == st["n_grains"]
        assert st["chunk_dispatches"] == 0     # nothing cold to stage
    if budget == "zero":
        assert st["hot_grains"] == 0 and st["chunk_dispatches"] > 0
        assert st["staged_bytes"] > 0


@pytest.mark.parametrize("mode", ["A", "B"])
def test_paged_parity_filters(mode, tmp_path):
    """Including Mode A under ts_range=(20, 70), where the JAX package's
    paged dists differ from its all-warm ones by an ulp."""
    oracle, tiered, qs = _pair(BUDGETS["mid"], tmp_path)
    for kw in ({"tag_mask": 0x1}, {"ts_range": (20.0, 70.0)},
               {"tag_mask": 0x2, "ts_range": (10.0, 90.0)}):
        _assert_same(oracle.search(qs, topk=5, mode=mode, **kw),
                     tiered.search(qs, topk=5, mode=mode, **kw), str(kw))


@pytest.mark.parametrize("budget", ["zero", "mid"])
def test_paged_parity_ts_range_mode_a_on_many_queries(budget, tmp_path):
    """The reference's failing case at a wider batch: 300 queries (two
    query batches of the all-warm plane, cold passes over query subsets of
    other sizes) under ts_range in Mode A."""
    oracle, tiered, _ = _pair(BUDGETS[budget], tmp_path)
    qs = (np.random.default_rng(9).standard_normal((300, D)) * 3.0) \
        .astype(np.float32)
    for kw in ({"ts_range": (20.0, 70.0)}, {}):
        _assert_same(oracle.search(qs, topk=5, mode="A", **kw),
                     tiered.search(qs, topk=5, mode="A", **kw), str(kw))


@pytest.mark.parametrize("scan_impl", ["ref", "fused_ref", "kernel"])
@pytest.mark.parametrize("mode", ["A", "B"])
def test_paged_parity_scan_backends(scan_impl, mode, tmp_path):
    oracle, tiered, qs = _pair(BUDGETS["mid"], tmp_path)
    _assert_same(oracle.search(qs, topk=5, mode=mode, scan_impl=scan_impl),
                 tiered.search(qs, topk=5, mode=mode, scan_impl=scan_impl),
                 scan_impl)


def test_paged_parity_cold_raw_tier(tmp_path):
    """device_budget with cold_tier=True: panels page from the panel
    file, Mode B re-ranks from the raw memmaps, and the results still
    equal the all-warm plane's."""
    oracle, tiered, qs = _pair(BUDGETS["mid"], tmp_path, cold=True)
    assert all(s.index.raw is None for s in tiered._segments)
    for mode in ("B", "A"):
        _assert_same(oracle.search(qs, topk=5, mode=mode),
                     tiered.search(qs, topk=5, mode=mode), mode)


@pytest.mark.parametrize("cold", [False, True])
def test_paged_parity_under_mutation(cold, tmp_path):
    """Deletes and upserts reach the paged plane through the host
    liveness bitmap; parity holds across mutation epochs and after
    compaction rewrites the segment set."""
    oracle, tiered, qs = _pair(BUDGETS["mid"], tmp_path, cold=cold)
    r = np.random.default_rng(3)
    dead = r.choice(N, size=40, replace=False)
    up = r.choice(np.setdiff1d(np.arange(N), dead), size=8, replace=False)
    upv = (r.standard_normal((8, D)) * 3.0).astype(np.float32)
    for st in (oracle, tiered):
        st.delete(dead)
        st.upsert(up, upv)
        st.seal()
    for mode in ("A", "B"):
        _assert_same(oracle.search(qs, topk=5, mode=mode),
                     tiered.search(qs, topk=5, mode=mode), "post-mutation")
    for st in (oracle, tiered):
        st.compact()
    for mode in ("A", "B"):
        _assert_same(oracle.search(qs, topk=5, mode=mode),
                     tiered.search(qs, topk=5, mode=mode), "post-compact")
    ids = tiered.search(qs, topk=5, mode="B").ids.numpy()
    assert not np.isin(ids, dead).any()


def test_one_store_under_every_budget_equals_its_all_warm_plane(tmp_path):
    """One cold store, its budget changed in place (as the chip phase
    does): every budget, filter and mode equals the same store's all-warm
    plane; the hot set follows update_residency()."""
    st, qs = _build(None, tmp_path, cold=True)
    st.delete(np.arange(0, N, 11))
    searches = [dict(mode=m, **f) for m in "AB"
                for f in ({}, {"tag_mask": 0x2}, {"ts_range": (5.0, 60.0)})]
    warm = [st.search(qs, topk=5, **kw) for kw in searches]
    for budget in (0, 8192, 10 ** 12):
        st.device_budget = budget
        st.search(qs, topk=5)
        st.update_residency()
        for kw, want in zip(searches, warm):
            _assert_same(want, st.search(qs, topk=5, **kw), f"{budget} {kw}")
    stats = st.residency_stats()
    assert stats["hot_grains"] == stats["n_grains"]


# ------------------------------------------------------------- refusals


def test_adaptive_routing_stays_refused_on_the_paged_plane(tmp_path):
    """Adaptive routing is ported to the paged plane: what it refuses now
    is what the all-warm plane refuses (the per-segment loop and
    per-segment routing), and a paged adaptive search feeds the same
    probe traffic as the all-warm one, which ``grain_health`` reports."""
    oracle, tiered, qs = _pair(BUDGETS["mid"], tmp_path)
    with pytest.raises(ValueError, match="fused search plane"):
        tiered.search(qs, topk=5, adaptive=True, fused=False)
    with pytest.raises(ValueError, match="global"):
        tiered.search(qs, topk=5, adaptive=True, route_mode="per_segment")
    for st in (oracle, tiered):
        st.search(qs, topk=5, adaptive=True, probe_margin=0.5)
    health = [tiered.grain_health(), oracle.grain_health()]
    for name in ("route_wins", "touches"):
        got, want = ([h[name] for h in hs] for hs in health)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert sum(int(h["route_wins"].sum()) for h in health[0]) == Q
    assert tiered.residency_stats()["paged_queries"] == Q


@pytest.mark.parametrize("mode", ["A", "B"])
@pytest.mark.parametrize("budget", ["zero", "mid"])
def test_paged_parity_adaptive(budget, mode, tmp_path):
    """Adaptive routing pages the probe sets the all-warm plane scans:
    three searches in a row (the hub set forms), each equal to the
    all-warm one (``torch.equal``), and the probe stats in lockstep."""
    oracle, tiered, qs = _pair(BUDGETS[budget], tmp_path)
    for margin in (0.5, 0.2, 0.2):     # 0.2: ragged plans at this shape
        _assert_same(
            oracle.search(qs, topk=5, mode=mode, adaptive=True,
                          probe_margin=margin, min_probes=1),
            tiered.search(qs, topk=5, mode=mode, adaptive=True,
                          probe_margin=margin, min_probes=1))
    assert oracle.probe_stats() == tiered.probe_stats()
    assert np.array_equal(oracle.hub_grains(), tiered.hub_grains())
    assert 1.0 <= tiered.probe_stats()["mean_active"] < 4.0


def test_tenants_and_budgets_stay_refused_on_the_paged_plane(tmp_path):
    """Tenancy on the paged plane: the fused dispatch with a per-query
    tenant bitmap (three tenants, every query's row reaching the last
    one too) pages through the tiered plane and returns the all-warm
    plane's ids and dists (``torch.equal``), static and adaptive, Mode A
    and B, with a filter, under budgets 0 and mid.  (The cascade's
    budgets are ported on the paged store too:
    ``test_paged_cascade_budgets_act_per_pass``.)"""
    r = np.random.default_rng(8)
    for budget in (BUDGETS["zero"], BUDGETS["mid"]):
        oracle, tiered, qs = _pair(budget, tmp_path)
        man = oracle.snapshot()
        shape = oracle._stacked_for(man.segments)["ids_host"].shape
        tman = tiered.snapshot()
        assert tiered._tiered_for(tman.segments)["ids_host"].shape == shape
        tl = r.random((3, *shape)) < 0.5
        ti = np.array([0, 1, 2, 2, 1, 0], np.int32)
        for mode in ("A", "B"):
            for kw in ({}, {"tag_mask": 1}, {"adaptive": True,
                                             "probe_margin": 0.3}):
                args = {**dict(topk=5, mode=mode, tag_mask=None,
                               ts_range=None, scan_impl=None, budgets=None,
                               nprobe=None, pool=None, route_mode="global",
                               now=0.0, tenant_live=tl, tenant_ix=ti), **kw}
                want = oracle._search_segments_fused(
                    torch.from_numpy(qs), man, **args)
                got = tiered._search_segments_fused(
                    torch.from_numpy(qs), tman, **args)
                assert torch.equal(want[0], got[0]), (budget, mode, kw)
                assert torch.equal(want[1], got[1]), (budget, mode, kw)
        assert tiered.residency_stats()["searches"] == 6


@pytest.mark.parametrize("mode", ["A", "B"])
def test_paged_cascade_budgets_act_per_pass(mode, tmp_path):
    """budgets= on the paged store: each pass runs the cascade over its
    own probes (a pass's pool is its top min(pool, b2) after stage 2), and
    the merged pool is cut to min(pool, b2), as in the JAX package."""
    oracle, tiered, qs = _pair(BUDGETS["mid"], tmp_path)
    got = tiered.search(qs, topk=5, mode=mode, scan_impl="cascade",
                        budgets=(64, 16))
    ref = tiered.search(qs, topk=5, mode=mode, scan_impl="cascade_ref",
                        budgets=(64, 16))
    _assert_same(ref, got, "cascade vs cascade_ref")
    assert (got.ids >= 0).all()
    # budgets covering every probed slot prune nothing
    wide = tiered.search(qs, topk=5, mode=mode, scan_impl="cascade",
                         budgets=(10 ** 6, 32))
    _assert_same(oracle.search(qs, topk=5, mode=mode), wide, "exhaustive")
    with pytest.raises(ValueError, match="not staged"):
        tiered.search(qs, topk=5, scan_impl="fused_ref", budgets=(64, 16))


# --------------------------------------------------- residency lifecycle


def _soa_files(st):
    return sorted(glob.glob(os.path.join(st.cold_dir, "panels_*.soa")))


def test_eviction_under_churn(tmp_path):
    """Skewed traffic re-elects the hot set towards the probed grains while
    every search stays equal to the all-warm plane; once the plane cache
    drops a segment set's tiered plane, its panel file is unlinked."""
    oracle, tiered, qs = _pair(BUDGETS["mid"], tmp_path)
    hot_q = np.repeat(qs[:1], Q, axis=0)     # hammer one region
    for i in range(8):                        # residency_interval=4
        _assert_same(oracle.search(hot_q, topk=5),
                     tiered.search(hot_q, topk=5), f"round {i}")
    stats = tiered.residency_stats()
    assert stats["searches"] == 8 and stats["hot_epochs"] >= 2
    # the hammered query's probe set is hot now: nothing pages
    pre = stats["chunk_dispatches"]
    _assert_same(oracle.search(hot_q, topk=5), tiered.search(hot_q, topk=5))
    assert tiered.residency_stats()["chunk_dispatches"] == pre
    files0 = _soa_files(tiered)
    assert len(files0) == 1
    for st in (oracle, tiered):
        st.compact()
    _assert_same(oracle.search(qs, topk=5), tiered.search(qs, topk=5),
                 "post-churn compact")
    extra = np.random.default_rng(4).standard_normal((SEG, D)) \
        .astype(np.float32)
    tiered.add(extra)                         # a third segment set
    tiered.search(qs, topk=5)                 # evicts the first plane
    gc.collect()
    files1 = _soa_files(tiered)
    assert len(files1) == 2 and files0[0] not in files1
    assert all(os.path.exists(f + ".json") for f in files1)


def test_update_residency_reelects(tmp_path):
    tiered, qs = _build(BUDGETS["mid"], tmp_path)
    tiered.search(qs, topk=5)                 # build the plane, seed by size
    st0 = tiered.residency_stats()
    assert 0 < st0["hot_grains"] < st0["n_grains"]
    assert st0["hot_bytes"] == st0["hot_grains"] * \
        st0["panel_bytes_per_grain"]
    hot_q = np.repeat(qs[:1], Q, axis=0)
    for _ in range(3):
        tiered.search(hot_q, topk=5)
    assert isinstance(tiered.update_residency(), bool)
    # idempotent: a second election with no new traffic changes nothing
    assert tiered.update_residency() is False
    # no tiered plane yet: a no-op
    assert VectorStore(_cfg(), device="cpu", device_budget=1) \
        .update_residency() is False


def test_seed_hot_is_biggest_grains(tmp_path):
    tiered, qs = _build(BUDGETS["mid"], tmp_path)
    tiered.search(qs, topk=5)
    (_, entry), = tiered._tiered_entries()
    tp = entry["tiered"]
    h = tp.n_hot
    assert h == BUDGETS["mid"] // tp.panel_bytes_per_grain()
    order = np.lexsort((np.arange(tp.n_grains),
                        -tp.sizes.astype(np.int64)))
    assert tp.hot_slots.tolist() == sorted(order[:h].tolist())


def test_knob_validation(tmp_path):
    with pytest.raises(ValueError):
        VectorStore(_cfg(), device="cpu", device_budget=-1)
    with pytest.raises(ValueError):
        VectorStore(_cfg(), device="cpu", device_budget=100,
                    residency_interval=0)
    with pytest.raises(ValueError):
        VectorStore(_cfg(), device="cpu", device_budget=100,
                    prefetch_grains=0)
    assert VectorStore(_cfg(), device="cpu",
                       prefetch_grains=3).prefetch_grains == 4
    st, qs = _build(BUDGETS["mid"], tmp_path)
    with pytest.raises(ValueError, match="fused"):
        st.search(qs, topk=5, fused=False)
    with pytest.raises(ValueError, match="route_mode"):
        st.search(qs, topk=5, route_mode="per_segment")
    with pytest.raises(ValueError, match="single-device"):
        st.search(qs, topk=5, mesh=object())


def test_branch_propagates_budget(tmp_path):
    parent, qs = _build(BUDGETS["mid"], tmp_path, cold=True)
    child = parent.branch()
    for knob in ("device_budget", "residency_interval", "prefetch_grains",
                 "cold_tier", "cold_dir"):
        assert getattr(child, knob) == getattr(parent, knob), knob
    assert child._cold_tag != parent._cold_tag
    oracle, _ = _build(None, tmp_path)
    _assert_same(oracle.search(qs, topk=5), child.search(qs, topk=5))


# ------------------------------------------------- planner pieces it uses


def test_static_route_and_probe_plan_equal_the_one_call_plane(tmp_path):
    """``static_route`` gives the probe sets ``search_stacked`` routes to,
    and ``search_stacked(probe_plan=...)`` scans them to the same result;
    ``project_probes`` gives the projection the candidate stage makes."""
    st, _ = _build(None, tmp_path)
    q = torch.from_numpy((np.random.default_rng(2).standard_normal(
        (300, D)) * 3.0).astype(np.float32))
    stacked = stack_segments(st._segments)
    extra, ok = planner._mixed_recall_mask(stacked.index.grains, 1, None)
    kw = dict(nprobe=5, pool=32, topk=5, tag_mask=1)
    gids, _ = planner.static_route(stacked.index.routing, q, nprobe=5,
                                   grain_mask=ok)
    na = torch.full((q.shape[0],), 5, dtype=torch.int32)
    for mode in ("A", "B"):
        want = planner.search_stacked(stacked, q, mode=mode, **kw)
        for plan in ((gids, None), (gids, na)):
            got = planner.search_stacked(stacked, q, mode=mode,
                                         probe_plan=plan, **kw)
            _assert_same(want, got, mode)
    proj = planner.project_probes(stacked.index, q, gids, 0.25, 8191)
    for lo in (0, 256):
        sl = slice(lo, lo + 256)
        own = planner._project_quantized(stacked.index, q[sl], gids[sl],
                                         0.25, 8191)
        for a, b in zip(proj, own):
            assert torch.equal(a[sl], b)
    with pytest.raises(ValueError, match="global routing"):
        planner.search_stacked(stacked, q, route_mode="per_segment",
                               seg_shape=(4, 8), probe_plan=(gids, None),
                               **kw)


def test_fewer_probes_kill_the_rest(tmp_path):
    """probe_plan's n_active: probes p >= n_active[q] scan nothing, the
    same as a plan of only the first n_active probes."""
    st, qs = _build(None, tmp_path)
    stacked = stack_segments(st._segments)
    q = torch.from_numpy(qs)
    gids, _ = planner.static_route(stacked.index.routing, q, nprobe=6)
    na = torch.tensor([1, 2, 3, 4, 5, 6], dtype=torch.int32)
    got = planner.search_stacked(stacked, q, nprobe=6, pool=32, topk=5,
                                 mode="A", probe_plan=(gids, na),
                                 scan_impl="fused_ref")
    for i in range(Q):
        one = planner.search_stacked(
            stacked, q[i:i + 1], nprobe=int(na[i]), pool=32, topk=5,
            mode="A", probe_plan=(gids[i:i + 1, :int(na[i])], None),
            scan_impl="fused_ref")
        assert torch.equal(got.ids[i], one.ids[0])


def test_select_on_a_mini_plane_kills_the_slack(tmp_path):
    """A pass's mini-plane (dummy grain last, slack probes on it behind
    n_active) gives what the same probes give with the slack cut off."""
    a = select_cases.mini_plane_inputs(3, q=16, p=4, g=9, k=8, cap=64, s=2)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    args, kw = select_cases.split(a, torch.from_numpy)
    d, r = fused_select.fused_scan_select(*args, width=40, **kw)
    for i in range(16):
        na = int(t["n_active"][i])
        one = {k: (v[i:i + 1, :na] if k in ("gids", "zq", "rq", "keep",
                                            "sq") else v)
               for k, v in t.items() if k != "n_active"}
        oargs, okw = select_cases.split(
            {k: v.numpy() for k, v in one.items()}, torch.from_numpy)
        od, orr = fused_select.fused_scan_select(*oargs, width=40, **okw)
        assert torch.equal(d[i], od[0]) and torch.equal(r[i], orr[0])


def test_panel_file_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    panels = {"coords": rng.integers(-9, 9, (5, 4, 32)).astype(np.int16),
              "res": rng.integers(0, 99, (5, 32)).astype(np.int32),
              "valid": rng.random((5, 32)) < 0.5,
              "tags": rng.integers(0, 2 ** 32, (5, 32)).astype(np.uint32)}
    path = str(tmp_path / "p.soa")
    meta = layout.write_panel_file(path, panels)
    back = layout.open_panel_file(path, meta)
    assert set(back) == set(panels)
    for k, v in panels.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v)
        assert not back[k].flags.writeable
    assert os.path.exists(path + ".json")


def test_staged_fields_are_aligned(tmp_path):
    """Every staged field starts on a 128-byte boundary (the select
    kernel's vector loads need 16), for every chunk size."""
    st, qs = _build(0, tmp_path)
    st.search(qs, topk=5)
    (_, entry), = st._tiered_entries()
    tp = entry["tiered"]
    for n in (2, 3, 5, 65):
        fields, nbytes = tp._layout(n)
        assert nbytes % residency.STAGE_ALIGN == 0
        assert all(off % residency.STAGE_ALIGN == 0
                   for off, _, _ in fields.values())
        assert list(fields)[-1] == "mask"


# ------------------------------------------------------- residency helpers


def test_compact_probes_helper():
    gids = np.array([[3, 1, 2, 0], [0, 3, 3, 1]], np.int32)
    na = np.array([4, 2], np.int32)
    member = np.array([-1, 0, 1, -1], np.int32)   # grains 1, 2 are members
    plan = residency.compact_probes(gids, na, member, dummy_slot=2)
    assert plan is not None
    plan_g, plan_na, w, act_q, pos = plan
    assert w == 2 and plan_g.shape == (2, 2)
    assert plan_g[0].tolist() == [0, 1] and pos[0].tolist() == [1, 2]
    assert plan_g[1].tolist() == [2, 2] and plan_na[1] == 1
    assert plan_na[0] == 2
    assert act_q.tolist() == [True, False]
    assert residency.compact_probes(
        gids, na, np.full(4, -1, np.int32), 0) is None


def test_chunk_cold_helper():
    out = residency.chunk_cold(np.arange(7), 4)
    assert [len(c) for c in out] == [4, 4]         # tail padded 3 -> 4
    assert out[1].tolist() == [4, 5, 6, 6]
    assert residency.chunk_cold(np.arange(4), 8)[0].tolist() == [0, 1, 2, 3]
    assert residency.pow2ceil(1) == 1 and residency.pow2ceil(5) == 8


def test_host_keep_mask_matches_filters():
    valid = np.array([[True, True], [True, False]])
    tags = np.array([[1, 2], [2, 2]], np.uint32)
    ts = np.array([[0.0, 5.0], [9.0, 1.0]], np.float32)
    pan = {"valid": valid, "tags": tags, "ts": ts}
    keep, gok = residency.host_keep_mask(pan, None, 0x1, None)
    assert keep.tolist() == [[True, False], [False, False]]
    assert gok.tolist() == [True, False]
    keep, gok = residency.host_keep_mask(pan, None, None, (4.0, 10.0))
    assert keep.tolist() == [[False, True], [True, False]]
    assert residency.host_keep_mask(pan, None, None, None) == (None, None)


def test_device_plan_maps_cold_probes_to_the_dummy():
    hot_map = torch.tensor([-1, 0, -1, 1], dtype=torch.int32)
    gids = torch.tensor([[0, 1, 3], [2, 3, 1]], dtype=torch.int32)
    got = residency.device_plan(hot_map, gids, dummy_slot=2)
    assert got.tolist() == [[2, 0, 1], [2, 1, 0]]


@pytest.mark.parametrize("seed", range(4))
def test_helpers_equal_the_reference(seed):
    """compact_probes, chunk_cold, host_keep_mask and host_tenant_mask on
    seeded inputs equal the JAX package's helpers."""
    pytest.importorskip("jax")
    from repro.core import residency as jax_residency

    rng = np.random.default_rng(seed)
    g, q, p, cap = 12, 9, 5, 16
    gids = np.stack([rng.permutation(g)[:p] for _ in range(q)]) \
        .astype(np.int32)
    na = rng.integers(1, p + 1, q).astype(np.int32)
    member = np.full(g, -1, np.int32)
    picked = rng.choice(g, 4, replace=False)
    member[picked] = np.arange(4)
    ours = residency.compact_probes(gids, na, member, 4)
    ref = jax_residency.compact_probes(gids, na, member, 4)
    assert (ours is None) == (ref is None)
    if ours is not None:
        for a, b in zip(ours[:4], ref):
            assert np.array_equal(a, b)
        plan_g, plan_na, w, act_q, pos = ours
        live = (np.arange(w)[None, :] < plan_na[:, None]) & act_q[:, None]
        assert np.array_equal(
            np.where(live, member[np.take_along_axis(gids, pos, 1)], 4),
            np.where(live, plan_g, 4))
    cold = np.sort(rng.choice(100, rng.integers(1, 40), replace=False))
    for chunk in (1, 4, 8, 64):
        a = residency.chunk_cold(cold, chunk)
        b = jax_residency.chunk_cold(cold, chunk)
        assert len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))
    pan = {"valid": rng.random((g, cap)) < 0.8,
           "tags": rng.integers(0, 16, (g, cap)).astype(np.uint32),
           "ts": rng.uniform(0, 1, (g, cap)).astype(np.float32)}
    live = rng.random((g, cap)) < 0.9
    for args in ((None, 0b0101, None), (live, None, (0.2, 0.6)),
                 (live, 0b0011, (0.1, 0.9)), (None, None, None)):
        a = residency.host_keep_mask(pan, *args)
        b = jax_residency.host_keep_mask(pan, *args)
        for x, y in zip(a, b):
            assert (x is None and y is None) or np.array_equal(x, y)
    keep, gok = residency.host_keep_mask(pan, live, 0b0101, None)
    t_live = rng.random((3, g, cap)) < 0.5
    t_ix = rng.integers(0, 3, q)
    assert np.array_equal(
        residency.host_tenant_mask(pan, keep, gok, t_live, t_ix),
        jax_residency.host_tenant_mask(pan, keep, gok, t_live, t_ix))
    assert np.array_equal(
        residency.host_tenant_mask(pan, keep, gok, None, None), gok)


def test_panel_file_equals_the_reference(tmp_path):
    """The port's panel file holds the JAX package's bytes and sidecar for
    the same panels."""
    pytest.importorskip("jax")
    from repro.core import layout as jax_layout

    rng = np.random.default_rng(1)
    panels = {"coords": rng.integers(-9, 9, (3, 4, 16)).astype(np.int16),
              "ids": rng.integers(-1, 99, (3, 16)).astype(np.int32),
              "ts": rng.random((3, 16)).astype(np.float32)}
    a, b = str(tmp_path / "a.soa"), str(tmp_path / "b.soa")
    assert layout.write_panel_file(a, panels) == \
        jax_layout.write_panel_file(b, panels)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(a + ".json").read() == open(b + ".json").read()


def test_budget_unit_equals_the_jax_stores(tmp_path):
    """The panel file's bytes per grain (the budget unit) and the elected
    hot-set size equal the JAX store's at the same geometry."""
    pytest.importorskip("jax")
    from repro.core import HNTLConfig as JaxConfig
    from repro.core.store import VectorStore as JaxStore

    vecs, tags, ts, qs = _data()
    jst = JaxStore(JaxConfig(d=D, k=4, s=2, block=16, n_grains=8, nprobe=4,
                             pool=32), seal_threshold=SEG,
                   device_budget=BUDGETS["mid"], cold_dir=str(tmp_path))
    for i in range(0, N, SEG):
        jst.add(vecs[i:i + SEG], tags=tags[i:i + SEG], ts=ts[i:i + SEG])
    jst.search(qs, topk=5)
    st, _ = _build(BUDGETS["mid"], tmp_path)
    st.search(qs, topk=5)
    ours, ref = st.residency_stats(), jst.residency_stats()
    for k in ("n_grains", "panel_bytes_per_grain", "hot_grains"):
        assert ours[k] == ref[k], k
