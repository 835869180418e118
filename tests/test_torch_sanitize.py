"""The port's runtime hygiene gate (``repro_torch.analysis.sanitize``):
twins of the JAX package's ``tests/test_sanitize.py``, on the port's own
stores, with no JAX.

1. **Zero re-stacks.**  The port compiles nothing, so the JAX suite's
   zero-recompile contract is the zero-re-stack one here: mutation
   epochs, TTL clocks, ``maintain()`` identity passes and the plane keys
   (``scan_impl``, ``budgets``) swap the liveness leaf or pick a runner,
   never re-stack the plane.  The searches run under ``install()``.
2. **Zero implicit syncs.**  Every search plane runs inside
   ``sync_guard()``: no scalar read, truth test, data-dependent shape or
   boolean-mask index of a tensor.  Host arrays reach the device through
   ``place``, and the only reads are ``fetch`` (the adaptive plan, the
   paged plan, the cold re-rank's candidate rows), which each guard
   counts.  Each guarded result is ``torch.equal`` to the same search run
   unguarded.

On the CPU the kernels' plain versions stand in for the kernels inside
the wrappers; they are never on the card's path, so the tests run them
with the guard suspended, at the seam the launch counters use (the
wrappers' plain-version names): what the guard checks here is the glue
around the kernels.  The ``gpu`` tests run the canary under the card's
sync-debug mode, where a blocking copy or a stream sync raises too, and
guarded searches of each plane on the card.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.analysis import sanitize
from repro_torch.core import HNTLConfig, VectorStore
from repro_torch.core import store as store_mod
from repro_torch.kernels import fused_select, hntl_scan
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import (RetrievalRequest, TenantRegistry,
                               coalesced_retrieve)
from test_torch_device import cuda_device  # noqa: F401  (the card fixture)

D, N_SEG, SEG_ROWS, Q = 16, 3, 128, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one thread each, so a worker among several
    on a busy host does not spin a pool of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def plain_versions_unguarded(monkeypatch):
    """The wrappers' plain versions (CPU only) run with the guard
    suspended."""
    for mod, name in ((fused_select, "fused_scan_select_ref"),
                      (hntl_scan, "hntl_scan_single_ref"),
                      (hntl_scan, "hntl_scan_ref")):
        monkeypatch.setattr(mod, name,
                            sanitize.unguarded(getattr(mod, name)))


@pytest.fixture
def installed():
    sanitize.install()
    try:
        yield
    finally:
        sanitize.uninstall()


@pytest.fixture
def stacks(monkeypatch):
    """Counts ``stack_segments`` calls (plane builds)."""
    count = {"n": 0}
    real = store_mod.stack_segments

    def counting(*args, **kwargs):
        count["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(store_mod, "stack_segments", counting)
    return count


def _cfg():
    return HNTLConfig(d=D, k=4, s=2, n_grains=8, nprobe=4, pool=64,
                      block=16)


def _build(device="cpu", *, cold=False, ttl=None, tmp_path=None,
           **store_kw):
    rng = np.random.default_rng(7)
    st = VectorStore(_cfg(), seal_threshold=SEG_ROWS, cold_tier=cold,
                     clock=lambda: 1000.0, device=device,
                     cold_dir=None if tmp_path is None else str(tmp_path),
                     **store_kw)
    x = rng.standard_normal((N_SEG * SEG_ROWS, D)).astype(np.float32)
    for i in range(N_SEG):
        st.add(x[i * SEG_ROWS:(i + 1) * SEG_ROWS],
               tags=[1 << (i % 3)] * SEG_ROWS, ts=[float(i)] * SEG_ROWS,
               ttl=ttl if i == 0 else None)
    assert st.n_segments == N_SEG and not st._mem
    q = (x[:Q] + 0.01 * rng.standard_normal((Q, D))).astype(np.float32)
    return st, x, q


def _same(a, b):
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.dists, b.dists)


def _guarded(st, q, **kw):
    """(unguarded result, guarded result, the guard's fetches); adaptive
    searches start both runs from the same probe-traffic counters."""
    traffic = copy.deepcopy(st._probe_traffic)
    want = st.search(q, **kw)
    st._probe_traffic = traffic
    with sanitize.sync_guard() as g:
        got = st.search(q, **kw)
    return want, got, g.fetches


# ------------------------------------------------------------------------
# 1. zero re-stacks
# ------------------------------------------------------------------------


def test_zero_restacks_across_mutation_and_maintenance(installed, stacks):
    """One stack per segment set: deletes, upserts, TTL clocks and
    ``maintain()`` identity passes swap the liveness leaf (placed with
    ``place``) under the guard, never re-stack."""
    st, x, q = _build(ttl=50.0)
    st.search(q, topk=5, mode="B")
    st.search(q, topk=5, mode="B")
    st.delete(np.arange(0, 10))
    st.search(q, topk=5, mode="B")
    assert stacks["n"] == 1
    for epoch in range(3):
        st.delete(np.arange(20 + 10 * epoch, 25 + 10 * epoch))
        st.search(q, topk=5, mode="B")
        st.upsert(np.arange(5) + 40, x[40:45] + 0.5)
        st.search(q, topk=5, mode="B")
    st.seal()                    # the upserts' memtable: a 4th segment
    assert st.n_segments == N_SEG + 1
    st.search(q, topk=5, mode="B")
    assert stacks["n"] == 2
    for now in (1000.0, 1020.0, 1100.0):       # segment 0 expires at 1050
        st.search(q, topk=5, mode="B", now=now)
    epochs = st.maintenance_epochs
    st.maintain(now=1000.0)
    st.search(q, topk=5, mode="B")
    assert st.maintenance_epochs == epochs     # a healthy store: identity
    assert stacks["n"] == 2, \
        "a TTL clock or a healthy maintenance pass re-stacked the plane"


def test_plane_keys_stack_once_then_hold(installed, stacks):
    """``scan_impl`` and ``budgets`` pick the runner over one stacked
    plane: the first search stacks it, no combination re-stacks."""
    st, _, q = _build()
    combos = [dict(scan_impl="fused_ref"), dict(scan_impl="fused"),
              dict(scan_impl="cascade_ref", budgets=(64, 32)),
              dict(scan_impl="cascade", budgets=(64, 32)),
              dict(scan_impl="kernel")]
    for _ in range(2):
        for kw in combos:
            st.search(q, topk=5, mode="A", **kw)
        assert stacks["n"] == 1


# ------------------------------------------------------------------------
# 2. the guard: every plane, nothing implicit
# ------------------------------------------------------------------------

PLANES = {
    "fused_ref": (dict(scan_impl="fused_ref"), 0),
    "fused": (dict(scan_impl="fused"), 0),
    "cascade_ref": (dict(scan_impl="cascade_ref", budgets=(64, 32)), 0),
    "cascade": (dict(scan_impl="cascade", budgets=(64, 32)), 0),
    "kernel": (dict(scan_impl="kernel"), 0),
    "ref": (dict(scan_impl="ref"), 0),
    # one read of the probe plan
    "adaptive": (dict(scan_impl="fused", adaptive=True, probe_margin=0.2),
                 1),
    "adaptive_cascade": (dict(scan_impl="cascade", budgets=(64, 32),
                              adaptive=True, probe_margin=0.2), 1),
}


@pytest.mark.parametrize("mode", ["A", "B"])
@pytest.mark.parametrize("plane", sorted(PLANES))
def test_search_planes_zero_implicit_syncs(plane, mode):
    kw, fetches = PLANES[plane]
    st, _, q = _build()
    want, got, n = _guarded(st, q, topk=5, mode=mode, **kw)
    _same(want, got)
    assert n == fetches


def test_filter_scalars_are_explicitly_placed():
    """tag_mask and ts_range join the scan as Python numbers and the
    liveness bitmap through ``place``: nothing read back."""
    st, _, q = _build()
    st.delete(np.arange(7))
    want, got, n = _guarded(st, q, topk=5, mode="A", tag_mask=0b011,
                            ts_range=(0.0, 2.0), scan_impl="fused")
    _same(want, got)
    assert n == 0


def _window(q):
    return [RetrievalRequest(rid=i, tenant="ab"[i % 2], q=q[i % len(q)],
                             topk=5, mode="A") for i in range(4)]


def test_tenant_coalesced_dispatch_zero_implicit_syncs(monkeypatch):
    """The coalesced serving plane's tenant stack and ``tenant_ix`` reach
    the device through ``place``.  The guard wraps what ``install()``
    wraps: the fused dispatch, not the host-side merge around it."""
    st, _, q = _build()
    reg = TenantRegistry(st, memtable_budget=256, max_live=4)
    reg.get("a").delete(np.arange(4))
    reg.get("b")
    want = coalesced_retrieve(reg, _window(q), scan_impl="fused")
    orig = VectorStore._search_segments_fused
    counts = []

    def guarded(self, *a, **kw):
        with sanitize.sync_guard() as g:
            out = orig(self, *a, **kw)
        counts.append(g.fetches)
        return out

    monkeypatch.setattr(VectorStore, "_search_segments_fused", guarded)
    got = coalesced_retrieve(reg, _window(q), scan_impl="fused")
    assert counts == [0]
    for w, g in zip(want, got):
        assert g.done
        _same(w.result, g.result)


@pytest.mark.parametrize("kw,fetches", [
    (dict(scan_impl="fused_ref"), 1),
    (dict(scan_impl="fused"), 1),
    (dict(scan_impl="cascade", budgets=(64, 32)), 1),
    # the plan, then one re-rank per width bucket
    (dict(scan_impl="fused", adaptive=True, probe_margin=0.2), None),
], ids=["fused_ref", "fused", "cascade", "adaptive"])
def test_cold_rerank_is_the_sanctioned_read(kw, fetches, tmp_path):
    """Mode B on a cold store reads its candidate rows' ids back with one
    ``fetch`` per re-rank batch, gathers the rows from the cold files on
    the host and places them: the one sanctioned transfer point stays
    guard-clean, and returns the warm store's bits."""
    st, _, q = _build(cold=True, tmp_path=tmp_path)
    warm, _, _ = _build()
    calls0 = st._rerank_stats["calls"]
    want, got, n = _guarded(st, q, topk=5, mode="B", **kw)
    _same(want, got)
    _same(warm.search(q, topk=5, mode="B", **kw), got)
    per_search = (st._rerank_stats["calls"] - calls0) // 2
    assert per_search >= 1
    assert n == (fetches if fetches is not None else 1 + per_search)


@pytest.mark.parametrize("kw", [
    dict(mode="A"), dict(mode="B"),
    dict(mode="B", scan_impl="cascade", budgets=(64, 32)),
    dict(mode="B", adaptive=True, probe_margin=0.2),
    dict(mode="A", tag_mask=0b001),
], ids=["A", "B", "cascade", "adaptive", "filtered"])
@pytest.mark.parametrize("budget", [0, 8192])
def test_tiered_search_zero_implicit_syncs(budget, kw, tmp_path):
    """The paged plane: the hot pass is queued before the host reads the
    plan back through ``fetch_async`` (one fetch), cold chunks are staged
    and their plans placed; the hot set's re-election (every 2 searches
    here) places the new hot map, all inside the guard."""
    st, _, q = _build(tmp_path=tmp_path, device_budget=budget,
                      residency_interval=2, prefetch_grains=2)
    for _ in range(3):
        want, got, n = _guarded(st, q, topk=5, **kw)
        _same(want, got)
        assert n == 1
    assert st.residency_stats()["searches"] == 6


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_sharded_search_zero_implicit_syncs(cold, tmp_path):
    """The grain-sharded plane on ``make_host_mesh(1, 4)`` (CPU slots):
    nothing read back warm; a cold store's re-rank is one fetch."""
    st, _, q = _build(cold=cold, tmp_path=tmp_path)
    mesh = make_host_mesh(1, 4, devices=["cpu"] * 4)
    for mode in "AB":
        want, got, n = _guarded(st, q, topk=5, mode=mode, mesh=mesh,
                                scan_impl="fused")
        _same(want, got)
        assert n == (1 if cold and mode == "B" else 0)


def test_paged_tenant_window_zero_implicit_syncs(installed, tmp_path):
    """A coalesced window on the paged plane, every dispatch guarded by
    ``install()``, equals the all-warm window."""
    st, _, q = _build(tmp_path=tmp_path, device_budget=0,
                      prefetch_grains=2)
    warm, _, _ = _build()
    results = []
    for store in (warm, st):
        reg = TenantRegistry(store, memtable_budget=256, max_live=4)
        reg.get("a").delete(np.arange(4))
        reg.get("b")
        results.append(coalesced_retrieve(reg, _window(q),
                                          scan_impl="fused"))
    for w, g in zip(*results):
        _same(w.result, g.result)


BUILDS = {
    "stacked": (dict(), dict(mode="B")),
    "cold": (dict(cold=True), dict(mode="B")),
    "tiered": (dict(device_budget=0, prefetch_grains=2), dict(mode="B")),
    "sharded": (dict(), dict(mode="B", sharded=True)),
}


def _first_search_builds_inside_the_guard(device, build, tmp_path):
    """A store's first search builds its plane (the stack, the host row
    tables, the tiered panel file, the shard layout) inside the guard:
    the builds' host reads are fetches too.  Equal to a second store's
    first search, unguarded."""
    store_kw, kw = BUILDS[build]
    kw = dict(kw)
    if kw.pop("sharded", False):
        kw["mesh"] = make_host_mesh(1, 4, devices=[device] * 4)
    results = []
    for guarded in (False, True):
        (tmp_path / str(guarded)).mkdir()
        st, _, q = _build(device, tmp_path=tmp_path / str(guarded),
                          **store_kw)
        with (sanitize.sync_guard() if guarded
              else sanitize.suspended()) as g:
            results.append(st.search(q, topk=5, **kw))
    _same(*results)
    assert g.fetches >= 1              # the plane's host tables


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_first_search_builds_inside_the_guard(build, tmp_path):
    _first_search_builds_inside_the_guard("cpu", build, tmp_path)


# ------------------------------------------------------------------------
# the canary and install()
# ------------------------------------------------------------------------

SYNCS = {
    "item": lambda t: t.sum().item(),
    "bool": lambda t: bool(t.sum() > 0),
    "int": lambda t: int(t[0]),
    "nonzero": lambda t: torch.nonzero(t),
    "where_cond": lambda t: torch.where(t > 1),
    "mask_index": lambda t: t[t > 1],
    "mask_assign": lambda t: t.clone().__setitem__(t > 1, t[:1].clone()
                                                   .expand(3)),
    "masked_select": lambda t: t.masked_select(t > 1),
    "unique": lambda t: torch.unique(t),
    "equal": lambda t: torch.equal(t, t),
    "repeat_interleave": lambda t: torch.repeat_interleave(
        t, torch.ones(5, dtype=torch.long)),
    "bincount": lambda t: torch.bincount(t.long()),
}


@pytest.mark.parametrize("what", sorted(SYNCS))
def test_guard_canary_raises_on_implicit_syncs(what):
    t = torch.arange(5.0)
    with pytest.raises(sanitize.SyncError):
        with sanitize.sync_guard():
            SYNCS[what](t)


def test_guard_canary_allows_the_sanctioned_transfers():
    t = torch.arange(5.0)
    with sanitize.sync_guard() as g:
        host = sanitize.fetch(t * 2)
        a, b = sanitize.fetch(t, None)
        pending = sanitize.fetch_async(t + 1, t)
        placed = sanitize.place(np.arange(3, dtype=np.int32), "cpu")
        filled = t.clone()
        filled[filled > 1] = 0.0             # a masked fill: no sync
        r = torch.repeat_interleave(t, torch.ones(5, dtype=torch.long),
                                    output_size=5)
        with sanitize.suspended():
            n = int(t.sum())
        later, same = pending.wait()
    assert g.fetches == 3
    assert torch.equal(host, t * 2) and torch.equal(a, t) and b is None
    assert torch.equal(later, t + 1) and torch.equal(same, t)
    assert placed.tolist() == [0, 1, 2] and n == 10
    assert filled.tolist() == [0.0, 1.0, 0.0, 0.0, 0.0]
    assert torch.equal(r, t)


def test_guards_nest_and_count_in_each():
    t = torch.arange(3)
    with sanitize.sync_guard() as outer:
        sanitize.fetch(t)
        with sanitize.sync_guard() as inner:
            sanitize.fetch(t)
        with pytest.raises(sanitize.SyncError):
            t.sum().item()
    assert (outer.fetches, inner.fetches) == (2, 1)
    assert t.sum().item() == 3               # outside: no guard


def test_nan_debug_names_the_op_that_made_a_nan():
    x = torch.tensor([1.0, 0.0])
    with sanitize.sync_guard(nan_debug=True):
        y = x * 2                            # finite: fine
    with pytest.raises(FloatingPointError, match="div"):
        with sanitize.sync_guard(nan_debug=True):
            y = x / x
    assert torch.isnan(y).any()


def test_install_marks_the_three_methods():
    names = sanitize.GUARDED_METHODS
    assert names == ("_search_segments_fused", "_search_segments_sharded",
                     "_search_segments_tiered")
    originals = [getattr(VectorStore, n) for n in names]
    assert not any(hasattr(f, "_hntl_sanitized") for f in originals)
    sanitize.install()
    try:
        sanitize.install()                   # idempotent
        for n, orig in zip(names, originals):
            fn = getattr(VectorStore, n)
            assert getattr(fn, "_hntl_sanitized", False)
            assert fn._hntl_original is orig
        st, _, q = _build()
        with pytest.raises(sanitize.SyncError):
            with torch.no_grad():
                _planted_sync_search(st, q)
    finally:
        sanitize.uninstall()
    assert [getattr(VectorStore, n) for n in names] == originals


def _planted_sync_search(st, q):
    """A search whose plane reads a scalar back: the installed guard must
    raise inside the store's method."""
    from repro_torch.core import planner
    real = planner.search_stacked

    def syncing(*args, **kwargs):
        res = real(*args, **kwargs)
        res.dists.max().item()
        return res

    planner.search_stacked = syncing
    try:
        st.search(q, topk=5, mode="A", scan_impl="fused_ref")
    finally:
        planner.search_stacked = real


# ------------------------------------------------------------------------
# on the card: the sync-debug mode, and one guarded search per plane
# ------------------------------------------------------------------------


@pytest.mark.gpu
def test_guard_canary_on_card(cuda_device):
    dev = cuda_device
    t = torch.arange(5.0, device=dev)
    mode = torch.cuda.get_sync_debug_mode()
    for what in ("cpu", "pageable_h2d", "stream_sync"):
        with pytest.raises(RuntimeError):
            with sanitize.sync_guard():
                if what == "cpu":
                    t.cpu()
                elif what == "pageable_h2d":
                    torch.from_numpy(np.zeros(3, np.float32)).to(dev)
                else:
                    torch.cuda.current_stream(dev).synchronize()
        assert torch.cuda.get_sync_debug_mode() == mode   # restored
    with sanitize.sync_guard() as g:
        host = sanitize.fetch(t)
        pending = sanitize.fetch_async(t * 2)
        placed = sanitize.place(np.arange(3, dtype=np.int32), dev)
        later = pending.wait()
    assert g.fetches == 2 and placed.device.type == "cuda"
    assert host.tolist() == [0, 1, 2, 3, 4] and later.tolist()[4] == 8
    assert torch.cuda.get_sync_debug_mode() == mode


@pytest.mark.gpu
def test_place_leaves_a_pinned_source_free_at_once(cuda_device):
    want = torch.arange(1 << 20, dtype=torch.float32)
    src = want.clone().pin_memory()
    with sanitize.sync_guard():          # the guard's first use is slow
        torch.ones(1, device=cuda_device).add_(1)
    torch.cuda._sleep(200_000_000)       # the copy queues behind ~0.1 s
    with sanitize.sync_guard():
        placed = sanitize.place(src, cuda_device)
    src.fill_(-1.0)                      # the caller reuses its buffer
    assert torch.equal(placed.cpu(), want)


CARD_PLANES = {
    "fused": (dict(scan_impl="fused", mode="B"), {}, 0),
    "cascade": (dict(scan_impl="cascade", budgets=(64, 32), mode="B"), {},
                0),
    "kernel": (dict(scan_impl="kernel", mode="B"), {}, 0),
    "adaptive": (dict(scan_impl="fused", adaptive=True, probe_margin=0.2,
                      mode="B"), {}, 1),
    "cold": (dict(scan_impl="fused", mode="B"), dict(cold=True), 1),
    "paged": (dict(scan_impl="fused", mode="B"), dict(device_budget=8192,
                                                      prefetch_grains=2), 1),
    "paged_adaptive": (dict(scan_impl="fused", mode="B", adaptive=True,
                            probe_margin=0.2),
                       dict(device_budget=0, prefetch_grains=2), 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("plane", sorted(CARD_PLANES))
def test_guarded_search_on_card(cuda_device, plane, tmp_path):
    kw, store_kw, fetches = CARD_PLANES[plane]
    st, _, q = _build(cuda_device, tmp_path=tmp_path, **store_kw)
    for _ in range(2):
        want, got, n = _guarded(st, q, topk=5, **kw)
        _same(want, got)
        assert n == fetches


@pytest.mark.gpu
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_first_search_builds_inside_the_guard_on_card(cuda_device, build,
                                                      tmp_path):
    _first_search_builds_inside_the_guard(cuda_device, build, tmp_path)


@pytest.mark.gpu
def test_guarded_sharded_and_tenant_search_on_card(cuda_device, tmp_path):
    dev = cuda_device
    st, _, q = _build(dev, tmp_path=tmp_path)
    mesh = make_host_mesh(1, 4, devices=[dev] * 4)
    want, got, n = _guarded(st, q, topk=5, mode="B", mesh=mesh)
    _same(want, got)
    assert n == 0
    reg = TenantRegistry(st, memtable_budget=256, max_live=4)
    reg.get("a").delete(np.arange(4))
    reg.get("b")
    want = coalesced_retrieve(reg, _window(q))
    sanitize.install()
    try:
        got = coalesced_retrieve(reg, _window(q))
    finally:
        sanitize.uninstall()
    for w, g in zip(want, got):
        _same(w.result, g.result)
