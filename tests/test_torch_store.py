"""The vector store's read and mutation path, against the JAX store and
against brute force.

- **Against the JAX store.**  A JAX ``VectorStore`` with sealed segments of
  two sizes, a memtable tail, tags, timestamps, deletes, upserts and TTL'd
  rows is carried across with ``manifest_from_numpy``, so both packages
  search the same segments (k-means seeds cannot match, so a port-built
  store cannot be held to the reference id for id).  For Mode A and B,
  the fused plane with global and per-segment routing and the per-segment
  loop, with and without tag/ts filters, on the "ref" and "fused_ref"
  planes, ``search(manifest=...)`` must return the JAX store's ids, with
  dists within rtol 1e-5 and atol 1e-5.  Ties: the port merges pools with
  a stable sort, the JAX store with ``np.argsort``, which is not stable;
  the inputs are random floats, so exact ties do not occur.
- ``stack_segments`` builds every leaf of the JAX stack, padding included.
- **The port's own stores at exhaustive knobs** (every grain probed, a
  pool of every slot, no envelope pruning): the fused search, the
  per-segment loop and brute force over the live records agree, after
  deletes, upserts and TTL expiry; and the store's semantics (snapshots,
  branches, the plane and liveness caches, refusals) hold.
"""
import dataclasses

import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import jax
import numpy as np
import torch

from repro.core.store import VectorStore as JaxStore
from repro.core.store import stack_segments as jax_stack_segments
from repro_torch.core import HNTLConfig, planner
from repro_torch.core import store as store_mod
from repro_torch.core.store import VectorStore, stack_segments
from repro_torch.core.types import BIG, tree_bytes
from repro_torch.interop import manifest_from_numpy, segment_from_numpy
from repro_torch.launch.mesh import make_search_mesh

import torch_parity as tp

T0 = 1000.0                  # a fixed store clock: deterministic TTLs
NOW = T0 + 45.0              # past the 30 s TTLs, before the 60 s ones


# ---------------------------------------------------------------------------
# Against the JAX store
# ---------------------------------------------------------------------------


def _jax_store(cfg, *, n_seg=4, rows=128, small=64, tail=48, seed=3):
    """A JAX store: n_seg sealed segments of ``rows`` plus one of ``small``
    rows (fewer grains), a memtable tail, per-row tags 1 << (row % 4) and
    ts row / n, one TTL'd sealed batch and TTL'd tail rows, deletes in
    both tiers and upserts of sealed gids."""
    n = n_seg * rows + small + tail
    x, q = tp.corpus(n=n, nq=8, seed=seed)
    tags = (1 << (np.arange(n) % 4)).astype(np.uint32)
    ts = (np.arange(n) / n).astype(np.float32)
    st = JaxStore(cfg, seal_threshold=rows, clock=lambda: T0)
    bounds = [i * rows for i in range(n_seg + 1)] + [n_seg * rows + small, n]
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        ttl = None
        if i == 2 or hi == n:
            ttl = np.where(np.arange(hi - lo) % 5 == 0, 30.0, np.inf)
        st.add(x[lo:hi], tags=tags[lo:hi], ts=ts[lo:hi], ttl=ttl)
        if i == n_seg:
            st.seal()                          # the small segment
    assert st.n_segments == n_seg + 1 and len(st._mem) == tail
    rng = np.random.default_rng(seed)
    st.delete(rng.choice(n - tail, 40, replace=False))
    st.delete([n - 3])                         # a memtable row
    up = rng.choice(n - tail, 6, replace=False)
    st.upsert(up, x[up] + 0.01 * rng.standard_normal(
        (6, x.shape[1])).astype(np.float32), tags=tags[up], ts=ts[up])
    return st, q


def _numpy_manifest(man):
    """The JAX manifest with every segment's index leaves numpy arrays."""
    return dataclasses.replace(man, segments=tuple(
        dataclasses.replace(s, index=jax.tree.map(np.asarray, s.index))
        for s in man.segments))


@pytest.fixture(scope="module")
def carried():
    jcfg = tp.jax_config(n_grains=4, nprobe=3, pool=24)
    jst, q = _jax_store(jcfg)
    man = jst.snapshot()
    pst = VectorStore(tp.port_config(jcfg), seal_threshold=128,
                      clock=lambda: T0, device="cpu")
    return jst, man, pst, manifest_from_numpy(_numpy_manifest(man), "cpu"), q


def _assert_same(port, ref):
    assert np.array_equal(port.ids.cpu().numpy().astype(np.int64),
                          np.asarray(ref.ids, np.int64))
    np.testing.assert_allclose(port.dists.cpu().numpy(),
                               np.asarray(ref.dists), rtol=1e-5, atol=1e-5)


FILTERS = {"none": {}, "tag": dict(tag_mask=0b0101),
           "ts": dict(ts_range=(0.25, 0.75)),
           "tag_and_ts": dict(tag_mask=0b0110, ts_range=(0.1, 0.9))}
PATHS = {"fused_global": dict(fused=True, route_mode="global"),
         "fused_per_segment": dict(fused=True, route_mode="per_segment"),
         "looped": dict(fused=False)}


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("mode", ["A", "B"])
@pytest.mark.parametrize("plane", ["ref", "fused_ref"])
def test_search_matches_jax_store(carried, plane, mode, path, filt):
    jst, man, pst, pman, q = carried
    kw = dict(topk=5, mode=mode, scan_impl=plane, now=NOW, **PATHS[path],
              **FILTERS[filt])
    ref = jst.search(q, manifest=man, **kw)
    got = pst.search(q, manifest=pman, **kw)
    _assert_same(got, ref)
    assert got.ids.dtype == torch.int32 and got.ids.shape == (q.shape[0], 5)


def test_carried_manifest_keeps_the_mutation_state(carried):
    _, man, _, pman, _ = carried
    assert pman.writer == man.writer and pman.epoch == man.epoch
    assert np.array_equal(pman.mut_gid, man.mut_gid)
    assert np.array_equal(pman.mut_seq, man.mut_seq)
    assert pman.mem_n == man.mem_n and pman.mem_ids == man.mem_ids
    assert pman.mem_expire == man.mem_expire
    assert all(a is b for a, b in zip(pman.mem, man.mem))
    seg, jseg = pman.segments[2], man.segments[2]
    assert seg.expire is not None and np.array_equal(seg.expire, jseg.expire)
    assert seg.index.grains.tags.dtype == torch.int64


def _assert_leaves_equal(port, ref, path="stacked"):
    if dataclasses.is_dataclass(ref):
        for f in dataclasses.fields(ref):
            if hasattr(port, f.name):
                _assert_leaves_equal(getattr(port, f.name),
                                     getattr(ref, f.name),
                                     f"{path}.{f.name}")
        return
    if ref is None:
        assert port is None, path
        return
    want = np.asarray(ref)
    got = port.cpu().numpy()
    assert got.shape == want.shape, path
    assert np.array_equal(got, want.astype(got.dtype)), path


def _two_size_segments(cfg, seed):
    """Sealed segments of a JAX store: 256 rows (8 grains) and 96 rows
    (3 grains), so the stack pads grains and caps."""
    x, _ = tp.corpus(n=352, nq=1, seed=seed)
    st = JaxStore(cfg, seal_threshold=256)
    st.add(x[:256], tags=[3] * 256, ts=np.linspace(0, 1, 256))
    st.add(x[256:], tags=[5] * 96)
    st.seal()
    return list(st.snapshot().segments)


@pytest.mark.parametrize("case", ["sketch", "no_sketch", "density",
                                  "mixed_precision"])
def test_stack_segments_matches_jax(carried, case):
    if case == "sketch":               # the parity store's 4 + 1 segments
        segs = list(carried[1].segments)
    elif case == "mixed_precision":    # a fixed-width segment in the stack
        segs = (_two_size_segments(tp.jax_config(bit_alloc="density"), 1)
                + _two_size_segments(tp.jax_config(), 2)[:1])
    else:
        kw = {"no_sketch": {"s": 0}, "density": {"bit_alloc": "density"}}
        segs = _two_size_segments(tp.jax_config(**kw[case]), 0)
    ref = jax_stack_segments(segs)
    port = stack_segments([segment_from_numpy(
        dataclasses.replace(s, index=jax.tree.map(np.asarray, s.index)),
        "cpu") for s in segs])
    g = port.index.grains
    assert g.n_grains > sum(s.index.grains.n_grains for s in segs)  # padded
    _assert_leaves_equal(port, ref)
    assert port.n_segments == len(segs) and port.live is None


# ---------------------------------------------------------------------------
# The port's own stores at exhaustive knobs, against brute force
# ---------------------------------------------------------------------------

D, N_SEG, SEG_ROWS = tp.SMALL["d"], 4, 128


def _cfg(**kw):
    # envelope_frac=1.0 prunes no grain, and pool == seal_threshold makes
    # the loop's per-segment Mode B pool exhaustive too
    return HNTLConfig(**{**tp.SMALL, "n_grains": 4, "pool": SEG_ROWS,
                         "envelope_frac": 1.0, **kw})


class _Model:
    """Brute force: the live version of every gid."""

    def __init__(self):
        self.rows = {}            # gid -> (vec, tag, ts, expire)

    def write(self, ids, vecs, tags, ts, expire=np.inf):
        exp = np.broadcast_to(np.asarray(expire, np.float64), (len(ids),))
        for i, g in enumerate(np.asarray(ids).tolist()):
            self.rows[g] = (vecs[i], int(tags[i]), float(ts[i]),
                            float(exp[i]))

    def search(self, q, topk, tag_mask=None, ts_range=None, now=T0):
        ok = [g for g, (_, tag, ts, exp) in self.rows.items()
              if exp > now and (tag_mask is None or tag & tag_mask)
              and (ts_range is None
                   or np.float32(ts_range[0]) <= np.float32(ts)
                   < np.float32(ts_range[1]))]
        gids = np.asarray(sorted(ok), np.int64)
        vecs = np.stack([self.rows[g][0] for g in gids])
        d = ((q[:, None, :].astype(np.float64) - vecs[None]) ** 2).sum(-1)
        order = np.argsort(d, axis=1, kind="stable")[:, :topk]
        return gids[order], np.take_along_axis(d, order, axis=1)


def _port_store(seed=11, tail=20):
    rng = np.random.default_rng(seed)
    st = VectorStore(_cfg(), seal_threshold=SEG_ROWS, clock=lambda: T0,
                     device="cpu")
    model = _Model()
    x = rng.standard_normal((N_SEG * SEG_ROWS + tail, D)).astype(np.float32)
    for i in range(N_SEG):
        lo = i * SEG_ROWS
        tags, ts = [1 << (i % 3)] * SEG_ROWS, [float(i)] * SEG_ROWS
        model.write(st.add(x[lo:lo + SEG_ROWS], tags=tags, ts=ts),
                    x[lo:lo + SEG_ROWS], tags, ts)
    if tail:
        tags, ts = [2] * tail, [1.5] * tail
        model.write(st.add(x[-tail:], tags=tags, ts=ts), x[-tail:], tags, ts)
    assert st.n_segments == N_SEG and len(st._mem) == tail
    q = (x[:6] + 0.01 * rng.standard_normal((6, D))).astype(np.float32)
    return st, model, x, q, rng


def _exhaustive(st):
    return dict(nprobe=sum(s.index.grains.n_grains for s in st._segments),
                pool=st.n_vectors * 2)


def _mutate(state, st, model, x, rng):
    if state == "mutated":
        dead = np.r_[np.arange(0, SEG_ROWS, 3), [N_SEG * SEG_ROWS + 1]]
        st.delete(dead)
        for g in dead.tolist():
            model.rows.pop(g)
        up = np.asarray([SEG_ROWS + 1, 2 * SEG_ROWS + 2, 5])
        vecs = x[:3] + 0.5
        st.upsert(up, vecs, tags=[1, 2, 4], ts=[0.5, 1.5, 2.5])
        model.write(up, vecs, [1, 2, 4], [0.5, 1.5, 2.5])
    elif state == "expired":
        tail = len(st._mem)
        for n in (SEG_ROWS - tail, 10):       # seals with the tail, then
            vecs = rng.standard_normal((n, D)).astype(np.float32)  # memtable
            ttl = np.where(np.arange(n) % 2 == 0, 30.0, 60.0)
            tags, ts = [4] * n, [2.5] * n
            model.write(st.add(vecs, tags=tags, ts=ts, ttl=ttl), vecs, tags,
                        ts, T0 + ttl)
        assert st.n_segments == N_SEG + 1 and len(st._mem) == 10


@pytest.mark.parametrize("state", ["fresh", "mutated", "expired"])
def test_exhaustive_fused_equals_looped_equals_brute_force(state):
    st, model, x, q, rng = _port_store()
    _mutate(state, st, model, x, rng)
    for filt in FILTERS.values():
        filt = {k: (v if k != "ts_range" else (1.0, 3.0))
                for k, v in filt.items()}
        kw = dict(topk=10, mode="B", now=NOW, **filt)
        fused = st.search(q, **kw, **_exhaustive(st))
        per_seg = st.search(q, route_mode="per_segment", **kw,
                            **_exhaustive(st))
        looped = st.search(q, fused=False, **kw)
        ids, d = model.search(q, 10, filt.get("tag_mask"),
                              filt.get("ts_range"), NOW)
        for res in (fused, per_seg, looped):
            got = res.ids.numpy().astype(np.int64)
            assert np.array_equal(got, np.where(d < BIG / 2, ids, -1)), filt
            np.testing.assert_allclose(res.dists.numpy(), d, rtol=1e-5,
                                       atol=1e-5)


def test_exhaustive_mode_a_fused_matches_looped():
    st, model, x, q, rng = _port_store()
    _mutate("mutated", st, model, x, rng)
    fused = st.search(q, topk=10, mode="A", **_exhaustive(st))
    looped = st.search(q, topk=10, mode="A", fused=False)
    # the same quantizers price every slot, so the merged top-k agree
    np.testing.assert_allclose(fused.dists.numpy(), looped.dists.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_select_plane_holds_a_pool_per_query_not_every_slot():
    """Candidate state of the stacked plane (``benchmarks/scan_select.py``'s
    accounting): the select plane's [Q, pool] output against the gather
    plane's [Q, P*cap] slot matrix."""
    rng = np.random.default_rng(2)
    st = VectorStore(_cfg(), seal_threshold=512, device="cpu")
    x = rng.standard_normal((1024, D)).astype(np.float32)
    st.add(x[:512])
    st.add(x[512:])
    q = x[:6]
    st.search(q)
    index = next(iter(st._stack_cache.values()))[1]["plane"].index
    qt = torch.from_numpy(q)
    nprobe, pool = 4, 16
    gids, _ = planner.routing.route(index.routing, qt, nprobe)
    kw = dict(envelope_frac=1.0, qeff=8191, width=pool)
    ds, rows = planner.candidate_stage(index, qt, gids,
                                       scan_impl="fused_ref", **kw)
    dg, _ = planner.candidate_stage(index, qt, gids, scan_impl="ref", **kw)
    assert ds.shape == rows.shape == (q.shape[0], pool)
    assert dg.shape == (q.shape[0], nprobe * index.grains.cap)
    select_state = q.shape[0] * pool * (4 + 4)          # dists + rows
    gather_state = dg.numel() * 4                        # dists
    assert select_state * 8 < gather_state


# ---------------------------------------------------------------------------
# Store semantics
# ---------------------------------------------------------------------------


def _ids(res):
    return res.ids.numpy().astype(np.int64)


def test_snapshot_survives_later_seal():
    st, _, _, _, _ = _port_store(tail=0)
    extra = (np.full((4, D), 2.5) + 0.1 * np.arange(4)[:, None]).astype(
        np.float32)
    extra_ids = st.add(extra)                       # memtable, not sealed
    man = st.snapshot()
    before = st.search(extra[:1], topk=2, manifest=man)
    st.add(np.zeros((SEG_ROWS, D), np.float32))     # seals
    assert not st._mem
    after = st.search(extra[:1], topk=2, manifest=man)
    assert torch.equal(before.ids, after.ids)
    assert torch.equal(before.dists, after.dists)
    assert int(after.ids[0, 0]) == int(extra_ids[0])


def test_snapshot_keeps_deleted_rows():
    st, _, x, _, _ = _port_store()
    man = st.snapshot()
    ex = _exhaustive(st)
    before = st.search(x[:2], topk=1, manifest=man, **ex)
    assert (_ids(before)[:, 0] == [0, 1]).all()
    st.delete([0, 1])
    assert torch.equal(st.search(x[:2], topk=1, manifest=man, **ex).ids,
                       before.ids)
    assert not np.isin(_ids(st.search(x[:2], topk=1, **ex)), [0, 1]).any()


def test_branch_mutations_are_isolated_both_ways():
    st, _, x, _, _ = _port_store()
    child = st.branch()
    child.delete([0])
    st.delete([1])
    ex = _exhaustive(st)
    p = _ids(st.search(x[:2], topk=1, **ex))[:, 0]
    c = _ids(child.search(x[:2], topk=1, **ex))[:, 0]
    assert p[0] == 0 and p[1] != 1
    assert c[0] != 0 and c[1] == 1
    child.upsert([5], np.full((1, D), 8.5, np.float32))
    probe = np.full((1, D), 8.5, np.float32)
    assert int(child.search(probe, topk=1).ids[0, 0]) == 5
    assert int(st.search(probe, topk=1).ids[0, 0]) != 5


def test_filtered_memtable_rows_never_leak_as_hits():
    st = VectorStore(_cfg(), seal_threshold=1024, device="cpu")
    st.add(np.eye(5, D, dtype=np.float32), tags=[1] * 5)    # memtable only
    res = st.search(np.zeros((1, D), np.float32), topk=3, tag_mask=2)
    assert (_ids(res) == -1).all() and (res.dists.numpy() == BIG).all()
    st2, _, _, q, _ = _port_store()
    assert (_ids(st2.search(q[:1], topk=3, tag_mask=8)) == -1).all()


def test_topk_wider_than_plane_pads_with_minus_one():
    st = VectorStore(_cfg(), seal_threshold=64, device="cpu")
    st.add(np.random.default_rng(0).standard_normal((64, D))
           .astype(np.float32))
    assert st.n_segments == 1 and not st._mem
    for fused in (True, False):
        ids = _ids(st.search(np.zeros((2, D), np.float32), topk=500,
                             fused=fused))
        assert ids.shape == (2, 500)
        assert (ids[:, :64] >= 0).all() and (ids[:, 64:] == -1).all()


def test_empty_store_and_tiny_segments():
    st = VectorStore(_cfg(pool=512), seal_threshold=64, device="cpu")
    q = np.zeros((2, D), np.float32)
    for fused in (True, False):
        assert (_ids(st.search(q, topk=3, fused=fused)) == -1).all()
    x = np.random.default_rng(13).standard_normal((64, D)).astype(np.float32)
    st.add(x)                                     # one 4-grain segment
    for fused in (True, False):
        assert (_ids(st.search(x[:2], topk=1, fused=fused))[:, 0]
                == [0, 1]).all()
    res = st.search(x[:2], topk=10, pool=4)       # pool below topk: clamped
    assert res.ids.shape == (2, 10) and (_ids(res)[:, 0] >= 0).all()


@pytest.fixture
def stacks(monkeypatch):
    calls = []
    real = store_mod.stack_segments

    def counting(segments):
        calls.append(len(segments))
        return real(segments)

    monkeypatch.setattr(store_mod, "stack_segments", counting)
    return calls


def test_restacks_on_a_manifest_change_not_on_a_delete(stacks):
    st, _, _, q, _ = _port_store()
    st.search(q, topk=5)
    st.search(q, topk=5, scan_impl="auto")        # "auto" is "ref" here
    assert stacks == [N_SEG]
    st.delete([0, 1, 2])
    res = st.search(q, topk=5)
    assert stacks == [N_SEG]                      # the live leaf only
    assert not np.isin(_ids(res), [0, 1, 2]).any()
    child = st.branch()
    new = np.full((SEG_ROWS, D), 0.5, np.float32)
    new_ids = child.add(new)                      # seals a 5th segment
    new_ids = set(new_ids.tolist())               # equal rows: any of them
    assert int(child.search(new[:1], topk=1).ids[0, 0]) in new_ids
    assert stacks == [N_SEG, N_SEG + 1]
    assert int(st.search(new[:1], topk=1).ids[0, 0]) not in new_ids


def test_every_scan_plane_reads_one_stacked_plane(stacks):
    st, _, _, q, _ = _port_store()
    for plane in ("ref", "fused_ref", "kernel", None):
        st.search(q, topk=5, scan_impl=plane)
    assert stacks == [N_SEG] and len(st._stack_cache) == 1


def test_plane_cache_keeps_the_newest_segment_sets(stacks):
    st, _, _, q, rng = _port_store(tail=0)
    old = st.snapshot()
    st.search(q, topk=5)
    for _ in range(store_mod.STACK_CACHE_ENTRIES):
        st.add(rng.standard_normal((SEG_ROWS, D)).astype(np.float32))
        st.search(q, topk=5)
    assert len(st._stack_cache) == store_mod.STACK_CACHE_ENTRIES
    n_stacks = len(stacks)
    st.search(q, topk=5)                          # the newest: cached
    assert len(stacks) == n_stacks
    st.search(q, topk=5, manifest=old)            # evicted: stacked again
    assert stacks[n_stacks:] == [N_SEG]
    assert len(st._stack_cache) == store_mod.STACK_CACHE_ENTRIES


def test_liveness_leaf_is_cached_per_epoch():
    st, _, _, q, _ = _port_store()
    st.delete([0])
    st.search(q, topk=5)
    entry = st._stacked_for(tuple(st._segments))
    key0, plane0 = entry["live"]
    assert plane0.live is not None and not bool(plane0.live.all())
    st.search(q, topk=5)
    assert entry["live"][0] == key0 and entry["live"][1] is plane0
    st.delete([1])
    st.search(q, topk=5)
    assert entry["live"][0] != key0


def test_one_search_stacked_call_per_search(monkeypatch):
    st = VectorStore(_cfg(), seal_threshold=64, device="cpu")
    x = np.random.default_rng(5).standard_normal((8 * 64, D)).astype(
        np.float32)
    for i in range(8):
        st.add(x[i * 64:(i + 1) * 64])
    calls = []
    real = planner.search_stacked
    monkeypatch.setattr(planner, "search_stacked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for mode in "AB":
        st.search(x[:5], topk=10, mode=mode)
    assert st.n_segments == 8 and len(calls) == 2


def test_delete_counts_and_cannot_poison_a_future_insert():
    st, _, _, _, _ = _port_store()
    assert st.delete([5, 6]) == 2
    assert st.delete([5, 6]) == 0                 # already dead
    assert st.n_live() == st.n_vectors - 2
    fresh = VectorStore(_cfg(), seal_threshold=1024, device="cpu")
    assert fresh.delete([5]) == 0 and not fresh._live_seq
    ids = fresh.add(np.eye(8, D, dtype=np.float32))
    res = fresh.search(np.eye(8, D, dtype=np.float32), topk=1)
    assert (_ids(res)[:, 0] == ids).all() and fresh.n_live() == 8


def test_upsert_shadows_inserts_and_loses_to_a_delete():
    st, _, x, _, _ = _port_store()
    ex = _exhaustive(st)
    target = np.full((1, D), 7.5, np.float32)
    st.upsert([3], target)
    res = st.search(target, topk=1, **ex)
    assert int(res.ids[0, 0]) == 3 and float(res.dists[0, 0]) == 0.0
    old = st.search(x[3][None], topk=1, **ex)
    assert int(old.ids[0, 0]) != 3                # the old row is dead
    assert st.n_live() == st.n_vectors - 1
    st.upsert([9], np.full((1, D), 4.5, np.float32))
    st.delete([9])
    res = st.search(np.full((1, D), 4.5, np.float32), topk=2, **ex)
    assert not np.isin(_ids(res), [9]).any()
    fresh = VectorStore(_cfg(), seal_threshold=64, device="cpu")
    fresh.upsert([41], np.full((1, D), 1.5, np.float32))
    assert fresh.add(np.zeros((2, D), np.float32)).min() > 41
    assert int(fresh.search(np.full((1, D), 1.5, np.float32),
                            topk=1).ids[0, 0]) == 41


def test_ttl_expiry_in_sealed_and_memtable_rows():
    t = [T0]
    st, _, _, _, _ = _port_store(tail=0)
    st._clock = lambda: t[0]
    sealed = st.add(np.full((SEG_ROWS, D), 5.5, np.float32), ttl=60.0)
    assert not st._mem                            # sealed a 5th segment
    mem = st.add(np.full((2, D), 6.5, np.float32), ttl=30.0)
    p_sealed = np.full((1, D), 5.5, np.float32)
    p_mem = np.full((1, D), 6.5, np.float32)
    ex = _exhaustive(st)

    def top(p, now=None):
        return int(st.search(p, topk=1, now=now, **ex).ids[0, 0])

    assert top(p_sealed, T0 + 10) in set(sealed.tolist())
    assert top(p_mem, T0 + 10) == int(mem[0])
    assert top(p_mem, NOW) not in set(mem.tolist())
    assert top(p_sealed, NOW) in set(sealed.tolist())
    assert top(p_sealed, T0 + 100) not in set(sealed.tolist())
    t[0] = T0 + 100.0                             # the store's own clock
    assert top(p_sealed) not in set(sealed.tolist())


@pytest.mark.parametrize("call, match", [
    (lambda st: VectorStore(_cfg(), device_budget=-1, device="cpu"),
     "device_budget must be >= 0"),
    (lambda st: st.search(np.zeros(D), scan_impl="cascade",
                          budgets=(32, 16), fused=False),
     "fused search plane"),
    (lambda st: st.search(np.zeros(D), budgets=(8, 16)), "b1 >= b2"),
    (lambda st: st.search(np.zeros(D), adaptive=True, fused=False),
     "fused search plane"),
    (lambda st: st.search(np.zeros(D), probe_margin=0.5), "adaptive=True"),
    (lambda st: st.search(np.zeros(D), fused=False,
                          mesh=make_search_mesh(1, devices=["cpu"])),
     "mesh= requires the fused search plane"),
    (lambda st: st.search(np.zeros(D), route_mode="nope"), "route_mode"),
], ids=["device_budget", "budgets",
        "budgets_invalid", "adaptive", "probe_margin", "mesh", "route_mode"])
def test_invalid_argument_combinations_are_refused(call, match):
    st, _, _, _, _ = _port_store(tail=0)
    with pytest.raises(ValueError, match=match):
        call(st)


@pytest.mark.parametrize("name, item", [
    ("tenant_live", 6), ("tenant_ix", 6), ("probe_margin", 5),
    ("hub_mask", 5)])
def test_search_stacked_tenant_and_adaptive_arguments(carried, name, item):
    """Tenancy (item 6) and adaptive routing (item 5) are ported.  The
    tenant pair is held to the JAX planner on the same stacked plane
    ("tenant_live": a random bitmap over three tenants, Mode A;
    "tenant_ix": every query on the last tenant row, Mode B), and is
    refused only half given or with per-segment routing, as the JAX
    package refuses it.  ``probe_margin=`` is refused only with
    per-segment routing, and an all-hub ``hub_mask=`` keeps every probe
    active even at margin 0, so the search is the static one."""
    st, _, _, q, _ = _port_store(tail=0)
    stacked = stack_segments(st._segments)
    qt = torch.from_numpy(q)
    kw = dict(nprobe=4, pool=16, topk=5)
    if item == 6:
        import jax.numpy as jnp
        from repro.core import planner as jax_planner

        _, man, _, pman, q = carried          # both packages' segments
        stacked = stack_segments(pman.segments)
        qt = torch.from_numpy(q)
        shape = tuple(stacked.index.grains.ids.shape)
        tl = np.random.default_rng(2).random((3, *shape)) < 0.5
        ti = np.random.default_rng(3).integers(0, 3, q.shape[0])
        mode = "A"
        if name == "tenant_ix":
            ti, mode = np.full(q.shape[0], 2), "B"
        ti = ti.astype(np.int32)
        jst = jax_stack_segments(man.segments)
        ref = jax_planner.search_stacked(
            jst, jnp.asarray(q), tenant_live=jnp.asarray(tl),
            tenant_ix=jnp.asarray(ti), mode=mode, **kw)
        got = planner.search_stacked(
            stacked, qt, tenant_live=torch.from_numpy(tl),
            tenant_ix=torch.from_numpy(ti), mode=mode, **kw)
        _assert_same(got, ref)
        with pytest.raises(ValueError, match="come together"):
            planner.search_stacked(stacked, qt,
                                   **{name: torch.from_numpy(
                                       tl if name == "tenant_live" else ti)},
                                   **kw)
        with pytest.raises(ValueError, match="global routing"):
            planner.search_stacked(
                stacked, qt, route_mode="per_segment",
                seg_shape=(len(pman.segments), stacked.index.grains.n_grains
                           // len(pman.segments)),
                tenant_live=torch.from_numpy(tl),
                tenant_ix=torch.from_numpy(ti), **kw)
    elif name == "probe_margin":
        with pytest.raises(ValueError, match="global routing"):
            planner.search_stacked(
                stacked, qt, route_mode="per_segment",
                seg_shape=(N_SEG, stacked.index.grains.n_grains // N_SEG),
                probe_margin=0.5, **kw)
    else:
        hubs = torch.ones(stacked.index.grains.n_grains, dtype=torch.bool)
        got = planner.search_stacked(stacked, qt, probe_margin=0.0,
                                     hub_mask=hubs, **kw)
        want = planner.search_stacked(stacked, qt, **kw)
        assert torch.equal(got.ids, want.ids)
        assert torch.equal(got.dists, want.dists)


def test_stacked_plane_bytes_and_shapes():
    st, _, _, _, _ = _port_store()
    stacked = stack_segments(st._segments)
    gmax = max(s.index.grains.n_grains for s in st._segments)
    assert stacked.index.grains.n_grains == N_SEG * gmax
    assert stacked.gid_of_row.shape[0] == N_SEG * SEG_ROWS
    assert int(stacked.index.routing.sizes.sum()) == N_SEG * SEG_ROWS
    assert tree_bytes(stacked.index.raw) == N_SEG * SEG_ROWS * D * 4
