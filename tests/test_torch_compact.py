"""The port's size-tiered compaction, against the JAX store and on its own.

- **Against the JAX store.**  A JAX ``VectorStore`` with sealed segments,
  TTL'd rows, deletes, upserts and a memtable is carried across with
  ``interop.store_from_numpy``, then both compact with the same knobs.
  The rebuilt indexes are held through the reference's k-means centroids:
  the test wraps the JAX build to record the centroids it computes and
  the port's ``index.build`` to take them (``centroids=``), a hook of the
  test, not of the store.  Exact: the merge count, each segment's seg_id,
  position, ``id_map``/``seq``/``tags``/``ts``/``expire`` and raw rows,
  the rebuilt ids/valid panels and routing sizes, the purged tombstones
  and the epoch; the PCA frames as projectors (1e-4).
- **Twins of the reference's compaction tests** on the port's own store
  (``tests/test_store_mutation.py``, ``tests/test_store_stacked.py``,
  ``tests/test_maintenance.py``), at exhaustive knobs where results are
  compared.
- **Mutation interleavings** (``torch_mutation_property``) with all six
  ops, ``compact`` and ``maintain`` included, against brute force over a
  fixed list of seeded interleavings.
"""
import dataclasses

import pytest

jax = pytest.importorskip("jax")   # the JAX package is the reference

import numpy as np
import torch

from repro.core import index as jax_index
from repro.core import kmeans as jax_kmeans
from repro.core.maintenance import MaintenancePolicy as JaxPolicy
from repro.core.store import VectorStore as JaxStore
from repro_torch.core import HNTLConfig, VectorStore
from repro_torch.core import index as port_index
from repro_torch.core import store as store_mod
from repro_torch.core.types import tree_bytes
from repro_torch.interop import store_from_numpy

import torch_mutation_property as tmp
import torch_parity as tp

T0 = 1000.0                       # a fixed store clock: deterministic TTLs


# ---------------------------------------------------------------------------
# Against the JAX store
# ---------------------------------------------------------------------------


def _jax_store(seed, bit_alloc="fixed", rows=128, n_seg=5):
    """n_seg sealed segments of ``rows`` (one with TTL'd rows), a memtable
    tail, deletes in two segments (all of one grain's rows included) and
    upserts of sealed gids."""
    cfg = tp.jax_config(n_grains=4, nprobe=4, pool=64, bit_alloc=bit_alloc)
    n = n_seg * rows + 20
    x, _ = tp.corpus(n=n, nq=1, seed=seed)
    tags = (1 << (np.arange(n) % 4)).astype(np.uint32)
    ts = (np.arange(n) / n).astype(np.float32)
    st = JaxStore(cfg, seal_threshold=rows, clock=lambda: T0)
    for i, lo in enumerate(range(0, n, rows)):
        hi = min(lo + rows, n)
        ttl = (np.where(np.arange(hi - lo) % 3 == 0, 30.0, np.inf)
               if i == 1 else None)
        st.add(x[lo:hi], tags=tags[lo:hi], ts=ts[lo:hi], ttl=ttl)
    rng = np.random.default_rng(seed)
    st.delete(rng.choice(2 * rows, 25, replace=False))
    st.delete(np.arange(3 * rows, 4 * rows))         # a whole segment
    up = rng.choice(n_seg * rows, 5, replace=False)
    st.upsert(up, x[up] + 0.01, tags=tags[up], ts=ts[up])
    return st


@pytest.fixture
def shared_centroids(monkeypatch):
    """The JAX build records the k-means centroids it uses; the port's
    build takes them, in the same order."""
    real_jax, real_port = jax_index.build, port_index.build
    queue = []

    def jax_build(x, cfg, **kw):
        if cfg.n_grains > 1 and kw.get("centroids") is None:
            cents, _ = jax_kmeans.kmeans(
                jax.random.PRNGKey(cfg.seed), jax.numpy.asarray(
                    np.asarray(x, np.float32)), cfg.n_grains,
                iters=cfg.kmeans_iters)
            kw["centroids"] = np.asarray(cents)
        queue.append(kw.get("centroids"))
        return real_jax(x, cfg, **kw)

    def port_build(x, cfg, **kw):
        return real_port(x, cfg, centroids=queue.pop(0), **kw)

    monkeypatch.setattr(jax_index, "build", jax_build)
    monkeypatch.setattr(port_index, "build", port_build)
    return queue


def _projector(b):
    return b @ np.swapaxes(b, -1, -2)


COMPACTIONS = {"fanin4": dict(fanin=4), "fanin2_cascade": dict(fanin=2),
               "ttl_passed": dict(fanin=3, now=T0 + 60.0),
               "tier_factor2": dict(fanin=2, tier_factor=2)}


@pytest.mark.parametrize("bit_alloc", ["fixed", "density"])
@pytest.mark.parametrize("case", sorted(COMPACTIONS))
def test_compact_matches_the_jax_store(shared_centroids, case, bit_alloc):
    jst = _jax_store(seed=4, bit_alloc=bit_alloc)
    pst = store_from_numpy(jst, device="cpu")
    shared_centroids.clear()               # the JAX store's seals
    kw = dict(COMPACTIONS[case], maintain=False)
    merges = jst.compact(**kw)
    assert pst.compact(**kw) == merges >= 1 and not shared_centroids
    assert pst._live_seq == jst._live_seq and pst._epoch == jst._epoch
    assert pst._next_seg == jst._next_seg
    assert pst.n_vectors == jst.n_vectors and pst.n_live() == jst.n_live()
    assert [s.seg_id for s in pst._segments] == \
        [s.seg_id for s in jst._segments]
    for ps, js in zip(pst._segments, jst._segments):
        assert (ps.n, ps.id_base) == (js.n, js.id_base)
        for f in ("id_map", "seq", "tags", "ts", "expire"):
            got, want = getattr(ps, f), getattr(js, f)
            assert (got is None) == (want is None), f
            assert got is None or np.array_equal(got, want), f
        assert np.array_equal(ps.index.raw.numpy(),
                              np.asarray(js.index.raw))
        pg, jg = ps.index.grains, js.index.grains
        for f in ("ids", "valid", "tags", "ts"):
            assert np.array_equal(getattr(pg, f).numpy(),
                                  np.asarray(getattr(jg, f))), f
        assert np.array_equal(ps.index.routing.sizes.numpy(),
                              np.asarray(js.index.routing.sizes))
        assert np.abs(_projector(pg.basis.numpy())
                      - _projector(np.asarray(jg.basis))).max() <= 1e-4


def test_compact_then_maintain_matches_the_jax_store(shared_centroids):
    """compact()'s default maintenance pass, on both packages: the merged
    segments come back by identity, the unmerged ones (each grain at a
    clear margin from every threshold) are repaired the same way."""
    jst = _jax_store(seed=6, n_seg=6)
    seg = jst._segments[4]                 # not merged: hollow a grain out
    ids, valid = np.asarray(seg.index.grains.ids), \
        np.asarray(seg.index.grains.valid)
    gi = int(np.argmax(valid.sum(axis=1)))
    jst.delete(seg.global_ids()[ids[gi][valid[gi]]][2:])
    tp.assert_clear_margins(jst, JaxPolicy(), now=T0, seg_ids=(4, 5))
    pst = store_from_numpy(jst, device="cpu")
    shared_centroids.clear()               # the JAX store's seals
    assert jst.compact(fanin=4) == pst.compact(fanin=4) == 1
    assert pst.maintenance_epochs == jst.maintenance_epochs == 1
    assert pst._segments[0].id_map is not None   # the merged one, in place
    for ps, js in zip(pst._segments, jst._segments):
        assert ps.seg_id == js.seg_id
        for f in ("ids", "valid"):
            assert np.array_equal(getattr(ps.index.grains, f).numpy(),
                                  np.asarray(getattr(js.index.grains, f)))


@pytest.mark.parametrize("fanin,tier_factor", [(1, 4), (4, 1), (0, 0)])
def test_compact_refuses_bad_knobs(fanin, tier_factor):
    st = VectorStore(_cfg(), device="cpu")
    with pytest.raises(ValueError, match="must be >= 2"):
        st.compact(fanin=fanin, tier_factor=tier_factor)


# ---------------------------------------------------------------------------
# Twins of the reference's compaction tests, on the port's own store
# ---------------------------------------------------------------------------

D, N_SEG, SEG_ROWS = tp.SMALL["d"], 8, 64


def _cfg():
    # pool == seal_threshold makes the looped Mode B re-rank exhaustive
    return HNTLConfig(**{**tp.SMALL, "n_grains": 4, "nprobe": 4,
                         "pool": SEG_ROWS, "envelope_frac": 1.0})


def _build(n_seg=N_SEG, seed=7):
    rng = np.random.default_rng(seed)
    st = VectorStore(_cfg(), seal_threshold=SEG_ROWS, clock=lambda: T0,
                     device="cpu")
    x = rng.standard_normal((n_seg * SEG_ROWS, D)).astype(np.float32)
    for i in range(n_seg):
        st.add(x[i * SEG_ROWS:(i + 1) * SEG_ROWS],
               tags=[1 << (i % 3)] * SEG_ROWS, ts=[float(i)] * SEG_ROWS)
    assert st.n_segments == n_seg and not st._mem
    q = (x[:6] + 0.01 * rng.standard_normal((6, D))).astype(np.float32)
    return st, x, q


def _exhaustive(st):
    return dict(nprobe=max(1, sum(s.index.grains.n_grains
                                  for s in st._segments)),
                pool=max(1, st.n_vectors * 2))


def _assert_same(a, b):
    assert torch.equal(a.ids, b.ids)
    np.testing.assert_allclose(a.dists.numpy(), b.dists.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_compact_reclaims_dead_rows():
    st, x, q = _build(4)
    dead = np.arange(0, 2 * SEG_ROWS, 2)
    st.delete(dead)
    st.upsert([2 * SEG_ROWS + 1], x[:1] + 9.0)
    pre = st.search(q, topk=10, mode="B", **_exhaustive(st))
    pre_rows = st.n_vectors
    pre_bytes = tree_bytes(st._stacked_for(tuple(st._segments))["plane"])
    assert st.compact(fanin=4) >= 1
    assert st.n_vectors < pre_rows                # rows physically dropped
    post_bytes = tree_bytes(st._stacked_for(tuple(st._segments))["plane"])
    assert post_bytes < pre_bytes                 # stacked plane shrank
    post = st.search(q, topk=10, mode="B", **_exhaustive(st))
    _assert_same(pre, post)                       # results identical
    assert not np.isin(post.ids.numpy(), dead).any()


def test_compact_reclaims_expired_rows():
    st, x, q = _build(4)
    st.add(np.full((SEG_ROWS, D), 5.5, np.float32), ttl=60.0)
    assert st.n_segments == 5
    pre_rows = st.n_vectors
    st.compact(fanin=5, now=T0 + 100)             # TTL passed -> reclaim
    assert st.n_vectors == pre_rows - SEG_ROWS
    res = st.search(np.full((1, D), 5.5, np.float32), topk=1, mode="B",
                    now=T0 + 100, **_exhaustive(st))
    assert float(res.dists[0, 0]) > 0.0           # the TTL'd rows are gone


def test_compact_purges_fully_reclaimed_tombstones():
    st, x, q = _build(4)
    st.delete(np.arange(SEG_ROWS))                # kill segment 0 entirely
    assert len(st._live_seq) == SEG_ROWS
    epoch = st._epoch
    assert st.compact(fanin=4) >= 1
    assert len(st._live_seq) == 0                 # nothing left to mask
    assert st._epoch == epoch + 1
    assert st.n_vectors == 3 * SEG_ROWS


def test_compact_all_dead_group_vanishes():
    st, x, q = _build(4)
    st.delete(np.arange(4 * SEG_ROWS))            # everything
    assert st.compact(fanin=4) >= 1
    assert st.n_vectors == 0 and st.n_segments == 0
    res = st.search(q, topk=3, mode="B")
    assert (res.ids == -1).all()


def test_compact_cow_keeps_branch_view_of_dead_rows():
    """Compaction reclaims rows for the compacting store only: a branch
    that never deleted them still searches the pre-merge segments."""
    st, x, q = _build(4)
    child = st.branch()
    st.delete(np.arange(0, SEG_ROWS))
    st.compact(fanin=4)
    res = child.search(x[:2], topk=1, mode="B", **_exhaustive(child))
    assert res.ids[:, 0].tolist() == [0, 1]


def test_compact_parity_and_id_remap():
    st, x, q = _build()
    pre = st.search(q, topk=10, mode="B", **_exhaustive(st))
    assert st.compact(fanin=4, tier_factor=4) >= 1
    assert st.n_segments < N_SEG
    assert all(s.id_map is not None for s in st._segments)
    assert st.n_vectors == N_SEG * SEG_ROWS       # nothing lost
    _assert_same(pre, st.search(q, topk=10, mode="B", **_exhaustive(st)))


def test_compact_size_tiered_policy():
    """8 tier-0 segments at fanin 4 -> two merges -> two tier-1 segments,
    which stop there (2 < fanin).  With dead rows the merged segments stay
    under 4 * seal_threshold, so they stay in tier 0 and the second round
    merges the 4 remaining originals: still 2 merges."""
    st, x, q = _build()
    assert st.compact(fanin=4, tier_factor=4) == 2
    assert st.n_segments == 2
    assert sorted(s.n for s in st._segments) == [4 * SEG_ROWS] * 2
    assert [s.seg_id for s in st._segments] == [8, 9]
    assert st.compact(fanin=4, tier_factor=4) == 0   # idempotent

    st, x, q = _build()
    st.delete(np.arange(0, N_SEG * SEG_ROWS, 50))
    assert st.compact(fanin=4, tier_factor=4) == 2
    assert [s.seg_id for s in st._segments] == [8, 9]
    assert all(s.n < 4 * SEG_ROWS for s in st._segments)
    assert st._tier_of(st._segments[0].n, 4) == 0


def test_compact_is_cow_for_branches():
    st, x, q = _build()
    man = st.snapshot()
    child = st.branch()
    st.compact(fanin=4)
    assert len(man.segments) == N_SEG and child.n_segments == N_SEG
    res_child = child.search(q, topk=5, mode="B", **_exhaustive(child))
    res_man = st.search(q, topk=5, mode="B", manifest=man,
                        **_exhaustive(child))
    _assert_same(res_child, res_man)


def test_compact_mixed_recall_survives():
    st, x, q = _build()
    kw = _exhaustive(st)
    pre = st.search(q, topk=5, mode="B", tag_mask=2, ts_range=(1.0, 7.0),
                    **kw)
    st.compact(fanin=4)
    post = st.search(q, topk=5, mode="B", tag_mask=2, ts_range=(1.0, 7.0),
                     **kw)
    _assert_same(pre, post)


def _sick_store(x):
    st = VectorStore(_cfg(), seal_threshold=256, clock=lambda: 0.0,
                     device="cpu")
    st.add(x[:256])
    st.add(x[256:])
    g = st._segments[0].index.grains
    st.delete(g.ids[0][g.valid[0]].numpy()[1:])   # sicken segment 0 only
    return st


def test_compact_runs_maintenance_and_flag_disables_it():
    x = np.random.default_rng(10).standard_normal((512, D)).astype(
        np.float32)
    st = _sick_store(x)
    segs0 = [id(s) for s in st._segments]
    st.compact(maintain=False)             # nothing tiered, nothing repaired
    assert [id(s) for s in st._segments] == segs0
    st.compact()                           # default: maintenance runs
    assert [id(s) for s in st._segments] != segs0
    assert st.maintenance_epochs == 1


def test_untouched_grains_bit_identical_and_one_restack(monkeypatch):
    calls = []
    real = store_mod.stack_segments

    def counting(segments):
        calls.append(len(tuple(segments)))
        return real(segments)

    monkeypatch.setattr(store_mod, "stack_segments", counting)
    x = np.random.default_rng(7).standard_normal((512, D)).astype(np.float32)
    st = _sick_store(x)
    q = x[:2]
    st.search(q, topk=3, mode="B")
    assert len(calls) == 1
    old_segs = list(st._segments)
    rep = st.maintain()
    assert rep.changed and st._segments[1] is old_segs[1]
    r0 = rep.segments[0]
    og, ng = old_segs[0].index.grains, st._segments[0].index.grains
    assert r0.unchanged
    for old_gi, new_gi in r0.unchanged:
        for f in ("coords", "res", "sketch", "ids", "valid", "basis", "mu",
                  "scale", "res_scale", "sketch_basis", "sketch_scale",
                  "tags", "ts"):
            a, b = getattr(og, f), getattr(ng, f)
            assert (a is None) == (b is None), f
            assert a is None or torch.equal(a[old_gi], b[new_gi]), f
        assert old_segs[0].index.routing.sizes[old_gi] == \
            st._segments[0].index.routing.sizes[new_gi]
    st.search(q, topk=3, mode="B")         # exactly ONE re-stack per epoch
    assert len(calls) == 2
    st.search(q, topk=3, mode="B")
    assert len(calls) == 2


def test_snapshot_keeps_its_segments_across_maintenance():
    x = np.random.default_rng(8).standard_normal((512, D)).astype(np.float32)
    st = _sick_store(x)
    man = st.snapshot()
    assert st.maintain().changed and man.segments[0] is not st._segments[0]
    res = st.search(x[:2], topk=1, mode="B", manifest=man,
                    **_exhaustive(st))
    assert res.ids[:, 0].tolist() == [0, 1]
    assert dataclasses.replace(man).maint_epoch == 0
    assert st.snapshot().maint_epoch == 1


# ---------------------------------------------------------------------------
# Mutation interleavings against brute force
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bit_alloc", ["fixed", "density"])
@pytest.mark.parametrize("seed", range(8))
def test_mutation_interleaving_matches_bruteforce(seed, bit_alloc):
    tmp.mutation_interleaving_check(tmp.interleaving(seed), seed,
                                    bit_alloc=bit_alloc)
