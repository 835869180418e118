"""The port's grain maintenance against the JAX package's.

- **Helpers** on seeded numpy inputs: ``two_means``, ``steal_rows``,
  ``merge_target`` and ``pack_members`` equal the reference exactly (they
  are host numpy in both packages); ``captured_fraction`` and
  ``best_captured_fraction`` (batched on the device here) within rtol
  1e-5.
- **Maintenance on a carried store.**  A JAX ``VectorStore`` is built and
  mutated, then carried across with ``interop.store_from_numpy``, so both
  packages maintain the same state (k-means seeds cannot match, so a
  port-built store cannot be held to the reference decision for
  decision).  For split, merge, retire, refit, a dropped segment, a
  mixed epoch and the all-healthy identity, under fixed and density bit
  allocation: every ``SegmentReport`` field equal; ids/valid panels and
  routing sizes equal exactly; untouched grains bit-equal; refit frames
  equal as projectors (1e-4), their coordinate scales within rtol 1e-4
  and their residual scales within 1e-5 of the group's largest squared
  row norm (the residual energy cancels); the search at exhaustive knobs
  equal to brute force.
- The plans are decided in float32 from statistics summed in another
  order than numpy's, so a grain near a threshold could flip.  Each case
  asserts, on the reference's own statistics, that every grain is at a
  clear margin from every threshold (``torch_parity.assert_clear_margins``) before it compares plans.
"""
import dataclasses

import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import numpy as np
import torch

from repro.core import kmeans as jax_kmeans
from repro.core import layout as jax_layout
from repro.core import pca as jax_pca
from repro.core import routing as jax_routing
from repro.core.maintenance import MaintenancePolicy as JaxPolicy
from repro.core.store import VectorStore as JaxStore
from repro_torch.core import kmeans, layout, pca, routing
from repro_torch.core.maintenance import MaintenancePolicy
from repro_torch.interop import store_from_numpy

import torch_parity as tp

D = tp.SMALL["d"]


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["clusters", "gaussian", "identical",
                                  "two_rows"])
def test_two_means_and_steal_rows_equal_the_reference(case):
    rng = np.random.default_rng(5)
    x = {"clusters": np.concatenate([rng.standard_normal((40, D)) + 3,
                                     rng.standard_normal((25, D)) - 3]),
         "gaussian": rng.standard_normal((77, D)),
         "identical": np.ones((12, D)),
         "two_rows": rng.standard_normal((2, D))}[case].astype(np.float32)
    c_ref, a_ref = jax_kmeans.two_means(x)
    c, a = kmeans.two_means(x)
    assert np.array_equal(a, a_ref) and np.array_equal(c, c_ref)
    d2 = np.sum((x - x.mean(0)) ** 2, axis=1)
    for n_move in (0, 1, len(x) // 2):
        assert np.array_equal(kmeans.steal_rows(d2, n_move),
                              jax_kmeans.steal_rows(d2, n_move))


@pytest.mark.parametrize("kw", [{}, {"excluded": [1, 2]},
                                {"max_merged": 40}, {"excluded": range(8)}])
def test_merge_target_equals_the_reference(kw):
    rng = np.random.default_rng(6)
    cents = rng.standard_normal((8, D)).astype(np.float32)
    counts = np.array([5, 30, 0, 12, 50, 28, 7, 33])
    for src in (0, 3, 6):
        assert routing.merge_target(cents, counts, 64, src, **kw) \
            == jax_routing.merge_target(cents, counts, 64, src, **kw)


def test_pack_members_equals_the_reference():
    rng = np.random.default_rng(7)
    members = [rng.permutation(50)[:m] for m in (0, 1, 16, 31, 32)]
    for got, want in zip(layout.pack_members(members, 32),
                         jax_layout.pack_members(members, 32)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="overflows cap"):
        layout.pack_members([np.arange(33)], 32)


@pytest.mark.parametrize("s", [0, 2])
def test_captured_fractions_match_the_reference(s):
    """Grains with every slot live, a few live, one live and none live
    (empty grains report 1.0 in both)."""
    rng = np.random.default_rng(8)
    g, cap, k = 6, 40, 4
    x, _ = tp.corpus(n=g * cap, nq=1, seed=8)
    x = x.reshape(g, cap, D)
    mask = rng.random((g, cap)) < 0.7
    mask[0] = True
    mask[1] = False
    mask[2, 1:] = False
    mask[3, 5:] = False
    basis = np.linalg.qr(rng.standard_normal((g, D, k + s)))[0]
    basis = basis.astype(np.float32)
    sk = basis[..., k:] if s else None
    c_ref, m_ref = jax_pca.captured_fraction(x, mask, basis[..., :k], sk)
    c, m = pca.captured_fraction(
        torch.from_numpy(x), torch.from_numpy(mask),
        torch.from_numpy(basis[..., :k].copy()),
        torch.from_numpy(sk.copy()) if s else None)
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-5)
    np.testing.assert_allclose(m.numpy(), m_ref, rtol=1e-5, atol=1e-6)
    b_ref = jax_pca.best_captured_fraction(x, mask, k, s)
    b = pca.best_captured_fraction(torch.from_numpy(x),
                                   torch.from_numpy(mask), k, s)
    np.testing.assert_allclose(b.numpy(), b_ref, rtol=1e-5)
    assert c[1] == 1.0 and b[1] == 1.0


# ---------------------------------------------------------------------------
# Maintenance on a carried store
# ---------------------------------------------------------------------------


def _cfg(**kw):
    return tp.jax_config(**{"n_grains": 4, "nprobe": 4, "pool": 64,
                            "envelope_frac": 1.0, **kw})


def _rows_of(st, seg_i, gi):
    g = st._segments[seg_i].index.grains
    ids, valid = np.asarray(g.ids), np.asarray(g.valid)
    return st._segments[seg_i].global_ids()[ids[gi][valid[gi]]]


def _one_side(st, seg_i, gi):
    """The rows of grain gi on the negative side of its mean along its
    first basis vector (a cut that walks the live mean off the
    centroid)."""
    g = st._segments[seg_i].index.grains
    rows = _rows_of(st, seg_i, gi)
    x = np.asarray(st._segments[seg_i].raw_vectors())
    local = np.asarray(g.ids)[gi][np.asarray(g.valid)[gi]]
    p = (x[local] - np.asarray(g.mu)[gi]) @ np.asarray(g.basis)[gi][:, 0]
    return rows[p < 0]


def _scenario(name, bit_alloc):
    """(jax store, policy kwargs, live gid -> vector) after the case's
    mutations."""
    x, _ = tp.corpus(n=512, nq=1, seed=13)
    policy = {}
    st = JaxStore(_cfg(bit_alloc=bit_alloc), seal_threshold=256,
                  clock=lambda: 0.0)
    if name == "split":
        x = np.concatenate([0.05 * x[:300] + 5.0, x[300:360]])
        st = JaxStore(_cfg(bit_alloc=bit_alloc), seal_threshold=4096,
                      clock=lambda: 0.0)
        st.add(x)
        st.seal()
        policy = dict(overfull_ratio=1.3, min_split_rows=32)
    elif name == "healthy":
        st.add(x)
    else:
        st.add(x[:256])
        st.add(x[256:])
        if name == "merge":
            st.delete(np.concatenate([_rows_of(st, 0, 0)[2:],
                                      _rows_of(st, 0, 1)[2:]]))
        elif name == "retire":
            st.delete(_rows_of(st, 0, 2))
        elif name == "refit":
            st.delete(np.concatenate([_one_side(st, 0, 1),
                                      _one_side(st, 0, 3)]))
            policy = dict(drift_ratio=0.05)
        elif name == "dropped":
            st.delete(np.arange(256))
        elif name == "mixed":
            st.delete(np.concatenate([_rows_of(st, 0, 0), _one_side(st, 0, 1),
                                      _rows_of(st, 0, 2)[3:]]))
            policy = dict(drift_ratio=0.05)
    live = {g: x[g] for g in range(len(x))}
    mg, ms = st._mut_arrays()
    for g in (mg[ms < 0].tolist() if mg is not None else []):
        live.pop(g)
    return st, policy, live


def _projector(b):
    return b @ np.swapaxes(b, -1, -2)


#: The repair each case must make (a report total that must be > 0).
CASES = {"split": "splits", "merge": "merges", "retire": "retires",
         "refit": "refits", "dropped": "retires", "mixed": "merges",
         "healthy": None}


@pytest.mark.parametrize("bit_alloc", ["fixed", "density"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_maintain_matches_the_jax_store(case, bit_alloc):
    jst, pkw, live = _scenario(case, bit_alloc)
    pst = store_from_numpy(jst, device="cpu")
    old = list(pst._segments)
    jpol, ppol = JaxPolicy(**pkw), MaintenancePolicy(**pkw)
    tp.assert_clear_margins(jst, jpol, now=0.0)
    jrep = jst.maintain(policy=jpol)
    prep = pst.maintain(policy=ppol)

    assert len(prep.segments) == len(jrep.segments)
    for a, b in zip(prep.segments, jrep.segments):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert prep.changed == (case != "healthy")
    assert CASES[case] is None or prep.total(CASES[case]) > 0
    assert sum(r.dropped for r in prep.segments) == (case == "dropped")
    assert pst.maintenance_epochs == jst.maintenance_epochs
    assert pst._epoch == jst._epoch and pst._live_seq == jst._live_seq
    assert [s.seg_id for s in pst._segments] == \
        [s.seg_id for s in jst._segments]
    for rep, seg in zip(prep.segments, old):
        if not rep.changed:                    # healthy: identity
            assert any(s is seg for s in pst._segments)

    for ps, js, rep in zip(pst._segments, jst._segments,
                           [r for r in prep.segments if not r.dropped]):
        pg, jg = ps.index.grains, js.index.grains
        for f in ("ids", "valid"):
            assert np.array_equal(getattr(pg, f).numpy(),
                                  np.asarray(getattr(jg, f)))
        assert np.array_equal(ps.index.routing.sizes.numpy(),
                              np.asarray(js.index.routing.sizes))
        assert torch.equal(ps.index.routing.centroids, pg.mu)
        kept = [b for _, b in rep.unchanged]
        touched = sorted(set(range(pg.n_grains)) - set(kept))
        for f in ("coords", "res", "sketch", "basis", "mu", "scale",
                  "res_scale", "sketch_basis", "sketch_scale", "tags", "ts",
                  "qmaxg"):
            got, want = getattr(pg, f), getattr(jg, f)
            assert (got is None) == (want is None), f
            if got is not None:               # untouched: bit-identical
                assert np.array_equal(got.numpy()[kept],
                                      np.asarray(want)[kept].astype(
                                          got.numpy().dtype)), f
        if not touched:
            continue
        for f in ("tags", "ts", "qmaxg"):     # exact in touched groups too
            if getattr(pg, f) is not None:
                assert np.array_equal(
                    getattr(pg, f).numpy()[touched],
                    np.asarray(getattr(jg, f))[touched].astype(
                        getattr(pg, f).numpy().dtype)), f
        p_b, j_b = pg.basis.numpy()[touched], np.asarray(jg.basis)[touched]
        assert np.abs(_projector(p_b) - _projector(j_b)).max() <= 1e-4
        np.testing.assert_allclose(pg.mu.numpy()[touched],
                                   np.asarray(jg.mu)[touched], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(pg.scale.numpy()[touched],
                                   np.asarray(jg.scale)[touched], rtol=1e-4)
        # the residual energy ||xc||^2 - ||z||^2 - ||s||^2 cancels: its
        # max (res_scale * 65535 / 1.05) agrees to 1e-5 of the group's
        # largest ||xc||^2
        ids = pg.ids.numpy()[touched]
        xc = (ps.index.raw.numpy()[np.maximum(ids, 0)]
              - pg.mu.numpy()[touched][:, None, :])
        vc2 = np.where(pg.valid.numpy()[touched], (xc ** 2).sum(-1), 0.0)
        diff = np.abs(pg.res_scale.numpy()[touched]
                      - np.asarray(jg.res_scale)[touched])
        assert (diff * 65535 / 1.05 <= 1e-5 * vc2.max(axis=1)).all()

    # the maintained store searches exactly at exhaustive knobs
    rng = np.random.default_rng(3)
    q = rng.standard_normal((5, D)).astype(np.float32)
    gids = np.fromiter(sorted(live), np.int64, len(live))
    vecs = np.stack([live[g] for g in gids])
    got = pst.search(q, topk=5, mode="B", now=0.0,
                     nprobe=max(1, sum(s.index.grains.n_grains
                                       for s in pst._segments)),
                     pool=2 * pst.n_vectors)
    d = ((q[:, None, :] - vecs[None]) ** 2).sum(-1)
    want = gids[np.argsort(d, axis=1)[:, :5]]
    for i in range(len(q)):
        assert set(got.ids[i].tolist()) == set(want[i].tolist())


def test_carried_store_keeps_every_counter():
    jst, _, _ = _scenario("mixed", "fixed")
    jst.maintain(policy=JaxPolicy(drift_ratio=0.05))
    jst.add(np.ones((3, D), np.float32), ttl=5.0)
    pst = store_from_numpy(jst, device="cpu")
    for name in ("_next_id", "_next_seq", "_next_seg", "_epoch",
                 "_maint_epoch", "_live_seq", "_mem_ids", "_mem_seq",
                 "_mem_expire", "_mem_tags", "_mem_ts", "seal_threshold"):
        assert getattr(pst, name) == getattr(jst, name), name
    assert pst._live_seq is not jst._live_seq
    assert pst.snapshot().maint_epoch == 1 == pst.maintenance_epochs
    assert pst.cfg.bit_alloc == jst.cfg.bit_alloc and pst.n_live() == \
        jst.n_live()


# ---------------------------------------------------------------------------
# The port's own store (twins of the reference's maintenance tests)
# ---------------------------------------------------------------------------


def _own_store(**kw):
    from repro_torch.core import HNTLConfig, VectorStore

    cfg = HNTLConfig(**{**tp.SMALL, "n_grains": 4, "nprobe": 4, "pool": 64,
                        "envelope_frac": 1.0})
    return VectorStore(cfg, **{"seal_threshold": 256, "clock": lambda: 0.0,
                               "device": "cpu", **kw})


def test_healthy_store_maintain_is_identity_and_reads_no_raw_tier(
        monkeypatch):
    from repro_torch.core import maintenance

    st = _own_store()
    st.add(tp.corpus(n=512, nq=1, seed=1)[0])
    segs0 = tuple(st._segments)
    calls = []
    monkeypatch.setattr(maintenance, "grain_stats",
                        lambda *a: calls.append(a))
    rep = st.maintain()
    assert not rep.changed and tuple(st._segments) == segs0
    assert st.maintenance_epochs == 0 and not calls


def test_maintenance_epoch_captured_by_manifest_and_branch():
    st = _own_store()
    st.add(tp.corpus(n=512, nq=1, seed=2)[0])
    assert st.snapshot().maint_epoch == 0
    st.delete(st._segments[0].global_ids()[
        st._segments[0].index.grains.ids[0][
            st._segments[0].index.grains.valid[0]].numpy()])
    assert st.maintain().changed
    assert st.maintenance_epochs == 1 == st.snapshot().maint_epoch
    assert st.branch().maintenance_epochs == 1
    assert not st.maintain().changed and st.maintenance_epochs == 1


def test_grain_health_reports_zero_traffic_and_flags_a_husk():
    st = _own_store()
    x = tp.corpus(n=512, nq=1, seed=4)[0]
    st.add(x[:256])
    st.add(x[256:])
    g = st._segments[0].index.grains
    husk = g.ids[1][g.valid[1]].numpy()
    st.delete(st._segments[0].global_ids()[husk[3:]])
    h = st.grain_health()
    assert len(h) == 2 and h[0]["seg_id"] == 0
    assert h[0]["live_cnt"][1] == 3 and (h[0]["route_wins"] == 0).all()
    assert (h[0]["touches"] == 0).all() and h[0]["route_wins"].dtype \
        == np.int64
    for k in ("captured", "best"):
        assert ((h[1][k] >= 0) & (h[1][k] <= 1)).all()
    np.testing.assert_allclose(h[1]["captured"], h[1]["best"], rtol=1e-4)
    assert (h[1]["drift2"] <= 1e-8 * np.maximum(h[1]["var_live"], 1)).all()
