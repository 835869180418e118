"""The mixed-precision cascade in the port, against the JAX package's.

- **Runner**: the same numpy inputs, made from a seed, go through the JAX
  package's ``make_cascade_runner("ref")`` and the port's "cascade" (stage
  1 through ``fused_scan_select``, whose CPU path is its plain version)
  and "cascade_ref" runners: sketch on and off, a tenant mask, ragged
  ``n_active``, a fully pruned pool, budgets None, exhaustive and real.
  Rows must be equal; dists agree to rtol 1e-6, as the select's parity
  tests hold them.
- **Searches**: ``planner.search`` on a JAX density index carried across
  with ``index_from_numpy``, and ``VectorStore.search`` on a JAX density
  store carried across with ``manifest_from_numpy`` (Mode A and B, tag
  and ts filters, after deletes and upserts) and on a cold store carried
  with ``store_from_numpy``: ids equal, dists within rtol 1e-5 and atol
  1e-5 (the planner's parity tolerance: see ``test_torch_planner.py``).
  The JAX side runs "cascade_ref" (its "cascade" is the Pallas kernel in
  interpret mode, the same stage 1 bit for bit).
- **The port alone**: at ``budgets=None`` the cascade equals "fused_ref"
  (the same distances, so the same pool where no two candidates tie); a
  paged store's cascade equals its all-warm cascade at ``budgets=None``
  and its paged "cascade_ref" at real budgets (which act per pass);
  ``budgets=(pool, pool)`` on the paged store equals brute force through
  mutation interleavings; validation errors, the registry's ``staged``
  flags, and the int4 codec and coordinate blob against the JAX package's.
"""
import copy
import dataclasses

import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import cascade as jax_cascade
from repro.core import layout as jax_layout
from repro.core import planner as jax_planner
from repro.core import quantize as jax_quantize
from repro.core.store import VectorStore as JaxStore
from repro_torch.core import (HNTLConfig, VectorStore, cascade, layout,
                              planner, quantize, scan_plane_names, scanplane)
from repro_torch.core.types import BIG
from repro_torch.interop import manifest_from_numpy, store_from_numpy
from repro_torch.kernels import select_cases

import torch_mutation_property as tmp
import torch_parity as tp

CASCADES = ["cascade", "cascade_ref"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: on one thread, so a worker among several on
    a busy host does not spin a pool of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same(port, ref, rtol=1e-5, atol=1e-5):
    assert np.array_equal(port.ids.cpu().numpy().astype(np.int64),
                          np.asarray(ref.ids, np.int64))
    np.testing.assert_allclose(port.dists.cpu().numpy(),
                               np.asarray(ref.dists), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# The runner, against the JAX package's
# ---------------------------------------------------------------------------

SHAPE = dict(q=5, p=4, g=6, k=4, cap=64)
WIDTH = 24
#: (inputs, budgets): sketch off and on, a tenant mask, ragged n_active,
#: a fully pruned pool; budgets None, exhaustive (every probed slot) and
#: real.  One shape for all, so the JAX side compiles few programs.
RUNNER_CASES = {
    "plain-none": (dict(), None),
    "sketch-none": (dict(s=2), None),
    "sketch-exhaustive": (dict(s=2), (4 * 64, WIDTH)),
    "sketch-real": (dict(s=2), (40, 12)),
    "tenant-real": (dict(s=2, tenants=3), (40, 12)),
    "ragged_n_active-none": (dict(s=2, ragged=True), None),
    "ragged_n_active-real": (dict(s=2, ragged=True), (40, 12)),
    "fully_pruned-real": (dict(s=2, keep_frac=0.0), (40, 12)),
}


@pytest.mark.parametrize("case", sorted(RUNNER_CASES))
def test_runner_matches_jax(case):
    extra, budgets = RUNNER_CASES[case]
    a = tp.select_inputs(sorted(RUNNER_CASES).index(case), **SHAPE, **extra)
    jd, jr = jax_cascade.make_cascade_runner("ref")(
        *select_cases.split(a, jnp.asarray)[0], width=WIDTH, budgets=budgets,
        **select_cases.split(a, jnp.asarray)[1])
    jd, jr = np.asarray(jd), np.asarray(jr)
    args, kw = select_cases.split(a, torch.from_numpy)
    for name in CASCADES:
        d, r = scanplane.get_scan_plane(name).runner(
            *args, width=WIDTH, budgets=budgets, **kw)
        assert d.shape == (SHAPE["q"], WIDTH) and r.dtype == torch.int32
        assert np.array_equal(r.numpy().astype(np.int64),
                              jr.astype(np.int64)), name
        np.testing.assert_allclose(d.numpy(), jd, rtol=1e-6, err_msg=name)
        assert torch.all((r == -1) == (d >= BIG / 2))
        if case.startswith("fully_pruned"):
            assert torch.all(r == -1) and torch.all(d == BIG)


def test_stage2_slices_change_nothing(monkeypatch):
    """Stage 2 re-prices the query batch in slices; one query per slice
    gives the same bits."""
    a = tp.select_inputs(3, **SHAPE, s=2, ragged=True)
    args, kw = select_cases.split(a, torch.from_numpy)
    run = scanplane.get_scan_plane("cascade").runner
    whole = run(*args, width=WIDTH, budgets=(40, 12), **kw)
    monkeypatch.setattr(cascade, "STAGE2_ELEMENTS", 1)
    part = run(*args, width=WIDTH, budgets=(40, 12), **kw)
    assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])


# ---------------------------------------------------------------------------
# One index: planner.search on a JAX density index
# ---------------------------------------------------------------------------


def _mixed_corpus(n, nq, seed):
    """``tp.corpus`` with its last quarter replaced by isotropic points in
    a region of their own: a density build keeps those grains at int8 and
    stores the manifold's at int4."""
    x, q = tp.corpus(n=n, nq=nq, seed=seed)
    rng = np.random.default_rng(seed)
    m = n // 4
    x[n - m:] = (rng.standard_normal((m, x.shape[1])) * 2.6 + 5.0) \
        .astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def dense_index():
    x, q = _mixed_corpus(2048, 8, 4)
    jcfg = tp.jax_config(bit_alloc="density")
    jidx, _ = tp.jax_build(x, jcfg)
    assert set(np.asarray(jidx.grains.qmaxg).tolist()) \
        == {quantize.INT4_QMAX, quantize.INT8_QMAX}
    return jcfg, jidx, tp.port_index(jidx), x, q


@pytest.mark.parametrize("budgets", [None, (200, 16)])
@pytest.mark.parametrize("mode", ["A", "B"])
def test_planner_search_matches_jax(dense_index, mode, budgets):
    jcfg, jidx, idx, _, q = dense_index
    kw = dict(nprobe=jcfg.nprobe, pool=jcfg.pool, topk=5, mode=mode,
              envelope_frac=jcfg.envelope_frac, budgets=budgets)
    ref = jax_planner.search(jidx, jnp.asarray(q), scan_impl="cascade_ref",
                             **kw)
    for name in CASCADES:
        got = planner.search(idx, torch.from_numpy(q), scan_impl=name, **kw)
        _assert_same(got, ref)


@pytest.mark.parametrize("mode", ["A", "B"])
def test_lossless_cascade_equals_fused_ref(dense_index, mode):
    """At budgets=None stage 1 keeps every probed slot and stage 2 prices
    it in the select's float op order: the same pool as "fused_ref"
    (random floats, so no two candidates tie)."""
    jcfg, _, idx, _, q = dense_index
    kw = dict(nprobe=jcfg.nprobe, pool=jcfg.pool, topk=5, mode=mode,
              envelope_frac=jcfg.envelope_frac)
    ref = planner.search(idx, torch.from_numpy(q), scan_impl="fused_ref",
                         **kw)
    for name in CASCADES:
        got = planner.search(idx, torch.from_numpy(q), scan_impl=name, **kw)
        assert torch.equal(got.ids, ref.ids) and torch.equal(got.dists,
                                                             ref.dists)


@pytest.mark.parametrize("mode", ["A", "B"])
def test_fully_pruned_pool_comes_back_empty(dense_index, mode):
    _, _, idx, x, _ = dense_index
    em = torch.zeros(idx.grains.valid.shape, dtype=torch.bool)
    for name in CASCADES:
        for budgets in (None, (64, 16)):
            res = planner.search(idx, torch.from_numpy(x[:3]), nprobe=4,
                                 pool=32, topk=4, mode=mode, scan_impl=name,
                                 budgets=budgets, extra_mask=em)
            assert torch.all(res.ids == -1) and torch.all(res.dists >= BIG / 2)


def test_planner_validation(dense_index):
    _, _, idx, x, _ = dense_index
    q = torch.from_numpy(x[:2])
    kw = dict(nprobe=2, pool=16)
    with pytest.raises(ValueError, match="< topk"):
        planner.search(idx, q, topk=8, scan_impl="cascade_ref",
                       budgets=(16, 4), **kw)
    with pytest.raises(ValueError, match="not staged"):
        planner.search(idx, q, topk=4, scan_impl="ref", budgets=(16, 8),
                       **kw)
    with pytest.raises(ValueError, match="not staged"):
        planner.search(idx, q, topk=4, scan_impl="fused", budgets=(16, 8),
                       **kw)
    cascade.check_budgets(None, 10)
    cascade.check_budgets((8, 8), 8)
    with pytest.raises(ValueError, match="b1 >= b2"):
        cascade.check_budgets((0, 0), 1)
    with pytest.raises(ValueError, match="stage1_engine"):
        cascade.make_cascade_runner("pallas")


def test_registry_staged_flags():
    names = scan_plane_names()
    assert "cascade" in names and "cascade_ref" in names
    for name in CASCADES:
        plane = scanplane.get_scan_plane(name)
        assert plane.kind == scanplane.SELECT
        assert plane.staged and plane.adaptive
    for name in ("ref", "kernel", "fused", "fused_ref"):
        assert not scanplane.get_scan_plane(name).staged
    assert scanplane.get_scan_plane(None).name == "ref"
    assert scanplane.get_scan_plane("auto", "cuda").name == "fused"


# ---------------------------------------------------------------------------
# The store: against the JAX density store, warm and cold
# ---------------------------------------------------------------------------

T0 = 1000.0


def _jax_dense_store(cfg, *, n_seg=3, rows=128, tail=24, seed=6, **kw):
    n = n_seg * rows + tail
    x, q = _mixed_corpus(n, 6, seed)
    tags = (1 << (np.arange(n) % 4)).astype(np.uint32)
    ts = (np.arange(n) / n).astype(np.float32)
    st = JaxStore(cfg, seal_threshold=rows, clock=lambda: T0, **kw)
    for lo in range(0, n, rows):
        st.add(x[lo:lo + rows], tags=tags[lo:lo + rows], ts=ts[lo:lo + rows])
    rng = np.random.default_rng(seed)
    st.delete(rng.choice(n - tail, 20, replace=False))
    up = rng.choice(n - tail, 4, replace=False)
    st.upsert(up, x[up] + 0.01, tags=tags[up], ts=ts[up])
    return st, q


@pytest.fixture(scope="module")
def carried_store():
    jcfg = tp.jax_config(n_grains=4, nprobe=3, pool=24, bit_alloc="density")
    jst, q = _jax_dense_store(jcfg)
    man = jst.snapshot()
    view = dataclasses.replace(man, segments=tuple(
        dataclasses.replace(s, index=jax.tree.map(np.asarray, s.index))
        for s in man.segments))
    pst = VectorStore(tp.port_config(jcfg), seal_threshold=128,
                      clock=lambda: T0, device="cpu")
    return jst, man, pst, manifest_from_numpy(view, "cpu"), q


STORE_SEARCHES = {"A": dict(mode="A"), "B": dict(mode="B"),
                  "B_tag": dict(mode="B", tag_mask=0b0101),
                  "B_ts": dict(mode="B", ts_range=(0.25, 0.75))}


@pytest.mark.parametrize("budgets", [None, (64, 16)])
@pytest.mark.parametrize("search", sorted(STORE_SEARCHES))
def test_store_matches_jax_store(carried_store, search, budgets):
    jst, man, pst, pman, q = carried_store
    kw = dict(topk=5, budgets=budgets, **STORE_SEARCHES[search])
    ref = jst.search(q, manifest=man, scan_impl="cascade_ref", **kw)
    dead = set(np.flatnonzero(np.asarray(
        [jst._live_seq.get(g) == -1 for g in range(jst._next_id)])).tolist())
    for name in CASCADES:
        got = pst.search(q, manifest=pman, scan_impl=name, **kw)
        _assert_same(got, ref)
        assert not dead & set(got.ids.numpy().ravel().tolist())


@pytest.mark.parametrize("budgets", [None, (64, 16)])
def test_cold_store_matches_the_jax_cold_store(budgets, tmp_path):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jcfg = tp.jax_config(n_grains=4, nprobe=3, pool=24, bit_alloc="density")
    jst, q = _jax_dense_store(jcfg, tail=0, cold_tier=True,
                              cold_dir=str(jdir))
    view = copy.copy(jst)
    view._segments = [dataclasses.replace(
        s, index=jax.tree.map(np.asarray, s.index)) for s in jst._segments]
    pst = store_from_numpy(view, "cpu", cold_dir=str(pdir))
    del view
    assert pst.cold_tier and all(s.index.raw is None for s in pst._segments)
    for mode in "AB":
        ref = jst.search(q, topk=5, mode=mode, scan_impl="cascade_ref",
                         budgets=budgets)
        for name in CASCADES:
            got = pst.search(q, topk=5, mode=mode, scan_impl=name,
                             budgets=budgets)
            _assert_same(got, ref)


def test_store_validation(carried_store):
    _, _, pst, pman, q = carried_store
    kw = dict(manifest=pman, topk=5)
    with pytest.raises(ValueError, match="< topk"):
        pst.search(q, scan_impl="cascade_ref", budgets=(64, 2), **kw)
    with pytest.raises(ValueError, match="b1 >= b2"):
        pst.search(q, scan_impl="cascade_ref", budgets=(8, 64), **kw)
    with pytest.raises(ValueError, match="b1, b2"):
        pst.search(q, scan_impl="cascade_ref", budgets=(64,), **kw)
    with pytest.raises(ValueError, match="not staged"):
        pst.search(q, scan_impl="fused_ref", budgets=(64, 8), **kw)
    with pytest.raises(ValueError, match="fused search plane"):
        pst.search(q, scan_impl="cascade_ref", budgets=(64, 8), fused=False,
                   **kw)


# ---------------------------------------------------------------------------
# The paged store (tiered residency): budgets act per pass
# ---------------------------------------------------------------------------

D_PAGED, N_PAGED, SEG_PAGED = 16, 512, 128


def _paged_store(tmp_path, budget):
    r = np.random.default_rng(0)
    x = (r.standard_normal((N_PAGED, D_PAGED)) * 3.0).astype(np.float32)
    tags = ((np.arange(N_PAGED) % 2) + 1).astype(np.uint32)
    q = (r.standard_normal((6, D_PAGED)) * 3.0).astype(np.float32)
    cfg = HNTLConfig(d=D_PAGED, k=4, s=2, block=16, n_grains=8, nprobe=4,
                     pool=32, bit_alloc="density")
    st = VectorStore(cfg, seal_threshold=SEG_PAGED, device="cpu",
                     device_budget=budget, residency_interval=4,
                     prefetch_grains=2, cold_dir=str(tmp_path))
    for lo in range(0, N_PAGED, SEG_PAGED):
        st.add(x[lo:lo + SEG_PAGED], tags=tags[lo:lo + SEG_PAGED])
    st.delete(np.arange(0, N_PAGED, 17))
    return st, q


@pytest.mark.parametrize("budget", [0, 8192])
@pytest.mark.parametrize("mode", ["A", "B"])
def test_paged_lossless_cascade_equals_all_warm(budget, mode, tmp_path):
    st, q = _paged_store(tmp_path, budget)
    for name in CASCADES:
        for kw in ({}, {"tag_mask": 2}):
            st.device_budget = None
            warm = st.search(q, topk=5, mode=mode, scan_impl=name, **kw)
            st.device_budget = budget
            paged = st.search(q, topk=5, mode=mode, scan_impl=name, **kw)
            assert torch.equal(paged.dists, warm.dists), (name, kw)
            assert torch.equal(paged.ids, warm.ids), (name, kw)


@pytest.mark.parametrize("mode", ["A", "B"])
def test_paged_budgeted_cascade_equals_paged_cascade_ref(mode, tmp_path):
    """Per-pass budgets: stage 1 on the select's kernel path and on its
    plain version give the same bits on every pass."""
    st, q = _paged_store(tmp_path, 0)
    for budgets in ((40, 8), (4096, 64)):
        got = st.search(q, topk=5, mode=mode, scan_impl="cascade",
                        budgets=budgets)
        ref = st.search(q, topk=5, mode=mode, scan_impl="cascade_ref",
                        budgets=budgets)
        assert torch.equal(got.ids, ref.ids)
        assert torch.equal(got.dists, ref.dists)
        assert (got.ids >= 0).all()


@pytest.mark.parametrize("paged", [False, True], ids=["warm", "paged"])
def test_exhaustive_budgets_equal_brute_force(paged, tmp_path):
    """budgets=(pool, pool) cover every live slot: through interleavings
    of add/seal/delete/upsert/compact/maintain the cascade still returns
    the brute-force top-k over the live set."""
    for i, (ops, seed) in enumerate([
            (("add", "seal", "delete", "upsert", "seal"), 5),
            (("seal", "delete", "maintain", "add", "compact"), 9)]):
        cold_dir = tmp_path / str(i)
        cold_dir.mkdir()
        tmp.mutation_interleaving_check(
            ops, seed, bit_alloc="density", scan_impl="cascade",
            budgeted=True, device_budget=0 if paged else None,
            cold_dir=str(cold_dir))


# ---------------------------------------------------------------------------
# int4 codec and the coordinate blob, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 8, 33])
def test_int4_pack_matches_jax(n):
    rng = np.random.default_rng(100 + n)
    ints = rng.integers(-300, 300, size=(2, n)).astype(np.int32)
    floats = (rng.standard_normal((2, n)) * 6).astype(np.float32)
    floats[0, rng.integers(0, n)] = np.nan
    for x in (ints, floats):
        packed = quantize.pack_int4(torch.from_numpy(x))
        want = np.asarray(jax_quantize.pack_int4(jnp.asarray(x)))
        assert packed.dtype == torch.uint8
        assert np.array_equal(packed.numpy(), want)
        back = quantize.unpack_int4(packed, n)
        assert back.dtype == torch.int8
        assert np.array_equal(back.numpy(), np.asarray(
            jax_quantize.unpack_int4(jnp.asarray(want), n)))
    expect = np.clip(np.round(np.nan_to_num(floats, nan=0.0)), -8, 7)
    assert np.array_equal(quantize.unpack_int4(quantize.pack_int4(
        torch.from_numpy(floats)), n).numpy(), expect.astype(np.int8))


@pytest.mark.parametrize("g, k, cap, fixed", [
    (1, 1, 4, False), (3, 5, 4, False), (6, 8, 8, False), (5, 7, 16, False),
    (4, 3, 8, True)])
def test_coordinate_blob_matches_jax(g, k, cap, fixed):
    rng = np.random.default_rng(300 + g * k)
    qm = None if fixed else rng.choice(
        [quantize.INT4_QMAX, quantize.INT8_QMAX, 8191],
        size=g).astype(np.int32)
    mags = [8191] * g if fixed else qm
    coords = np.stack([rng.integers(-m, m + 1, size=(k, cap))
                       for m in mags]).astype(np.int16)
    got = layout.pack_coords_blob(torch.from_numpy(coords),
                                  None if fixed else torch.from_numpy(qm))
    want = jax_layout.pack_coords_blob(coords, qm)
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b))
    assert np.array_equal(layout.coord_width_bits(qm, g),
                          jax_layout.coord_width_bits(qm, g))
    back = layout.unpack_coords_blob(*got, k, cap)
    assert back.dtype == np.int16 and np.array_equal(back, coords)
