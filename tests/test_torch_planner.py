"""The slice end to end: search on a JAX-built index, in both packages.

The index is built by ``repro.core.index.build`` and carried across with
``index_from_numpy``; ``repro_torch.core.search`` with the "ref" and
"fused_ref" planes (and "auto", which is "ref" on the CPU, and "fused",
whose CPU path is its plain version) must give the ids of
``repro.core.index.search``, with dists within rtol 1e-5 and atol 1e-5
(the JAX package's own plane-parity tolerance): the f32 projection and
re-rank sums are taken in another order, and the query residual
rq = ||q - mu||^2 - ||zq||^2 - ||sq||^2 cancels, so a Mode A distance
near 0 carries an absolute error of a few ulps of ||q - mu||^2.
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import numpy as np
import torch

from repro.core import index as jax_index
from repro_torch.core import planner, search as port_search
from repro_torch.core.types import BIG

import torch_parity as tp

PLANES = ["ref", "fused_ref", "fused", None]


@pytest.fixture(scope="module", params=["sketch", "no_sketch", "density"])
def built(request):
    kw = {"sketch": {}, "no_sketch": {"s": 0},
          "density": {"bit_alloc": "density"}}[request.param]
    x, q = tp.corpus(n=2048, nq=8, seed=1)
    cfg = tp.jax_config(**kw)
    idx, _ = tp.jax_build(x, cfg)
    return cfg, idx, tp.port_config(cfg), tp.port_index(idx), x, q


def _extra_mask(idx, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random(np.asarray(idx.grains.valid).shape) < 0.6


def _assert_same(port, ref):
    assert np.array_equal(port.ids.numpy().astype(np.int64),
                          np.asarray(ref.ids, np.int64))
    np.testing.assert_allclose(port.dists.numpy(), np.asarray(ref.dists),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["A", "B"])
@pytest.mark.parametrize("plane", PLANES)
def test_search_matches_jax(built, mode, plane):
    jcfg, jidx, cfg, idx, _, q = built
    ref = jax_index.search(jidx, q, jcfg, topk=5, mode=mode)
    got = port_search(idx, q, cfg, topk=5, mode=mode, scan_impl=plane)
    _assert_same(got, ref)


@pytest.mark.parametrize("mode", ["A", "B"])
@pytest.mark.parametrize("plane", ["ref", "fused_ref"])
def test_search_with_extra_mask_matches_jax(built, mode, plane):
    jcfg, jidx, cfg, idx, _, q = built
    em = _extra_mask(jidx)
    ref = jax_index.search(jidx, q, jcfg, topk=5, mode=mode, extra_mask=em)
    got = port_search(idx, q, cfg, topk=5, mode=mode, scan_impl=plane,
                      extra_mask=em)
    _assert_same(got, ref)
    valid = np.asarray(jidx.grains.valid) & em
    allowed = set(np.asarray(jidx.grains.ids)[valid].tolist())
    ids = got.ids.numpy()
    assert set(ids[ids >= 0].tolist()) <= allowed


def test_query_batching_changes_nothing(built, monkeypatch):
    _, _, cfg, idx, _, q = built
    whole = port_search(idx, q, cfg, topk=5, scan_impl="fused_ref")
    for qb in (1, 3):
        monkeypatch.setattr(planner, "QUERY_BATCH", qb)
        part = port_search(idx, q, cfg, topk=5, scan_impl="fused_ref")
        assert torch.equal(part.ids, whole.ids)
        assert torch.equal(part.dists, whole.dists)


def test_select_and_gather_candidates_agree(built):
    """The fused_ref pool is the head of the gather plane's sorted slots."""
    _, _, cfg, idx, _, q = built
    qt = torch.from_numpy(q)
    gids, _ = planner.routing.route(idx.routing, qt, cfg.nprobe)
    kw = dict(envelope_frac=cfg.envelope_frac, qeff=8191)
    dg, ig = planner.candidate_stage(idx, qt, gids, width=16,
                                     scan_impl="ref", **kw)
    ds, rs = planner.candidate_stage(idx, qt, gids, width=16,
                                     scan_impl="fused_ref", **kw)
    sd, pos = torch.sort(dg, dim=1, stable=True)
    head = torch.gather(ig, 1, pos)[:, :16]
    assert torch.equal(ds, sd[:, :16])
    assert torch.equal(rs, torch.where(ds < BIG / 2, head, -1))


def test_budgets_are_refused_until_the_cascade_is_ported(built):
    """Budgets need a staged plane (the cascade, ``test_torch_cascade.py``):
    any other plane refuses them, and invalid budgets are refused first."""
    _, _, cfg, idx, _, q = built
    for plane in ("ref", "fused_ref", None):
        with pytest.raises(ValueError, match="not staged"):
            planner.search(idx, torch.from_numpy(q), nprobe=4, pool=16,
                           topk=5, scan_impl=plane, budgets=(32, 16))
    with pytest.raises(ValueError, match="b1 >= b2"):
        planner.search(idx, torch.from_numpy(q), nprobe=4, pool=16, topk=5,
                       scan_impl="cascade", budgets=(8, 16))


@pytest.mark.parametrize("name", ["pallas", "interpret", "mosaic", "nope"])
def test_unported_planes_raise(built, name):
    _, _, cfg, idx, _, q = built
    with pytest.raises(ValueError, match="registered"):
        port_search(idx, q, cfg, topk=5, scan_impl=name)
