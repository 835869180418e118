"""The port's build against the JAX package's.

k-means seeds cannot match (``jax.random`` vs ``torch.Generator``), so
both builds get the JAX package's centroids through ``centroids=``.  Then:
the greedy pass of the balanced assignment, fed the reference's
distances, gives exactly the reference's assignment; slots are exact;
the PCA frames span the same subspaces (projectors within 1e-4; bases
differ by eigenvector signs); var_captured and the coordinate scales
agree to rtol 1e-4.  The port's own build (its own k-means) must reach
the JAX package's recall@10 less 0.02.
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import jax
import numpy as np
import torch

from repro.core import index as jax_index
from repro.core import kmeans as jax_kmeans
from repro.core import layout as jax_layout
from repro.core.flat import flat_search as jax_flat
from repro_torch.core import build as port_build
from repro_torch.core import kmeans as port_kmeans
from repro_torch.core import layout as port_layout
from repro_torch.core import search as port_search
from repro_torch.core.flat import flat_search, recall_at_k

import torch_parity as tp


@pytest.fixture(scope="module")
def data():
    x, q = tp.corpus(n=2048, nq=32, seed=2)
    cfg = tp.jax_config()
    cents, _ = jax_kmeans.kmeans(jax.random.PRNGKey(cfg.seed),
                                 jax.numpy.asarray(x), cfg.n_grains,
                                 iters=cfg.kmeans_iters)
    return x, q, cfg, np.asarray(cents)


def _ref_order(x, cents):
    """The reference's own distances, full preference order and gap."""
    d2 = (np.sum(x * x, axis=1, keepdims=True) - 2.0 * x @ cents.T
          + np.sum(cents * cents, axis=1)[None, :])
    order = np.argsort(d2, axis=1)
    n = np.arange(len(x))
    return order, d2[n, order[:, 0]] - d2[n, order[:, 1]]


@pytest.mark.parametrize("n_pref,cap", [(16, 384), (2, 272), (2, 256),
                                        (3, 200)])
def test_greedy_pass_is_the_reference_assignment(data, n_pref, cap):
    """cap 256 * 8 grains == N: the last points find every grain full;
    cap 200: some fall back to their first choice.  n_pref 2 and 3 force
    the full-order fallback."""
    x, _, cfg, cents = data
    order, gap = _ref_order(x, cents)
    got = port_kmeans.greedy_assign(order[:, :n_pref], gap, cap,
                                    cfg.n_grains, lambda i: order[i])
    ref = jax_kmeans.balanced_assign(x, cents, cap)
    assert np.array_equal(got, ref)


def test_pack_grains_slots_are_exact(data):
    x, _, cfg, cents = data
    assign = jax_kmeans.balanced_assign(x, cents, 384)
    for cap in (None, 512):
        ref = jax_layout.pack_grains(assign, cfg.n_grains, cfg.block, cap)
        got = port_layout.pack_grains(assign, cfg.n_grains, cfg.block, cap)
        assert np.array_equal(got[0], ref[0]) and got[2] == ref[2]
        assert np.array_equal(got[3], ref[3]) and got[3].dtype == np.int32
    with pytest.raises(ValueError, match="overflow"):
        port_layout.pack_grains(assign, cfg.n_grains, cfg.block, 16)


@pytest.fixture(scope="module")
def both(data):
    x, q, cfg, cents = data
    jidx, jinfo = jax_index.build(x, cfg, centroids=cents)
    pidx, pinfo = port_build(x, tp.port_config(cfg), centroids=cents,
                             device="cpu")
    return jidx, jinfo, pidx, pinfo


def test_build_layout_matches(both):
    jidx, jinfo, pidx, pinfo = both
    assert pinfo.cap == jinfo.cap
    for f in ("ids", "valid"):
        assert np.array_equal(getattr(pidx.grains, f).numpy(),
                              np.asarray(getattr(jidx.grains, f)))
    assert np.array_equal(pidx.routing.sizes.numpy(),
                          np.asarray(jidx.routing.sizes))
    np.testing.assert_allclose(pidx.grains.mu.numpy(),
                               np.asarray(jidx.grains.mu), rtol=1e-5,
                               atol=1e-6)
    for f in ("coords", "res", "sketch", "ids", "valid", "basis", "mu",
              "scale", "res_scale", "sketch_basis", "sketch_scale"):
        pt, jt = getattr(pidx.grains, f), np.asarray(getattr(jidx.grains, f))
        assert pt.shape == jt.shape and str(pt.dtype)[6:] == str(jt.dtype)


def test_pca_subspaces_match(both):
    jidx, jinfo, pidx, pinfo = both
    w = pidx.grains.basis.numpy()
    wj = np.asarray(jidx.grains.basis)
    proj = w @ np.swapaxes(w, 1, 2)
    proj_j = wj @ np.swapaxes(wj, 1, 2)
    assert np.abs(proj - proj_j).max() <= 1e-4
    np.testing.assert_allclose(pinfo.var_captured, jinfo.var_captured,
                               rtol=1e-4)
    assert abs(pinfo.var_captured_mean - jinfo.var_captured_mean) <= 1e-4


def test_scales_match(both):
    jidx, _, pidx, _ = both
    np.testing.assert_allclose(pidx.grains.scale.numpy(),
                               np.asarray(jidx.grains.scale), rtol=1e-4)


def test_own_build_recall_reaches_the_reference(data):
    x, q, cfg, _ = data
    truth = np.asarray(jax_flat(jax.numpy.asarray(x), jax.numpy.asarray(q),
                                topk=10).ids)
    jidx, _ = jax_index.build(x, cfg)
    ref = recall_at_k(np.asarray(jax_index.search(jidx, q, cfg,
                                                  topk=10).ids), truth)
    pidx, _ = port_build(x, tp.port_config(cfg), device="cpu")
    got = recall_at_k(port_search(pidx, q, tp.port_config(cfg),
                                  topk=10).ids, truth)
    assert got >= ref - 0.02, (got, ref)
    # the port's own flat oracle agrees with the reference's
    port_truth = flat_search(torch.from_numpy(x), torch.from_numpy(q), 10,
                             chunk=500).ids.numpy()
    assert recall_at_k(port_truth, truth) == 1.0
