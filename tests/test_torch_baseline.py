"""The port's HNSW baseline and its last core helpers against the JAX
package's.

- ``core.hnsw.HNSW``: the same seed and data build the same graph and
  return the same ids and distances as the reference's numpy HNSW;
- ``pca.project`` / ``reconstruct`` / ``residual`` and
  ``quantize.dequantize_coords`` / ``dequantize_residual`` match JAX to
  1e-6;
- ``dequantize_coords(quantize_coords(z))`` holds the reference's
  round-trip bound (``tests/test_core_index.py``: within scale / 2 +
  1e-5 at an int32-safe qmax).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import hnsw as ref_hnsw  # noqa: E402
from repro.core import pca as ref_pca  # noqa: E402
from repro.core import quantize as ref_quantize  # noqa: E402
from repro_torch.core import hnsw, pca, quantize  # noqa: E402
from repro_torch.core.index import int32_safe_qmax  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

TOL = 1e-6


def test_hnsw_equals_the_reference():
    x = synthetic.clustered(600, 16, n_clusters=12, seed=1)
    q = synthetic.queries_from(x, nq=10)
    mine = hnsw.HNSW(16, m=8, ef_construction=40, seed=3).build(x)
    ref = ref_hnsw.HNSW(16, m=8, ef_construction=40, seed=3).build(x)
    assert mine.levels == ref.levels and mine.entry == ref.entry
    assert mine.graph_bytes() == ref.graph_bytes()
    ids, d = mine.search(q, topk=5, ef_search=20)
    rids, rd = ref.search(q, topk=5, ef_search=20)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(d, rd)
    one_ids, one_d = mine.search(q[0], topk=5)
    assert one_ids.shape == (5,) and one_d.shape == (5,)
    assert mine.vector_bytes() == x.size * 4


def test_pca_helpers_match_jax():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((7, 12)).astype(np.float32)
    w = np.linalg.qr(rng.standard_normal((12, 5)))[0].astype(np.float32)
    z = np.asarray(ref_pca.project(jnp.asarray(v), jnp.asarray(w)))
    zt = pca.project(torch.from_numpy(v), torch.from_numpy(w))
    np.testing.assert_allclose(zt.numpy(), z, rtol=0, atol=TOL)
    rec = np.asarray(ref_pca.reconstruct(jnp.asarray(z), jnp.asarray(w)))
    np.testing.assert_allclose(
        pca.reconstruct(torch.from_numpy(z), torch.from_numpy(w)).numpy(),
        rec, rtol=0, atol=TOL)
    res = np.asarray(ref_pca.residual(jnp.asarray(v), jnp.asarray(z),
                                      jnp.asarray(w)))
    got = pca.residual(torch.from_numpy(v), torch.from_numpy(z),
                       torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, res, rtol=0, atol=TOL)
    # the residual is orthogonal to the basis
    assert np.abs(got @ w).max() < 1e-5


def test_dequantize_helpers_match_jax_and_round_trip():
    rng = np.random.default_rng(2)
    cap, live, k = 64, 40, 24
    z = np.zeros((cap, k), np.float32)
    z[:live] = rng.standard_normal((live, k)).astype(np.float32) * 5.0
    mask = np.zeros(cap, bool)
    mask[:live] = True
    qmax = int32_safe_qmax(k)
    scale = quantize.fit_scale(torch.from_numpy(z), torch.from_numpy(mask),
                               qmax=qmax)
    zq = quantize.quantize_coords(torch.from_numpy(z[:live]), scale,
                                  qmax=qmax)
    assert int((zq.abs() >= qmax).sum()) == 0
    deq = quantize.dequantize_coords(zq, scale)
    assert float((deq - torch.from_numpy(z[:live])).abs().max()) \
        <= float(scale) * 0.5 + 1e-5
    ref = np.asarray(ref_quantize.dequantize_coords(
        jnp.asarray(zq.numpy()), jnp.asarray(scale.numpy())))
    np.testing.assert_allclose(deq.numpy(), ref, rtol=0, atol=TOL)

    r = np.abs(rng.standard_normal(cap)).astype(np.float32)
    rs = quantize.fit_res_scale(torch.from_numpy(r), torch.from_numpy(mask))
    rq = quantize.quantize_residual(torch.from_numpy(r), rs)
    got = quantize.dequantize_residual(rq, rs)
    assert got.dtype == torch.float32
    ref = np.asarray(ref_quantize.dequantize_residual(
        jnp.asarray(rq.numpy()), jnp.asarray(rs.numpy())))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)
    assert float((got[:live] - torch.from_numpy(r[:live])).abs().max()) \
        <= float(rs) * 0.5 + 1e-6
