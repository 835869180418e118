"""Quantization and routing: each port function against its JAX twin.

Integer outputs are exact; floats agree to rtol 1e-6.  ``torch.round`` and
``jnp.round`` both round half to even.  ``route`` breaks ties to the lower
grain index through a stable sort.
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import quantize as jq
from repro.core import routing as jr
from repro.core.types import RoutingPlane as JaxPlane
from repro_torch.core import quantize as tq
from repro_torch.core import routing as tr
from repro_torch.core.types import RoutingPlane as PortPlane

T = torch.from_numpy


def _z(seed, g=5, cap=40, k=4):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((g, cap, k)) * rng.uniform(0.1, 3, (g, 1, 1))) \
        .astype(np.float32)
    mask = rng.random((g, cap)) < 0.7
    mask[1] = False                      # an all-padding grain
    mask[2, :3] = True
    mask[2, 3:] = False                  # a nearly empty grain
    z[~mask] = rng.standard_normal(z[~mask].shape) * 100   # padded garbage
    return z, mask


@pytest.mark.parametrize("qmax", [32767, 127, "per_grain"])
def test_fit_scale(qmax):
    z, mask = _z(0)
    if qmax == "per_grain":
        qm = np.array([7, 127, 7, 127, 8191], np.float32)
        ref = np.stack([np.asarray(jq.fit_scale(z[i], mask[i], qmax=qm[i]))
                        for i in range(len(z))])
        got = tq.fit_scale(T(z), T(mask), qmax=T(qm)).numpy()
    else:
        ref = np.stack([np.asarray(jq.fit_scale(z[i], mask[i], qmax=qmax))
                        for i in range(len(z))])
        got = tq.fit_scale(T(z), T(mask), qmax=qmax).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_fit_scale_quantile_and_mult():
    z, mask = _z(1)
    ref = np.stack([np.asarray(jq.fit_scale(z[i], mask[i], quantile=0.9,
                                            mult=2.0))
                    for i in range(len(z))])
    got = tq.fit_scale(T(z), T(mask), quantile=0.9, mult=2.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_fit_res_scale():
    z, mask = _z(2)
    r = np.abs(z[..., 0]) * 10
    r[0, ~mask[0]] = np.nan              # NaN garbage on padded rows
    ref = np.stack([np.asarray(jq.fit_res_scale(r[i], mask[i]))
                    for i in range(len(r))])
    got = tq.fit_res_scale(T(r), T(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("qmax", [8191, 127, "per_grain"])
def test_quantize_coords_exact(qmax):
    rng = np.random.default_rng(3)
    z = rng.standard_normal((6, 50, 4)).astype(np.float32) * 3
    scale = rng.uniform(1e-3, 1e-1, (6, 1, 1)).astype(np.float32)
    # exact half-way points: round half to even in both packages
    z[0, :4, 0] = np.array([0.5, 1.5, 2.5, -2.5], np.float32) * scale[0, 0, 0]
    qm = np.array([7, 127, 7, 127, 8191, 7], np.int32)[:, None, None] \
        if qmax == "per_grain" else qmax
    ref = np.asarray(jq.quantize_coords(jnp.asarray(z), jnp.asarray(scale),
                                        qmax=jnp.asarray(qm)
                                        if qmax == "per_grain" else qm))
    got = tq.quantize_coords(T(z), T(scale),
                             qmax=T(qm) if qmax == "per_grain" else qm)
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), ref)


def test_round_half_to_even_in_both():
    v = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5], np.float32)
    assert np.array_equal(torch.round(T(v)).numpy(),
                          np.asarray(jnp.round(jnp.asarray(v))))


def test_quantize_residual_exact():
    rng = np.random.default_rng(4)
    r = rng.uniform(0, 10, (6, 50)).astype(np.float32)
    rs = rng.uniform(1e-4, 1e-3, (6, 1)).astype(np.float32)
    ref = np.asarray(jq.quantize_residual(jnp.asarray(r), jnp.asarray(rs)))
    got = tq.quantize_residual(T(r), T(rs))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


def test_saturation_and_envelope():
    rng = np.random.default_rng(5)
    z = rng.standard_normal((8, 3, 4)).astype(np.float32)
    scale = rng.uniform(1e-4, 1e-3, (8, 3, 1)).astype(np.float32)
    qm = rng.choice([7, 127, 8191], size=(8, 3, 1)).astype(np.int32)
    for qmax in (8191, qm):
        jqm = jnp.asarray(qmax) if isinstance(qmax, np.ndarray) else qmax
        tqm = T(qmax) if isinstance(qmax, np.ndarray) else qmax
        np.testing.assert_allclose(
            tq.saturation_fraction(T(z), T(scale), tqm).numpy(),
            np.asarray(jq.saturation_fraction(jnp.asarray(z),
                                              jnp.asarray(scale), jqm)),
            rtol=1e-6)
        assert np.array_equal(
            tq.envelope_keep(T(z), T(scale), 0.25, tqm).numpy(),
            np.asarray(jq.envelope_keep(jnp.asarray(z), jnp.asarray(scale),
                                        0.25, jqm)))


def test_assign_grain_qmax():
    captured = np.array([0.9, 0.5, 0.85, 0.99, 0.86], np.float32)
    live = np.array([10, 100, 8, 3, 8], np.int32)
    ref = np.asarray(jq.assign_grain_qmax(jnp.asarray(captured),
                                          jnp.asarray(live),
                                          captured_min=0.85, min_rows=8))
    got = tq.assign_grain_qmax(T(captured), T(live), captured_min=0.85,
                               min_rows=8)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ref)


def _planes(c, sizes):
    return (JaxPlane(centroids=jnp.asarray(c), sizes=jnp.asarray(sizes)),
            PortPlane(centroids=T(c), sizes=T(sizes)))


def test_centroid_d2_and_route():
    rng = np.random.default_rng(6)
    c = rng.standard_normal((12, 16)).astype(np.float32)
    sizes = rng.integers(0, 5, 12).astype(np.int32)
    sizes[3] = 0                                   # an empty grain
    q = rng.standard_normal((9, 16)).astype(np.float32)
    jp, tp_ = _planes(c, sizes)
    for gm in (None, rng.random(12) < 0.8, rng.random((9, 12)) < 0.8):
        jgm = None if gm is None else jnp.asarray(gm)
        tgm = None if gm is None else T(gm)
        np.testing.assert_allclose(
            tr._centroid_d2(tp_, T(q), tgm).numpy(),
            np.asarray(jr._centroid_d2(jp, jnp.asarray(q), jgm)), rtol=1e-5,
            atol=1e-5)
        ji, jd = jr.route(jp, jnp.asarray(q), 5, jgm)
        ti, td = tr.route(tp_, T(q), 5, tgm)
        assert ti.dtype == torch.int32
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-5)


def test_route_ties_break_to_lower_index():
    """Duplicate centroids give exactly equal distances; the lower grain
    index must come first, as with lax.top_k."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((3, 16)).astype(np.float32)
    c = np.concatenate([base, base, base])[[0, 3, 1, 6, 4, 2, 7, 5, 8]]
    sizes = np.ones(9, np.int32)
    q = rng.standard_normal((6, 16)).astype(np.float32)
    jp, tp_ = _planes(c, sizes)
    ji, _ = jr.route(jp, jnp.asarray(q), 9)
    ti, _ = tr.route(tp_, T(q), 9)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    for row in ti.numpy():                         # equal-d2 runs ascend
        for a, b in zip(row[:-1], row[1:]):
            if np.array_equal(c[a], c[b]):
                assert a < b
