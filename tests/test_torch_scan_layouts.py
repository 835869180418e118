"""The paper's Table 2 baselines in the port against the JAX package.

``repro_torch.core.scan.aos_scan`` and ``pointer_chase_scan`` (on CPU
tensors: the plain versions that the CUDA kernels of
``kernels/layout_scan.py`` are held to bit for bit on the card) and
``repro_torch.kernels.ref.topc_select_ref`` against ``repro.core.scan``
and ``repro.kernels.ref`` on the same integer inputs, made with numpy
from a seed.

Tolerances:

- ``aos_scan`` is bit-equal to the JAX function evaluated op by op, and
  on the transposed layout to ``blocksoa_scan`` (the shared op order).
  Compiled with ``jax.jit``, XLA on the CPU contracts the epilogue's
  multiply-add into an FMA, which the port rounds in two steps: there
  the results agree to rtol 1e-6.
- ``pointer_chase_scan``'s loop is a ``lax.scan``, which XLA always
  compiles, so the same contraction applies: the port agrees with it to
  rtol 1e-6.  Bit for bit, the port equals the JAX op order evaluated op
  by op on the rows JAX visits, and its visit order equals JAX's
  exactly (read off JAX's own scan with distances set to row numbers),
  the clamp and wrap of bad pointers included.
- ``topc_select_ref``: equal, ids included (ties keep the lower index).
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import scan as jax_scan
from repro.kernels import ref as jax_ref
from repro_torch.core import scan as port_scan
from repro_torch.core.types import BIG
from repro_torch.kernels import layout_scan
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import scan_cases as sc

#: XLA on the CPU may contract a multiply-add that the port rounds twice.
JIT_RTOL = 1e-6

_jit_aos = jax.jit(jax_scan.aos_scan)
_jit_chase = jax.jit(jax_scan.pointer_chase_scan, static_argnums=6)


def _t(v):
    return torch.from_numpy(np.ascontiguousarray(v) if np.ndim(v) else
                            np.asarray(v))


def _j(v):
    return jnp.asarray(v)


AOS_CASES = {
    "k=8 int16": dict(p=3, cap=200, k=8),
    "k=1 int16": dict(p=2, cap=130, k=1),
    "k=33 int32": dict(p=2, cap=77, k=33, coord_dtype=np.int32),
    "invalid slots int16": dict(p=4, cap=96, k=16, valid_frac=0.3),
    "all invalid int32": dict(p=2, cap=40, k=8, valid_frac=0.0,
                              coord_dtype=np.int32),
    "int32 wraparound": dict(p=2, cap=64, k=32, coord_dtype=np.int32,
                             coord_range=2 ** 31 - 1, zq_range=2 ** 31 - 1),
}


@pytest.mark.parametrize("case", sorted(AOS_CASES))
def test_aos_scan_matches_jax(case):
    a = sc.aos(sorted(AOS_CASES).index(case), **AOS_CASES[case])
    got = port_scan.aos_scan(*sc.aos_args(a, _t))
    assert got.dtype == torch.float32
    got = got.numpy()
    jargs = sc.aos_args(a, _j)
    np.testing.assert_array_equal(got, np.asarray(jax_scan.aos_scan(*jargs)))
    np.testing.assert_allclose(got, np.asarray(_jit_aos(*jargs)),
                               rtol=JIT_RTOL, atol=0)
    assert (got[~a["valid"]] == np.float32(BIG)).all()


@pytest.mark.parametrize("k,dtype", [(1, np.int16), (8, np.int16),
                                     (33, np.int32)])
def test_aos_on_transposed_layout_equals_blocksoa(k, dtype):
    a = sc.single(sc.panels(100 + k, p=3, q=1, k=k, cap=150,
                            coord_dtype=dtype))
    soa = sc.args(a, _t)
    aos = list(soa)
    aos[2] = soa[2].transpose(1, 2).contiguous()
    want = port_scan.blocksoa_scan(*soa)
    got = port_scan.aos_scan(*aos)
    assert torch.equal(got, want)
    jsoa = [_j(t.numpy()) for t in soa]
    jaos = [_j(t.numpy()) for t in aos]
    np.testing.assert_array_equal(
        np.asarray(jax_scan.aos_scan(*jaos)),
        np.asarray(jax_scan.blocksoa_scan(*jsoa)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_scan.blocksoa_scan(*jsoa)))


CHASE_CASES = {
    "n_steps < N": dict(n=50, k=8, n_steps=17),
    "n_steps == N": dict(n=50, k=8, n_steps=50),
    "n_steps > N": dict(n=50, k=8, n_steps=173),
    "int16 rows k=33": dict(n=40, k=33, n_steps=40, coord_dtype=np.int16),
    "bad pointers": dict(n=60, k=8, n_steps=150, bad_ptrs=12),
    "head 0, bad pointers": dict(n=30, k=4, n_steps=70, head=0, bad_ptrs=6),
    "head N-1": dict(n=30, k=4, n_steps=70, head=29, bad_ptrs=6),
    "head -1": dict(n=30, k=4, n_steps=20, head=-1),
    "head -N-3": dict(n=30, k=4, n_steps=20, head=-33),
    "head past N": dict(n=30, k=4, n_steps=20, head=1000),
    "int32 wraparound": dict(n=30, k=32, n_steps=30, coord_range=2 ** 31 - 1,
                             zq_range=2 ** 31 - 1),
    "N=1": dict(n=1, k=8, n_steps=4),
}


def _chase(case):
    return sc.chase(200 + sorted(CHASE_CASES).index(case),
                    **CHASE_CASES[case])


def _jax_visit_order(a):
    """The rows JAX's ``pointer_chase_scan`` visits: with zq, coordinates
    and scale 0, res_flat = row number and res_scale 1, each distance is
    its row number, exactly."""
    n = a["next_ptr"].shape[0]
    d = np.asarray(jax_scan.pointer_chase_scan(
        jnp.zeros(a["zq"].shape, jnp.int32), np.float32(0),
        jnp.zeros(a["coords_flat"].shape, jnp.int32),
        jnp.arange(n, dtype=jnp.int32), _j(a["next_ptr"]), _j(a["head"]),
        a["n_steps"], np.float32(0), np.float32(1)))
    return d.astype(np.int64)


@pytest.mark.parametrize("case", sorted(CHASE_CASES))
def test_pointer_chase_visits_the_rows_jax_visits(case):
    a = _chase(case)
    want = _jax_visit_order(a)
    got = port_ref.chase_order(_t(a["next_ptr"]), int(a["head"]),
                               a["n_steps"])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(CHASE_CASES))
def test_pointer_chase_scan_matches_jax(case):
    a = _chase(case)
    got = port_scan.pointer_chase_scan(*sc.chase_args(a, _t))
    assert got.dtype == torch.float32 and got.shape == (a["n_steps"],)
    got = got.numpy()
    jargs = sc.chase_args(a, _j)
    np.testing.assert_allclose(got, np.asarray(_jit_chase(*jargs)),
                               rtol=JIT_RTOL, atol=0)
    # Bit for bit: the JAX op order, op by op, on the rows JAX visits.
    rows = _jax_visit_order(a)
    c = _j(a["coords_flat"])[rows].astype(jnp.int32)
    diff = _j(a["zq"]) - c
    d = jnp.sum(diff * diff, axis=-1).astype(jnp.float32) * a["scale"] \
        * a["scale"]
    d = d + _j(a["res_flat"])[rows].astype(jnp.float32) * a["res_scale"] \
        + a["rq"]
    np.testing.assert_array_equal(got, np.asarray(d))


def test_pointer_chase_scan_takes_numbers_and_tensors():
    a = _chase("bad pointers")
    args = sc.chase_args(a, _t)
    want = port_scan.pointer_chase_scan(*args)
    plain = [float(a["rq"]), int(a["head"]), float(a["scale"]),
             float(a["res_scale"])]
    got = port_scan.pointer_chase_scan(
        args[0], plain[0], args[2], args[3], args[4], plain[1],
        a["n_steps"], plain[2], plain[3])
    assert torch.equal(got, want)
    jgot = np.asarray(jax_scan.pointer_chase_scan(
        *sc.chase_args(a, _j)[:1], plain[0], *sc.chase_args(a, _j)[2:5],
        plain[1], a["n_steps"], plain[2], plain[3]))
    np.testing.assert_allclose(got.numpy(), jgot, rtol=JIT_RTOL, atol=0)


def test_pointer_chase_scan_of_no_steps_is_empty():
    a = _chase("n_steps < N")
    args = sc.chase_args(a, _t)
    args[6] = 0
    out = port_scan.pointer_chase_scan(*args)
    assert out.shape == (0,) and out.dtype == torch.float32
    jargs = sc.chase_args(a, _j)
    jargs[6] = 0
    assert np.asarray(jax_scan.pointer_chase_scan(*jargs)).shape == (0,)


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    before = (layout_scan.aos_scan.launches,
              layout_scan.pointer_chase_scan.launches)
    a = sc.aos(7, p=2, cap=50, k=8)
    assert torch.equal(layout_scan.aos_scan(*sc.aos_args(a, _t)),
                       port_ref.aos_scan_ref(*sc.aos_args(a, _t)))
    c = _chase("n_steps > N")
    assert torch.equal(layout_scan.pointer_chase_scan(*sc.chase_args(c, _t)),
                       port_ref.pointer_chase_scan_ref(
                           *sc.chase_args(c, _t)))
    assert (layout_scan.aos_scan.launches,
            layout_scan.pointer_chase_scan.launches) == before


TOPC_CASES = {
    "exact ties": (np.array([[3., 1., 2., 1., 3., 1., 0.5, 2.]]), 5),
    "all equal": (np.full((2, 9), 7.25), 4),
    "ties at the cut": (np.array([[4., 2., 2., 9., 2., 1.],
                                  [0., 0., 1., 1., 0., 1.]]), 3),
    "BIG padding": (np.array([[BIG, 1., BIG, BIG, 2.]]), 4),
    "c = M": (np.array([[2., 1., 2., 1.]]), 4),
    "random with ties": (np.random.default_rng(3).integers(
        0, 6, (4, 40)).astype(np.float64) / 4, 12),
}


@pytest.mark.parametrize("case", sorted(TOPC_CASES))
def test_topc_select_ref_matches_jax(case):
    d, c = TOPC_CASES[case]
    d = d.astype(np.float32)
    ids = (np.arange(d.size).reshape(d.shape) * 7 + 3).astype(np.int32)
    gd, gi = port_ref.topc_select_ref(_t(d), _t(ids), c)
    wd, wi = jax_ref.topc_select_ref(_j(d), _j(ids), c)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert gi.dtype == torch.int32


def test_topc_select_ref_refuses_c_above_m():
    with pytest.raises(ValueError, match="c=5"):
        port_ref.topc_select_ref(torch.zeros(1, 4), torch.zeros(
            1, 4, dtype=torch.int32), 5)
