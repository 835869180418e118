"""The port's fused scan→select plain version against the JAX package.

``repro_torch``'s ``fused_scan_select_ref`` (what the "fused" plane runs
on CPU tensors, and what the CUDA kernel is held to bit for bit on the
card) against the JAX Pallas kernel in interpret mode and against the JAX
package's own oracle ``blocksoa_select_ref``, on the same integer inputs.
Rows must be equal; dists agree to rtol 1e-6 (XLA on the CPU may contract
a multiply-add that the port rounds in two steps).
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import scan as jax_scan
from repro.kernels import fused_select as jax_fused
from repro_torch.core import scan as port_scan
from repro_torch.core.types import BIG
from repro_torch.kernels import fused_select as port_fused
from repro_torch.kernels import select_cases

import torch_parity as tp

CASES = {
    "plain": dict(q=4, p=3, g=6, k=4, cap=128, width=32),
    "sketch": dict(q=4, p=3, g=6, k=4, cap=128, width=32, s=2),
    "tenant": dict(q=4, p=3, g=6, k=4, cap=128, width=32, s=2, tenants=3),
    "ragged_probes": dict(q=5, p=4, g=6, k=4, cap=128, width=32, ragged=True),
    "ragged_cap_width": dict(q=3, p=3, g=5, k=4, cap=150, width=45, s=2),
    "single_query": dict(q=1, p=3, g=6, k=4, cap=128, width=20),
    "k1_stage1_shape": dict(q=3, p=3, g=6, k=1, cap=96, width=40, s=2),
    "width_beyond_slots": dict(q=2, p=2, g=4, k=4, cap=40, width=100),
}

def _run_all(a, width):
    jargs, jkw = select_cases.split(a, jnp.asarray)
    targs, tkw = select_cases.split(a, torch.from_numpy)
    out = {
        "jax_kernel": jax_fused.fused_scan_select(*jargs, width=width,
                                                  interpret=True, **jkw),
        "jax_oracle": jax_scan.blocksoa_select_ref(*jargs, width=width,
                                                   **jkw),
        "port": port_fused.fused_scan_select(*targs, width=width, **tkw),
    }
    return {k: (np.asarray(d), np.asarray(r)) for k, (d, r) in out.items()}


def _assert_agree(out):
    pd, pr = out["port"]
    for name in ("jax_kernel", "jax_oracle"):
        d, r = out[name]
        assert np.array_equal(pr.astype(np.int64), r.astype(np.int64)), name
        np.testing.assert_allclose(pd, d, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_select_matches_jax(case):
    c = dict(CASES[case])
    width = c.pop("width")
    a = tp.select_inputs(sorted(CASES).index(case), **c)
    out = _run_all(a, width)
    _assert_agree(out)
    d, r = out["port"]
    assert d.shape == (c["q"], width) and r.dtype == np.int32
    assert np.all(np.diff(d, axis=1) >= 0)                 # ascending
    assert np.all((r == -1) == (d >= BIG / 2))


def test_fully_pruned_pool_is_all_empty():
    a = tp.select_inputs(11, q=3, p=3, g=5, k=4, cap=64, s=2)
    a["keep"][:] = False
    out = _run_all(a, 16)
    _assert_agree(out)
    d, r = out["port"]
    assert np.all(r == -1) and np.all(d == np.float32(BIG))


@pytest.mark.parametrize("width", [10, 300])
def test_every_slot_entering_the_pool_matches_jax(width):
    """Each slot nearer than all before it: the pool is the last `width`
    slots visited, nearest first (the kernel's buffer-fold stress case)."""
    a = select_cases.descending_inputs(q=2, p=3, k=4, cap=128)
    out = _run_all(a, width)
    _assert_agree(out)
    d, r = out["port"]
    last = np.arange(3 * 128 - 1, 3 * 128 - 1 - width, -1)
    assert np.array_equal(r, np.tile(last, (2, 1)))
    assert np.array_equal(d, np.tile(-last.astype(np.float32), (2, 1)))


def test_exact_ties_break_by_probe_then_slot():
    """Equal distances across two probes and within one tile: the earlier
    (probe, slot) wins, as the JAX carry's lax.top_k does."""
    q, p, g, k, cap = 1, 3, 4, 2, 64
    a = dict(gids=np.array([[2, 0, 2]], np.int32),
             zq=np.zeros((q, p, k), np.int32),
             rq=np.zeros((q, p), np.float32),
             keep=np.ones((q, p), bool),
             coords=np.zeros((g, k, cap), np.int16),
             res=np.full((g, cap), 2, np.int32),
             mask=np.ones((g, cap), bool),
             rows=np.arange(g * cap, dtype=np.int32).reshape(g, cap),
             scale=np.ones(g, np.float32),
             res_scale=np.ones(g, np.float32))
    # distance 1 at slots 5, 9, 40 of every grain, 0 at slot 7 of grain 0,
    # 2 elsewhere
    a["res"][:, [5, 9, 40]] = 1
    a["res"][0, 7] = 0
    out = _run_all(a, 8)
    _assert_agree(out)
    d, r = out["port"]
    # grain 0 is probe 1; grain 2 is probes 0 and 2 (a duplicate probe)
    assert r[0, 0] == 0 * cap + 7
    assert list(r[0, 1:7]) == [2 * cap + 5, 2 * cap + 9, 2 * cap + 40,
                               0 * cap + 5, 0 * cap + 9, 0 * cap + 40]
    assert list(d[0, :8]) == [0, 1, 1, 1, 1, 1, 1, 1]
    assert r[0, 7] == 2 * cap + 5                  # probe 2 after probe 1


def test_plane_name_is_the_same_function():
    assert port_fused.fused_scan_select_ref is port_scan.blocksoa_select_ref


def test_cpu_tensors_take_the_plain_version_without_counting():
    a = tp.to_torch(tp.select_inputs(3, q=2, p=2, g=3, k=4, cap=32))
    before = port_fused.fused_scan_select.launches
    args = [a[n] for n in select_cases.ARG_NAMES]
    d, r = port_fused.fused_scan_select(*args, width=8)
    d2, r2 = port_fused.fused_scan_select_ref(*args, width=8)
    assert torch.equal(d, d2) and torch.equal(r, r2)
    assert port_fused.fused_scan_select.launches == before
