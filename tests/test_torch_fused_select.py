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


def _tie_inputs():
    """Equal distances across two probes and within one tile; grain 2 is
    probed twice (probes 0 and 2), grain 0 once (probe 1)."""
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
    return a


def test_exact_ties_break_by_probe_then_slot():
    """Equal distances across two probes and within one tile: the earlier
    (probe, slot) wins, as the JAX carry's lax.top_k does."""
    cap = 64
    a = _tie_inputs()
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


# ---------------------------------------------------------------------------
# The CUDA kernels' design, checked where there is no card: the schedule,
# and a model of the two-stage select (per-probe top-min(width, cap), then
# a per-query merge) held equal to the plain version.
# ---------------------------------------------------------------------------

_EMPTY = 2 ** 64 - 1
_CHUNK = 128                             # slots a warp prices at a time


def _order_bits(d):
    u = np.ascontiguousarray(d, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)


def _float_of_order(o):
    o = np.uint32(o)
    u = o & np.uint32(0x7fffffff) if o & 0x80000000 else ~o
    return np.array([u], np.uint32).view(np.float32)[0]


def _merge_at(a, b, i):
    """Output i of the ascending merge of sorted runs a and b, ties to a:
    the kernels' merge path (binary search for the a's among the first i
    outputs)."""
    lo, hi = max(0, i - len(b)), min(i, len(a))
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= b[i - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    j = i - lo
    return a[lo] if lo < len(a) and (j >= len(b) or a[lo] <= b[j]) else b[j]


def _merge(a, b, n):
    return [_merge_at(a, b, i) for i in range(n)]


def _probe_top(keys, big_key, L):
    """The per-probe kernel on one pair: keys [cap] (EMPTY where dead) in
    128-slot chunks; per chunk, keys at or above the carry's L-th dropped,
    the n survivors sorted and cut to min(n, L), and merged into the
    sorted carry of L big_keys."""
    carry, thr = [big_key] * L, big_key
    for base in range(0, len(keys), _CHUNK):
        run = sorted(k for k in keys[base:base + _CHUNK] if k < thr)
        if run:
            carry = _merge(carry, run[:L], L)
            thr = carry[-1]
    return carry


def _tree(runs, base, cut, big_key):
    """The tree merge in global scratch: rounds merge runs 2j and 2j + 1
    (each a group of input runs of ``base`` keys; an empty run is a dead
    probe's) into runs of min(count * base, cut) keys padded with
    big_keys, one round at least, down to one run."""
    runs = [(r, 1) for r in runs]
    while True:
        out = []
        for j in range(0, len(runs), 2):
            (a, ca), (b, cb) = runs[j], (runs[j + 1] if j + 1 < len(runs)
                                         else ([], 0))
            n = min((ca + cb) * base, cut)
            m = _merge(a, b, min(len(a) + len(b), n))
            out.append((m + [big_key] * (n - len(m)), ca + cb))
        runs = out
        if len(runs) == 1:
            return runs[0][0]


def _chunk_runs_top(keys, big_key, L):
    """The chunk-run path on one pair (L > the shared width): each
    128-slot chunk sorted whole, dropped slots (and keys at or above
    big_key) as big_key, the tail past cap as big_key; the pair's runs
    tree-merged with each output cut to L."""
    runs = []
    for base in range(0, len(keys), _CHUNK):
        run = [k if k < big_key else big_key
               for k in keys[base:base + _CHUNK]]
        runs.append(sorted(run + [big_key] * (_CHUNK - len(run))))
    return _tree(runs, _CHUNK, L, big_key)


def two_stage_select(a, width, smem_width=port_fused.SMEM_WIDTH):
    """numpy model of the CUDA kernels: per live (query, probe) pair its
    top-min(width, cap) keys (order bits of the distance << 32 | visit
    index + 1), then per query a carry of `width` big_keys folded with
    each live probe's list in probe order, then keys -> (dist, row).
    ``smem_width`` is the kernels' shared width: a list above it is built
    from the pair's chunk runs, and a width above it merges the probes'
    lists by the tree merge."""
    t = {n: torch.from_numpy(np.ascontiguousarray(v)) for n, v in a.items()}
    gl = t["gids"].long()
    sk = "sketch" in t
    extra = (t["tenant_mask"][t["tenant_ix"].long()[:, None], gl]
             if "tenant_mask" in t else None)
    d = port_scan.blocksoa_scan(
        t["zq"], t["rq"], t["coords"][gl], t["res"][gl], t["mask"][gl],
        t["scale"][gl], t["res_scale"][gl], t.get("sq"),
        t["sketch"][gl] if sk else None,
        t["sketch_scale"][gl] if sk else None, extra_mask=extra).numpy()
    live = a["mask"][a["gids"]]
    if extra is not None:
        live = live & extra.numpy()
    q_n, p_n, cap = d.shape
    big = np.float32(BIG)
    big_key = int(_order_bits(big)[0]) << 32
    L = min(width, cap)
    alive = _alive(a)
    visit = np.arange(p_n * cap, dtype=np.uint64).reshape(p_n, cap) + 1
    keys = (_order_bits(d) << np.uint64(32)) | visit
    out_d = np.empty((q_n, width), np.float32)
    out_r = np.empty((q_n, width), np.int32)
    top = _chunk_runs_top if L > smem_width else _probe_top
    for q in range(q_n):
        carry = [big_key] * width
        lists = []
        for p in range(p_n):
            lst = [] if not alive[q, p] else top(
                [int(k) if ok else _EMPTY for k, ok in
                 zip(keys[q, p], live[q, p])], big_key, L)
            lists.append(lst)
            if width <= smem_width and lst and lst[0] < carry[-1]:
                carry = _merge(carry, lst, width)
        if width > smem_width:
            carry = _tree(lists, L, width, big_key)
        for i, key in enumerate(carry):
            out_d[q, i] = _float_of_order(key >> 32)
            v = (key & 0xffffffff) - 1
            out_r[q, i] = (a["rows"][a["gids"][q, v // cap], v % cap]
                           if out_d[q, i] < big * np.float32(0.5) else -1)
    return out_d, out_r

def _alive(a):
    p = np.arange(a["keep"].shape[1])[None, :]
    alive = a["keep"].copy()
    if "n_active" in a:
        alive &= p < a["n_active"][:, None]
    return alive


@pytest.mark.parametrize("case", ["random", "ragged_holes", "hot_grain",
                                  "all_killed", "int32_keys"])
def test_schedule_orders_live_pairs_by_grain_killed_last(case):
    n_grains = 40000 if case == "int32_keys" else 4
    if case == "hot_grain":
        a = select_cases.hot_grain_inputs(0, q=6, p=5, g=9, k=2, cap=8)
    else:
        a = select_cases.random_inputs(1, q=7, p=6, g=4, k=2, cap=8,
                                       keep_frac=0.5,
                                       ragged=case == "ragged_holes")
    if case == "int32_keys":                     # grain ids past int16
        a["gids"] += 33000
    if case == "all_killed":
        a["keep"][:] = False
    t = tp.to_torch(a)
    order = port_fused.schedule(t["gids"], t["keep"], n_grains,
                                t.get("n_active"))
    q_n, p_n = a["gids"].shape
    order = order.numpy()
    assert order.dtype == np.int64
    assert np.array_equal(np.sort(order), np.arange(q_n * p_n))
    alive = _alive(a).reshape(-1)[order]
    n_live = int(alive.sum())
    assert alive[:n_live].all() and not alive[n_live:].any()
    live = order[:n_live]
    g = a["gids"].reshape(-1)[live]
    assert np.all(np.diff(g) >= 0)                         # grain order
    same = np.diff(g) == 0
    assert np.all(np.diff(live)[same] > 0)                 # then (q, p)
    assert np.all(np.diff(order[n_live:]) > 0)             # killed, in order


def _model_inputs():
    cases = {f"random_{name}": (tp.select_inputs(i, **{
        k: v for k, v in c.items() if k != "width"}), c["width"])
        for i, (name, c) in enumerate(sorted(CASES.items()))}
    cases.update({
        "random_multi_tile": (select_cases.random_inputs(
            21, q=2, p=3, g=4, k=3, cap=2100, s=2, ragged=True), 150),
        "random_width_1": (select_cases.random_inputs(
            24, q=3, p=3, g=5, k=4, cap=200, s=2), 1),
        "random_ragged_holes": (select_cases.random_inputs(
            22, q=6, p=5, g=3, k=4, cap=64, keep_frac=0.5, ragged=True), 40),
        "hot_grain": (select_cases.hot_grain_inputs(
            23, q=3, p=4, g=5, k=4, cap=130, s=2), 50),
        "descending_10": (select_cases.descending_inputs(
            q=2, p=3, k=4, cap=128), 10),
        "descending_300": (select_cases.descending_inputs(
            q=2, p=3, k=4, cap=128), 300),
        "ties_small": (_tie_inputs(), 8),
        "ties_across_grains": (select_cases.tie_inputs(
            q=3, p=4, g=3, k=2, cap=70, s=2), 150),
    })
    return cases


MODEL_CASES = _model_inputs()


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_two_stage_select_model_equals_plain_version(case):
    a, width = MODEL_CASES[case]
    args, kw = select_cases.split(a, torch.from_numpy)
    want_d, want_r = port_scan.blocksoa_select_ref(*args, width=width, **kw)
    got_d, got_r = two_stage_select(a, width)
    assert np.array_equal(got_r, want_r.numpy())
    assert np.array_equal(got_d.view(np.uint32),
                          want_d.numpy().view(np.uint32))


#: Caps above a shared width of 64, so the model takes the chunk-run path
#: (L = min(width, cap) > 64) at small shapes: one chunk and many, widths
#: from L up to P * cap, ragged n_active, killed pairs, ties across
#: probes, every slot entering the pool, the cascade's stage-1 form.
CHUNK_RUN_CASES = {
    "one_chunk_p1": (65, lambda: select_cases.random_inputs(
        31, q=3, p=1, g=3, k=4, cap=65, s=2)),
    "width_p_cap": (900, lambda: select_cases.random_inputs(
        32, q=3, p=3, g=5, k=3, cap=300, s=2)),
    "ragged_killed": (200, lambda: select_cases.random_inputs(
        33, q=5, p=5, g=6, k=3, cap=300, ragged=True, keep_frac=0.6)),
    "scalar_cap_tenant": (1000, lambda: select_cases.random_inputs(
        34, q=3, p=5, g=6, k=3, cap=333, s=2, tenants=2)),
    "ties_across_probes": (400, lambda: select_cases.tie_inputs(
        q=3, p=4, g=3, k=2, cap=150, s=2)),
    "descending": (900, lambda: select_cases.descending_inputs(
        q=2, p=3, k=4, cap=300)),
    "stage1_form": (1200, lambda: select_cases.stage1_inputs(
        35, q=3, p=3, g=5, cap=400, s=2, ragged=True)),
}


@pytest.mark.parametrize("case", sorted(CHUNK_RUN_CASES))
def test_chunk_run_model_equals_plain_version(case):
    """The kernels' path for a per-probe list above the shared width,
    modelled at a shared width of 64 (the kernels' is ``SMEM_WIDTH``):
    bit for bit the plain version."""
    width, make = CHUNK_RUN_CASES[case]
    a = make()
    assert min(width, a["coords"].shape[2]) > 64
    args, kw = select_cases.split(a, torch.from_numpy)
    want_d, want_r = port_scan.blocksoa_select_ref(*args, width=width, **kw)
    got_d, got_r = two_stage_select(a, width, smem_width=64)
    assert np.array_equal(got_r, want_r.numpy())
    assert np.array_equal(got_d.view(np.uint32),
                          want_d.numpy().view(np.uint32))


def test_vector_loads_need_cap_multiple_of_4_and_aligned_panels():
    x = torch.zeros(64, dtype=torch.int16)
    assert port_fused.vector_loads(8, x, None)
    assert not port_fused.vector_loads(6, x)
    assert not port_fused.vector_loads(8, x[1:])          # 2-byte offset
