"""The port's fused scan→select plain version against the JAX package.

``repro_torch``'s ``fused_scan_select_ref`` (what the "fused" plane runs
on CPU tensors, and what the CUDA kernel is held to bit for bit on the
card) against the JAX Pallas kernel in interpret mode and against the JAX
package's own oracle ``blocksoa_select_ref``, on the same integer inputs.
Rows must be equal; dists agree to rtol 1e-6 (XLA on the CPU may contract
a multiply-add that the port rounds in two steps).
"""
import bisect
import re
from pathlib import Path

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
_CU = (Path(port_fused.__file__).parent / "csrc" / "fused_select.cu"
       ).read_text()
#: The kernels' block-sort threshold and the keys a CTA sorts at once,
#: as ``csrc/fused_select.cu`` sets them (on the card the wrapper reads
#: the threshold from the built library: ``block_sort_length()``).
BLOCK_SORT_L = int(re.search(r"#define FUSED_SELECT_BLOCK_SORT_L (\d+)",
                             _CU).group(1))
SORT_KEYS = int(re.search(r"constexpr int kSortKeys = (\d+);", _CU).group(1))
#: Small modelled widths: a shared width, a block-sort threshold and a
#: block sort's keys, so that small shapes take every path.
MODELLED = dict(smem_width=64, block_sort_l=16, sort_keys=64)


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
    """The warp's probe kernel on one pair: keys [cap] (EMPTY where dead)
    in 128-slot chunks; per chunk, keys at or above the carry's L-th
    dropped, the n survivors sorted and cut to min(n, L), and merged into
    the sorted carry of L big_keys."""
    carry, thr = [big_key] * L, big_key
    for base in range(0, len(keys), _CHUNK):
        run = sorted(k for k in keys[base:base + _CHUNK] if k < thr)
        if run:
            carry = _merge(carry, run[:L], L)
            thr = carry[-1]
    return carry


def _sort_hi(keys):
    """The kernels' block_sort_hi: a stable sort on the upper 32 bits."""
    return sorted(keys, key=lambda k: k >> 32)


def _corank(inputs, b):
    """The co-rank kernel: how many keys of each sorted input (live keys
    only, unique) come before output b of their merge.  A (c + 1)-ary
    search on the upper 32 bits (c = 32 // n candidates a round for n <=
    16 inputs, else 1) finds the distance D of output b; the outputs
    below b at D are the first of them in input order."""
    lens = [len(x) for x in inputs]
    if b == 0 or b >= sum(lens):
        return [0] * len(inputs) if b == 0 else lens
    lo = min(x[0] >> 32 for x in inputs if x)
    hi = max(x[-1] >> 32 for x in inputs if x)
    c = 32 // len(inputs) if len(inputs) <= 16 else 1
    while lo < hi:
        span = hi - lo
        cands = [lo + span * (i + 1) // (c + 1) for i in range(c)]
        above = [sum(bisect.bisect_left(x, (m + 1) << 32) for x in inputs) > b
                 for m in cands]
        first = above.index(True) if True in above else c
        if first < c:
            hi = cands[first]
        if first > 0:
            lo = cands[first - 1] + 1
    lt = [bisect.bisect_left(x, lo << 32) for x in inputs]
    at = [bisect.bisect_left(x, (lo + 1) << 32) - t
          for x, t in zip(inputs, lt)]
    r, before, out = b - sum(lt), 0, []
    for t, e in zip(lt, at):
        out.append(t + min(max(r - before, 0), e))
        before += e
    return out


def _multiway(inputs, cut, big_key, tile):
    """The multi-way merge of sorted inputs (each padded with big_keys;
    [] for a dead probe), cut to ``cut`` keys: per tile of ``tile``
    outputs, the inputs' slices between two co-ranks staged in input
    order and sorted by ``_sort_hi``; big_keys past the live keys."""
    live = [x[:bisect.bisect_left(x, big_key)] for x in inputs]
    out = []
    for t0 in range(0, cut, tile):
        a0, a1 = _corank(live, t0), _corank(live, min(t0 + tile, cut))
        stage = _sort_hi([k for x, i, j in zip(live, a0, a1)
                          for k in x[i:j]])
        out += stage + [big_key] * (min(tile, cut - t0) - len(stage))
    return out


def _block_top(keys, big_key, L, sort_keys):
    """The block-sort probe kernel on one pair: dropped slots (and keys at
    or above big_key) as big_key; a cap of at most ``sort_keys`` slots
    sorted whole and cut to L; a larger one in runs of ``sort_keys``
    slots, each sorted, cut to min(sort_keys, L) and padded with
    big_keys, then merged per pair by the multi-way merge, cut to L."""
    keys = [min(k, big_key) for k in keys]
    if len(keys) <= sort_keys:
        return _sort_hi(keys)[:L]
    stride = min(sort_keys, L)
    runs = []
    for base in range(0, len(keys), sort_keys):
        run = _sort_hi(keys[base:base + sort_keys])[:stride]
        runs.append(run + [big_key] * (stride - len(run)))
    return _multiway(runs, L, big_key, sort_keys)


def two_stage_select(a, width, smem_width=port_fused.SMEM_WIDTH,
                     block_sort_l=BLOCK_SORT_L, sort_keys=SORT_KEYS):
    """numpy model of the CUDA kernels: per live (query, probe) pair its
    top-min(width, cap) keys (order bits of the distance << 32 | visit
    index + 1), then per query a merge of the live probes' lists, then
    keys -> (dist, row).  A list of L = min(width, cap) keys below
    ``block_sort_l`` is the warp's carry, and with width <=
    ``smem_width`` the query folds the lists into a carry of ``width``
    big_keys in probe order; a longer list is block-sorted (in runs of
    ``sort_keys`` slots where the cap exceeds that), and every shape but
    the first takes the multi-way merge."""
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
    block = L >= block_sort_l
    alive = _alive(a)
    visit = np.arange(p_n * cap, dtype=np.uint64).reshape(p_n, cap) + 1
    keys = (_order_bits(d) << np.uint64(32)) | visit
    out_d = np.empty((q_n, width), np.float32)
    out_r = np.empty((q_n, width), np.int32)
    for q in range(q_n):
        lists = []
        for p in range(p_n):
            pair = [int(k) if ok else _EMPTY for k, ok in
                    zip(keys[q, p], live[q, p])]
            lists.append([] if not alive[q, p] else
                         _block_top(pair, big_key, L, sort_keys) if block
                         else _probe_top(pair, big_key, L))
        if block or width > smem_width:
            carry = _multiway(lists, width, big_key, sort_keys)
        else:
            carry = [big_key] * width
            for lst in lists:
                if lst and lst[0] < carry[-1]:
                    carry = _merge(carry, lst, width)
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


#: Caps above a block sort of 64 keys, so the model (``MODELLED``) takes
#: the sorted-run path (L = min(width, cap) > 64) at small shapes: one run
#: and many, widths from L up to P * cap, ragged n_active, killed pairs,
#: ties across probes, every slot entering the pool, the cascade's
#: stage-1 form.
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


def _assert_model_equals_plain(a, width, **modelled):
    args, kw = select_cases.split(a, torch.from_numpy)
    want_d, want_r = port_scan.blocksoa_select_ref(*args, width=width, **kw)
    got_d, got_r = two_stage_select(a, width, **modelled)
    assert np.array_equal(got_r, want_r.numpy())
    assert np.array_equal(got_d.view(np.uint32),
                          want_d.numpy().view(np.uint32))


@pytest.mark.parametrize("case", sorted(CHUNK_RUN_CASES))
def test_chunk_run_model_equals_plain_version(case):
    """The kernels' path for a per-probe list longer than a block sort
    (each pair's sorted runs, merged per pair by the multi-way merge),
    modelled at the small ``MODELLED`` widths (the kernels' are
    ``SORT_KEYS`` and ``BLOCK_SORT_L``): bit for bit the plain
    version."""
    width, make = CHUNK_RUN_CASES[case]
    a = make()
    assert min(width, a["coords"].shape[2]) > MODELLED["sort_keys"]
    _assert_model_equals_plain(a, width, **MODELLED)


def _dead_query(a):
    a["keep"][1] = False                 # query 1: every probe dead
    return a


#: The block-sort path and the multi-way merge at the small ``MODELLED``
#: widths (threshold 16, a block sort of 64 keys, a shared width of 64):
#: name -> (width, maker).  Lists one below, at and one above the
#: threshold; P = 1 and an odd P; a query whose probes are all dead; ties
#: across probes; a tenant mask; caps that are not a multiple of 4; no
#: sketch; the warp's lists above the shared width; the stage-1 form.
BLOCK_SORT_CASES = {
    "l_below_threshold": (15, lambda: select_cases.random_inputs(
        41, q=3, p=4, g=4, k=3, cap=40, s=2)),
    "l_at_threshold": (16, lambda: select_cases.random_inputs(
        42, q=3, p=4, g=4, k=3, cap=40, s=2)),
    "l_above_threshold": (17, lambda: select_cases.random_inputs(
        43, q=3, p=4, g=4, k=3, cap=40, s=2)),
    "p1": (50, lambda: select_cases.random_inputs(
        44, q=3, p=1, g=3, k=4, cap=60, s=2)),
    "odd_p7_width_p_cap": (7 * 30, lambda: select_cases.random_inputs(
        45, q=3, p=7, g=5, k=3, cap=30, s=2)),
    "all_dead_query": (120, lambda: _dead_query(select_cases.random_inputs(
        46, q=3, p=4, g=4, k=3, cap=50, s=2))),
    "ties_across_probes": (150, lambda: select_cases.tie_inputs(
        q=3, p=4, g=3, k=2, cap=50, s=2)),
    "tenant_mask": (100, lambda: select_cases.random_inputs(
        47, q=4, p=3, g=5, k=3, cap=48, s=2, tenants=3, ragged=True)),
    "cap_not_multiple_of_4": (70, lambda: select_cases.random_inputs(
        48, q=3, p=3, g=4, k=3, cap=63, s=2)),
    "no_sketch": (60, lambda: select_cases.random_inputs(
        49, q=3, p=4, g=4, k=4, cap=60, ragged=True, keep_frac=0.6)),
    "warp_lists_above_shared_width": (100, lambda: select_cases.random_inputs(
        50, q=3, p=9, g=4, k=2, cap=12)),
    "stage1_form_width_p_cap": (5 * 40, lambda: select_cases.stage1_inputs(
        51, q=3, p=5, g=6, cap=40, s=2)),
}


@pytest.mark.parametrize("case", sorted(BLOCK_SORT_CASES))
def test_block_sort_model_equals_plain_version(case):
    """The block-sort probe kernel, its runs and the multi-way merge with
    its co-rank search, modelled at the small ``MODELLED`` widths: bit for
    bit the plain version."""
    width, make = BLOCK_SORT_CASES[case]
    _assert_model_equals_plain(make(), width, **MODELLED)


@pytest.mark.parametrize("seed", range(4))
def test_corank_search_splits_the_merge_exactly(seed):
    """Each co-rank set is what the first b outputs of the merge take from
    each input, found from the distances (upper 32 bits) alone: inputs
    with many equal distances across and within inputs."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9)) if seed % 2 else int(rng.integers(17, 30))
    inputs, visit = [], 1
    for _ in range(n):               # input j holds visits after input j-1's
        m = int(rng.integers(0, 40))
        hi = rng.integers(0, 6, size=m)
        inputs.append(sorted((int(h) << 32) | (visit + i)
                             for i, h in enumerate(hi)))
        visit += m
    merged = sorted(k for x in inputs for k in x)
    for b in range(len(merged) + 2):
        first = set(merged[:b])
        assert _corank(inputs, b) == [sum(k in first for k in x)
                                      for x in inputs]


def test_kernel_constants_stand_where_the_design_puts_them():
    """The block-sort threshold lies in 256..2048 (a block-wide form was
    measured slower at W=64, so the main path keeps the warp) and a block
    sort holds a whole list of the cascade's stage 1 (cap 1,664)."""
    assert 256 <= BLOCK_SORT_L <= 2048
    assert 1664 <= SORT_KEYS <= 8192 and SORT_KEYS % 4 == 0
    assert select_cases.resolve_width(lambda bsl: bsl + 1, 7) == 8
    assert select_cases.resolve_width(9, 7) == 9


def test_vector_loads_need_cap_multiple_of_4_and_aligned_panels():
    x = torch.zeros(64, dtype=torch.int16)
    assert port_fused.vector_loads(8, x, None)
    assert not port_fused.vector_loads(6, x)
    assert not port_fused.vector_loads(8, x[1:])          # 2-byte offset
