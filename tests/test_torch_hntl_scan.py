"""The port's Block-SoA scans against the JAX package.

``repro_torch.kernels.ops.scan_single`` / ``scan_batched`` (on CPU tensors:
the plain versions the CUDA kernels are held to bit for bit on the card)
against the JAX package's ``ops`` with ``backend="ref"`` (its oracle) and
``backend="interpret"`` (the Pallas kernel body), on the same integer
inputs.  Against the oracle the results are equal; against the Pallas
body they agree to rtol 1e-6 (XLA on the CPU may contract a multiply-add
that the port rounds in two steps, and the body forms the integer sum as
zq^2 + z^2 - 2 zq.z).  An integer model of the batched CUDA kernel's
arithmetic (byte limbs, shift classes, the cross term modulo 2^32) is
held equal to both oracles.  Then the "kernel" gather plane (the
counterpart of the JAX package's "pallas" plane) against the "ref" plane
on a JAX-built index: ids and dists equal.
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import jax.numpy as jnp
import numpy as np
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core import planner, scanplane, search as port_search
from repro_torch.core.types import BIG
from repro_torch.kernels import hntl_scan as port_kernels
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import scan_cases as sc

import torch_parity as tp


def _jax(a):
    return [jnp.asarray(v) for v in sc.args(a, np.asarray)]


def _torch(a):
    return sc.args(a, torch.from_numpy)


def _sketch(seed, p, q, s, cap):
    """Sketch-pass inputs: sq [P, Q, s] i32, sketch [P, s, cap] i8,
    sketch_scale [P] f32."""
    rng = np.random.default_rng(seed)
    return dict(sq=rng.integers(-127, 128, (p, q, s)).astype(np.int32),
                sketch=rng.integers(-127, 128, (p, s, cap)).astype(np.int8),
                sketch_scale=(rng.random(p) * 0.01 + 1e-3).astype(
                    np.float32))


def _compare(got, jax_fn, jargs, jkw=None):
    jkw = jkw or {}
    want_ref = np.asarray(jax_fn(*jargs, **jkw, backend="ref"))
    want_pallas = np.asarray(jax_fn(*jargs, **jkw, backend="interpret"))
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == want_ref.shape
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-6, atol=0)
    return got


@pytest.mark.parametrize("p,q,k,cap", sc.SWEEP)
def test_scan_batched_matches_jax(p, q, k, cap):
    a = sc.panels(p * 1000 + cap, p=p, q=q, k=k, cap=cap)
    got = port_ops.scan_batched(*_torch(a))
    _compare(got, jax_ops.scan_batched, _jax(a))


@pytest.mark.parametrize("p,k,cap",
                         sc.SINGLE_SWEEP + [(p * q, k, cap)
                                            for p, q, k, cap in sc.SWEEP])
def test_scan_single_matches_jax(p, k, cap):
    a = sc.single(sc.panels(p + 7 * cap, p=p, q=1, k=k, cap=cap))
    got = port_ops.scan_single(*_torch(a))
    _compare(got, jax_ops.scan_single, _jax(a))


@pytest.mark.parametrize("form", ["single", "batched"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_sketch_pass_and_extra_mask_match_jax(form, with_mask):
    # the JAX batched kernel takes only caps that are multiples of 128
    # (see test_batched_ragged_cap_the_jax_kernel_refuses)
    p, q, k, s = 4, 3, 16, 8
    cap = 200 if form == "single" else 256
    a = sc.panels(5, p=p, q=q, k=k, cap=cap)
    sk = _sketch(6, p, q, s, cap)
    rng = np.random.default_rng(7)
    mask = rng.random((p, cap)) < 0.7 if with_mask else None
    if form == "single":
        a = sc.single(a)
        sk["sq"] = sk["sq"][:, 0]
    port_fn = port_ops.scan_single if form == "single" \
        else port_ops.scan_batched
    jax_fn = jax_ops.scan_single if form == "single" \
        else jax_ops.scan_batched
    tkw = {n: torch.from_numpy(v) for n, v in sk.items()}
    jkw = {n: jnp.asarray(v) for n, v in sk.items()}
    if mask is not None:
        tkw["extra_mask"] = torch.from_numpy(mask)
        jkw["extra_mask"] = jnp.asarray(mask)
    got = _compare(port_fn(*_torch(a), **tkw), jax_fn, _jax(a), jkw)
    dead = ~a["valid"] if mask is None else ~(a["valid"] & mask)
    if form == "batched":
        dead = np.broadcast_to(dead[:, None, :], got.shape)
    assert np.all(got[dead] == np.float32(BIG))
    assert np.all(got[~dead] < BIG / 2)


def test_sketch_pass_adds_only_to_live_slots():
    """d = where(d < BIG/2, d + ds, d): the same bits as the plain scan
    that adds the sketch inside its epilogue and masks after."""
    from repro_torch.core import scan as port_scan
    p, k, s, cap = 6, 8, 4, 130
    a = sc.single(sc.panels(8, p=p, q=1, k=k, cap=cap, valid_frac=0.5))
    sk = _sketch(9, p, 1, s, cap)
    sk["sq"] = sk["sq"][:, 0]
    tkw = {n: torch.from_numpy(v) for n, v in sk.items()}
    got = port_ops.scan_single(*_torch(a), **tkw)
    want = port_scan.blocksoa_scan(*_torch(a), **tkw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("form", ["single", "batched"])
def test_int32_exactness_at_extremes(form):
    k = 32
    a = sc.extremes(p=1, q=2, k=k, cap=128)
    if form == "single":
        a = sc.single(a)
        got = port_ops.scan_single(*_torch(a))
        jgot = np.asarray(jax_ref.hntl_scan_single_ref(*_jax(a)))
        rq = a["rq"][:, None]
    else:
        got = port_ops.scan_batched(*_torch(a))[0]
        jgot = np.asarray(jax_ref.hntl_scan_ref(*_jax(a)))[0]
        rq = a["rq"][0][:, None]
    qmax = sc.int32_safe_qmax(k)
    assert k * (2 * qmax) ** 2 < 2 ** 31            # the invariant itself
    d_int = np.float32(k * (2 * qmax) ** 2)
    want = ((d_int * (a["scale"][0] * a["scale"][0]))
            + a["res"][0].astype(np.float32) * a["res_scale"][0]) + rq
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    np.testing.assert_array_equal(got.numpy(), jgot.reshape(got.shape))


def test_batched_ragged_cap_the_jax_kernel_refuses():
    """A difference from the JAX package: its batched Pallas wrapper pads
    the 2-D res/valid panels with a 3-D pad width, so a cap that is not a
    multiple of 128 raises there; the port masks the ragged tail and
    matches the JAX oracle."""
    a = sc.panels(10, p=2, q=3, k=8, cap=200)
    got = port_ops.scan_batched(*_torch(a))
    want = np.asarray(jax_ops.scan_batched(*_jax(a), backend="ref"))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="pad"):
        jax_ops.scan_batched(*_jax(a), backend="interpret")


def test_int32_wraparound_matches_jax():
    """Out-of-contract sums wrap as int32 in both packages."""
    a = sc.panels(11, p=2, q=3, k=16, cap=160, zq_range=2 ** 31 - 1)
    got = port_ops.scan_batched(*_torch(a))
    want = np.asarray(jax_ref.hntl_scan_ref(*_jax(a)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_all_invalid_panels_read_big():
    a = sc.panels(12, p=3, q=2, k=8, cap=140, valid_frac=0.0)
    got = port_ops.scan_batched(*_torch(a))
    assert torch.all(got == BIG)
    s = port_ops.scan_single(*_torch(sc.single(sc.panels(
        13, p=3, q=1, k=8, cap=140, valid_frac=0.0))))
    assert torch.all(s == BIG)


def test_kernel_wrappers_take_the_plain_version_on_the_cpu():
    a = sc.panels(14, p=2, q=4, k=8, cap=96)
    before = (port_kernels.hntl_scan.launches,
              port_kernels.hntl_scan_single.launches)
    assert torch.equal(port_kernels.hntl_scan(*_torch(a)),
                       port_ref.hntl_scan_ref(*_torch(a)))
    s = sc.single(a)
    assert torch.equal(port_kernels.hntl_scan_single(*_torch(s)),
                       port_ref.hntl_scan_single_ref(*_torch(s)))
    assert (port_kernels.hntl_scan.launches,
            port_kernels.hntl_scan_single.launches) == before
    with pytest.raises(ValueError, match="backend"):
        port_ops.scan_single(*_torch(s), backend="interpret")


# ---------------------------------------------------------------------------
# The batched CUDA kernel's integer arithmetic, modelled on the CPU
# ---------------------------------------------------------------------------

_M32 = (1 << 32) - 1


def _limbs(v, n):
    """The n byte limbs of int64 ``v``: u8 below, s8 on top (the bytes of
    its two's complement, as the kernel cuts them)."""
    out = [(v >> (8 * i)) & 0xFF for i in range(n)]
    out[-1] = np.where(out[-1] >= 128, out[-1] - 256, out[-1])
    return out


def _limb_count(tile):
    """1, 2 or 4: the kernel's vote over a 16-query tile."""
    if np.all((tile >= -128) & (tile <= 127)):
        return 1
    if np.all((tile >= -32768) & (tile <= 32767)):
        return 2
    return 4


def _kernel_model(zq, rq, coords, res, valid, scale, res_scale, seen=None):
    """What ``csrc/hntl_scan.cu::hntl_scan_kernel`` computes, step by step:
    per 16-query tile the limb count, per 32-deep step the byte-limb
    products summed into shift classes (0, 8, 16, 24 bits; shifts of 32
    or more dropped) and folded as sum_class (acc << shift) into the
    uint32 cross term, then zq2 + c2 - 2 cross modulo 2^32 and the float
    epilogue.  ``seen`` collects the (query limbs, coordinate limbs)
    pairs used."""
    p, q, k = zq.shape
    cap = coords.shape[2]
    nc = 2 if coords.dtype == np.int16 else 1
    z = zq.astype(np.int64)
    c = coords.astype(np.int64)
    zq2 = ((z * z) & _M32).sum(-1) & _M32                     # [P, Q]
    c2 = (c * c).sum(1) & _M32                                 # [P, cap]
    d_int = np.zeros((p, q, cap), np.int64)
    for pi in range(p):
        cl = _limbs(c[pi], nc)
        for q0 in range(0, q, 16):
            tile = z[pi, q0:q0 + 16]
            nl = _limb_count(tile)
            if seen is not None:
                seen.add((nl, nc))
            zl = _limbs(tile, nl)
            assert np.array_equal(sum(v << (8 * i) for i, v in enumerate(zl)),
                                  tile)
            cross = np.zeros((tile.shape[0], cap), np.int64)
            for s0 in range(0, k, 32):
                acc = np.zeros((4, tile.shape[0], cap), np.int64)
                for li in range(nl):
                    for mi in range(nc):
                        if li + mi < 4:
                            acc[li + mi] += (zl[li][:, s0:s0 + 32]
                                             @ cl[mi][s0:s0 + 32])
                # the kernel's s32 accumulators never overflow
                assert np.abs(acc).max(initial=0) < 2 ** 22
                for cls in range(4):
                    cross = (cross + ((acc[cls] & _M32) << (8 * cls))) & _M32
            d_int[pi, q0:q0 + 16] = (zq2[pi, q0:q0 + 16, None]
                                     + c2[pi][None, :] - 2 * cross) & _M32
    d = d_int.astype(np.uint32).view(np.int32).astype(np.float32)
    d = d * (scale * scale)[:, None, None]
    d = d + res.astype(np.float32)[:, None, :] * res_scale[:, None, None]
    d = d + rq[:, :, None]
    return np.where(valid[:, None, :], d, np.float32(BIG))


def _mixed_tile(seed, coord_dtype):
    """Three 16-query tiles of one query each at a limb count's edge:
    tile 0 holds -32768 and 32767 (2 limbs), tile 1 one value of 32768
    (4 limbs, its 15 neighbours in int16) and, in the second panel, a
    query of -2^31; tile 2 holds -128 and 127 (1 limb)."""
    int8 = coord_dtype == np.int8
    a = sc.panels(seed, p=2, q=40, k=32, cap=333,
                  coord_range=128 if int8 else 32768, coord_dtype=coord_dtype)
    z = a["zq"]
    z[0, 3, :4] = [-32768, 32767, -32768, 32767]
    z[0, 17, 5] = 32768
    z[1, 20, :] = -2 ** 31
    z[:, 32:, :] = np.clip(z[:, 32:, :], -128, 127)
    z[:, 32, :2] = [-128, 127]
    return a


#: The kernel model's cases: the JAX sweep, int32 extremes, wraparound on
#: int16 and int8 panels, tiles at every limb count's edge, k off 32 and
#: off 8, and a k of three 64-dimension chunks.
MODEL_CASES = {
    **{f"sweep_{p}x{q}x{k}x{cap}": lambda p=p, q=q, k=k, cap=cap: sc.panels(
        p * 1000 + cap, p=p, q=q, k=k, cap=cap) for p, q, k, cap in sc.SWEEP},
    "extremes": lambda: sc.extremes(p=2, q=3, k=32, cap=200),
    "wraparound_int16": lambda: sc.panels(
        11, p=2, q=19, k=16, cap=160, zq_range=2 ** 31 - 1),
    "wraparound_int8": lambda: sc.panels(
        12, p=2, q=19, k=8, cap=130, zq_range=2 ** 31 - 1, coord_range=128,
        coord_dtype=np.int8),
    "mixed_tile_int16": lambda: _mixed_tile(13, np.int16),
    "mixed_tile_int8": lambda: _mixed_tile(14, np.int8),
    **{f"k{k}": lambda k=k: sc.panels(15 + k, p=2, q=21, k=k, cap=200)
       for k in (8, 12, 16, 64)},
    "k192_wraparound": lambda: sc.panels(
        16, p=1, q=20, k=192, cap=140, zq_range=2 ** 31 - 1,
        coord_range=32768),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_batched_kernel_arithmetic_model_matches_references(case):
    a = MODEL_CASES[case]()
    got = _kernel_model(*sc.args(a, np.asarray))
    assert torch.equal(torch.from_numpy(got),
                       port_ref.hntl_scan_ref(*_torch(a)))
    np.testing.assert_array_equal(got,
                                  np.asarray(jax_ref.hntl_scan_ref(*_jax(a))))


def test_kernel_model_cases_reach_every_limb_pair():
    """Every (query limbs, coordinate limbs) pair the kernel can take."""
    seen = set()
    for make in MODEL_CASES.values():
        _kernel_model(*sc.args(make(), np.asarray), seen=seen)
    assert seen == {(nl, nc) for nl in (1, 2, 4) for nc in (1, 2)}


# ---------------------------------------------------------------------------
# The "kernel" gather plane on a JAX-built index
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["sketch", "no_sketch"])
def built(request):
    kw = {"sketch": {}, "no_sketch": {"s": 0}}[request.param]
    x, q = tp.corpus(n=2048, nq=8, seed=2)
    cfg = tp.jax_config(**kw)
    idx, _ = tp.jax_build(x, cfg)
    return tp.port_config(cfg), tp.port_index(idx), q


def test_kernel_plane_is_registered_as_a_gather_plane():
    plane = scanplane.get_scan_plane("kernel")
    assert plane.kind == scanplane.GATHER
    assert scanplane.get_scan_plane(None, "cuda").name == "fused"
    assert scanplane.get_scan_plane(None, "cpu").name == "ref"


@pytest.mark.parametrize("mode", ["A", "B"])
def test_kernel_plane_equals_ref_plane(built, mode):
    cfg, idx, q = built
    got = port_search(idx, q, cfg, topk=5, mode=mode, scan_impl="kernel")
    want = port_search(idx, q, cfg, topk=5, mode=mode, scan_impl="ref")
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.dists, want.dists)


def test_kernel_plane_with_extra_mask_equals_ref_plane(built):
    cfg, idx, q = built
    rng = np.random.default_rng(3)
    em = torch.from_numpy(rng.random(tuple(idx.grains.valid.shape)) < 0.6)
    got = port_search(idx, q, cfg, topk=5, scan_impl="kernel", extra_mask=em)
    want = port_search(idx, q, cfg, topk=5, scan_impl="ref", extra_mask=em)
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.dists, want.dists)


def test_kernel_plane_folds_n_active_like_ref(built):
    """Ragged probes are folded into the probe verdict before the plane
    runs: the kernel never receives ``n_active``."""
    cfg, idx, q = built
    qt = torch.from_numpy(q)
    gids, _ = planner.routing.route(idx.routing, qt, cfg.nprobe)
    n_active = torch.tensor([1, 4, 2, 0, 3, 4, 1, 2], dtype=torch.int32)
    kw = dict(envelope_frac=cfg.envelope_frac, qeff=8191, width=16,
              n_active=n_active)
    dk, ik = planner.candidate_stage(idx, qt, gids, scan_impl="kernel", **kw)
    dr, ir = planner.candidate_stage(idx, qt, gids, scan_impl="ref", **kw)
    assert torch.equal(dk, dr) and torch.equal(ik, ir)
    cap = idx.grains.cap
    for row, n in enumerate(n_active.tolist()):
        assert torch.all(dk[row, n * cap:] == BIG)
