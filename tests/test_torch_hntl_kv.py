"""HNTL-KV retrieval attention in the port against the JAX package.

The JAX ``build_kv_index`` result is carried across with
``kv_index_from_numpy``, so both packages scan the same integer panels:
``_retrieve_pool`` must keep the same tokens (v_cand equal) with pool
logits within atol 1e-5, and ``retrieval_decode_attention`` /
``retrieval_cross_attention`` / ``reference_decode_attention`` must give
outputs within atol 1e-5 (float32 sums in another order, at |out| <= ~3)
and the same tails.  A build in the port is held to the JAX build within
stated tolerances; its eigenvector signs may differ, so bases are compared
as projectors.  Shapes are the phi3 smoke config's (hd=16, kt=4, cap=16).
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import hntl_attention as JH
from repro_torch.configs import get_smoke_config
from repro_torch.interop import kv_index_from_numpy, model_config_from_dict
from repro_torch.kernels import hntl_scan as port_kernels
from repro_torch.models import hntl_attention as TH

ATOL = 1e-5


def _cfgs(**kw):
    jcfg = dataclasses.replace(jax_smoke_config("phi3-mini-3.8b"),
                               kv_pool=48, kv_nprobe=3, **kw)
    return jcfg, model_config_from_dict(dataclasses.asdict(jcfg))


def _clustered(rng, cfg, n_grains=8, batch=2):
    """tests/test_hntl_kv.py's keys: one centre (x2) per grain, noise 0.1."""
    kv, hd, cap = cfg.n_kv_heads, cfg.head_dim, cfg.kv_cap
    s = n_grains * cap
    centres = rng.standard_normal((n_grains, hd)).astype(np.float32) * 2
    k = np.repeat(centres[None, :, None, :], cap, axis=2).reshape(1, s, 1, hd)
    k = np.broadcast_to(k, (batch, s, kv, hd)).copy()
    k += 0.1 * rng.standard_normal(k.shape).astype(np.float32)
    v = rng.standard_normal((batch, s, kv, hd)).astype(np.float32)
    return centres, k, v


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(0)
    centres, k, v = _clustered(rng, cfg)
    jidx = JH.build_kv_index(jnp.asarray(k), jnp.asarray(v), jcfg)
    idx = kv_index_from_numpy(jax.tree.map(np.asarray, jidx), "cpu")
    return jcfg, cfg, centres, k, v, jidx, idx


def _step_inputs(rng, cfg, centres, b=2, far=False):
    hq, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if far:
        q = np.full((b, 1, hq, hd), 1e4, np.float32)
    else:
        q = (centres[3][None, None, None, :]
             + 0.05 * rng.standard_normal((b, 1, hq, hd))).astype(np.float32)
    k_new = rng.standard_normal((b, 1, kv, hd)).astype(np.float32)
    v_new = rng.standard_normal((b, 1, kv, hd)).astype(np.float32)
    return q, k_new, v_new


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_retrieve_pool_matches_jax(setup):
    jcfg, cfg, centres, k, _, jidx, idx = setup
    rng = np.random.default_rng(1)
    q, _, _ = _step_inputs(rng, cfg, centres)
    qh = q[:, 0].reshape(2, cfg.n_kv_heads, -1, cfg.head_dim)
    jl, jv, jpool = JH._retrieve_pool(jnp.asarray(qh), jidx, jcfg)
    before = port_kernels.hntl_scan_single.launches
    tl, tv, pool, tpos = TH._retrieve_pool(torch.from_numpy(qh), idx, cfg)
    assert port_kernels.hntl_scan_single.launches == before   # CPU: plain
    assert pool == jpool
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    # the same tokens: v_cand rows are the raw values at token_pos
    b, kv = tpos.shape[:2]
    bi = np.arange(b)[:, None, None, None]
    ki = np.arange(kv)[None, :, None, None]
    want_v = np.asarray(jidx.v_raw)[bi, tpos.numpy(), ki]
    np.testing.assert_array_equal(want_v, np.asarray(jv))


@pytest.mark.parametrize("far", [False, True], ids=["near", "envelope"])
def test_retrieval_decode_matches_jax(setup, far):
    jcfg, cfg, centres, _, _, jidx, idx = setup
    rng = np.random.default_rng(2)
    q, k_new, v_new = _step_inputs(rng, cfg, centres, far=far)
    pos = np.full((2,), idx.sealed_len + 3, np.int32)
    jo, jn = JH.retrieval_decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jidx,
        jnp.asarray(pos), jcfg)
    to, tn = TH.retrieval_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        idx, torch.from_numpy(pos), cfg)
    assert bool(torch.isfinite(to).all())
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tn.tail_k.numpy(), np.asarray(jn.tail_k))
    np.testing.assert_array_equal(tn.tail_v.numpy(), np.asarray(jn.tail_v))
    assert torch.all(idx.tail_k == 0)          # the input is not modified


def test_retrieval_cross_attention_matches_jax(setup):
    jcfg, cfg, centres, _, _, jidx, idx = setup
    q, _, _ = _step_inputs(np.random.default_rng(3), cfg, centres)
    jo = JH.retrieval_cross_attention(jnp.asarray(q), jidx, jcfg)
    to = TH.retrieval_cross_attention(torch.from_numpy(q), idx, cfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)


def test_retrieval_matches_exact_attention(setup):
    """The JAX test's bound (0.05) in the clustered regime, and the port's
    exact oracle against JAX's."""
    jcfg, cfg, centres, k, v, _, idx = setup
    rng = np.random.default_rng(4)
    q, k_new, v_new = _step_inputs(rng, cfg, centres)
    s = idx.sealed_len
    pos = np.full((2,), s, np.int32)
    out, new_idx = TH.retrieval_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        idx, torch.from_numpy(pos), cfg)
    k_all = np.concatenate([k, k_new], axis=1)
    v_all = np.concatenate([v, v_new], axis=1)
    ref = TH.reference_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_all), torch.from_numpy(v_all),
        torch.from_numpy(pos), cfg)
    jref = JH.reference_decode_attention(
        jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all),
        jnp.asarray(pos), jcfg)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), rtol=0,
                               atol=ATOL)
    err = float((out - ref).abs().max())
    assert err < 0.05, err
    assert not bool(torch.all(new_idx.tail_k == 0))


def test_envelope_fallback_no_nan(setup):
    """A query far outside every tangent patch keeps its nearest grain."""
    _, cfg, centres, _, _, _, idx = setup
    q, k_new, _ = _step_inputs(np.random.default_rng(5), cfg, centres,
                               far=True)
    out, _ = TH.retrieval_decode_attention(
        torch.from_numpy(q), torch.zeros_like(torch.from_numpy(k_new)),
        torch.zeros_like(torch.from_numpy(k_new)), idx,
        torch.full((2,), idx.sealed_len), cfg)
    assert bool(torch.isfinite(out).all())


def _projector(basis):
    b = basis.float().numpy() if isinstance(basis, torch.Tensor) \
        else np.asarray(basis, np.float32)
    return np.einsum("...hk,...gk->...hg", b, b)


@pytest.mark.parametrize("variant", ["f32", "sq8", "bf16_meta", "bf16_cache"])
def test_build_matches_jax(variant):
    kw = {"sq8": dict(kv_sq8=True), "bf16_meta": dict(kv_bf16_meta=True)}
    jcfg, cfg = _cfgs(**kw.get(variant, {}))
    _, k, v = _clustered(np.random.default_rng(6), cfg)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if variant == "bf16_cache":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    jidx = JH.build_kv_index(jk, jv, jcfg)
    idx = TH.build_kv_index(tk, tv, cfg, device="cpu")
    for name in ("centroids", "basis", "coords", "res", "scale", "res_scale",
                 "k_raw", "v_raw", "tail_k", "tail_v", "k_scale", "v_scale"):
        want, got = getattr(jidx, name), getattr(idx, name)
        assert (want is None) == (got is None), name
        if want is not None:
            assert tuple(got.shape) == want.shape, name
            assert str(got.dtype).split(".")[-1] == str(want.dtype), name
    meta_tol = 1e-2 if variant == "bf16_meta" else 1e-5
    np.testing.assert_allclose(_np(idx.centroids), _np(jidx.centroids),
                               atol=meta_tol, rtol=0)
    np.testing.assert_allclose(_projector(idx.basis),
                               _projector(jidx.basis), atol=1e-2 if
                               variant == "bf16_meta" else 1e-4, rtol=0)
    np.testing.assert_allclose(idx.scale.numpy(), np.asarray(jidx.scale),
                               rtol=1e-4)
    np.testing.assert_allclose(idx.res_scale.numpy(),
                               np.asarray(jidx.res_scale), rtol=1e-4)
    if variant == "sq8":
        np.testing.assert_allclose(idx.k_scale.numpy(),
                                   np.asarray(jidx.k_scale), rtol=1e-6)
        assert np.mean(idx.k_raw.numpy() == np.asarray(jidx.k_raw)) > 0.999
    else:
        np.testing.assert_array_equal(_np(idx.k_raw), _np(jidx.k_raw))


def test_sq8_retrieval_matches_jax():
    jcfg, cfg = _cfgs(kv_sq8=True)
    rng = np.random.default_rng(7)
    centres, k, v = _clustered(rng, cfg)
    jidx = JH.build_kv_index(jnp.asarray(k), jnp.asarray(v), jcfg)
    idx = kv_index_from_numpy(jax.tree.map(np.asarray, jidx), "cpu")
    assert idx.k_raw.dtype == torch.int8 and idx.k_scale is not None
    q, _, _ = _step_inputs(rng, cfg, centres)
    jo = JH.retrieval_cross_attention(jnp.asarray(q), jidx, jcfg)
    to = TH.retrieval_cross_attention(torch.from_numpy(q), idx, cfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)


def test_seal_tail_grows_index_like_jax(setup):
    jcfg, cfg, _, _, _, jidx, idx = setup
    rng = np.random.default_rng(8)
    shape = (2, cfg.kv_tail, cfg.n_kv_heads, cfg.head_dim)
    tk = rng.standard_normal(shape).astype(np.float32)
    tv = rng.standard_normal(shape).astype(np.float32)
    jfilled = dataclasses.replace(jidx, tail_k=jnp.asarray(tk),
                                  tail_v=jnp.asarray(tv))
    filled = dataclasses.replace(idx, tail_k=torch.from_numpy(tk),
                                 tail_v=torch.from_numpy(tv))
    jsealed = JH.seal_tail(jfilled, cfg.kv_tail, jcfg)
    sealed = TH.seal_tail(filled, cfg.kv_tail, cfg)
    assert sealed.n_grains == jsealed.n_grains \
        == idx.n_grains + cfg.kv_tail // cfg.kv_cap
    assert sealed.sealed_len == jsealed.sealed_len \
        == idx.sealed_len + cfg.kv_tail
    for name in ("k_raw", "v_raw", "tail_k", "tail_v"):
        np.testing.assert_array_equal(_np(getattr(sealed, name)),
                                      _np(getattr(jsealed, name)))
    np.testing.assert_allclose(_np(sealed.centroids), _np(jsealed.centroids),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(_projector(sealed.basis),
                               _projector(jsealed.basis), atol=1e-4, rtol=0)
    np.testing.assert_allclose(sealed.scale.numpy(),
                               np.asarray(jsealed.scale), rtol=1e-4)
    assert TH.seal_tail(filled, cfg.kv_cap - 1, cfg) is filled


def test_seal_tail_refuses_an_sq8_index():
    _, cfg = _cfgs(kv_sq8=True)
    _, k, v = _clustered(np.random.default_rng(9), cfg, n_grains=2)
    idx = TH.build_kv_index(torch.from_numpy(k), torch.from_numpy(v), cfg,
                            device="cpu")
    with pytest.raises(ValueError, match="SQ8"):
        TH.seal_tail(idx, cfg.kv_tail, cfg)


def test_config_copy_matches_jax():
    jcfg = jax_smoke_config("phi3-mini-3.8b")
    cfg = get_smoke_config("phi3-mini-3.8b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.compute_dtype == torch.bfloat16
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    full = get_config("phi3-mini-3.8b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_config("phi3-mini-3.8b"))
    assert (full.n_heads, full.n_kv_heads, full.head_dim) == (32, 32, 96)
    assert (full.kv_kt, full.kv_cap, full.kv_nprobe, full.kv_pool,
            full.kv_tail) == (16, 4096, 8, 128, 1024)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-7b")


def test_build_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    _, k, v = _clustered(np.random.default_rng(10), cfg, n_grains=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TH.build_kv_index(k, v, cfg)
