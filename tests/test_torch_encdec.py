"""The port's encoder-decoder (``models/encdec.py``, whisper) against the
JAX package.

Weights come from the JAX ``init`` (its stacked ``enc`` / ``dec`` layers
carried across with ``interop.params_from_numpy``), frames and tokens from
a numpy seed; float32 (TF32 off), rtol = atol = 1e-4.  ``encode``, the
teacher-forced ``decode``, ``build_cross_cache`` and three
``decode_step``s hold to JAX's; ``decode_step_retrieval`` holds to JAX's
on JAX's ``build_cross_index`` carried across
(``interop.caches_from_numpy``: a stacked ``KVIndex`` -> one per layer),
and the port's own ``build_cross_index`` matches JAX's by projectors
(eigenvector signs may differ), as ``tests/test_torch_serve.py`` holds
``promote_to_retrieval``.  Then ``Model``'s enc-dec entry points and the
refusal of the decoder-only ones.
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference


import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import encdec as JE
from repro_torch.interop import caches_from_numpy
from repro_torch.models import encdec as E
from repro_torch.models import hntl_attention as H

import torch_parity

TOL = 1e-4
B, T_MEM, STEPS = 2, 64, 3        # 64 frames: 4 grains of kv_cap 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def pair():
    jcfg, jmodel, jparams, cfg, model, params = torch_parity.model_pair(
        "whisper-base", kv_pool=16)
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, T_MEM, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, size=(B, 8)).astype(np.int32)
    jmem = jax.jit(jmodel.encode)(jparams, jnp.asarray(frames))
    mem = model.encode(params, torch.from_numpy(frames))
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, cfg=cfg,
                model=model, params=params, frames=frames, tokens=tokens,
                jmem=jmem, mem=mem)


def test_encode_matches_jax(pair):
    _close(pair["mem"], pair["jmem"], msg="memory")
    assert pair["mem"].shape == (B, T_MEM, pair["cfg"].d_model)


def test_teacher_forced_decode_matches_jax(pair):
    p = pair
    for q_offset in (0, 3):
        hidden = E.decode(p["params"], p["cfg"],
                          torch.from_numpy(p["tokens"]), p["mem"],
                          q_offset=q_offset)
        jhidden = JE.decode(p["jparams"], p["jcfg"], jnp.asarray(p["tokens"]),
                            p["jmem"], q_offset=q_offset)
        _close(E.logits_fn(p["params"], hidden),
               jnp.einsum("bsd,vd->bsv", jhidden,
                          p["jparams"]["dec"]["embedding"]),
               msg=f"decode logits at offset {q_offset}")


def test_decode_steps_match_jax_and_the_teacher_forced_decode(pair):
    p = pair
    cfg = p["cfg"]
    cross = E.build_cross_cache(p["params"], cfg, p["mem"])
    jcross = jax.jit(JE.build_cross_cache, static_argnums=1)(
        p["jparams"], p["jcfg"], p["jmem"])
    carried = caches_from_numpy(jax.tree.map(np.asarray, jcross), cfg, "cpu")
    assert len(cross) == len(carried) == cfg.n_layers
    for mine, theirs in zip(cross, carried):
        for k in ("k", "v"):
            _close(mine[k], theirs[k], msg=f"cross {k}")
    sc = E.init_self_cache(cfg, B, "cpu")
    jsc = JE.init_self_cache(p["jcfg"], B)
    jstep = jax.jit(JE.decode_step, static_argnums=1)
    hidden = E.decode(p["params"], cfg, torch.from_numpy(p["tokens"]),
                      p["mem"])
    forced = E.logits_fn(p["params"], hidden)
    for t in range(STEPS):
        tok = p["tokens"][:, t]
        pos = np.full((B,), t, np.int32)
        logits, sc = p["model"].encdec_decode_step(
            p["params"], torch.from_numpy(tok), sc, cross,
            torch.from_numpy(pos))
        jlogits, jsc = jstep(p["jparams"], p["jcfg"], jnp.asarray(tok), jsc,
                             jcross, jnp.asarray(pos))
        _close(logits, jlogits, msg=f"step {t}")
        _close(logits, forced[:, t], msg=f"step {t} against decode")
    again = caches_from_numpy(jax.tree.map(np.asarray, jsc), cfg, "cpu")
    for mine, theirs in zip(sc, again):
        _close(mine["k"], theirs["k"], msg="self k")


def test_decode_step_retrieval_on_jax_cross_index_matches_jax(pair):
    p = pair
    cfg = p["cfg"]
    jidx = jax.jit(JE.build_cross_index, static_argnums=1)(
        p["jparams"], p["jcfg"], p["jmem"])
    idx = caches_from_numpy(jax.tree.map(np.asarray, jidx), cfg, "cpu")
    assert len(idx) == cfg.n_layers
    assert all(isinstance(i, H.KVIndex) and i.n_grains == T_MEM // cfg.kv_cap
               for i in idx)
    sc = E.init_self_cache(cfg, B, "cpu")
    jsc = JE.init_self_cache(p["jcfg"], B)
    jstep = jax.jit(JE.decode_step_retrieval, static_argnums=1)
    for t in range(STEPS):
        tok = p["tokens"][:, t]
        pos = np.full((B,), t, np.int32)
        logits, sc = E.decode_step_retrieval(
            p["params"], cfg, torch.from_numpy(tok), sc, idx,
            torch.from_numpy(pos))
        jlogits, jsc = jstep(p["jparams"], p["jcfg"], jnp.asarray(tok), jsc,
                             jidx, jnp.asarray(pos))
        _close(logits, jlogits, msg=f"retrieval step {t}")
    assert bool(torch.isfinite(logits).all())


def _projector(basis):
    b = basis.float().numpy()
    return np.einsum("...hk,...gk->...hg", b, b)


def test_port_cross_index_matches_jax_by_projectors(pair):
    p = pair
    cfg = p["cfg"]
    mine = E.build_cross_index(p["params"], cfg, p["mem"])
    jidx = jax.jit(JE.build_cross_index, static_argnums=1)(
        p["jparams"], p["jcfg"], p["jmem"])
    theirs = caches_from_numpy(jax.tree.map(np.asarray, jidx), cfg, "cpu")
    for li, (m, t) in enumerate(zip(mine, theirs)):
        for name in ("centroids", "basis", "coords", "res", "scale",
                     "res_scale", "k_raw", "v_raw", "tail_k", "tail_v"):
            a, c = getattr(m, name), getattr(t, name)
            assert a.shape == c.shape and a.dtype == c.dtype, (li, name)
        _close(m.centroids, t.centroids, 1e-5, f"layer {li} centroids")
        np.testing.assert_allclose(_projector(m.basis), _projector(t.basis),
                                   atol=1e-4, rtol=0)
        _close(m.scale, t.scale, 1e-4, f"layer {li} scale")
        _close(m.k_raw, t.k_raw, TOL, f"layer {li} raw keys")
    # the port's own index decodes close to JAX's: the candidate pools
    # agree, float order differs
    logits, _ = E.decode_step_retrieval(
        p["params"], cfg, torch.tensor([3, 7]), E.init_self_cache(cfg, B,
                                                                  "cpu"),
        mine, torch.zeros(B, dtype=torch.long))
    jlogits, _ = JE.decode_step_retrieval(
        p["jparams"], p["jcfg"], jnp.asarray([3, 7], jnp.int32),
        JE.init_self_cache(p["jcfg"], B), jidx, jnp.zeros((B,), jnp.int32))
    _close(logits, jlogits, 1e-3, "port-built index")


def test_model_entry_points_and_decoder_only_refusals(pair):
    p = pair
    model, cfg = p["model"], p["cfg"]
    assert isinstance(p["params"], E.EncDec)
    own = model.init(0, device="cpu")
    assert isinstance(own, E.EncDec)
    assert set(dict(own.named_parameters())) == set(
        dict(p["params"].named_parameters()))
    assert len(own.enc.layers) == cfg.n_enc_layers
    assert len(own.dec.layers) == cfg.n_layers
    mem = model.encode(own, torch.zeros((1, 16, cfg.d_model)))
    logits, sc = model.encdec_decode_step(
        own, torch.tensor([1]), E.init_self_cache(cfg, 1, "cpu"),
        E.build_cross_cache(own, cfg, mem), torch.tensor([0]))
    assert logits.shape == (1, cfg.vocab) and len(sc) == cfg.n_layers
    for call in (lambda: model.prefill(own, torch.zeros((1, 4))),
                 lambda: model.decode_step(own, None, None, None),
                 lambda: model.init_cache(1, 8, "cpu")):
        with pytest.raises(ValueError, match="encoder-decoder"):
            call()
