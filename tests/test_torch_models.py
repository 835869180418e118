"""The port's attention-only decoders against the JAX package.

Weights come from the JAX ``init`` and are carried across with
``interop.params_from_numpy``; tokens, positions and patch embeddings are
made from a numpy seed.  In float32 (``dtype="float32"``, TF32 off) the
port's ``forward`` logits, ``prefill`` logits and caches and three
``decode_step``s hold to the JAX package's at rtol = atol = 1e-4 for the
five smoke configs; phi3-mini in bf16 holds to the reference's own
decode-vs-forward tolerances (3e-2 prefill, 5e-2 decode).  Then the port's
twin of ``tests/test_models.py::test_decode_matches_forward`` (gemma2
with a prompt longer than its 16-token window, and the MoE, RG-LRU and
RWKV6 smoke models), the configuration copies of all ten architectures,
and the five configurations of item 11a, which the port accepts since it
landed (their parity is in ``test_torch_families.py``,
``test_torch_moe.py``, ``test_torch_recurrent.py`` and
``test_torch_encdec.py``).
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import get_model as jax_get_model
from repro.models import transformer as JT
from repro_torch import configs as port_configs
from repro_torch.interop import model_config_from_dict, params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import get_model
from repro_torch.models import transformer as T

ARCHS = ["phi3-mini-3.8b", "gemma2-2b", "stablelm-3b", "codeqwen1.5-7b",
         "qwen2-vl-2b"]
#: The configurations of ROADMAP item 11a: refused until it landed.
UNPORTED = ["recurrentgemma-9b", "rwkv6-1.6b", "qwen3-moe-30b-a3b",
            "dbrx-132b", "whisper-base"]
DECODERS_11A = [a for a in UNPORTED if a != "whisper-base"]
B, S = 2, 24
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, dtype="float32", **kw):
    """(JAX cfg, model, params; port cfg, model, params) on the same
    weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype, **kw)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jmodel, jparams, cfg, get_model(cfg), params


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _inputs(cfg, seed=1, b=B, s=S):
    """tokens [b, s]; for M-RoPE, three distinct position streams and two
    patch embeddings (written at offset 1)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    kw = {}
    if cfg.mrope_sections is not None:
        base = np.arange(s, dtype=np.int32)
        kw["positions"] = np.stack([base, base // 2, base // 3])[:, None] \
            .repeat(b, axis=1)
        kw["patch_embeds"] = rng.standard_normal(
            (b, 2, cfg.d_model)).astype(np.float32)
    return tokens, kw


def _port_kw(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def _jax_kw(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _cache_leaves(caches):
    """The port's per-layer linear caches as [(k, v)]."""
    return [(c["mixer"]["k"], c["mixer"]["v"]) for c in caches]


def _jax_cache_leaves(jcaches, cfg):
    out = []
    for g in range(cfg.n_groups):
        for i in range(len(cfg.pattern)):
            m = jcaches["groups"][f"l{i}"]["mixer"]
            out.append((m["k"][g], m["v"][g]))
    return out + [(c["mixer"]["k"], c["mixer"]["v"])
                  for c in jcaches["tail"]]


def _parity(arch, dtype, tol_prefill, tol_decode):
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch, dtype)
    tokens, kw = _inputs(cfg)
    hidden, _ = T.forward(params, cfg, torch.from_numpy(tokens),
                          **_port_kw(kw))
    jhidden, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens), **_jax_kw(kw))
    _close(T.logits_fn(params, cfg, hidden),
           JT.logits_fn(jparams, jcfg, jhidden), tol_prefill, "forward")

    s0 = S // 2
    pkw = {k: (v[..., :s0] if k == "positions" else v)
           for k, v in kw.items()}
    logits, caches = model.prefill(params, torch.from_numpy(tokens[:, :s0]),
                                   max_len=S, **_port_kw(pkw))
    jlogits, jcaches = jmodel.prefill(jparams, jnp.asarray(tokens[:, :s0]),
                                      max_len=S, **_jax_kw(pkw))
    _close(logits, jlogits, tol_prefill, "prefill logits")
    for li, ((k, v), (jk, jv)) in enumerate(zip(
            _cache_leaves(caches), _jax_cache_leaves(jcaches, jcfg))):
        _close(k, jk, tol_prefill, f"prefill k, layer {li}")
        _close(v, jv, tol_prefill, f"prefill v, layer {li}")
    for t in range(s0, s0 + 3):
        pos = np.full((B,), t, np.int32)
        logits, caches = model.decode_step(
            params, torch.from_numpy(tokens[:, t]), caches,
            torch.from_numpy(pos))
        jlogits, jcaches = jmodel.decode_step(
            jparams, jnp.asarray(tokens[:, t]), jcaches, jnp.asarray(pos))
        _close(logits, jlogits, tol_decode, f"decode logits @ {t}")
    for (k, v), (jk, jv) in zip(_cache_leaves(caches),
                                _jax_cache_leaves(jcaches, jcfg)):
        _close(k, jk, tol_decode, "decoded k")
        _close(v, jv, tol_decode, "decoded v")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax_float32(arch):
    _parity(arch, "float32", TOL, TOL)


def test_phi3_bf16_matches_jax_within_reference_tolerance():
    _parity("phi3-mini-3.8b", "bfloat16", 3e-2, 5e-2)


@pytest.mark.parametrize("arch,s,s0", [(a, S, S // 2)
                                       for a in ARCHS + DECODERS_11A]
                         + [("gemma2-2b", 40, 20)])
def test_decode_matches_forward(arch, s, s0):
    """The port's twin of the reference's test (bf16 smoke configs); the
    gemma2 (40, 20) case prefills past its 16-token window, so the local
    layers' ring caches keep the last window."""
    cfg = port_configs.get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    tokens, _ = _inputs(cfg, seed=1, s=s)
    tokens = torch.from_numpy(tokens)
    tf_logits = _np(T.logits_fn(params, cfg,
                                T.forward(params, cfg, tokens)[0]))
    logits0, caches = model.prefill(params, tokens[:, :s0], max_len=s)
    np.testing.assert_allclose(_np(logits0), tf_logits[:, s0 - 1],
                               rtol=3e-2, atol=3e-2)
    if cfg.pattern[0].window is not None and s0 > cfg.pattern[0].window:
        assert caches[0]["mixer"]["k"].shape[1] == cfg.pattern[0].window
    for t in range(s0, s):
        logits, caches = model.decode_step(
            params, tokens[:, t], caches, torch.full((B,), t))
        np.testing.assert_allclose(_np(logits), tf_logits[:, t], rtol=5e-2,
                                   atol=5e-2, err_msg=f"{arch}@{t}")


ATTN_CASES = {
    "causal_gqa": dict(),
    "window_softcap": dict(window=5, logit_cap=50.0),
    "padded_chunks": dict(kv_chunk=7),
    "valid_len_offset": dict(causal=False, q_offset=3, kv_valid=True),
    "p_bf16": dict(p_bf16=True, kv_chunk=8),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_jax_and_blocking_changes_nothing(
        case, monkeypatch):
    """The chunked path against JAX's at 1e-5.  With the query blocks
    forced down to 3 rows, the chunks a whole block masks are skipped:
    that run equals (``torch.equal``) the same blocks with every chunk
    visited (``kv_valid_len`` = T adds 0.0 and turns skipping off), and
    differs from the one-block run only by the matrix products' float
    order at another row count (1e-6)."""
    kw = dict(ATTN_CASES[case])
    kv_valid = kw.pop("kv_valid", False)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 19, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 19, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 19, 2, 8)).astype(np.float32)
    valid = np.array([19, 11], np.int32) if kv_valid else None
    kw.setdefault("kv_chunk", 4)
    want = JA.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        kv_valid_len=None if valid is None
                        else jnp.asarray(valid), **kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tvalid = None if valid is None else torch.from_numpy(valid)
    one = TA.attention(tq, tk, tv, kv_valid_len=tvalid, **kw)
    np.testing.assert_allclose(one.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    monkeypatch.setattr(TA, "SCORE_BLOCK_ELEMENTS",
                        3 * 2 * 4 * kw["kv_chunk"])
    blocked = TA.attention(tq, tk, tv, kv_valid_len=tvalid, **kw)
    visited = TA.attention(tq, tk, tv, kv_valid_len=tvalid if kv_valid
                           else torch.full((2,), 19), **kw)
    assert torch.equal(blocked, visited)
    np.testing.assert_allclose(blocked.numpy(), one.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS + UNPORTED)
def test_config_copies_and_param_count_match_jax(arch):
    for get, jget in ((port_configs.get_config, jax_get_config),
                      (port_configs.get_smoke_config, jax_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.n_groups == jcfg.n_groups
        assert cfg.tail_pattern == tuple(
            T.LayerSpec(**dataclasses.asdict(s)) for s in jcfg.tail_pattern)
    assert port_configs.list_archs() == list(
        __import__("repro.configs", fromlist=["x"]).list_archs())


def test_shapes_copy_matches_jax():
    from repro.configs import shapes as jshapes
    assert {k: dataclasses.asdict(v)
            for k, v in port_configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert port_configs.get_shape("decode_32k").seq_len == 32768


@pytest.mark.parametrize("arch", UNPORTED)
def test_item_11a_archs_are_accepted_and_carry_jax_weights(arch):
    """Item 11a landed: the five configurations the port refused until
    then (naming the item) are accepted by ``get_config``,
    ``get_smoke_config``, ``get_model`` and ``params_from_numpy``; the
    carried JAX weights have the names and shapes of the port's own
    ``init``, and the smoke model runs a step on the CPU."""
    cfg = port_configs.get_smoke_config(arch)
    assert port_configs.get_config(arch).family == cfg.family
    model = get_model(cfg)
    own = model.init(0, device="cpu")
    jcfg = jax_smoke_config(arch)
    jparams = jax.jit(jax_get_model(jcfg).init)(jax.random.PRNGKey(0))
    carried = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                "cpu")
    mine = {k: (tuple(v.shape), v.dtype) for k, v in own.named_parameters()}
    assert mine == {k: (tuple(v.shape), v.dtype)
                    for k, v in carried.named_parameters()}
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        mem = model.encode(own, torch.zeros((1, 8, cfg.d_model)))
        logits, _ = model.encdec_decode_step(
            own, torch.tensor([1]), encdec.init_self_cache(cfg, 1, "cpu"),
            encdec.build_cross_cache(own, cfg, mem), torch.tensor([0]))
    else:
        _, caches = model.prefill(own, torch.ones((1, 4), dtype=torch.long))
        logits, _ = model.decode_step(own, torch.tensor([1]), caches,
                                      torch.tensor([4]))
    assert logits.shape == (1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_encdec_decode_steps_equal_teacher_forced_decode():
    """Item 11a landed: ``Model.encode`` and ``encdec_decode_step`` run
    the whisper smoke model, and step by step give the teacher-forced
    ``encdec.decode``'s logits (float32, 1e-4); no source file of the
    port still names item 11a."""
    import pathlib

    from repro_torch.models import encdec

    cfg = dataclasses.replace(port_configs.get_smoke_config("whisper-base"),
                              dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 5)))
    mem = model.encode(params, frames)
    forced = encdec.logits_fn(params, encdec.decode(params, cfg, tokens, mem))
    sc, cross = encdec.init_self_cache(cfg, 2, "cpu"), \
        encdec.build_cross_cache(params, cfg, mem)
    for t in range(tokens.shape[1]):
        logits, sc = model.encdec_decode_step(params, tokens[:, t], sc, cross,
                                              torch.full((2,), t))
        np.testing.assert_allclose(logits.numpy(), forced[:, t].numpy(),
                                   rtol=TOL, atol=TOL)
    src = pathlib.Path(T.__file__).resolve().parents[1]
    named = [str(f) for f in src.rglob("*.py") if "11a" in f.read_text()]
    assert named == []


def test_untied_lm_head_is_its_own_draw():
    """The reference draws lm_head from the embedding's key (so an untied
    model starts with the two tables equal); the port does not."""
    cfg = port_configs.get_smoke_config("phi3-mini-3.8b")
    assert not cfg.tie_embeddings
    params = get_model(cfg).init(0, device="cpu")
    assert params.lm_head.shape == params.embedding.shape
    assert not torch.equal(params.lm_head, params.embedding)
    jparams = jax_get_model(jax_smoke_config("phi3-mini-3.8b")).init(
        jax.random.PRNGKey(0))
    assert np.array_equal(np.asarray(jparams["lm_head"], np.float32),
                          np.asarray(jparams["embedding"], np.float32))
    again = get_model(cfg).init(0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(),
                                                 again.parameters()))


def test_parameters_keep_the_reference_names_and_shapes():
    jcfg, _, jparams, cfg, _, params = _pair("gemma2-2b", "bfloat16")
    own = get_model(cfg).init(0, device="cpu")
    names = dict(own.named_parameters())
    assert set(names) == set(dict(params.named_parameters()))
    for g in range(jcfg.n_groups):
        for i in range(len(jcfg.pattern)):
            flat = jax.tree_util.tree_flatten_with_path(
                jparams["groups"][f"l{i}"])[0]
            for path, leaf in flat:
                key = ".".join(str(p.key) for p in path)
                name = f"layers.{g * len(jcfg.pattern) + i}.{key}"
                assert tuple(names[name].shape) == leaf.shape[1:], name
                assert names[name].dtype == torch.bfloat16, name
    assert "lm_head" not in names                    # gemma2 ties
