"""The port's serving engine and promote-to-retrieval, against the JAX
package where there is one to hold them to.

The four tests of ``tests/test_serve.py`` run on the port's engine (a
float32 phi3-mini smoke model, so greedy argmax has no bf16 ties; the
manual greedy oracle runs the engine's own ``decode_step`` at the engine's
batch shape).  ``promote_to_retrieval`` is held to JAX's on the same
prefill caches: the same shapes, centroids, projectors (eigenvector signs
may differ), scales, raw tiers and tails.  Then ``decode_step`` on JAX's
promoted caches carried across with ``interop.caches_from_numpy`` gives
JAX's logits within 1e-4 and the same tails, the twin of
``tests/test_hntl_kv.py::test_long_context_decode_step_integration`` runs,
and ``launch.serve.main`` serves on the CPU with a memory sidecar and two
tenants.
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models import hntl_attention as JH
from repro.serve.engine import promote_to_retrieval as jax_promote
from repro_torch.configs import get_smoke_config
from repro_torch.interop import (caches_from_numpy, model_config_from_dict,
                                 params_from_numpy)
from repro_torch.models import get_model
from repro_torch.models import hntl_attention as H
from repro_torch.serve.engine import ServeEngine, promote_to_retrieval

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served():
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"), n_layers=2,
                              dtype="float32")
    model = get_model(cfg)
    return cfg, model, model.init(0, device="cpu")


def test_engine_matches_manual_greedy(served):
    cfg, model, params = served
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=8)
    n_slots, max_new = 2, 6
    engine = ServeEngine(model, params, n_slots=n_slots, max_len=64)

    caches = model.init_cache(n_slots, 64, "cpu")
    token_buf = np.zeros(n_slots, np.int64)
    pos = np.zeros(n_slots, np.int64)
    for tok in prompt[:-1]:                       # per-slot prefill feed
        token_buf[:] = 0
        token_buf[0] = tok
        _, caches = model.decode_step(params, torch.from_numpy(token_buf),
                                      caches, torch.from_numpy(pos))
        pos[0] += 1
    token_buf[0] = prompt[-1]
    out_manual = []
    for _ in range(max_new):
        logits, caches = model.decode_step(
            params, torch.from_numpy(token_buf), caches,
            torch.from_numpy(pos))
        cur = int(logits[0].argmax())
        out_manual.append(cur)
        pos[0] += 1
        token_buf[0] = cur

    req = engine.submit(prompt, max_new=max_new)
    engine.run_to_completion()
    assert req.done
    assert req.out == out_manual, (req.out, out_manual)


def test_engine_batched_slots(served):
    cfg, model, params = served
    rng = np.random.default_rng(1)
    engine = ServeEngine(model, params, n_slots=2, max_len=64)
    reqs = [engine.submit(rng.integers(0, cfg.vocab, size=6), max_new=4)
            for _ in range(5)]                     # more requests than slots
    engine.run_to_completion()
    assert all(r.done and len(r.out) == 4 for r in reqs)


def test_rids_unique_across_submit_waves(served):
    cfg, model, params = served
    rng = np.random.default_rng(2)
    engine = ServeEngine(model, params, n_slots=2, max_len=64)
    reqs = [engine.submit(rng.integers(0, cfg.vocab, size=4), max_new=2)
            for _ in range(3)]
    engine.step()                                  # drains queue into slots
    reqs += [engine.submit(rng.integers(0, cfg.vocab, size=4), max_new=2)
             for _ in range(3)]                    # second wave
    rids = [r.rid for r in reqs]
    assert len(set(rids)) == len(rids), rids
    assert rids == sorted(rids)
    engine.run_to_completion()
    assert all(r.done for r in reqs)


def test_engine_temperature_sampling_is_seeded(served):
    cfg, model, params = served
    outs = []
    for _ in range(2):
        engine = ServeEngine(model, params, n_slots=2, max_len=64,
                             temperature=0.8, seed=5)
        reqs = [engine.submit(np.arange(1, 5 + i), max_new=5)
                for i in range(3)]
        engine.run_to_completion()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(o) == 5 for o in outs[0])


def test_promote_to_retrieval(served):
    cfg, _, params = served
    cfg2 = dataclasses.replace(cfg, kv_pool=32, kv_nprobe=2)
    model2 = get_model(cfg2)
    b, s = 1, 3 * cfg2.kv_cap + 5                 # 3 sealable grains + tail
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg2.vocab, size=(b, s)))
    _, caches = model2.prefill(params, tokens, max_len=s + 64)
    promoted = promote_to_retrieval(model2, caches, cache_len=s)
    mix = promoted[0]["mixer"]
    assert isinstance(mix, H.KVIndex)
    assert mix.k_raw.shape[1] == 3 * cfg2.kv_cap
    logits, new = model2.decode_step(params, torch.tensor([1]), promoted,
                                     torch.tensor([s]))
    assert bool(torch.isfinite(logits).all())
    assert isinstance(new[1]["mixer"], H.KVIndex)


# ---------------------------------------------------------------------------
# promote_to_retrieval and retrieval decode against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def promoted_pair():
    """gemma2's smoke model (local ring layers stay linear, global layers
    are promoted) in float32, prefilled by JAX on 3 grains + 5 tokens,
    promoted by JAX and by the port on the carried caches."""
    jcfg = dataclasses.replace(jax_smoke_config("gemma2-2b"),
                               dtype="float32", kv_pool=32, kv_nprobe=2)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    b, s = 2, 3 * cfg.kv_cap + 5
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, size=(b, s))
    _, jcaches = jmodel.prefill(jparams, jnp.asarray(tokens, jnp.int32),
                                max_len=s + 24)
    jprom = jax_promote(jmodel, jcaches, cache_len=s)
    caches = caches_from_numpy(jax.tree.map(np.asarray, jcaches), cfg, "cpu")
    prom = promote_to_retrieval(get_model(cfg), caches, cache_len=s)
    carried = caches_from_numpy(jax.tree.map(np.asarray, jprom), cfg, "cpu")
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, cfg=cfg,
                params=params, s=s, b=b, jprom=jprom, prom=prom,
                carried=carried)


def _projector(basis):
    b = basis.float().numpy()
    return np.einsum("...hk,...gk->...hg", b, b)


def test_promoted_indexes_match_jax(promoted_pair):
    pp = promoted_pair
    cfg = pp["cfg"]
    kinds = [spec.window is None for spec in
             list(cfg.pattern) * cfg.n_groups]
    assert len(pp["prom"]) == len(pp["carried"]) == cfg.n_layers
    for li, (mine, theirs, is_global) in enumerate(
            zip(pp["prom"], pp["carried"], kinds)):
        m, t = mine["mixer"], theirs["mixer"]
        if not is_global:                          # ring caches stay linear
            assert not isinstance(m, H.KVIndex)
            assert torch.equal(m["k"], t["k"]) and torch.equal(m["v"], t["v"])
            continue
        assert isinstance(m, H.KVIndex) and isinstance(t, H.KVIndex)
        for name in ("centroids", "basis", "coords", "res", "scale",
                     "res_scale", "k_raw", "v_raw", "tail_k", "tail_v"):
            a, c = getattr(m, name), getattr(t, name)
            assert a.shape == c.shape and a.dtype == c.dtype, (li, name)
        assert m.k_scale is None and t.k_scale is None
        np.testing.assert_allclose(m.centroids.numpy(), t.centroids.numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(_projector(m.basis), _projector(t.basis),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(m.scale.numpy(), t.scale.numpy(),
                                   rtol=1e-4)
        np.testing.assert_allclose(m.res_scale.numpy(), t.res_scale.numpy(),
                                   rtol=1e-4)
        for name in ("k_raw", "v_raw", "tail_k", "tail_v"):
            assert torch.equal(getattr(m, name), getattr(t, name)), name
        assert m.sealed_len == 3 * cfg.kv_cap
        assert bool((m.tail_k[:, 5:] == 0).all())


def test_decode_on_carried_promoted_caches_matches_jax(promoted_pair):
    pp = promoted_pair
    model = get_model(pp["cfg"])
    caches, jcaches = pp["carried"], pp["jprom"]
    rng = np.random.default_rng(5)
    for step in range(3):
        tok = rng.integers(0, pp["cfg"].vocab, size=pp["b"]).astype(np.int32)
        pos = np.full((pp["b"],), pp["s"] + step, np.int32)
        logits, caches = model.decode_step(pp["params"], torch.from_numpy(tok),
                                           caches, torch.from_numpy(pos))
        jlogits, jcaches = pp["jmodel"].decode_step(
            pp["jparams"], jnp.asarray(tok), jcaches, jnp.asarray(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL, err_msg=f"step {step}")
    again = caches_from_numpy(jax.tree.map(np.asarray, jcaches), pp["cfg"],
                              "cpu")
    for mine, theirs in zip(caches, again):
        m, t = mine["mixer"], theirs["mixer"]
        if isinstance(m, H.KVIndex):
            np.testing.assert_allclose(m.tail_k.numpy(), t.tail_k.numpy(),
                                       rtol=TOL, atol=TOL)
        else:
            np.testing.assert_allclose(m["k"].numpy(), t["k"].numpy(),
                                       rtol=TOL, atol=TOL)


def test_port_promoted_decode_is_close_to_jax(promoted_pair):
    """The port's own promoted index (its eigenvector signs) decodes to
    JAX's logits within 1e-3: the candidate pools agree, float order
    differs."""
    pp = promoted_pair
    tok = np.array([3, 7], np.int32)
    pos = np.full((pp["b"],), pp["s"], np.int32)
    logits, _ = get_model(pp["cfg"]).decode_step(
        pp["params"], torch.from_numpy(tok), pp["prom"],
        torch.from_numpy(pos))
    jlogits, _ = pp["jmodel"].decode_step(pp["jparams"], jnp.asarray(tok),
                                          pp["jprom"], jnp.asarray(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-3, atol=1e-3)


def test_long_context_decode_step_integration():
    """Full decode_step with a KVIndex mixer cache on a smoke model."""
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              n_layers=2, kv_pool=32, kv_nprobe=2)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 4 * cfg.kv_cap
    rng = np.random.default_rng(1)
    k_raw = torch.from_numpy(rng.standard_normal(
        (b, s, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32))
    v_raw = torch.from_numpy(rng.standard_normal(k_raw.shape)
                             .astype(np.float32))
    idx = H.build_kv_index(k_raw.to(torch.bfloat16).float(),
                           v_raw.to(torch.bfloat16).float(), cfg,
                           device="cpu")
    caches = [{"mixer": idx, "ffn": ()}, {"mixer": idx, "ffn": ()}]
    logits, new = model.decode_step(params, torch.ones(b, dtype=torch.long),
                                    caches, torch.full((b,), s + 1))
    assert logits.shape == (b, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert isinstance(new[0]["mixer"], H.KVIndex)
    assert not torch.equal(new[0]["mixer"].tail_k, idx.tail_k)
    assert torch.equal(caches[0]["mixer"].tail_k, idx.tail_k)   # inputs kept


def test_serve_main_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    reqs = serve.main(["--arch", "phi3-mini-3.8b", "--smoke", "--device",
                       "cpu", "--retrieval-docs", "512", "--tenants", "2",
                       "--requests", "3", "--max-new", "4"])
    assert len(reqs) == 3
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert [r.rid for r in reqs] == [0, 1, 2]
    out = capsys.readouterr().out
    assert "retrieval sidecar: 512 docs" in out
    assert "2 tenants coalesced" in out


def test_serve_main_refuses_bad_flags():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="bad adaptive"):
        serve.main(["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
                    "--probe-margin", "0.2"])
    with pytest.raises(SystemExit, match="--tenants requires"):
        serve.main(["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
                    "--tenants", "2"])
    # the reference's launcher refuses an encoder-decoder too
    with pytest.raises(SystemExit, match="encoder-decoder"):
        serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu"])
