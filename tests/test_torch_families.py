"""The port's MoE, RG-LRU and RWKV6 decoders against the JAX package.

Weights come from the JAX ``init`` and are carried across with
``interop.params_from_numpy``; tokens and inputs are made from a numpy
seed.  In float32 (TF32 off) the port's ``forward`` logits, ``prefill``
logits and caches (recurrent states included) and three ``decode_step``s
hold to the JAX package's at rtol = atol = 1e-4 for the smoke configs of
qwen3-moe, dbrx, recurrentgemma and rwkv6, and so does a decode from JAX's
own prefill caches carried across with ``interop.caches_from_numpy``.
The engine: a fresh 1-slot engine gives JAX's engine tokens, and a
2-slot engine gives each request the tokens it gets served alone (the JAX
engine does not, for rwkv6: its prompt feed advances the other slot's
recurrent state).  The blocks, and bf16 parity against the reference's
op-by-op program, are in ``test_torch_moe.py`` and
``test_torch_recurrent.py``.
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.models import transformer as JT
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.interop import caches_from_numpy, model_config_from_dict
from repro_torch.models import get_model
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

import torch_parity

FAMILIES = ["qwen3-moe-30b-a3b", "dbrx-132b", "recurrentgemma-9b",
            "rwkv6-1.6b"]
B, S = 2, 24
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _state_leaves(caches):
    """Every tensor of the port's per-layer caches, with its path."""
    out = []
    for li, lc in enumerate(caches):
        for part in ("mixer", "ffn"):
            for name, v in sorted(lc[part].items() if lc[part] else ()):
                out.append((f"layer {li} {part}.{name}", v))
    return out


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return (request.param,) + torch_parity.model_pair(request.param)


def test_forward_prefill_decode_match_jax_float32(family):
    arch, jcfg, jmodel, jparams, cfg, model, params = family
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)
    hidden = T.forward(params, cfg, torch.from_numpy(tokens))
    _close(T.logits_fn(params, cfg, hidden), jax.jit(
        lambda p, t: JT.logits_fn(p, jcfg, JT.forward(p, jcfg, t)[0]))(
            jparams, jnp.asarray(tokens)), TOL, "forward")

    s0 = S // 2
    logits, caches = model.prefill(params, torch.from_numpy(tokens[:, :s0]),
                                   max_len=S)
    jlogits, jcaches = jax.jit(functools.partial(jmodel.prefill, max_len=S))(
        jparams, jnp.asarray(tokens[:, :s0]))
    _close(logits, jlogits, TOL, "prefill logits")
    carried = caches_from_numpy(jax.tree.map(np.asarray, jcaches), cfg, "cpu")
    mine, theirs = _state_leaves(caches), _state_leaves(carried)
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    for (name, a), (_, b) in zip(mine, theirs):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        _close(a, b, TOL, f"prefill cache {name}")
    jstep = jax.jit(jmodel.decode_step)
    for t in range(s0, s0 + 3):
        pos = np.full((B,), t, np.int32)
        tok = torch.from_numpy(tokens[:, t])
        logits, caches = model.decode_step(params, tok, caches,
                                           torch.from_numpy(pos))
        # the same step from JAX's caches, carried across
        from_jax, carried = model.decode_step(params, tok, carried,
                                              torch.from_numpy(pos))
        jlogits, jcaches = jstep(jparams, jnp.asarray(tokens[:, t]), jcaches,
                                 jnp.asarray(pos))
        _close(logits, jlogits, TOL, f"decode logits @ {t}")
        _close(from_jax, jlogits, TOL, f"decode from JAX caches @ {t}")
    again = caches_from_numpy(jax.tree.map(np.asarray, jcaches), cfg, "cpu")
    for (name, a), (_, b) in zip(_state_leaves(caches),
                                 _state_leaves(again)):
        _close(a, b, TOL, f"decoded cache {name}")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_recurrent_state_does_not_grow_with_context(arch):
    """RG-LRU and RWKV6 layers keep a fixed-size state: the same bytes
    after an 8- and a 40-token prefill."""
    cfg = model_config_from_dict(dataclasses.asdict(jax_smoke_config(arch)))
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    sizes = []
    for s in (8, 40):
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab, size=(1, s)))
        _, caches = model.prefill(params, tokens, max_len=s)
        sizes.append([[tuple(v.shape) for _, v in _state_leaves([lc])]
                      for lc, spec in zip(caches, T.layer_specs(cfg))
                      if spec.kind != "attn"])
    assert sizes[0] and sizes[0] == sizes[1]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

PROMPTS = [np.random.default_rng(20 + i).integers(0, 512, size=6)
           for i in range(3)]
MAX_NEW = 5


def _served(engine, prompts):
    reqs = [engine.submit(p, max_new=MAX_NEW) for p in prompts]
    engine.run_to_completion()
    assert all(r.done and len(r.out) == MAX_NEW for r in reqs)
    return [r.out for r in reqs]


def test_one_slot_engine_matches_jax_engine(family):
    """A fresh 1-slot engine per request, in both packages (float32, so
    greedy argmax has no bf16 ties)."""
    arch, jcfg, jmodel, jparams, cfg, model, params = family
    for prompt in PROMPTS[:2]:
        mine = _served(ServeEngine(model, params, n_slots=1, max_len=32),
                       [prompt])
        theirs = _served(JaxServeEngine(jmodel, jparams, n_slots=1,
                                        max_len=32), [prompt])
        assert mine == theirs, (arch, mine, theirs)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-9b",
                                  "qwen3-moe-30b-a3b"])
def test_two_slot_engine_equals_each_request_alone(arch):
    """Each slot is isolated: 3 requests through 2 slots (one refill)
    get the tokens each gets from a fresh 1-slot engine."""
    cfg = dataclasses.replace(
        model_config_from_dict(dataclasses.asdict(jax_smoke_config(arch))),
        dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    alone = [_served(ServeEngine(model, params, n_slots=1, max_len=32),
                     [p])[0] for p in PROMPTS]
    together = _served(ServeEngine(model, params, n_slots=2, max_len=32),
                       PROMPTS)
    assert together == alone, (arch, together, alone)


def test_reference_engine_leaks_recurrent_state_across_slots():
    """The fault the port's engine does not copy: the JAX engine's prompt
    feed advances the other slot's RWKV state, so a request served
    beside another gets other tokens than served alone."""
    jcfg = dataclasses.replace(jax_smoke_config("rwkv6-1.6b"),
                               dtype="float32")
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    alone = [_served(JaxServeEngine(jmodel, jparams, n_slots=1, max_len=32),
                     [p])[0] for p in PROMPTS]
    together = _served(JaxServeEngine(jmodel, jparams, n_slots=2,
                                      max_len=32), PROMPTS)
    assert together != alone
