"""The port's AdamW, schedules and clipping against the JAX package's.

- ``warmup_cosine`` and ``constant`` over a range of steps, ``global_norm``
  and ``clip_by_global_norm`` on a random tree: float32, to rtol 1e-6;
- one AdamW update from a carried-across state (random parameters,
  gradients and moments of a smoke model, count 3; the moments kept away
  from 0 so the step is a smooth function of its inputs), with and
  without clipping: moments and count equal JAX's (rtol 1e-6), the
  parameters to rtol 1e-6 / atol 1e-7, except the 1-d parameters of the
  reference's stacked groups, where the reference decays and the port
  does not (there the port's minus JAX's is lr * wd * p);
- the pin of that fault: JAX's AdamW decays a norm scale inside its
  groups ([n_groups, d]) and not the same kind of scale in its tail or
  ``final_norm``; the port's decays none of them.
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parity
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.optim import adamw as J
from repro_torch.interop import model_config_from_dict, train_state_from_numpy
from repro_torch.optim import adamw as P

LR, WD = 3e-3, 0.1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_schedules_match_jax():
    for args in ((3e-3, 5, 60), (1e-3, 0, 10, 0.2), (3e-4, 50, 50)):
        js, ps = J.warmup_cosine(*args), P.warmup_cosine(*args)
        for step in range(0, 70, 3):
            np.testing.assert_allclose(float(ps(step)),
                                       float(js(jnp.int32(step))),
                                       rtol=1e-6, err_msg=f"{args} {step}")
            assert ps(step).dtype == torch.float32
    assert float(P.constant(1e-3)(7)) == float(J.constant(1e-3)(7))


def _random_tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 3).astype(np.float32)
            for k, s in shapes.items()}


def test_global_norm_and_clip_match_jax():
    tree = _random_tree(0, {"a": (4, 8), "b": (7,), "c": (3, 2, 5)})
    ported = {k: torch.from_numpy(v) for k, v in tree.items()}
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    np.testing.assert_allclose(float(P.global_norm(ported)),
                               float(J.global_norm(jtree)), rtol=1e-6)
    for max_norm in (1.0, 1e3):
        got, norm = P.clip_by_global_norm(ported, max_norm)
        want, jnorm = J.clip_by_global_norm(jtree, max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
    bf = {"x": torch.from_numpy(tree["a"]).to(torch.bfloat16)}
    got, _ = P.clip_by_global_norm(bf, 1.0)
    assert got["x"].dtype == torch.bfloat16


def _carried_state(arch, seed=0):
    """JAX parameters, gradients and AdamW state (count 3) of ``arch``'s
    float32 smoke model, every leaf random (numpy), the moments' v away
    from 0."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    shapes = jax.eval_shape(jax_get_model(jcfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(scale, positive=False):
        def leaf(s):
            x = rng.standard_normal(s.shape).astype(np.float32) * scale
            return np.abs(x) + scale if positive else x
        return jax.tree.map(leaf, shapes)

    params, grads = draw(0.5), draw(0.05)
    opt = {"m": draw(0.01), "v": draw(1e-3, positive=True),
           "count": np.int32(3)}
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    return cfg, params, grads, opt


@pytest.mark.parametrize("max_grad_norm", [1.0, None])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "qwen3-moe-30b-a3b"])
def test_one_update_from_a_carried_state_matches_jax(arch, max_grad_norm):
    cfg, params, grads, opt = _carried_state(arch)
    jopt = J.AdamW(lr=J.warmup_cosine(LR, 2, 10), weight_decay=WD,
                   max_grad_norm=max_grad_norm)
    jparams, jstate, jmetrics = jax.jit(jopt.update)(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, opt),
        jax.tree.map(jnp.asarray, params))
    state = train_state_from_numpy(
        {"params": params, "opt_state": opt, "step": 3}, cfg, "cpu")
    popt = P.AdamW(lr=P.warmup_cosine(LR, 2, 10), weight_decay=WD,
                   max_grad_norm=max_grad_norm)
    before = torch_parity.port_named(params, cfg)
    out, new_state, metrics = popt.update(
        torch_parity.port_named(grads, cfg), state.opt_state, state.params)
    assert out is state.params and new_state["count"] == 4
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(metrics["lr"], float(jmetrics["lr"]),
                               rtol=1e-6)
    lr = metrics["lr"]
    for k in ("m", "v"):
        want = torch_parity.port_named(jstate[k], cfg)
        for name, t in new_state[k].items():
            torch.testing.assert_close(t, want[name], rtol=1e-6, atol=1e-9,
                                       msg=lambda m, n=name: f"{k} {n}: {m}")
    torch_parity.assert_update_matches(
        {k: v.detach() for k, v in out.named_parameters()},
        torch_parity.port_named(jparams, cfg), before, cfg, lr=lr, wd=WD,
        rtol=1e-6, atol=1e-7)
    assert torch_parity.reference_decays(cfg, before)   # the pin applies


def test_reference_decays_group_norm_scales_and_the_port_does_not():
    """With zero gradients and moments an update is the decay alone: JAX
    scales recurrentgemma's in-group ``pre_norm`` ([n_groups, d]) by
    (1 - lr wd) and leaves its tail layer's and ``final_norm`` as they
    were; the port leaves all three as they were, and decays the 2-d
    weights as JAX does."""
    cfg, params, grads, opt = _carried_state("recurrentgemma-9b")
    assert cfg.n_groups >= 1 and cfg.tail_pattern
    zeros = jax.tree.map(np.zeros_like, params)
    opt = {"m": zeros, "v": zeros, "count": np.int32(0)}
    jopt = J.AdamW(lr=J.constant(LR), weight_decay=WD)
    jparams, _, _ = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, zeros),
                                         jax.tree.map(jnp.asarray, opt),
                                         jax.tree.map(jnp.asarray, params))
    shrink = np.float32(1) - np.float32(LR) * np.float32(WD)
    group = params["groups"]["l0"]["pre_norm"]["scale"]
    np.testing.assert_allclose(
        np.asarray(jparams["groups"]["l0"]["pre_norm"]["scale"]),
        group * shrink, rtol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(jparams["tail"][0]["pre_norm"]["scale"]),
        params["tail"][0]["pre_norm"]["scale"])
    np.testing.assert_array_equal(np.asarray(jparams["final_norm"]["scale"]),
                                  params["final_norm"]["scale"])

    state = train_state_from_numpy(
        {"params": params, "opt_state": opt, "step": 0}, cfg, "cpu")
    before = torch_parity.port_named(params, cfg)
    P.AdamW(lr=P.constant(LR), weight_decay=WD).update(
        torch_parity.port_named(zeros, cfg), state.opt_state, state.params)
    after = {k: v.detach() for k, v in state.params.named_parameters()}
    tail = f"layers.{cfg.n_layers - 1}"
    for name in ("layers.0.pre_norm.scale", f"{tail}.pre_norm.scale",
                 "final_norm.scale"):
        assert torch.equal(after[name], before[name]), name
    w = "layers.0.mixer.wq" if "layers.0.mixer.wq" in after else next(
        k for k, v in after.items() if v.dim() >= 2 and k.startswith(
            "layers.0."))
    torch.testing.assert_close(after[w], before[w] * float(shrink),
                               rtol=1e-6, atol=1e-8)
