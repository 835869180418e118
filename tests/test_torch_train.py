"""The port's training loss, gradients and train step against the JAX
package's.

Weights come from the JAX ``init`` and are carried across with
``interop.params_from_numpy``; batches (tokens, labels with -100 masked
slots, qwen2-vl's three position streams and patch embeddings, whisper's
frames) are made from a numpy seed.  In float32 (TF32 off):

- ``Model.loss`` and every gradient equal JAX's ``value_and_grad`` of its
  ``model.loss`` for the five attention-only smoke configs
  (``torch_parity.loss_grad_parity``: the loss to rtol 1e-5, each
  gradient leaf within 1e-4 * its own max |g| of JAX's, the reference's
  gradients unstacked into the port's layers; the other five families
  are in ``test_torch_train_families.py``);
- remat "full", "dots" and "none" give equal losses and gradients
  (``torch.equal``: the recomputation runs the same ops);
- the port's ``microbatches=4`` step equals JAX's (updated parameters to
  rtol 1e-5 / atol 1e-6 at eps 1e-3, except the 1-d parameters of the
  reference's stacked layers, which its AdamW decays and the port's does
  not: there the difference is lr * wd * p), and the port's 1 equals its
  4 to the same tolerance;

and in bf16 one train step of every architecture changes the parameters
and keeps them finite (the twin of
``tests/test_models.py::test_smoke_forward_and_train_step``).
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parity
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import constant as jax_constant
from repro.train import step as jax_step
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import MarkovLM
from repro_torch.interop import train_state_from_numpy
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamW, constant
from repro_torch.train.step import init_state, make_train_step

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", torch_parity.ATTENTION_ARCHS)
def test_loss_and_grads_match_jax_float32(arch):
    torch_parity.loss_grad_parity(arch)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-9b", "whisper-base"])
def test_remat_policies_give_equal_losses_and_grads(arch):
    base = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    batch = {k: torch.from_numpy(v)
             for k, v in torch_parity.train_batch(base).items()}
    runs = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots"),
                          (True, "none")):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        model = get_model(cfg)
        params = model.init(0, device="cpu").requires_grad_(True)
        runs[remat, policy] = torch_parity.loss_and_grads(model, params,
                                                           batch)
    (loss0, _, grads0) = runs.pop((False, "full"))
    for key, (loss, _, grads) in runs.items():
        assert torch.equal(loss, loss0), key
        for k in grads0:
            assert torch.equal(grads[k], grads0[k]), (key, k)


def _microbatch_setup():
    """phi3-mini's smoke pair and a Markov batch of 8 x 16 (no masked
    label, so the mean over 4 microbatches' token means is the batch's
    token mean, as in ``tests/test_train.py::test_microbatch_equivalence``).
    """
    jcfg, jmodel, jparams, cfg, model, _ = torch_parity.model_pair(
        "phi3-mini-3.8b")
    batch = MarkovLM(vocab=cfg.vocab, seed=2).batch(0, 8, 16)
    return jcfg, jmodel, jparams, cfg, model, batch


def test_microbatches_match_jax_and_one_batch():
    """One AdamW step over 4 microbatches: the port equals JAX's, and the
    port's 4 equals its 1.  At eps = 1e-3 a first Adam step is a smooth
    function of the gradient; at the default 1e-8 an element whose
    gradient is near 0 steps by up to +-lr on the gradient's last bits
    (JAX's own 1 and 4 microbatches then differ by 4.5e-6 here, and by
    2 lr on a batch with masked labels)."""
    jcfg, jmodel, jparams, cfg, model, batch = _microbatch_setup()
    lr, wd, eps = 1e-3, 0.1, 1e-3
    jopt = JaxAdamW(lr=jax_constant(lr), max_grad_norm=None, eps=eps)
    jstate = jax_step.TrainState(params=jparams,
                                 opt_state=jopt.init(jparams),
                                 step=jnp.zeros((), jnp.int32))
    before = torch_parity.port_named(jparams, cfg)
    jnew, jmetrics = jax.jit(jax_step.make_train_step(
        jmodel, jopt, microbatches=4))(jstate, jax.tree.map(jnp.asarray,
                                                            batch))
    opt = AdamW(lr=constant(lr), max_grad_norm=None, eps=eps)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = {}
    for n in (1, 4):
        state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), cfg,
                                       "cpu")
        state, metrics = make_train_step(model, opt, microbatches=n)(state,
                                                                     tb)
        assert state.step == 1 and state.opt_state["count"] == 1
        got[n] = ({k: v.detach().clone()
                   for k, v in state.params.named_parameters()}, metrics)
    np.testing.assert_allclose(float(got[4][1]["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    torch_parity.assert_update_matches(
        got[4][0], torch_parity.port_named(jnew.params, cfg), before, cfg,
        lr=lr, wd=wd, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got[1][1]["loss"]),
                               float(got[4][1]["loss"]), rtol=1e-5)
    for k, v in got[4][0].items():
        torch.testing.assert_close(v, got[1][0][k], rtol=1e-5, atol=1e-6,
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("arch", torch_parity.ALL_ARCHS)
def test_bf16_train_step_changes_params_and_stays_finite(arch):
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    opt = AdamW(lr=constant(1e-3))
    state = init_state(model, opt, 0, device="cpu")
    before = {k: v.detach().clone()
              for k, v in state.params.named_parameters()}
    batch = {k: torch.from_numpy(v)
             for k, v in torch_parity.train_batch(cfg, s=8).items()}
    loss0, _ = model.loss(state.params, batch)
    assert bool(torch.isfinite(loss0))
    state, metrics = make_train_step(model, opt)(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert state.step == 1
    after = dict(state.params.named_parameters())
    assert all(bool(torch.isfinite(v).all()) for v in after.values())
    assert any(not torch.equal(after[k], before[k]) for k in before)
    assert after["embedding" if cfg.family != "encdec"
                 else "dec.embedding"].dtype == torch.bfloat16
