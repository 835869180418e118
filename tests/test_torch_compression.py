"""Compressed data-parallel steps against the JAX package's, and the JAX
one-device step carried across against the port's mesh step.

One subprocess with 8 forced host devices runs the reference's
``make_compressed_train_step`` on ``make_host_mesh(8, 1)`` for each of
``none``, ``bf16`` and ``int8_ef`` (3 steps of phi3-mini's smoke config
cut to 2 layers, float32, AdamW at eps 1e-3 without clipping) and writes
the losses, the step-1 parameters and the step-1 per-device errors to an
``.npz``.  The port runs the same from the same weights carried across on
``["cpu"] * 8`` slots:

- losses within rtol 1e-5;
- step-1 parameters within one quantization step's effect through
  Adam's steepest first-step slope: lr * q / eps + 1e-6, with q one bf16
  step (2^-8) or one int8 step (1/127) of the leaf's largest mean
  gradient, and at most 1 in 1,000 of them off by more than 1e-6;
  int8_ef's per-slot errors within 1e-6;
- a per-slot scale (no maximum over slots) misses that bound.

``tests/test_torch_compression_port.py`` holds the checks that need no
JAX (error feedback's exactness, the 12-step trajectory bounds).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import get_model as ref_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.tokens import MarkovLM  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim.adamw import AdamW, constant  # noqa: E402
from repro_torch.train.step import (init_state, make_train_step,  # noqa
                                    place_train_state)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SCHEMES = ("none", "bf16", "int8_ef")
LR, EPS = 3e-3, 1e-3
Q_STEP = {"none": 2.0 ** -23, "bf16": 2.0 ** -8, "int8_ef": 1 / 127}
LOSS_RTOL = 1e-5

REF = """
import os, sys
import dataclasses, jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.models import get_model
from repro.optim.adamw import AdamW, constant
from repro.distributed.compression import make_compressed_train_step
from repro.data.tokens import MarkovLM
from repro.launch.mesh import make_host_mesh
cfg = dataclasses.replace(get_smoke_config('phi3-mini-3.8b'), n_layers=2,
                          vocab=64, dtype='float32')
model = get_model(cfg)
mesh = make_host_mesh(8, 1)
data = MarkovLM(vocab=cfg.vocab, seed=0)
devs = list(mesh.devices.flat)
out = {}
for scheme in ('none', 'bf16', 'int8_ef'):
    opt = AdamW(lr=constant(%(lr)r), max_grad_norm=None, eps=%(eps)r)
    params = model.init(jax.random.PRNGKey(0))
    st = opt.init(params)
    step, init_err = make_compressed_train_step(model, opt, mesh,
                                                scheme=scheme)
    err = init_err(params)
    losses = []
    for s in range(3):
        b = {k: jnp.asarray(v) for k, v in data.batch(s, 16, 16).items()}
        params, st, err, loss = step(params, st, err, b)
        losses.append(float(loss))
        if s == 0:
            for i, l in enumerate(jax.tree.leaves(params)):
                out[f'{scheme}/p1/{i}'] = np.asarray(l)
            if scheme == 'int8_ef':
                for i, l in enumerate(jax.tree.leaves(err)):
                    by = {x.device: np.asarray(x.data)
                          for x in l.addressable_shards}
                    out[f'{scheme}/err1/{i}'] = np.stack([by[d]
                                                          for d in devs])
    out[f'{scheme}/losses'] = np.asarray(losses)
np.savez(sys.argv[1], **out)
""" % {"lr": LR, "eps": EPS}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("compression") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REF), path],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return dict(np.load(path))


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(ref_smoke("phi3-mini-3.8b"), n_layers=2,
                               vocab=64, dtype="float32")
    jparams = ref_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              n_layers=2, vocab=64, dtype="float32")
    return cfg, jparams


def _port_params(cfg, jparams):
    p = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return p.requires_grad_(True)


def _named(tree_leaves, jparams, cfg) -> dict:
    treedef = jax.tree.structure(jparams)
    return {k: v.detach() for k, v in params_from_numpy(
        jax.tree.unflatten(treedef, tree_leaves), cfg,
        "cpu").named_parameters()}


class _Capture:
    """An optimizer that keeps the gradients of its first update."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, *args):
        if self.grads is None:
            self.grads = {k: v.clone() for k, v in grads.items()}
        return self.opt.update(grads, *args)


def _run(cfg, jparams, scheme, steps=3, slots=8, b=16, lr=LR, eps=EPS,
         clip=None):
    model = get_model(cfg)
    opt = _Capture(AdamW(lr=constant(lr), max_grad_norm=clip, eps=eps))
    params = _port_params(cfg, jparams) if jparams is not None \
        else model.init(0, device="cpu").requires_grad_(True)
    st = opt.init(params)
    mesh = make_host_mesh(slots, 1, devices=["cpu"] * slots)
    step, init_err = compression.make_compressed_train_step(
        model, opt, mesh, scheme=scheme)
    err = init_err(params)
    data = MarkovLM(vocab=cfg.vocab, seed=0)
    losses, p1, e1 = [], None, None
    for s in range(steps):
        batch = {k: torch.from_numpy(v)
                 for k, v in data.batch(s, b, 16).items()}
        params, st, err, loss = step(params, st, err, batch)
        losses.append(float(loss))
        if s == 0:
            p1 = {k: v.detach().clone() for k, v in params.named_parameters()}
            e1 = [{k: v.clone() for k, v in e.items()} for e in err] \
                if scheme == "int8_ef" else None
    return losses, p1, e1, opt.grads


def _param_ratio(p1, want, grads, scheme) -> float:
    """The largest |p1 - want| over its bound lr * q * max|g| / eps +
    1e-6."""
    worst = 0.0
    for k, w in want.items():
        bound = LR * Q_STEP[scheme] * float(grads[k].abs().max()) / EPS \
            + 1e-6
        worst = max(worst, float((p1[k] - w).abs().max()) / bound)
    return worst


@pytest.mark.parametrize("scheme", SCHEMES)
def test_compressed_step_equals_the_reference(scheme, ref, pair):
    cfg, jparams = pair
    losses, p1, e1, _ = _run(cfg, jparams, scheme)
    _, _, _, exact = _run(cfg, jparams, "none", steps=1)
    np.testing.assert_allclose(losses, ref[f"{scheme}/losses"],
                               rtol=LOSS_RTOL)
    n = len(jax.tree.leaves(jparams))
    want = _named([ref[f"{scheme}/p1/{i}"] for i in range(n)], jparams, cfg)
    assert _param_ratio(p1, want, exact, scheme) <= 1.0
    # element by element: at most 1 in 1,000 parameters off by 1e-6 (a
    # bf16 sum rounded add by add, not once, moves ~40% of them)
    off = sum(int(((p1[k] - w).abs() > 1e-6).sum()) for k, w in want.items())
    assert off <= 1e-3 * sum(w.numel() for w in want.values()), off
    if scheme == "int8_ef":
        for slot in range(8):
            e_ref = _named([ref[f"int8_ef/err1/{i}"][slot] for i in range(n)],
                           jparams, cfg)
            for k, v in e_ref.items():
                np.testing.assert_allclose(e1[slot][k].numpy(), v.numpy(),
                                           rtol=0, atol=1e-6, err_msg=k)


def test_a_per_slot_scale_is_caught(ref, pair, monkeypatch):
    """Without the maximum over slots (each slot quantizing with its own
    scale, slot 0's dequantizing the sum) the step-1 parameters leave
    the bound."""
    cfg, jparams = pair
    _, _, _, exact = _run(cfg, jparams, "none", steps=1)
    monkeypatch.setattr(compression, "_slot_scales", lambda local: [
        torch.clamp(s, min=1e-12) for s in local])
    _, p1, _, _ = _run(cfg, jparams, "int8_ef", steps=1)
    n = len(jax.tree.leaves(jparams))
    want = _named([ref[f"int8_ef/p1/{i}"] for i in range(n)], jparams, cfg)
    assert _param_ratio(p1, want, exact, "int8_ef") > 1.0


def test_jax_one_device_step_equals_the_port_mesh_step(pair):
    """The reference's one-device step on carried weights, the port's
    step on a 4 x 2 mesh: loss within rtol 1e-5, parameters within 1e-5
    (AdamW at eps 1e-3)."""
    import jax.numpy as jnp
    from repro.optim.adamw import AdamW as RefAdamW
    from repro.optim.adamw import constant as ref_constant
    from repro.train.step import init_state as ref_init
    from repro.train.step import make_train_step as ref_step
    from torch_parity import assert_update_matches, port_named

    cfg, jparams = pair
    jcfg = dataclasses.replace(ref_smoke("phi3-mini-3.8b"), n_layers=2,
                               vocab=64, dtype="float32")
    jmodel = ref_model(jcfg)
    jopt = RefAdamW(lr=ref_constant(1e-3), eps=1e-3)
    data = MarkovLM(vocab=cfg.vocab, seed=0)
    batch = data.batch(0, 8, 16)
    batch["labels"][2, 5:] = -100
    jstate = ref_init(jmodel, jopt, jax.random.PRNGKey(0))
    jnew, jm = jax.jit(ref_step(jmodel, jopt))(
        jstate, jax.tree.map(jnp.asarray, batch))

    model = get_model(cfg)
    opt = AdamW(lr=constant(1e-3), eps=1e-3)
    params = _port_params(cfg, jstate.params)
    state = place_train_state(
        init_state(model, opt, 0, "cpu").__class__(
            params=params, opt_state=opt.init(params), step=0),
        shd.default_rules(make_host_mesh(4, 2, devices=["cpu"] * 8)))
    before = {k: v.gather("cpu").detach().clone()
              for k, v in state.params.named_parameters()}
    new, m = make_train_step(model, opt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    got = {k: v.gather("cpu").detach() for k, v in
           new.params.named_parameters()}
    assert_update_matches(got, port_named(jnew.params, cfg), before, cfg,
                          lr=1e-3, wd=0.1, rtol=0, atol=1e-5)
