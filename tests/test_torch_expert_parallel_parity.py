"""The port's expert-parallel step against the reference's SPMD step.

One subprocess with 8 forced host devices runs the JAX package's jitted
train step of qwen3-moe-30b-a3b's float32 smoke config on a 4 x 2 (data,
model) mesh, its parameters placed by ``infer_param_shardings`` (the pjit
step of ``tests/test_distributed.py::test_pjit_smoke_train_on_mesh``),
AdamW at eps 1e-3 and weight decay 0, and writes the initial parameters,
the batch, the loss and the parameters after the step to an ``.npz``.
The port steps the same weights, carried across with
``interop.params_from_numpy``, on a 4 x 2 mesh of ``["cpu"] * 8`` slots,
where its step splits heads, vocab and experts over the model slots and
its four data rows route the whole batch together:

- the loss within rtol 1e-5;
- the parameters after the step within 1e-5.

Weight decay is 0: the reference decays its stacked groups' 1-d leaves
(ROADMAP, faults of the reference), and qwen3-moe's QK-norm scales start
at 1 (its other norms' at 0), so a decay would move them in the
reference alone.
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
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim.adamw import AdamW, constant  # noqa: E402
from repro_torch.train.step import (TrainState, execution,  # noqa: E402
                                    make_train_step)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCH = "qwen3-moe-30b-a3b"
LR, EPS = 1e-3, 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5

REF = """
import sys, dataclasses, jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.data.tokens import MarkovLM
from repro.distributed import sharding as shd
from repro.models import get_model
from repro.optim.adamw import AdamW, constant
from repro.train.step import init_state, make_train_step
cfg = dataclasses.replace(get_smoke_config(%(arch)r), dtype='float32')
model = get_model(cfg)
opt = AdamW(lr=constant(%(lr)r), eps=%(eps)r, weight_decay=0.0)
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ('data', 'model'))
rules = shd.default_rules(mesh)
batch = MarkovLM(vocab=cfg.vocab, seed=0).batch(0, 8, 16)
batch['labels'][1, 5:] = -100
out = {'batch/' + k: np.asarray(v) for k, v in batch.items()}
with mesh, shd.use_rules(rules):
    state = init_state(model, opt, jax.random.PRNGKey(0))
    for i, leaf in enumerate(jax.tree.leaves(state.params)):
        out[f'p0/{i}'] = np.asarray(leaf)
    sh = shd.infer_param_shardings(state.params, rules)
    state = dataclasses.replace(state,
                                params=jax.device_put(state.params, sh))
    b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                       NamedSharding(mesh, P('data')))
    state, m = jax.jit(make_train_step(model, opt))(state, b)
    out['loss'] = np.asarray(m['loss'])
    for i, leaf in enumerate(jax.tree.leaves(state.params)):
        out[f'p1/{i}'] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
""" % {"arch": ARCH, "lr": LR, "eps": EPS}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("expert_parallel") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REF), path],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return dict(np.load(path))


def _named(ref: dict, key: str, cfg) -> dict:
    jcfg = dataclasses.replace(ref_smoke(ARCH), dtype="float32")
    treedef = jax.tree.structure(jax.eval_shape(
        ref_model(jcfg).init, jax.random.PRNGKey(0)))
    leaves = [ref[f"{key}/{i}"] for i in range(treedef.num_leaves)]
    return params_from_numpy(jax.tree.unflatten(treedef, leaves), cfg,
                             "cpu")


def test_expert_parallel_step_equals_the_reference_pjit_step(ref):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
        model = get_model(cfg)
        opt = AdamW(lr=constant(LR), eps=EPS, weight_decay=0.0)
        params = _named(ref, "p0", cfg).requires_grad_(True)
        state = TrainState(params=params, opt_state=opt.init(params),
                           step=0)
        batch = {k.split("/", 1)[1]: torch.from_numpy(v)
                 for k, v in ref.items() if k.startswith("batch/")}
        rules = shd.default_rules(make_host_mesh(4, 2,
                                                 devices=["cpu"] * 8))
        assert execution(model, rules) == "expert-parallel"
        with shd.use_rules(rules):
            new, metrics = make_train_step(model, opt)(state, batch)
        assert isinstance(new.params, shd.PlacedModule)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(ref["loss"]), rtol=LOSS_RTOL)
        want = dict(_named(ref, "p1", cfg).named_parameters())
        for k, p in new.params.named_parameters():
            np.testing.assert_allclose(p.gather("cpu").detach().numpy(),
                                       want[k].detach().numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
    finally:
        torch.set_num_threads(n)
