"""The port's mixture of experts (``models/ffn.py``) against the JAX
package.

``moe_apply``'s ``y`` and ``aux`` at 1e-5 (float32) with no drops
(cf = E / K), with capacity drops at the published factor 1.25 (a shared
direction skews the routing) and with tied router probabilities (a zero
router: the stable descending sort takes experts 0..k-1, as
``jax.lax.top_k``); the combine is run-to-run identical; and the qwen3-moe
and dbrx smoke models in bf16 against the reference's op-by-op program
within its own tolerances.
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parity

from repro.models import ffn as JF
from repro_torch.models import ffn


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


MOE_CASES = {
    # cf = E / K: no token can be dropped
    "no_drop": dict(e=8, k=2, cf=4.0, t=24, tied=False),
    # the published factor: experts overflow and tokens are dropped
    "drops_cf_1_25": dict(e=8, k=2, cf=1.25, t=96, tied=False),
    # a zero router: every probability ties, top-k takes experts 0..k-1
    "tied_router": dict(e=8, k=3, cf=1.25, t=40, tied=True),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case):
    c = MOE_CASES[case]
    d, ff = 16, 32
    jp = JF.moe_init(jax.random.PRNGKey(3), d, ff, c["e"], jnp.float32)
    if c["tied"]:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, c["t"] // 2, d)).astype(np.float32)
    if case == "drops_cf_1_25":     # a shared direction skews the routing
        x = x + 3.0 * rng.standard_normal(d).astype(np.float32)
    kw = dict(top_k=c["k"], capacity_factor=c["cf"], norm_topk=True)
    jy, jaux = jax.jit(functools.partial(JF.moe_apply, **kw))(
        jp, jnp.asarray(x))
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    y, aux = ffn.moe_apply(p, torch.from_numpy(x), **kw)
    _close(y, jy, 1e-5, "y")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # how many (token, expert) pairs the capacity dropped, as the
    # reference computes it
    t = c["t"]
    cap = ffn._capacity(t, c["e"], c["k"], c["cf"])
    probs = jax.nn.softmax(jnp.asarray(x.reshape(t, d)) @ jp["router"], -1)
    _, top_e = jax.lax.top_k(probs, c["k"])
    counts = np.bincount(np.asarray(top_e).reshape(-1), minlength=c["e"])
    dropped = int(np.maximum(counts - cap, 0).sum())
    assert (dropped > 0) == (case != "no_drop"), dropped
    if c["tied"]:
        assert set(np.asarray(top_e).reshape(-1).tolist()) == set(
            range(c["k"]))


def test_moe_combine_is_run_to_run_identical():
    """The combine gathers and sums each token's outputs in rank order:
    two calls give the same bits."""
    gen = torch.Generator().manual_seed(0)
    p = ffn.moe_init(gen, 16, 32, 8, torch.float32)
    x = torch.randn((3, 17, 16), generator=gen)
    a = ffn.moe_apply(p, x, top_k=2, capacity_factor=1.25)
    b = ffn.moe_apply(p, x, top_k=2, capacity_factor=1.25)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_moe_models_bf16_match_jax_within_reference_tolerance(arch):
    torch_parity.bf16_model_parity(arch)
