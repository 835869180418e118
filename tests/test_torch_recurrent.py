"""The port's RG-LRU (``models/rglru.py``) and RWKV6 (``models/rwkv6.py``)
blocks against the JAX package.

The RG-LRU's log-depth scan against its own decode steps and JAX's
associative scan (1e-5, with and without a carried state, S = 1, 13, 32),
the block from a carried state; the step and chunked WKV against JAX's
(1e-5) and each other (the reference's 3e-4), the time-mix and
channel-mix from carried states; and the recurrentgemma and rwkv6 smoke
models in bf16 against the reference's op-by-op program within its own
tolerances.
"""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parity

from repro.models import rglru as JG
from repro.models import rwkv6 as JR
from repro_torch.models import rglru, rwkv6


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


@pytest.mark.parametrize("s", [1, 13, 32])
def test_rglru_scan_matches_steps_and_jax(s):
    r, nb = 32, 4
    jp = JG.rg_block_init(jax.random.PRNGKey(5), 16, r, nb, 4, jnp.float32)
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, s, r)).astype(np.float32)
    h0 = rng.standard_normal((2, r)).astype(np.float32)
    for init in (None, h0):
        y, h = rglru.rglru(p, torch.from_numpy(x),
                           None if init is None else torch.from_numpy(init))
        jy, jh = jax.jit(JG.rglru)(
            jp, jnp.asarray(x), None if init is None else jnp.asarray(init))
        _close(y, jy, 1e-5, "scan against JAX")
        _close(h, jh, 1e-5, "last state against JAX")
        state = torch.zeros((2, r)) if init is None \
            else torch.from_numpy(init)
        steps = []
        for t in range(s):
            yt, state = rglru.rglru_step(p, torch.from_numpy(x[:, t:t + 1]),
                                         state)
            steps.append(yt)
        _close(torch.cat(steps, 1), y, 1e-5, "scan against steps")
        _close(state, h, 1e-5, "last state against steps")


def test_rg_block_with_state_matches_jax():
    """The block (gates, causal conv, recurrence) over a segment from a
    carried state, then one step from the state it returns."""
    jp = JG.rg_block_init(jax.random.PRNGKey(7), 16, 32, 4, 4, jnp.float32)
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    st = {"h": rng.standard_normal((2, 32)).astype(np.float32),
          "conv": rng.standard_normal((2, 3, 32)).astype(np.float32)}
    y, new = rglru.rg_block_apply(
        p, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in
                                 st.items()})
    jblock = jax.jit(JG.rg_block_apply)
    jy, jnew = jblock(jp, jnp.asarray(x),
                      {k: jnp.asarray(v) for k, v in st.items()})
    _close(y, jy, 1e-5, "segment")
    for k in ("h", "conv"):
        _close(new[k], jnew[k], 1e-5, k)
    y1, _ = rglru.rg_block_apply(p, torch.from_numpy(x[:, :1]), new)
    jy1, _ = jblock(jp, jnp.asarray(x[:, :1]), jnew)
    _close(y1, jy1, 1e-5, "step")


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def _wkv_inputs(seed=0, b=2, s=29, h=2, n=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.7, 0.999, (b, s, h, n)).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("chunks", [1, 4, 7])
def test_rwkv_chunked_equals_stepwise_and_jax(chunks):
    """The port's twin of ``tests/test_models.py::
    test_rwkv_chunked_equals_stepwise`` (its 3e-4), and each form against
    JAX's at 1e-5."""
    args = _wkv_inputs()
    targs = [torch.from_numpy(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    o1, f1 = rwkv6._wkv_scan(*targs)
    o2, f2 = rwkv6._wkv_chunked(*targs, chunks)
    jo1, jf1 = jax.jit(JR._wkv_scan)(*jargs)
    jo2, jf2 = jax.jit(functools.partial(JR._wkv_chunked,
                                         n_chunks=chunks))(*jargs)
    _close(o2, o1, 3e-4, "chunked against steps (out)")
    _close(f2, f1, 3e-4, "chunked against steps (state)")
    _close(o1, jo1, 1e-5, "steps against JAX (out)")
    _close(f1, jf1, 1e-5, "steps against JAX (state)")
    _close(o2, jo2, 1e-5, "chunked against JAX (out)")
    _close(f2, jf2, 1e-5, "chunked against JAX (state)")


def test_rwkv_blocks_with_state_match_jax():
    jtm = JR.timemix_init(jax.random.PRNGKey(9), 32, 8, jnp.float32)
    jcm = JR.channelmix_init(jax.random.PRNGKey(10), 32, 64, jnp.float32)
    tm = {k: torch.tensor(np.asarray(v)) for k, v in jtm.items()}
    cm = {k: torch.tensor(np.asarray(v)) for k, v in jcm.items()}
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    st = {"s": rng.standard_normal((2, 4, 8, 8)).astype(np.float32),
          "shift": rng.standard_normal((2, 32)).astype(np.float32)}
    y, new = rwkv6.timemix_apply(tm, torch.from_numpy(x), 8,
                                 {k: torch.from_numpy(v)
                                  for k, v in st.items()})
    jy, jnew = jax.jit(functools.partial(JR.timemix_apply, head_size=8))(
        jtm, jnp.asarray(x), state={k: jnp.asarray(v) for k, v in st.items()})
    _close(y, jy, 1e-5, "time-mix")
    for k in ("s", "shift"):
        _close(new[k], jnew[k], 1e-5, k)
    cst = {"shift": torch.from_numpy(st["shift"])}
    y, new = rwkv6.channelmix_apply(cm, torch.from_numpy(x), cst)
    jy, jnew = jax.jit(JR.channelmix_apply)(
        jcm, jnp.asarray(x), {"shift": jnp.asarray(st["shift"])})
    _close(y, jy, 1e-5, "channel-mix")
    _close(new["shift"], jnew["shift"], 1e-5, "channel-mix shift")



@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_recurrent_models_bf16_match_jax_within_reference_tolerance(arch):
    torch_parity.bf16_model_parity(arch)
