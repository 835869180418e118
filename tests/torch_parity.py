"""Shared inputs for the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages: the
JAX package (``repro``, the reference) and the port (``repro_torch``).
"""
import dataclasses
import functools

import jax  # the parity test modules importorskip it first
import numpy as np
import torch

from repro.core import HNTLConfig as JaxConfig
from repro.core import index as jax_index
from repro.data import synthetic as jax_synthetic
from repro_torch.interop import config_from_dict, index_from_numpy
from repro_torch.kernels import select_cases

#: The port tests' small shape: d=16, k=4, s=2, G=8, block=16.
SMALL = dict(d=16, k=4, s=2, block=16, n_grains=8, nprobe=4, pool=32)


def corpus(n: int = 2048, nq: int = 8, seed: int = 0):
    x = jax_synthetic.anisotropic_manifold(n=n, d=SMALL["d"], intrinsic=4,
                                           seed=seed)
    return x, jax_synthetic.queries_from(x, nq=nq)


def jax_config(**kw) -> JaxConfig:
    return JaxConfig(**{**SMALL, **kw})


def jax_build(x, cfg: JaxConfig, **kw):
    """(index, info) from the JAX package's build."""
    return jax_index.build(x, cfg, **kw)


def numpy_tree(index):
    """The JAX index with every leaf turned into a numpy array."""
    return jax.tree.map(np.asarray, index)


def port_index(index, device="cpu"):
    return index_from_numpy(numpy_tree(index), device)


def port_config(cfg: JaxConfig):
    return config_from_dict(dataclasses.asdict(cfg))


#: Random inputs of the fused scan→select contract at the parity tests'
#: value ranges (small coordinates, scales near 1e-3).
select_inputs = functools.partial(select_cases.random_inputs, coord_range=200,
                                  scale_range=(1e-3, 2e-3))


def to_torch(a: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in a.items()}


def assert_clear_margins(jax_store, policy, now, seg_ids=None,
                         margin=1e-3):
    """Every grain of the JAX store's health statistics (of the segments
    ``seg_ids``, default all) is at least ``margin`` (relative for the
    drift test) from every threshold a maintenance plan compares it with,
    so a plan made from statistics summed in another order cannot flip."""
    for h in jax_store.grain_health(now=now):
        if seg_ids is not None and h["seg_id"] not in seg_ids:
            continue
        judged = h["live_cnt"] >= policy.min_refit_rows
        var = np.maximum(np.asarray(h["var_live"]), 1e-12)
        gaps = [h["best"] - h["captured"] - policy.stale_margin,
                h["captured"] - policy.stale_ratio * h["best"],
                (h["drift2"] - policy.drift_ratio * h["var_live"] - 1e-8)
                / var]
        for gap in gaps:
            assert (np.abs(np.asarray(gap)[judged]) > margin).all(), gaps


def assert_clear_probe_margins(gd2, margin, tol=1e-4):
    """No valid probe's routing distance sits within ``tol`` (relative to
    the query's best) of adaptive routing's threshold (1 + margin) * best,
    so a gd2 that differs by an ulp between the two packages' f32 routing
    matmuls cannot flip a probe of the stopping rule.  The lead itself
    (probe 0, compared with itself) is exact in both."""
    gd2 = np.asarray(gd2, np.float64)
    lead = gd2[:, :1]
    ok = (gd2 < 1e29) & (lead > 0)
    ok[:, 0] = False
    ratio = np.divide(gd2, lead, out=np.zeros_like(gd2), where=ok)
    gap = np.abs(ratio - (1.0 + margin))[ok]
    assert (gap > tol).all(), float(gap.min())


def model_pair(arch: str, dtype: str = "float32", **kw):
    """(JAX cfg, model, params; port cfg, model, params) of ``arch``'s
    smoke config on the same weights (JAX's ``init``, carried across with
    ``interop.params_from_numpy``)."""
    from repro.configs import get_smoke_config
    from repro.models import get_model as jax_get_model
    from repro_torch.interop import model_config_from_dict, params_from_numpy
    from repro_torch.models import get_model

    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw)
    jmodel = jax_get_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jmodel, jparams, cfg, get_model(cfg), params


def bf16_model_parity(arch: str, *, b: int = 2, s0: int = 12,
                      steps: int = 1) -> None:
    """The port's bf16 smoke model against the JAX package's, evaluated
    op by op (``lowering``'s ``unroll_layers``, no remat, so every bf16
    op rounds as the program writes it; compiled, XLA keeps some
    intermediates in float32, and its recurrentgemma then differs from
    its own op-by-op logits by up to 0.038 + 3e-2 |x|): ``forward``
    logits over ``s0`` tokens and ``prefill`` logits within the
    reference's 3e-2, then ``steps`` decode steps within its 5e-2 (the
    tolerances of ``tests/test_models.py::test_decode_matches_forward``),
    rtol = atol."""
    import jax.numpy as jnp

    from repro.models import lowering
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T

    jcfg, jmodel, jparams, cfg, model, params = model_pair(
        arch, "bfloat16", remat=False)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(b, s0 + steps)).astype(np.int32)

    def close(got, want, tol, msg):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol, err_msg=f"{arch}: {msg}")

    lowering._STACK.append(lowering.LoweringFlags(unroll_layers=True))
    try:
        head = torch.from_numpy(tokens[:, :s0])
        close(T.logits_fn(params, cfg, T.forward(params, cfg, head))[:, -1],
              JT.logits_fn(jparams, jcfg, JT.forward(
                  jparams, jcfg, jnp.asarray(tokens[:, :s0]))[0])[:, -1],
              3e-2, "forward")
        logits, caches = model.prefill(params, head, max_len=s0 + steps)
        jlogits, jcaches = jmodel.prefill(jparams, jnp.asarray(tokens[:, :s0]),
                                          max_len=s0 + steps)
        close(logits, jlogits, 3e-2, "prefill")
        for t in range(s0, s0 + steps):
            pos = np.full((b,), t, np.int32)
            logits, caches = model.decode_step(
                params, torch.from_numpy(tokens[:, t]), caches,
                torch.from_numpy(pos))
            jlogits, jcaches = jmodel.decode_step(
                jparams, jnp.asarray(tokens[:, t]), jcaches, jnp.asarray(pos))
            close(logits, jlogits, 5e-2, f"decode @ {t}")
    finally:
        lowering._STACK.pop()
