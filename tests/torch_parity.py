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
        close(T.logits_fn(params, cfg, T.forward(params, cfg, head)[0])[:, -1],
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


#: The attention-only decoders, and every architecture of the repo.
ATTENTION_ARCHS = ["phi3-mini-3.8b", "gemma2-2b", "stablelm-3b",
                   "codeqwen1.5-7b", "qwen2-vl-2b"]
FAMILY_ARCHS = ["recurrentgemma-9b", "rwkv6-1.6b", "qwen3-moe-30b-a3b",
                "dbrx-132b", "whisper-base"]
ALL_ARCHS = ATTENTION_ARCHS + FAMILY_ARCHS

#: Training parity in float32: the loss's rtol, and each gradient leaf's
#: absolute tolerance as a fraction of its own largest |value|.
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def train_batch(cfg, b: int = 2, s: int = 16, seed: int = 1,
                frames: int = 24) -> dict:
    """A training batch (numpy) for ``cfg``: tokens and labels with a few
    -100 (masked) labels; for M-RoPE three distinct position streams and
    two patch embeddings; for the encoder-decoder ``frames`` frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    labels[:, -3:] = -100
    labels[0, 2] = -100
    batch = {"tokens": tokens, "labels": labels}
    if cfg.mrope_sections is not None:
        base = np.arange(s, dtype=np.int32)
        batch["positions"] = np.stack([base, base // 2, base // 3])[:, None] \
            .repeat(b, axis=1)
        batch["patch_embeds"] = rng.standard_normal(
            (b, 2, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, frames, cfg.d_model)).astype(np.float32)
    return batch


def port_named(tree, cfg) -> dict:
    """A JAX parameter-shaped tree (parameters, gradients, moments; numpy
    leaves) -> {port parameter name: CPU tensor}, unstacked as
    ``interop.params_from_numpy`` unstacks parameters."""
    from repro_torch.interop import params_from_numpy

    return {k: v.detach() for k, v in params_from_numpy(
        jax.tree.map(np.asarray, tree), cfg, "cpu").named_parameters()}


def reference_decays(cfg, named: dict) -> set:
    """The port's 1-d parameters that lie in the reference's stacked
    layers ([n, d] there): the reference's AdamW decays them (it tests
    ``ndim`` on the stack), the port's does not."""
    if cfg.family == "encdec":
        stacked = ("enc.layers.", "dec.layers.")
    else:
        stacked = tuple(f"layers.{i}." for i in range(
            cfg.n_groups * len(cfg.pattern)))
    return {k for k, v in named.items()
            if v.dim() == 1 and k.startswith(stacked)}


def assert_update_matches(port: dict, ref: dict, before: dict, cfg, *,
                          lr: float, wd: float, rtol: float, atol: float):
    """The port's updated parameters against the reference's, leaf by
    leaf: within (rtol, atol), except where the reference decays a 1-d
    parameter of its stacked layers and the port does not; there the
    port's minus the reference's is lr * wd * (the parameter before)."""
    decayed = reference_decays(cfg, port)
    assert set(port) == set(ref)
    for k in port:
        want = ref[k].float()
        if k in decayed:
            want = want + lr * wd * before[k].float()
        torch.testing.assert_close(port[k].float(), want, rtol=rtol,
                                   atol=atol, msg=lambda m, k=k: f"{k}: {m}")


def loss_and_grads(model, params, batch):
    """(loss, metrics, {name: gradient}) of the port's ``model.loss``."""
    loss, metrics = model.loss(params, batch)
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, dict(zip(named, grads))


def loss_grad_parity(arch: str) -> None:
    """``arch``'s float32 smoke model: the port's ``Model.loss``, its ce
    and aux and every gradient against JAX's ``value_and_grad`` of
    ``model.loss`` on the same weights and batch (``train_batch``)."""
    import jax.numpy as jnp

    jcfg, jmodel, jparams, cfg, model, params = model_pair(arch)
    params.requires_grad_(True)
    batch = train_batch(cfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, jax.tree.map(jnp.asarray,
                                                          batch))
    loss, metrics, grads = loss_and_grads(
        model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmetrics["ce"]),
                               rtol=LOSS_RTOL)
    if cfg.n_experts:
        assert float(metrics["aux"]) > 0
        np.testing.assert_allclose(float(metrics["aux"]),
                                   float(jmetrics["aux"]), rtol=LOSS_RTOL)
    want = port_named(jgrads, cfg)
    assert set(grads) == set(want)
    for k, g in grads.items():
        tol = GRAD_TOL * float(want[k].abs().max())
        torch.testing.assert_close(g, want[k], rtol=0, atol=tol,
                                   msg=lambda m, k=k: f"{arch} {k}: {m}")
