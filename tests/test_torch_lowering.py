"""The lowering flags, ``scan_layers`` and MoE's shape-static dispatch
against the JAX package and the port's earlier code.

- Under ``lowering.unrolled`` the port's gemma2 smoke loss is within the
  reference's own tolerance (rtol 2e-2, atol 1e-3,
  ``tests/test_models.py::test_unrolled_lowering_equals_scan``) of its
  plain loss.
- ``attn_chunks`` attention (causal, windowed, soft-capped, offset
  queries) equals the reference's under the same flags in float32, to
  1e-4; rwkv6's float32 smoke forward under ``wkv_chunks=2`` equals the
  reference's under ``lowering.unrolled(wkv_chunks=2)``, to 1e-4.
- ``scan_layers`` equals the reference's on a toy body, exactly.
- MoE counts by ``scatter_add_`` equal ``torch.bincount``; ``moe_apply``
  equals the boolean-mask dispatch it replaced bit for bit on the smoke
  configs; a full-width qwen3-moe train step traces on the meta device.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import attention as ref_attention  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import lowering as ref_lowering  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models import ffn, get_model, lowering  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.common import ACTS, scan_layers  # noqa: E402

import torch_parity  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_flags_nest_and_default_off():
    assert lowering.flags() == lowering.LoweringFlags()
    with lowering.unrolled(attn_chunks=3, wkv_chunks=5):
        f = lowering.flags()
        assert (f.attn_chunks, f.wkv_chunks) == (3, 5)
        with lowering.unrolled():
            assert lowering.flags().attn_chunks == 8
        assert lowering.flags().attn_chunks == 3
    assert lowering.flags() == lowering.LoweringFlags()


def test_unrolled_gemma2_loss_equals_plain():
    cfg = get_smoke_config("gemma2-2b")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             torch_parity.train_batch(cfg, b=2, s=160).items()}
    with torch.no_grad():
        plain, _ = model.loss(params, batch)
        with lowering.unrolled(attn_chunks=2, wkv_chunks=2):
            unrolled, _ = model.loss(params, batch)
    np.testing.assert_allclose(float(unrolled), float(plain), rtol=2e-2,
                               atol=1e-3)


ATTN_CASES = {"causal": dict(causal=True),
              "window": dict(causal=True, window=70),
              "softcap": dict(causal=True, logit_cap=30.0),
              "offset": dict(causal=True, q_offset=200),
              "bidirectional": dict(causal=False)}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("chunks", [2, 3, 8])
def test_attn_chunks_attention_equals_the_reference(case, chunks):
    kw = ATTN_CASES[case]
    rng = np.random.default_rng(chunks)
    t = 600
    s = t - kw.get("q_offset", 0)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    with ref_lowering.unrolled(attn_chunks=chunks):
        want = ref_attention.attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **kw)
    with lowering.unrolled(attn_chunks=chunks):
        got = port_attention.attention(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_attn_chunks_sets_the_chunk():
    """kv_chunk = max(128, ceil(t / attn_chunks)): the einsums see it."""
    seen = []
    real = torch.einsum

    def spy(eq, *ops):
        if eq == "bshgd,bthd->bshgt":
            seen.append(ops[1].shape[1])
        return real(eq, *ops)

    q = torch.zeros((1, 1000, 2, 8))
    k = v = torch.zeros((1, 1000, 2, 8))
    torch.einsum = spy
    try:
        with lowering.unrolled(attn_chunks=3):
            port_attention.attention(q, k, v)
        with lowering.unrolled(attn_chunks=64):
            port_attention.attention(q, k, v)
    finally:
        torch.einsum = real
    assert set(seen) == {334, 128}


def test_wkv_chunks_rwkv6_forward_equals_the_reference():
    jcfg, jmodel, jparams, cfg, model, params = torch_parity.model_pair(
        "rwkv6-1.6b")
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 40)).astype(np.int32)
    with ref_lowering.unrolled(wkv_chunks=2):
        want, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens))
    calls = []
    real = T.rwkv6._wkv_chunked

    def spy(*a, **kw):
        calls.append(kw["n_chunks"])
        return real(*a, **kw)

    T.rwkv6._wkv_chunked = spy
    try:
        with torch.no_grad(), lowering.unrolled(wkv_chunks=2):
            got, _ = T.forward(params, cfg, torch.from_numpy(tokens))
    finally:
        T.rwkv6._wkv_chunked = real
    assert calls == [2] * cfg.n_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_scan_layers_equals_the_reference():
    rng = np.random.default_rng(0)
    xs = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": [rng.standard_normal((5, 2, 2)).astype(np.float32)]}

    def body(carry, x, lib):
        c = carry * 0.5 + lib.sum(x["a"]) + lib.sum(x["b"][0])
        return c, {"y": x["a"] * c, "z": x["b"][0][0]}

    with ref_lowering.unrolled():
        rc, rys = ref_common.scan_layers(
            lambda c, x: body(c, x, jnp), jnp.float32(1.0),
            jax.tree.map(jnp.asarray, xs))
    pc, pys = scan_layers(lambda c, x: body(c, x, torch), torch.tensor(1.0),
                          {"a": torch.from_numpy(xs["a"]),
                           "b": [torch.from_numpy(xs["b"][0])]})
    assert float(pc) == float(rc)
    np.testing.assert_array_equal(pys["y"].numpy(), np.asarray(rys["y"]))
    np.testing.assert_array_equal(pys["z"].numpy(), np.asarray(rys["z"]))
    carry, ys = scan_layers(lambda c, x: (c + x, None), torch.tensor(0.0),
                            torch.arange(4.0))
    assert float(carry) == 6.0 and ys is None


@pytest.mark.parametrize("seed", range(4))
def test_moe_counts_equal_bincount(seed):
    g = torch.Generator().manual_seed(seed)
    e = 1 + seed * 7
    flat_e = torch.randint(0, e, (257,), generator=g)
    counts = torch.zeros(e, dtype=torch.long).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    assert torch.equal(counts, torch.bincount(flat_e, minlength=e))


def _moe_masked(params, x, *, top_k, capacity_factor=1.25, norm_topk=True):
    """``ffn.moe_apply`` as it was before the dispatch became
    shape-static (``torch.bincount`` and boolean masks): the reference
    the new one must equal bit for bit."""
    b, s, d = x.shape
    e = params["router"].shape[1]
    t = b * s
    xf = x.reshape(t, d)
    probs = torch.softmax(xf.to(torch.float32) @ params["router"], dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
    if norm_topk:
        top_p = top_p / torch.clamp(torch.sum(top_p, -1, keepdim=True),
                                    min=1e-9)
    importance = torch.mean(probs, dim=0)
    load = torch.mean(torch.nn.functional.one_hot(
        top_e[:, 0], e).to(torch.float32), dim=0)
    aux = torch.sum(importance * load) * e
    cap = ffn._capacity(t, e, top_k, capacity_factor)
    flat_e = top_e.reshape(-1)
    flat_tok = torch.arange(t).repeat_interleave(top_k)
    flat_w = top_p.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)
    offsets = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(t * top_k) - offsets[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    in_cap = rank < cap
    disp_tok = torch.full((e, cap), t, dtype=torch.long)
    disp_tok[flat_e[in_cap], rank[in_cap]] = flat_tok[in_cap]
    xe = torch.cat([xf, xf.new_zeros((1, d))], dim=0)[disp_tok]
    h = ACTS["silu"](torch.bmm(xe, params["e_gate"])) \
        * torch.bmm(xe, params["e_up"])
    ye = torch.bmm(h, params["e_down"])
    slot = torch.where(in_cap, flat_e * cap + rank, 0)
    yk = ye.reshape(e * cap, d)[slot].to(torch.float32) * flat_w[:, None]
    yk.masked_fill_(~in_cap[:, None], 0.0)
    y = torch.sum(yk.reshape(t, top_k, d), dim=1)
    return y.reshape(b, s, d).to(x.dtype), aux


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [1.25, 0.3])
def test_moe_apply_unchanged_bit_for_bit(arch, dtype, factor):
    """Capacity factor 0.3 drops pairs, so the spill column is used."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    gen = torch.Generator().manual_seed(1)
    params = ffn.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                          cfg.compute_dtype)
    x = torch.randn((3, 17, cfg.d_model), generator=gen).to(
        cfg.compute_dtype)
    kw = dict(top_k=cfg.moe_top_k, capacity_factor=factor,
              norm_topk=cfg.norm_topk)
    y, aux = ffn.moe_apply(params, x, **kw)
    y0, aux0 = _moe_masked(params, x, **kw)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


def test_qwen3_moe_meta_train_step_traces():
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.optim.adamw import AdamW, constant
    from repro_torch.train.step import init_state, make_train_step

    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=1)
    model = get_model(cfg)
    opt = AdamW(lr=constant(1e-4))
    state = init_state(model, opt, 0, "meta")
    b, s = 2, 256
    batch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    counter = StepCounter()
    with counter:
        make_train_step(model, opt)(state, batch)
    assert counter.ops["aten.scatter_add.default"] == 1
    assert counter.flops_by_dtype["bfloat16"] > 0
    assert counter.bytes["update"] > 0 and counter.bytes["backward"] > 0
