"""Carrying a JAX-built index across: every leaf keeps dtype, shape and
values (tags: u32 values in int64), with the sketch on and off, with
tags/ts, and with density bit allocation (qmaxg).  The same for an
HNTL-KV ``KVIndex`` (bf16 and int8 leaves, ``None`` leaves) and for the
configuration dataclasses."""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import dataclasses

import jax
import numpy as np
import torch

from repro.core import HNTLConfig as JaxConfig
from repro_torch.core.types import GrainStore, HNTLIndex, RoutingPlane, \
    tree_bytes
from repro_torch.interop import config_from_dict, index_from_numpy

import torch_parity as tp

CASES = {
    "sketch": dict(),
    "no_sketch": dict(s=0),
    "tags_ts": dict(tags_ts=True),
    "density": dict(bit_alloc="density"),
}


def _build(case):
    kw = dict(CASES[case])
    tags_ts = kw.pop("tags_ts", False)
    x, _ = tp.corpus(n=1024, nq=1, seed=3)
    extra = {}
    if tags_ts:
        rng = np.random.default_rng(0)
        extra = dict(tags=rng.integers(0, 2 ** 32, size=len(x),
                                       dtype=np.uint32),
                     ts=rng.uniform(0, 100, size=len(x)).astype(np.float32))
    cfg = tp.jax_config(**kw)
    idx, _ = tp.jax_build(x, cfg, **extra)
    return tp.numpy_tree(idx)


def _leaves(tree, cls):
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_leaf_converts(case):
    tree = _build(case)
    idx = index_from_numpy(tree, "cpu")
    assert isinstance(idx, HNTLIndex)
    pairs = [(idx.routing, tree.routing, RoutingPlane),
             (idx.grains, tree.grains, GrainStore)]
    n_leaves = 0
    for port, ref, cls in pairs:
        for name, want in _leaves(ref, cls).items():
            got = getattr(port, name)
            if want is None:
                assert got is None, name
                continue
            n_leaves += 1
            assert tuple(got.shape) == want.shape, name
            if want.dtype == np.uint32:
                assert got.dtype == torch.int64, name
            else:
                assert got.numpy().dtype == want.dtype, name
            assert np.array_equal(got.numpy(), want.astype(got.numpy().dtype)
                                  ), name
    assert np.array_equal(idx.raw.numpy(), tree.raw)
    assert idx.grains.coords.dtype == torch.int16
    assert idx.grains.res.dtype == torch.int32
    assert idx.grains.valid.dtype == torch.bool
    if case == "density":
        assert idx.grains.qmaxg.dtype == torch.int32
    if case == "tags_ts":
        assert idx.grains.tags.max() > 2 ** 31      # u32 values kept
        assert idx.grains.ts.dtype == torch.float32
    if case == "no_sketch":
        assert idx.grains.sketch is None and idx.grains.sketch_basis is None
    assert tree_bytes(idx) >= sum(a.nbytes for a in [tree.raw])
    assert n_leaves >= 10


def test_index_from_nested_mappings():
    tree = _build("sketch")
    as_dict = {"routing": _leaves(tree.routing, RoutingPlane),
               "grains": _leaves(tree.grains, GrainStore), "raw": tree.raw}
    a = index_from_numpy(as_dict, "cpu")
    b = index_from_numpy(tree, "cpu")
    assert torch.equal(a.grains.coords, b.grains.coords)
    assert torch.equal(a.routing.centroids, b.routing.centroids)


def test_config_round_trip():
    jcfg = JaxConfig(d=16, k=4, s=2, n_grains=8, bit_alloc="density")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.qmax == jcfg.qmax and cfg.block_bytes == jcfg.block_bytes
    with pytest.raises(ValueError, match="unknown"):
        config_from_dict({"d": 16, "bogus": 1})


KV_CASES = {
    "f32": (dict(), np.float32),
    "bf16_cache": (dict(), "bfloat16"),
    "sq8_bf16_meta": (dict(kv_sq8=True, kv_bf16_meta=True), np.float32),
}


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """A port leaf as numpy; bf16 as its raw 16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _raw_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("case", sorted(KV_CASES))
def test_kv_index_round_trip(case):
    """A JAX KVIndex from build_kv_index crosses over with every dtype,
    shape and bit kept, and None leaves kept None."""
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.models import hntl_attention as JH
    from repro_torch.interop import kv_index_from_numpy
    from repro_torch.models.hntl_attention import KVIndex

    kw, dtype = KV_CASES[case]
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"), **kw)
    rng = np.random.default_rng(4)
    shape = (1, 4 * cfg.kv_cap, cfg.n_kv_heads, cfg.head_dim)
    k = jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(dtype)
    v = jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(dtype)
    tree = jax.tree.map(np.asarray, JH.build_kv_index(k, v, cfg))
    idx = kv_index_from_numpy(tree, "cpu")
    assert isinstance(idx, KVIndex)
    for f in dataclasses.fields(KVIndex):
        want, got = getattr(tree, f.name), getattr(idx, f.name)
        if want is None:
            assert got is None, f.name
            continue
        back = _as_numpy(got)
        assert back.shape == want.shape, f.name
        assert str(got.dtype).split(".")[-1] == want.dtype.name, f.name
        assert np.array_equal(back, _raw_bits(want)), f.name
    assert idx.n_grains == 4 and idx.cap == cfg.kv_cap
    if case == "sq8_bf16_meta":
        assert idx.k_raw.dtype == torch.int8
        assert idx.centroids.dtype == torch.bfloat16
        assert idx.k_scale is not None
    else:
        assert idx.k_scale is None and idx.v_scale is None


def test_model_config_round_trip():
    from repro.configs import get_config
    from repro.models.config import LayerSpec as JaxLayerSpec
    from repro_torch.interop import model_config_from_dict
    from repro_torch.models.config import LayerSpec

    jcfg = dataclasses.replace(
        get_config("phi3-mini-3.8b"),
        pattern=(JaxLayerSpec("attn", window=512), JaxLayerSpec("rglru")),
        mrope_sections=(16, 24, 24))
    cfg = model_config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.pattern == (LayerSpec("attn", 512), LayerSpec("rglru"))
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown"):
        model_config_from_dict({**dataclasses.asdict(jcfg), "bogus": 1})
