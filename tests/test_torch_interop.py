"""Carrying a JAX-built index across: every leaf keeps dtype, shape and
values (tags: u32 values in int64), with the sketch on and off, with
tags/ts, and with density bit allocation (qmaxg)."""
import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import dataclasses

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
    a = index_from_numpy(as_dict)
    b = index_from_numpy(tree)
    assert torch.equal(a.grains.coords, b.grains.coords)
    assert torch.equal(a.routing.centroids, b.routing.centroids)


def test_config_round_trip():
    jcfg = JaxConfig(d=16, k=4, s=2, n_grains=8, bit_alloc="density")
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.qmax == jcfg.qmax and cfg.block_bytes == jcfg.block_bytes
    with pytest.raises(ValueError, match="unknown"):
        config_from_dict({"d": 16, "bogus": 1})
