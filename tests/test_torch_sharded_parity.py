"""The port's grain-sharded plane against the JAX package's, on the same
inputs.

- **Layout**: ``store.shard_segments`` on a JAX manifest carried across
  with ``interop.manifest_from_numpy``, at 1, 3 and 4 shards: the row
  permutation, the shard-local id panels, ``gid_of_row``, validity, sizes
  and the permuted raw tier equal the JAX package's.
- **One shard, in process**: ``planner.search_stacked_sharded`` on a
  1-device JAX mesh against the port's on ``interop.sharded_from_numpy``
  of the same plane, Mode A and B; and the stores' sharded searches on
  the carried manifest.
- **Four shards, in a subprocess** with 4 forced host devices (the JAX
  package needs them set before it is imported): the JAX planner on its
  plane against the port's on a 4-slot CPU mesh, Modes A and B, a tag
  mask, a tombstone bitmap and the cascade at budgets (4096, 32).

Ids must match exactly; dists to rtol and atol 1e-5.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("jax")   # the JAX package is the reference

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import planner as jax_planner
from repro.core.store import VectorStore as JaxStore
from repro.core.store import shard_segments as jax_shard_segments
from repro.distributed import sharding as jax_sharding
from repro.launch.mesh import make_search_mesh as jax_search_mesh
from repro_torch.core import planner
from repro_torch.core.index import int32_safe_qmax
from repro_torch.core.store import VectorStore, shard_segments
from repro_torch.interop import manifest_from_numpy, sharded_from_numpy
from repro_torch.launch.mesh import make_search_mesh

import torch_parity as tp

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_store(seed=3):
    """4 sealed segments of 128 rows and one of 64, tags 1 << (row % 4),
    ts row / n, some deletes."""
    cfg = tp.jax_config(n_grains=4, nprobe=3, pool=24)
    x, q = tp.corpus(n=4 * 128 + 64, nq=8, seed=seed)
    n = x.shape[0]
    tags = (1 << (np.arange(n) % 4)).astype(np.uint32)
    ts = (np.arange(n) / n).astype(np.float32)
    st = JaxStore(cfg, seal_threshold=128, clock=lambda: 0.0)
    st.add(x, tags=tags, ts=ts)
    st.seal()
    st.delete(np.random.default_rng(seed).choice(n, 30, replace=False))
    return st, cfg, q


@pytest.fixture(scope="module")
def carried():
    jst, cfg, q = _jax_store()
    man = jst.snapshot()
    nman = dataclasses.replace(man, segments=tuple(
        dataclasses.replace(s, index=jax.tree.map(np.asarray, s.index))
        for s in man.segments))
    pst = VectorStore(tp.port_config(cfg), seal_threshold=128,
                      clock=lambda: 0.0, device="cpu")
    return jst, man, pst, manifest_from_numpy(nman, "cpu"), q


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_shard_segments_layout_matches_jax(carried, n_shards):
    jst, man, pst, pman, q = carried
    jplane, jperm = jax_shard_segments(man.segments, n_shards)
    pplane, pperm = shard_segments(pman.segments, n_shards)
    np.testing.assert_array_equal(pperm, jperm)
    for name in ("ids", "valid", "coords", "mu", "scale", "tags", "ts"):
        np.testing.assert_array_equal(
            getattr(pplane.index.grains, name).numpy(),
            np.asarray(getattr(jplane.index.grains, name)), err_msg=name)
    np.testing.assert_array_equal(pplane.gid_of_row.numpy(),
                                  np.asarray(jplane.gid_of_row))
    np.testing.assert_array_equal(pplane.index.routing.sizes.numpy(),
                                  np.asarray(jplane.index.routing.sizes))
    np.testing.assert_array_equal(pplane.index.raw.numpy(),
                                  np.asarray(jplane.index.raw))


@pytest.mark.parametrize("mode", ["A", "B"])
def test_one_shard_planner_matches_jax(carried, mode):
    jst, man, pst, pman, q = carried
    jplane, _ = jax_shard_segments(man.segments, 1)
    jmesh = jax_search_mesh(1)
    placed = jax_sharding.shard_search_plane(
        jplane, jax_sharding.search_plane_rules(jmesh))
    pplane = sharded_from_numpy(jax.tree.map(np.asarray, jplane), "cpu")
    kw = dict(nprobe=3, pool=24, topk=10, mode=mode,
              qeff=int32_safe_qmax(4, 16))
    ref = jax_planner.search_stacked_sharded(placed, jnp.asarray(q),
                                             mesh=jmesh, **kw)
    got = planner.search_stacked_sharded(
        pplane, torch.from_numpy(q), mesh=make_search_mesh(
            1, devices=["cpu"]), **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(ref.dists),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["A", "B"])
def test_one_shard_store_search_matches_jax(carried, mode):
    """The stores' own sharded searches on one manifest (a 1-device JAX
    mesh, a 1-slot CPU mesh), with a tag filter and the deletes."""
    jst, man, pst, pman, q = carried
    for filt in ({}, dict(tag_mask=0b0101)):
        ref = jst.search(q, topk=10, mode=mode, manifest=man,
                         mesh=jax_search_mesh(1), **filt)
        got = pst.search(q, topk=10, mode=mode, manifest=pman,
                         mesh=make_search_mesh(1, devices=["cpu"]), **filt)
        np.testing.assert_array_equal(got.ids.numpy().astype(np.int64),
                                      np.asarray(ref.ids, np.int64))
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(ref.dists),
                                   rtol=1e-5, atol=1e-5)


def test_four_shards_match_jax_forced_devices():
    """The JAX planner on 4 forced host devices against the port's on a
    4-slot CPU mesh, on the same plane (``sharded_from_numpy``)."""
    code = textwrap.dedent("""
        import dataclasses
        import jax, jax.numpy as jnp, numpy as np, torch
        from repro.core import planner as jp
        from repro.distributed import sharding as jshd
        from repro.launch.mesh import make_search_mesh as jmesh
        from repro.core.store import shard_segments as jshard
        from repro_torch.core import planner as pp
        from repro_torch.core.index import int32_safe_qmax
        from repro_torch.interop import sharded_from_numpy
        from repro_torch.launch.mesh import make_search_mesh as pmesh
        from test_torch_sharded_parity import _jax_store

        torch.set_num_threads(1)
        assert len(jax.devices()) == 4
        st, cfg, q = _jax_store()
        plane, _ = jshard(st._segments, 4)
        valid = np.asarray(plane.index.grains.valid)
        rng = np.random.default_rng(9)
        plane = dataclasses.replace(
            plane, live=valid & (rng.random(valid.shape) > 0.2))
        mesh = jmesh(4)
        placed = jshd.shard_search_plane(plane,
                                         jshd.search_plane_rules(mesh))
        port = sharded_from_numpy(jax.tree.map(np.asarray, plane), "cpu")
        pm = pmesh(4, devices=["cpu"] * 4)
        base = dict(nprobe=3, pool=24, topk=10, qeff=int32_safe_qmax(4))
        cases = [dict(mode="A"), dict(mode="B"),
                 dict(mode="B", tag_mask=0b0110),
                 dict(mode="B", scan_impl="cascade_ref",
                      budgets=(4096, 32))]
        for case in cases:
            jkw, pkw = dict(base, **case), dict(base, **case)
            if "tag_mask" in case:
                jkw["tag_mask"] = jnp.uint32(case["tag_mask"])
            ref = jp.search_stacked_sharded(placed, jnp.asarray(q),
                                            mesh=mesh, **jkw)
            got = pp.search_stacked_sharded(port, torch.from_numpy(q),
                                            mesh=pm, **pkw)
            np.testing.assert_array_equal(got.ids.numpy(),
                                          np.asarray(ref.ids), str(case))
            np.testing.assert_allclose(got.dists.numpy(),
                                       np.asarray(ref.dists), rtol=1e-5,
                                       atol=1e-5, err_msg=str(case))
            print("ok", case)
        print("OK")
    """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([SRC, HERE])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK" in out.stdout
