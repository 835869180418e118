"""Shared checks of the dry-run's input shardings against the JAX
package's (``test_torch_dryrun_shardings*.py``).

The spec of each batch leaf, token and position input and cache leaf
from the port's ``launch.specs.cell_in_shardings`` is held to the
reference's on a ``jax.sharding.AbstractMesh``: its trailing entries for
a stacked cache leaf (the port's caches are per layer), with a reference
spec shorter than its leaf padded with ``None`` and a one-axis tuple
entry read as that axis.  Each cell's parameter and moment shardings are
``infer_param_specs``' (held to the reference in ``test_torch_specs.py``).
"""
import jax  # the test modules importorskip it first
import numpy as np

from repro.configs import SHAPES as REF_SHAPES
from repro.distributed import sharding as ref_shd
from repro.launch import specs as ref_specs
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh

MESHES = {"16x16": False, "2x16x16": True}


def _norm(spec, ndim: int) -> tuple:
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, (tuple, list)) else e)
    return tuple(out) + (None,) * (ndim - len(out))


def _ref_specs(tree, shapes) -> dict:
    """{path: normalized spec} of a reference sharding tree; ``shapes``:
    the matching input tree (for each leaf's rank)."""
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    shs = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.NamedSharding))
    assert len(leaves) == len(shs)
    return [(_path(p), _norm(s.spec, len(x.shape)))
            for (p, x), s in zip(leaves, shs)]


def _path(path) -> str:
    parts = []
    for p in path:
        for attr in ("key", "idx", "name"):
            if hasattr(p, attr):
                parts.append(str(getattr(p, attr)))
                break
    return ".".join(parts)


def _port_cache_specs(tree) -> list:
    """Per layer, the sorted [(leaf name, spec)] of a port cache sharding
    tree (a list with one entry per layer)."""
    out = []
    for layer in tree:
        one = []
        specs.map_cache(lambda name, s: one.append((name, s.spec)) or s,
                        [layer])
        out.append(sorted(one, key=repr))
    return out


def _ref_cache_specs(tree, shapes, cfg) -> list:
    """Per layer as the port lists them, the sorted [(leaf name, spec)]
    of the reference's cache shardings: a stacked leaf's spec without
    its leading entry."""
    def layer(t, s, stacked):
        return sorted(((p.split(".")[-1], spec[1:] if stacked else spec)
                       for p, spec in _ref_specs(t, s)), key=repr)

    if isinstance(shapes, dict) and "groups" in shapes:
        groups = [layer(tree["groups"][f"l{i}"], shapes["groups"][f"l{i}"],
                        True) for i in range(len(cfg.pattern))]
        return groups * cfg.n_groups + [
            layer(t, s, False) for t, s in zip(tree["tail"], shapes["tail"])]
    return [layer(tree, shapes, True)] * cfg.n_layers


def build_cells(archs) -> tuple:
    """({(arch, shape): (inputs, cfg)} of the reference, and of the
    port) for every shape of ``archs``."""
    ref = {(a, s): ref_specs.build_cell(a, s)[1:]
           for a in archs for s in REF_SHAPES}
    port = {(a, s): specs.build_cell(a, s)[1:]
            for a in archs for s in REF_SHAPES}
    return ref, port


def rules_for(mesh_name, shape):
    multi = MESHES[mesh_name]
    dims = (2, 16, 16) if multi else (16, 16)
    names = ("pod", "data", "model") if multi else ("data", "model")
    seq = shape in ("prefill_32k", "long_500k")
    ref = ref_shd.default_rules(jax.sharding.AbstractMesh(dims, names),
                                seq_sharded=seq)
    mesh = make_production_mesh(multi_pod=multi,
                                devices=["meta"] * int(np.prod(dims)))
    return ref, shd.default_rules(mesh, seq_sharded=seq)


def check_cell_shardings(mesh_name, arch, shape, cells) -> None:
    ref_rules, rules = rules_for(mesh_name, shape)
    (ref_in, ref_cfg), (inputs, cfg) = cells[0][arch, shape], \
        cells[1][arch, shape]
    sh = REF_SHAPES[shape]
    want = ref_specs.cell_in_shardings(ref_in, ref_cfg, ref_rules, sh.kind,
                                       sh.global_batch)
    got = specs.cell_in_shardings(inputs, cfg, rules, sh.kind,
                                  sh.global_batch)
    if sh.kind == "train":
        params = inputs[0].params
        assert {k: s.spec for k, s in got[0].params.items()} == \
            shd.infer_param_specs(params, rules)
        assert {k: s.spec for k, s in got[0].opt_state["m"].items()} == \
            shd.infer_param_specs(params, rules)
        want_batch = dict(_ref_specs(want[1], ref_in[1]))
        assert {k: s.spec for k, s in got[1].items()} == want_batch
        return
    assert {k: s.spec for k, s in got[0].items()} == \
        shd.infer_param_specs(inputs[0], rules)
    n_caches = 0
    for g, w, x, wx in zip(got[1:], want[1:], inputs[1:], ref_in[1:]):
        if hasattr(wx, "shape"):            # tokens, positions, pos
            assert g.spec == _norm(w.spec, len(wx.shape))
            assert len(g.spec) == x.dim()
            continue
        n_caches += 1
        mine = _port_cache_specs(g)
        theirs = _ref_cache_specs(w, wx, ref_cfg)
        assert len(mine) == len(theirs)
        bad = [(i, m, t) for i, (m, t) in enumerate(zip(mine, theirs))
               if m != t]
        assert not bad, bad[:4]
    assert n_caches == {"prefill": 0, "decode": 1 if cfg.family != "encdec"
                        else 2, "long_decode": 1 if cfg.family != "encdec"
                        else 2}[sh.kind]
