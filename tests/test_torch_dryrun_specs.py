"""The dry-run's cell inputs against the JAX package's, at full width.

For every arch x shape cell, the meta tensors of the port's
``launch.specs.build_cell`` have the shapes, dtypes and total bytes of
the reference's ``ShapeDtypeStruct`` inputs, with the reference's stacked
leaves unstacked as ``interop`` unstacks them (parameters by port name,
caches one entry per layer).  Also ``kv_index_specs`` for each attention
config under ``long_decode_cfg``, and ``_model_flops`` for every cell.
Everything is compared exactly.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models import hntl_attention as ref_H  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import hntl_attention as H  # noqa: E402

# The reference's dry-run forces 512 host devices through XLA_FLAGS when
# it is imported; keep that from reaching any later JAX start-up here.
_prior = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402
if _prior is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _prior

from repro_torch.launch import dryrun  # noqa: E402

ARCHS = sorted(list_archs())
CELLS = [(a, s) for a in ARCHS for s in REF_SHAPES]


class _Leaf:
    """A reference leaf's (shape, dtype); indexing drops the leading
    (stack) dim, as ``interop`` unstacks arrays."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), str(np.dtype(dtype))

    def __getitem__(self, i):
        return _Leaf(self.shape[1:], self.dtype)

    def key(self):
        return self.shape, self.dtype


def _leaves(tree):
    return jax.tree.map(lambda x: _Leaf(x.shape, x.dtype), tree)


def _port_key(t):
    return tuple(t.shape), str(t.dtype).split(".")[-1]


def _flat(tree, prefix, out):
    """{path: leaf} of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree
    return out


def _ref_param_keys(tree, cfg) -> dict:
    """The reference's parameter-shaped tree -> {port name: key}."""
    tree = _leaves(tree)
    if cfg.family == "encdec":
        enc, dec = tree["enc"], tree["dec"]
        out = _flat({"final_ln": enc["final_ln"]}, "enc.", {})
        _flat({k: dec[k] for k in ("embedding", "pos_embedding",
                                   "final_ln")}, "dec.", out)
        for side, n in (("enc", cfg.n_enc_layers), ("dec", cfg.n_layers)):
            for i, lt in enumerate(interop._unstack(tree[side]["layers"],
                                                    n)):
                _flat(lt, f"{side}.layers.{i}.", out)
    else:
        out = _flat({k: v for k, v in tree.items()
                     if k in ("embedding", "final_norm", "lm_head")}, "", {})
        for i, lt in enumerate(interop._layer_trees(tree, cfg)):
            _flat(lt, f"layers.{i}.", out)
    return {k: v.key() for k, v in out.items()}


def _path_str(path) -> str:
    parts = []
    for p in path:
        for attr in ("key", "idx", "name"):
            if hasattr(p, attr):
                parts.append(str(getattr(p, attr)))
                break
    return ".".join(parts)


def _ref_tree_keys(tree, drop_lead: bool) -> dict:
    """{path: key} of a reference tree (dicts, tuples, ``KVIndex``), the
    leading dim dropped from each leaf with ``drop_lead``."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        shape = tuple(x.shape)[1:] if drop_lead else tuple(x.shape)
        out[_path_str(path)] = (shape, str(np.dtype(x.dtype)))
    return out


def _port_tree_keys(tree) -> dict:
    out = {}

    def walk(t, prefix):
        if isinstance(t, H.KVIndex):
            for f in t.__dataclass_fields__:
                v = getattr(t, f)
                if v is not None:
                    out[prefix + f] = _port_key(v)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{prefix}{i}.")
        else:
            out[prefix[:-1]] = _port_key(t)
    walk(tree, "")
    return out


def _ref_cache_layers(tree, cfg) -> list:
    """The reference's serving caches -> one {path: key} per layer, as
    ``interop.caches_from_numpy`` slices them."""
    if isinstance(tree, (list, tuple)) or cfg.family == "encdec":
        return [_ref_tree_keys(tree, True)] * cfg.n_layers
    groups, tail = tree["groups"], tree["tail"]
    out = [_ref_tree_keys(groups[f"l{i}"], True)
           for _ in range(cfg.n_groups) for i in range(len(cfg.pattern))]
    return out + [_ref_tree_keys(t, False) for t in tail]


def _nbytes_ref(tree) -> int:
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def _nbytes_port(tree) -> int:
    total = 0

    def walk(t):
        nonlocal total
        if isinstance(t, H.KVIndex):
            for f in t.__dataclass_fields__:
                walk(getattr(t, f))
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif hasattr(t, "named_parameters"):
            for _, p in t.named_parameters():
                walk(p)
        elif t is not None and hasattr(t, "numel"):
            total += t.numel() * t.element_size()
    walk(tree)
    return total


@pytest.fixture(scope="module")
def ref_cells():
    return {c: ref_specs.build_cell(*c)[1:] for c in CELLS}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_inputs_equal_the_reference(arch, shape, ref_cells):
    """Shapes and dtypes leaf by leaf, and total bytes, exactly."""
    ref_inputs, ref_cfg = ref_cells[arch, shape]
    _, inputs, cfg = specs.build_cell(arch, shape)
    assert cfg.name == ref_cfg.name and cfg.kv_cap == ref_cfg.kv_cap
    kind = REF_SHAPES[shape].kind
    if kind == "train":
        ref_state, ref_batch = ref_inputs
        state, batch = inputs
        want = _ref_param_keys(ref_state.params, ref_cfg)
        assert {n: _port_key(p) for n, p in state.params.named_parameters()
                } == want
        for mom in ("m", "v"):
            assert {n: _port_key(t) for n, t in state.opt_state[mom].items()
                    } == _ref_param_keys(ref_state.opt_state[mom], ref_cfg)
        assert {k: _port_key(v) for k, v in batch.items()} == \
            _ref_tree_keys(ref_batch, False)
        assert all(p.is_meta for p in state.params.parameters())
        assert _nbytes_port(state.params) + _nbytes_port(
            [state.opt_state["m"], state.opt_state["v"]]) == _nbytes_ref(
            (ref_state.params, ref_state.opt_state["m"],
             ref_state.opt_state["v"]))
        assert _nbytes_port(batch) == _nbytes_ref(ref_batch)
        return
    params, rest = inputs[0], inputs[1:]
    assert {n: _port_key(p) for n, p in params.named_parameters()} == \
        _ref_param_keys(ref_inputs[0], ref_cfg)
    assert _nbytes_port(params) == _nbytes_ref(ref_inputs[0])
    assert len(rest) == len(ref_inputs) - 1
    for got, want in zip(rest, ref_inputs[1:]):
        if hasattr(want, "shape"):              # tokens, positions, pos
            assert _port_key(got) == (tuple(want.shape),
                                      str(np.dtype(want.dtype)))
            continue
        layers = _ref_cache_layers(want, ref_cfg)
        assert len(got) == len(layers)
        for li, (g, w) in enumerate(zip(got, layers)):
            assert _port_tree_keys(g) == w, li
        assert _nbytes_port(got) == _nbytes_ref(want)


ATTN_ARCHS = [a for a in ARCHS if not get_config(a).is_attention_free]


@pytest.mark.parametrize("arch", ATTN_ARCHS)
@pytest.mark.parametrize("variant", ["plain", "bf16_meta_sq8"])
def test_kv_index_specs_equal_the_reference(arch, variant):
    import dataclasses

    import jax.numpy as jnp

    kw = {} if variant == "plain" else {"kv_bf16_meta": True,
                                        "kv_sq8": True}
    rcfg = dataclasses.replace(ref_specs.long_decode_cfg(ref_config(arch)),
                               **kw)
    cfg = dataclasses.replace(specs.long_decode_cfg(get_config(arch)), **kw)
    sealed = 524288 - cfg.kv_tail
    want = ref_H.kv_index_specs(rcfg, 2, sealed, jnp.bfloat16)
    got = H.kv_index_specs(cfg, 2, sealed, cfg.compute_dtype)
    assert _port_tree_keys(got) == _ref_tree_keys(want, False)
    assert all(t.is_meta for t in (got.coords, got.k_raw, got.tail_v))
    assert (got.k_scale is None) == (variant == "plain")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    assert dryrun._model_flops(arch, shape) == \
        ref_dryrun._model_flops(arch, shape)
    assert dryrun._full_cfg(arch).param_count() == \
        ref_dryrun._full_cfg(arch).param_count()
