"""The port's model sharding rules against the JAX package's, at full
width, with no allocation.

For every config, on the 16 x 16 production mesh and on the 2 x 16 x 16
(pod) one, each parameter's spec from the port's ``infer_param_specs``
(on ``Model.init(device="meta")``: shapes, no bytes) equals the trailing
dims of the reference's spec for its stacked leaf (``jax.eval_shape`` of
the reference's ``init`` under an ``AbstractMesh``).  Also the fallback
cases of ``spec_for_shape`` (the reference's own test asserts nothing
there) and ``search_plane_specs`` on a sharded plane carried across.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import list_archs  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import get_model as ref_model  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import get_model  # noqa: E402

ARCHS = sorted(list_archs())
MESHES = {"16x16": False, "2x16x16": True}


class _Spec:
    """A reference spec standing in for a stacked leaf: slicing a layer
    drops the leading (stack) entry, as ``interop`` unstacks arrays."""

    def __init__(self, spec):
        self.spec = tuple(spec)

    def __getitem__(self, i):
        return _Spec(self.spec[1:])


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree.spec
    return out


def _port_named_specs(spec_tree, cfg) -> dict:
    """The reference's spec tree -> {port parameter name: spec}, through
    ``interop``'s own unstacking of the reference's layer tree."""
    tree = jax.tree.map(_Spec, spec_tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    if cfg.family == "encdec":
        enc, dec = tree["enc"], tree["dec"]
        out = _flatten({"final_ln": enc["final_ln"]}, "enc.", {})
        out.update(_flatten({k: dec[k] for k in
                             ("embedding", "pos_embedding", "final_ln")},
                            "dec.", {}))
        for side, n in (("enc", cfg.n_enc_layers), ("dec", cfg.n_layers)):
            for i, lt in enumerate(interop._unstack(tree[side]["layers"],
                                                    n)):
                _flatten(lt, f"{side}.layers.{i}.", out)
        return out
    out = _flatten({k: v for k, v in tree.items()
                    if k in ("embedding", "final_norm", "lm_head")}, "", {})
    for i, lt in enumerate(interop._layer_trees(tree, cfg)):
        _flatten(lt, f"layers.{i}.", out)
    return out


@pytest.fixture(scope="module")
def meta_models():
    return {a: get_model(get_config(a)).init(0, device="meta")
            for a in ARCHS}


@pytest.fixture(scope="module")
def ref_shapes():
    return {a: jax.eval_shape(ref_model(ref_config(a)).init,
                              jax.random.PRNGKey(0)) for a in ARCHS}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference_at_full_width(arch, mesh_name,
                                                       meta_models,
                                                       ref_shapes):
    multi_pod = MESHES[mesh_name]
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    abstract = jax.sharding.AbstractMesh(shape, names)
    ref_rules = ref_shd.default_rules(abstract)
    want = _port_named_specs(
        ref_shd.infer_param_specs(ref_shapes[arch], ref_rules),
        ref_config(arch))

    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * int(np.prod(shape)))
    got = shd.infer_param_specs(meta_models[arch], shd.default_rules(mesh))
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not bad, list(bad.items())[:5]
    assert all(p.is_meta for p in meta_models[arch].parameters())
    if multi_pod:       # the pod axis never lands in a parameter's spec
        assert not any("pod" in str(s) for s in got.values())


def test_spec_for_shape_fallbacks_match_the_reference():
    """Each fallback case of the reference's ``spec_for_shape``: an axis
    that does not divide its dim, an axis an earlier dim took, an absent
    rule, a rank mismatch; compared with the reference on the same mesh
    shape and asserted outright."""
    mesh = make_host_mesh(2, 4, devices=["cpu"] * 8)
    rules = shd.default_rules(mesh)
    ref = ref_shd.default_rules(jax.sharding.AbstractMesh(
        (2, 4), ("data", "model")))
    cases = {((3, 5), ("batch", "mlp")): (None, None),
             ((4, 8), ("batch", "mlp")): ("data", "model"),
             ((4, 6), ("batch", "mlp")): ("data", None),
             ((8, 8), ("mlp", "heads")): ("model", None),
             ((8, 8), ("embed", "batch")): ("data", None),
             ((8, 8), (None, "head_dim")): (None, None),
             ((8, 8), ("nonexistent", "vocab")): (None, "model")}
    for (shape, axes), want in cases.items():
        assert rules.spec_for_shape(shape, axes) == want
        assert tuple(ref.spec_for_shape(shape, axes)) == want
    with pytest.raises(ValueError, match="dims"):
        rules.spec_for_shape((4, 8), ("batch",))
    pod = shd.default_rules(make_production_mesh(
        multi_pod=True, devices=["meta"] * 512))
    assert pod.spec_for_shape((64, 8), ("batch", None)) == (("pod", "data"),
                                                            None)
    assert pod.spec_for_shape((16, 8), ("batch", None)) == (None, None)


def test_search_plane_specs_on_a_carried_plane_equal_the_reference():
    from repro.core import HNTLConfig
    from repro.core.store import VectorStore, shard_segments as ref_shard
    from repro.data import synthetic

    cfg = HNTLConfig(d=16, k=4, s=2, block=16, n_grains=4, nprobe=2,
                     pool=8)
    st = VectorStore(cfg, seal_threshold=256)
    x = synthetic.clustered(768, 16, n_clusters=8, seed=0)
    for lo in range(0, 768, 256):
        st.add(x[lo:lo + 256])
    plane, _ = ref_shard(st._segments, 4)
    ref_rules = ref_shd.search_plane_rules(jax.sharding.AbstractMesh(
        (1, 4), ("data", "model")))
    want = ref_shd.search_plane_specs(plane, ref_rules)
    port_plane = interop.sharded_from_numpy(
        jax.tree.map(np.asarray, plane), "cpu")
    rules = shd.search_plane_rules(make_host_mesh(1, 4,
                                                  devices=["cpu"] * 4))
    got = shd.search_plane_specs(port_plane, rules)
    flat_want = {jax.tree_util.keystr(p): tuple(s) for p, s in
                 jax.tree_util.tree_flatten_with_path(
                     want, is_leaf=lambda v: isinstance(
                         v, jax.sharding.PartitionSpec))[0]}

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}.{k}"))
            elif v is not None:
                out[f"{prefix}.{k}"] = v
        return out
    assert flat(got) == flat_want
    assert got["index"]["grains"]["coords"][0] == "model"
    assert got["gid_of_row"] == ("model",)
