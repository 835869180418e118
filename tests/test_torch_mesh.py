"""Meshes, sharding rules and placement, elastic re-meshing, cross-mesh
restore, ``launch.train --host-mesh`` and search on ``make_host_mesh``
(no JAX).

Twin of ``tests/test_distributed.py``'s
``test_elastic_remesh_and_cross_mesh_restore``: train 3 steps on a 4 x 2
mesh of CPU slots, save, ``shrink_mesh`` to 4 devices, restore with
``shardings=`` onto 2 x 2 and ``remesh_train_state``; every leaf is bit
equal to the saved one and the next step's loss equals the one-device
step's from the same state (rtol 1e-5).  ``"meta"`` slots stand in for a
second device where placement across devices is checked.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.core import HNTLConfig
from repro_torch.core.store import VectorStore
from repro_torch.data.tokens import MarkovLM
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.elastic import (remesh_train_state,
                                             reshard_tree, shrink_mesh)
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh, make_search_mesh)
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamW, constant
from repro_torch.train.step import (init_state, make_train_step,
                                    place_train_state, state_shardings)

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu(data, model):
    return make_host_mesh(data, model, devices=["cpu"] * (data * model))


# ---------------------------------------------------------------------------
# Meshes and rules
# ---------------------------------------------------------------------------


def test_host_and_production_meshes(monkeypatch):
    mesh = _cpu(2, 4)
    assert mesh == make_search_mesh(4, batch=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    prod = make_production_mesh(devices=["meta"] * 256)
    assert prod.shape == {"data": 16, "model": 16}
    pod = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert pod.axis_names == ("pod", "data", "model")
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert pod.device_at((1, 15, 15)) == torch.device("meta")
    assert len(pod.coords()) == 512 and pod.coords()[17] == (0, 1, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="needs 8 devices, found 2"):
        make_host_mesh(4, 2)
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh()
    assert make_host_mesh(2, 1).flat_devices() == (
        torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="devices= has 3"):
        make_host_mesh(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="axes"):
        Mesh(devices=(("cpu",),), axis_names=("x", "y"))


def test_search_refuses_a_pod_mesh():
    pod = make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    with pytest.raises(ValueError, match="search plane runs on"):
        shd.search_plane_rules(pod)


def test_use_rules_and_constrain():
    x = torch.zeros(4, 8, 16)
    assert shd.active_rules() is None
    assert shd.constrain(x, "batch", "seq", "act_embed") is x
    rules = shd.default_rules(_cpu(2, 2))
    with shd.use_rules(rules):
        assert shd.active_rules() is rules
        assert shd.constrain(x, "batch", "seq", "act_embed") is x
        with pytest.raises(ValueError, match="dims"):
            shd.constrain(x, "batch", "seq")
        with shd.use_rules(None):
            assert shd.active_rules() is None
    assert shd.active_rules() is None
    serve = shd.default_rules(_cpu(2, 2), serve_params=True,
                              seq_sharded=True)
    assert serve.spec_for_shape((4, 8), ("embed", "mlp")) == (None, "model")
    assert serve.spec_for_shape((4, 8), ("batch", "seq")) == ("data", None)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def test_slots_on_one_device_keep_the_leaf_whole_and_view_it():
    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    mesh = _cpu(4, 2)
    p = shd.place(t, shd.NamedSharding(mesh, ("data", "model", None)))
    assert len(p.pieces) == 1 and p.pieces[0].tensor is t
    assert p.gather("cpu") is t
    for c in mesh.coords():
        sh = p.shard(c)
        assert sh.data_ptr() == t[2 * c[0]:, 3 * c[1]:].data_ptr()
        assert torch.equal(sh, t[2 * c[0]:2 * c[0] + 2,
                                 3 * c[1]:3 * c[1] + 3])
    assert p.shard((1, 1)).shape == (2, 3, 4)


def test_slots_on_two_devices_hold_their_own_blocks():
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    mesh = make_host_mesh(2, 2, devices=["cpu", "cpu", "meta", "meta"])
    p = shd.place(t, shd.NamedSharding(mesh, ("data", "model")))
    cpu = [x for x in p.pieces if x.device.type == "cpu"]
    meta = [x for x in p.pieces if x.device.type == "meta"]
    assert [x.slices for x in cpu] == [(slice(0, 4), slice(0, 3)),
                                       (slice(0, 4), slice(3, 6))]
    assert len(meta) == 2 and all(x.tensor.shape == (4, 3) for x in meta)
    assert torch.equal(p.shard((0, 1)), t[:4, 3:])
    # replicated over data: each device holds both model blocks, whole
    r = shd.place(t, shd.NamedSharding(mesh, (None, "model")))
    assert [(x.device.type, x.slices) for x in r.pieces] == [
        ("cpu", None), ("meta", None)]
    assert r.pieces[0].tensor is t
    # a device holding every block keeps the leaf whole
    mixed = make_host_mesh(2, 2, devices=["cpu", "cpu", "cpu", "meta"])
    m = shd.place(t, shd.NamedSharding(mixed, (None, "model")))
    assert m.whole_on("cpu") is t and m.whole_on("meta") is None
    assert torch.equal(m.gather("cpu"), t)


def test_infer_param_specs_on_the_port_names():
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    model = get_model(cfg).init(0, device="meta")
    rules = shd.default_rules(_cpu(2, 2))
    specs = shd.infer_param_specs(model, rules)
    assert specs["layers.0.mixer.wq"] == ("data", "model", None)
    assert specs["layers.0.ffn.e_gate"] == ("model", "data", None)
    assert specs["final_norm.scale"] == (None,)
    placed = shd.place_module(get_model(cfg).init(0, device="cpu"), rules)
    assert set(shd.infer_param_specs(placed, rules)) == set(specs)
    assert {k: v.spec for k, v in placed.named_parameters()} == specs


# ---------------------------------------------------------------------------
# Elastic re-mesh and cross-mesh restore
# ---------------------------------------------------------------------------


def _tiny():
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              n_layers=2, vocab=64, dtype="float32")
    return cfg, get_model(cfg)


def _host_leaves(tree) -> dict:
    out = {}
    ckpt._map_leaves(tree, lambda n, leaf, _: out.__setitem__(
        n, ckpt._to_host(leaf)[0]))
    return out


def test_shrink_mesh_refuses_too_few_devices():
    with pytest.raises(ValueError, match="cannot host model axis 4"):
        shrink_mesh(["cpu"] * 3, model_parallel=4)
    m = shrink_mesh(["cpu"] * 7, model_parallel=2)
    assert m.shape == {"data": 3, "model": 2}


def test_elastic_remesh_and_cross_mesh_restore(tmp_path):
    cfg, model = _tiny()
    opt = AdamW(lr=constant(1e-3))
    data = MarkovLM(vocab=cfg.vocab, seed=0)
    batch = lambda s: {k: torch.from_numpy(v)  # noqa: E731
                       for k, v in data.batch(s, 8, 16).items()}
    devs = ["cpu"] * 8
    rules8 = shd.default_rules(Mesh(devices=(tuple(devs[:2]),) * 4))
    step = make_train_step(model, opt)
    with shd.use_rules(rules8):
        state = init_state(model, opt, 0, "cpu")
        for s in range(3):
            state, _ = step(state, batch(s))
    assert isinstance(state.params, shd.PlacedModule)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=3)
    saved = _host_leaves(state)

    mesh4 = shrink_mesh(devs[:4], model_parallel=2)
    rules4 = shd.default_rules(mesh4)
    target = init_state(model, opt, 1, "meta")
    restored = mgr.restore(target, step=3,
                           shardings=state_shardings(target, rules4))
    assert isinstance(restored.params, shd.PlacedModule)
    assert restored.params.rules.mesh == mesh4
    restored = remesh_train_state(restored, mesh4, rules=rules4)
    assert restored.opt_state["count"] == 3 and restored.step == 3
    got = _host_leaves(restored)
    assert set(got) == set(saved) and len(saved) > 40
    for k in saved:
        assert got[k].dtype == saved[k].dtype
        assert np.array_equal(got[k], saved[k]), k

    one = mgr.restore(init_state(model, opt, 1, "cpu"), step=3)
    _, m_one = step(one, batch(3))
    _, m_mesh = step(restored, batch(3))
    assert np.isfinite(float(m_mesh["loss"]))
    np.testing.assert_allclose(float(m_mesh["loss"]), float(m_one["loss"]),
                               rtol=LOSS_RTOL)


def test_restore_places_the_module_under_the_rules_it_was_given(tmp_path):
    cfg, model = _tiny()
    opt = AdamW(lr=constant(1e-3))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(init_state(model, opt, 0, "cpu"), step=0)
    rules = shd.default_rules(_cpu(2, 2), seq_sharded=True)
    target = init_state(model, opt, 1, "meta")
    back = mgr.restore(target, step=0,
                       shardings=state_shardings(target, rules))
    assert back.params.rules is rules
    shardings = state_shardings(target, rules)
    by_hand = dataclasses.replace(shardings, params={
        k: shd.NamedSharding(rules.mesh, v.spec)
        for k, v in shardings.params.items()})
    back = mgr.restore(target, step=0, shardings=by_hand)
    assert back.params.rules.mesh == rules.mesh
    assert back.params.rules is not rules       # the mesh's default rules


def test_remesh_keeps_whole_leaves_in_place():
    cfg, model = _tiny()
    opt = AdamW(lr=constant(1e-3))
    state = place_train_state(init_state(model, opt, 0, "cpu"),
                              shd.default_rules(_cpu(4, 2)))
    again = remesh_train_state(state, _cpu(2, 2))
    for (k, a), (_, b) in zip(state.params.named_parameters(),
                              again.params.named_parameters()):
        assert b.pieces[0].tensor is a.pieces[0].tensor, k
    moved = reshard_tree(state.opt_state["m"], shd.default_rules(
        make_host_mesh(1, 2, devices=["cpu", "meta"])))
    w = moved["layers.0.mixer.wq"]           # [d, H, hd], H over model
    assert [(p.device.type, p.slices[1]) for p in w.pieces] == [
        ("cpu", slice(0, 2)), ("meta", slice(2, 4))]
    assert w.whole_on("cpu") is None
    assert torch.equal(w.shard((0, 0)), state.opt_state["m"][
        "layers.0.mixer.wq"].gather("cpu")[:, :2])


def test_a_placed_state_checkpoints_whole_and_restores_in_place(tmp_path):
    cfg, model = _tiny()
    opt = AdamW(lr=constant(1e-3))
    state = place_train_state(init_state(model, opt, 0, "cpu"),
                              shd.default_rules(_cpu(2, 2)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=0)
    plain = init_state(model, opt, 0, "cpu")
    assert _host_leaves(plain).keys() == _host_leaves(state).keys()
    other = place_train_state(init_state(model, opt, 5, "cpu"),
                              shd.default_rules(_cpu(2, 2)))
    ptr = other.params.leaves["embedding"].pieces[0].tensor.data_ptr()
    back = mgr.restore(other, step=0)
    assert back.params.leaves["embedding"].pieces[0].tensor.data_ptr() == ptr
    a, b = _host_leaves(state), _host_leaves(back)
    assert all(np.array_equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# launch.train --host-mesh, search on make_host_mesh
# ---------------------------------------------------------------------------


def _losses(tmp, mesh):
    import io
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = launch_train.main([
            "--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "8", "--seq", "16",
            "--host-mesh", mesh, "--ckpt-dir", str(tmp)])
    return state, [float(line.split("loss")[1].split()[0])
                   for line in buf.getvalue().splitlines()
                   if line.startswith("[trainer] step")]


def test_launch_train_host_mesh_equals_one_slot(tmp_path):
    one, l1 = _losses(tmp_path / "a", "1,1")
    mesh, l2 = _losses(tmp_path / "b", "4,2")
    assert isinstance(mesh.params, shd.PlacedModule)
    assert mesh.params.rules.mesh.shape == {"data": 4, "model": 2}
    assert not isinstance(one.params, shd.PlacedModule)
    assert mesh.step == one.step == 3
    np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [3]


def test_launch_train_host_mesh_without_device_needs_the_cards(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="needs 8 devices, found 2"):
        launch_train.main(["--arch", "phi3-mini-3.8b", "--smoke",
                           "--host-mesh", "4,2", "--ckpt-dir",
                           str(tmp_path)])


def test_search_on_a_host_mesh_equals_the_search_mesh():
    rng = np.random.default_rng(3)
    cfg = HNTLConfig(d=16, k=4, s=2, block=16, n_grains=4, nprobe=4,
                     pool=16)
    st = VectorStore(cfg, seal_threshold=256, device="cpu")
    x = rng.standard_normal((1024, 16)).astype(np.float32)
    for lo in range(0, 1024, 256):
        st.add(x[lo:lo + 256])
    q = (x[:8] + 0.01 * rng.standard_normal((8, 16))).astype(np.float32)
    for mode in ("A", "B"):
        host = st.search(q, topk=5, mode=mode, mesh=_cpu(1, 4))
        want = st.search(q, topk=5, mode=mode, mesh=make_search_mesh(
            4, devices=["cpu"] * 4))
        assert torch.equal(host.ids, want.ids)
        assert torch.equal(host.dists, want.dists)
    both = st.search(q, topk=5, mode="B", mesh=_cpu(2, 2),
                     shard_queries=True)
    want = st.search(q, topk=5, mode="B", mesh=make_search_mesh(
        2, batch=2, devices=["cpu"] * 4), shard_queries=True)
    assert torch.equal(both.ids, want.ids)
