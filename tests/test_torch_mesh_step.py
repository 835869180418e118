"""The train step on a mesh equals the one-device step (no JAX).

On a 4 x 2 mesh of ``["cpu"] * 8`` slots (``make_host_mesh``,
``default_rules``), float32 configs of gemma2-2b, qwen3-moe-30b-a3b and
rwkv6-1.6b (the archs of the reference's
``test_pjit_smoke_train_on_mesh``) and whisper-base:

- the loss within rtol 1e-5 of the one-device step's;
- each gradient leaf within 1e-4 of its own max |g|;
- one step's parameters within 1e-5 (AdamW at eps 1e-3: a first step
  at eps 1e-8 moves every element by about lr whatever its gradient);
  the moments to rtol 1e-4 where the rows gather whole parameters, and
  to the gradient gate where gemma2's rows split over the model slots
  (``test_torch_tensor_parallel.py``);
- padded labels in one row only: equal to one device, and a mean of the
  rows' means would not be;
- microbatches split the global batch as on one device;
- a config with experts splits its batch over the data rows too, its
  rows stepping together expert-parallel (its aux equal too;
  ``test_torch_expert_parallel.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.index import full_fp32_matmul
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamW, constant
from repro_torch.train.step import (execution, init_state,
                                    make_train_step, place_train_state,
                                    row_groups, value_and_grad)

ARCHS = ["gemma2-2b", "qwen3-moe-30b-a3b", "rwkv6-1.6b", "whisper-base"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4           # of each leaf's own max |g|
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rules(data=4, model=2):
    return shd.default_rules(make_host_mesh(
        data, model, devices=["cpu"] * (data * model)))


def _setup(arch, b=8, s=16, seed=0):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = get_model(cfg)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab, (b, s)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, 16, cfg.d_model)).astype(np.float32))
    return cfg, model, batch


def _opt():
    return AdamW(lr=constant(1e-3), eps=1e-3)


def _worst_grad(got: dict, want: dict) -> float:
    worst = 0.0
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        limit = GRAD_TOL * float(w.abs().max())
        worst = max(worst, err / limit if limit > 0 else
                    (0.0 if err == 0 else float("inf")))
    return worst


def _mesh_and_one(arch, batch_fn=None):
    cfg, model, batch = _setup(arch)
    if batch_fn is not None:
        batch_fn(batch)
    one = init_state(model, _opt(), 0, "cpu")
    placed = place_train_state(init_state(model, _opt(), 0, "cpu"),
                               _rules())
    with full_fp32_matmul():
        l1, m1, g1 = value_and_grad(model, one.params, batch)
        l2, m2, g2 = value_and_grad(model, placed.params, batch)
    return cfg, model, batch, (one, l1, m1, g1), (placed, l2, m2, g2)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_loss_and_gradients_equal_one_device(arch):
    cfg, model, batch, (_, l1, m1, g1), (placed, l2, m2, g2) = \
        _mesh_and_one(arch)
    groups = row_groups(model, placed.params.rules, batch)
    assert len(groups) == 4
    np.testing.assert_allclose(float(l2), float(l1), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m2["aux"]), float(m1["aux"]),
                               rtol=LOSS_RTOL)
    assert set(g2) == set(g1)
    assert _worst_grad(g2, g1) <= 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_parameters_equal_one_device(arch):
    cfg, model, batch = _setup(arch)
    opt = _opt()
    step = make_train_step(model, opt)
    one, _ = step(init_state(model, opt, 0, "cpu"), batch)
    with shd.use_rules(_rules()):
        mesh, metrics = step(init_state(model, opt, 0, "cpu"), batch)
    assert isinstance(mesh.params, shd.PlacedModule) and mesh.step == 1
    assert mesh.opt_state["count"] == 1
    want = dict(one.params.named_parameters())
    for k, p in mesh.params.named_parameters():
        np.testing.assert_allclose(p.gather("cpu").detach().numpy(),
                                   want[k].detach().numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    # the tensor- and expert-parallel steps split float32 sums over the
    # model slots: their moments hold the gradient gate (m = 0.1 g within
    # GRAD_TOL of its leaf's max, v = 0.05 g^2 within twice that), where
    # row-gather, which splits the batch only, holds each element to
    # rtol 1e-4
    split = execution(model, _rules()) in ("tensor-parallel",
                                           "expert-parallel")
    for part in ("m", "v"):
        for k, v in mesh.opt_state[part].items():
            want = one.opt_state[part][k].numpy()
            tol = dict(rtol=0, atol=GRAD_TOL * (1 if part == "m" else 2)
                       * float(np.abs(want).max())) if split \
                else dict(rtol=1e-4, atol=1e-9)
            np.testing.assert_allclose(v.gather("cpu").numpy(), want,
                                       err_msg=f"{part}.{k}", **tol)


def test_padding_in_one_row_is_a_token_mean_over_the_batch():
    """-100 labels in one data row only: the mesh loss is the token mean
    over the whole batch (== one device); the mean of the four rows'
    means differs by far more than the tolerance."""
    def pad(batch):
        batch["labels"][0, 2:] = -100           # data row 0 of 4: rows 0-1
        batch["labels"][1, 1:] = -100

    cfg, model, batch, (one, l1, _, g1), (placed, l2, _, g2) = \
        _mesh_and_one("gemma2-2b", pad)
    np.testing.assert_allclose(float(l2), float(l1), rtol=LOSS_RTOL)
    assert _worst_grad(g2, g1) <= 1.0
    with torch.no_grad():
        row_means = [float(model.loss(one.params, {
            k: v[r * 2:(r + 1) * 2] for k, v in batch.items()})[0])
            for r in range(4)]
    assert abs(np.mean(row_means) - float(l1)) > 100 * LOSS_RTOL * float(l1)


def test_mesh_microbatches_equal_one_device():
    cfg, model, batch = _setup("gemma2-2b")
    batch["labels"][5, 3:] = -100
    opt = _opt()
    step = make_train_step(model, opt, microbatches=2)
    one, m1 = step(init_state(model, opt, 0, "cpu"), batch)
    with shd.use_rules(_rules()):
        mesh, m2 = step(init_state(model, opt, 0, "cpu"), batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=LOSS_RTOL)
    want = dict(one.params.named_parameters())
    for k, p in mesh.params.named_parameters():
        np.testing.assert_allclose(p.gather("cpu").detach().numpy(),
                                   want[k].detach().numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_a_dropped_row_is_caught():
    """The gradient gate fails when one row's gradient is left out."""
    cfg, model, batch = _setup("gemma2-2b")
    one = init_state(model, _opt(), 0, "cpu")
    placed = place_train_state(init_state(model, _opt(), 0, "cpu"),
                               _rules())
    with full_fp32_matmul():
        _, _, g1 = value_and_grad(model, one.params, batch)
        half = {k: v[:6] for k, v in batch.items()}
        _, _, g2 = value_and_grad(model, placed.params, half)
    assert _worst_grad(g2, g1) > 1.0


def test_a_state_on_a_mesh_of_one_slot_per_device_steps_in_place():
    """Slots on one device hold every leaf whole: the placed parameters
    are the state's own tensors (no copy), the row modules use them, and
    a step writes them in place."""
    cfg, model, batch = _setup("gemma2-2b")
    state = init_state(model, _opt(), 0, "cpu")
    ptrs = {k: p.data_ptr() for k, p in state.params.named_parameters()}
    placed = place_train_state(state, _rules())
    for k, p in placed.params.named_parameters():
        assert len(p.pieces) == 1 and p.pieces[0].slices is None
        assert p.pieces[0].tensor.data_ptr() == ptrs[k]
    module = placed.params.module_on("cpu")
    assert module is placed.params.module_on("cpu")
    assert all(p.data_ptr() == ptrs[k]
               for k, p in module.named_parameters())
    new, _ = make_train_step(model, _opt())(placed, batch)
    assert all(p.pieces[0].tensor.data_ptr() == ptrs[k]
               for k, p in new.params.named_parameters())


def test_mesh_splits_mrope_position_streams_by_row():
    """qwen2-vl's [3, B, S] M-RoPE positions and [B, 2, d] patch
    embeddings split by row with the tokens: the mesh loss and gradients
    equal one device's."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-vl-2b"),
                              dtype="float32")
    model = get_model(cfg)
    _, _, batch = _setup("qwen2-vl-2b", s=12)
    base = torch.arange(12, dtype=torch.int32)
    batch["positions"] = torch.stack([base, base // 2, base // 3])[:, None] \
        .repeat(1, 8, 1)
    batch["patch_embeds"] = torch.randn(
        8, 2, cfg.d_model, generator=torch.Generator().manual_seed(0))
    batch["labels"][3, 6:] = -100
    one = init_state(model, _opt(), 0, "cpu")
    placed = place_train_state(init_state(model, _opt(), 0, "cpu"),
                               _rules())
    with full_fp32_matmul():
        l1, _, g1 = value_and_grad(model, one.params, batch)
        l2, _, g2 = value_and_grad(model, placed.params, batch)
    np.testing.assert_allclose(float(l2), float(l1), rtol=LOSS_RTOL)
    assert _worst_grad(g2, g1) <= 1.0
