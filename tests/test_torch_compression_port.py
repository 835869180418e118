"""Compressed data-parallel steps on the port alone (no JAX).

- int8_ef's error feedback is exact: per slot ``acc - q * scale`` is
  the new error and ``q * scale + err' == acc`` bit for bit, and the
  gradient is the int32 sum of q times the scale over the slot count;
- the reference's trajectory bounds over 12 steps on 8 slots (its
  ``test_int8_ef_compression_tracks_exact``): exact training falls by
  0.2, int8_ef ends within 0.35 of exact and bf16 within 0.2;
- the int8 scales cover the reference's stacked leaves;
- a replicated state on two devices, and the refusals.

``tests/test_torch_compression.py`` holds the parity with the JAX
package.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import MarkovLM
from repro_torch.distributed import compression
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamW, constant

LR, EPS = 3e-3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(**kw):
    return dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                               n_layers=2, vocab=64, **kw)


class _Capture:
    """An optimizer that keeps the gradients of its first update."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, *args):
        if self.grads is None:
            self.grads = {k: v.clone() for k, v in grads.items()}
        return self.opt.update(grads, *args)


def _run(cfg, scheme, steps=12, slots=8):
    """The reference test's run: lr 3e-3, no clipping, 16 x 16 batches."""
    model = get_model(cfg)
    opt = AdamW(lr=constant(3e-3), max_grad_norm=None)
    params = model.init(0, device="cpu").requires_grad_(True)
    st = opt.init(params)
    step, init_err = compression.make_compressed_train_step(
        model, opt, make_host_mesh(slots, 1, devices=["cpu"] * slots),
        scheme=scheme)
    err = init_err(params)
    data = MarkovLM(vocab=cfg.vocab, seed=0)
    losses = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v)
                 for k, v in data.batch(s, 16, 16).items()}
        params, st, err, loss = step(params, st, err, batch)
        losses.append(float(loss))
    return losses


def test_int8_error_feedback_is_exact(monkeypatch):
    """acc == q * scale + err' exactly, slot by slot, and the gradient is
    the int32 sum of q times scale over the slot count."""
    from repro_torch.core.index import full_fp32_matmul
    from repro_torch.train.step import value_and_grad

    cfg = _tiny(dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device="cpu").requires_grad_(True)
    opt = _Capture(AdamW(lr=constant(LR), eps=EPS))
    st = opt.init(params)
    mesh = make_host_mesh(4, 1, devices=["cpu"] * 4)
    step, init_err = compression.make_compressed_train_step(
        model, opt, mesh, scheme="int8_ef")
    err = init_err(params)
    batch = {k: torch.from_numpy(v) for k, v in
             MarkovLM(vocab=cfg.vocab, seed=0).batch(0, 8, 16).items()}
    accs = []
    for i in range(4):
        with full_fp32_matmul():
            _, _, g = value_and_grad(model, params, {
                k: v[2 * i:2 * i + 2] for k, v in batch.items()})
        accs.append({k: g[k] + err[i][k] for k in g})
    scales = []
    real = compression._slot_scales
    monkeypatch.setattr(compression, "_slot_scales", lambda local: (
        scales.append(real(local)[0]) or real(local)))
    params, st, err, _ = step(params, st, err, batch)
    groups = compression.scale_groups(cfg, list(accs[0]))
    assert len(scales) == len(groups) < len(accs[0])
    for sc, names in zip(scales, groups.values()):
        for k in names:
            total = torch.zeros(accs[0][k].shape, dtype=torch.int32)
            for i in range(4):
                q = torch.clamp(torch.round(accs[i][k] / sc), -127, 127)
                assert torch.equal(accs[i][k] - q * sc, err[i][k]), k
                assert torch.equal(q * sc + err[i][k], accs[i][k]), k
                total += q.to(torch.int32)
            assert torch.equal(total.to(torch.float32) * sc / 4.0,
                               opt.grads[k]), k


def test_trajectory_bounds_of_the_reference():
    """The reference's own bounds over 12 steps (8 slots, lr 3e-3, no
    clipping): exact training falls by 0.2, int8_ef ends within 0.35 of
    exact and bf16 within 0.2."""
    cfg = _tiny()
    exact = _run(cfg, "none")
    comp = _run(cfg, "int8_ef")
    bf16 = _run(cfg, "bf16")
    assert exact[-1] < exact[0] - 0.2, exact
    assert abs(comp[-1] - exact[-1]) < 0.35, (comp[-1], exact[-1])
    assert abs(bf16[-1] - exact[-1]) < 0.2, (bf16[-1], exact[-1])


def test_scale_groups_follow_the_reference_stack():
    cfg = get_smoke_config("gemma2-2b")
    names = [k for k, _ in get_model(cfg).init(0, device="meta")
             .named_parameters()]
    groups = compression.scale_groups(cfg, names)
    n = len(cfg.pattern)
    stacked = [k for k in names if k.startswith("layers.0.")]
    for k in stacked:
        key = "groups.l0." + k.split(".", 2)[2]
        assert groups[key] == [f"layers.{g * n}." + k.split(".", 2)[2]
                               for g in range(cfg.n_groups)]
    assert groups["embedding"] == ["embedding"]
    enc = compression.scale_groups(get_smoke_config("whisper-base"), [
        "enc.layers.0.attn.wq", "enc.layers.1.attn.wq", "dec.embedding"])
    assert enc == {"enc.layers.attn.wq": ["enc.layers.0.attn.wq",
                                          "enc.layers.1.attn.wq"],
                   "dec.embedding": ["dec.embedding"]}


def test_replicated_state_on_two_devices_and_bad_calls():
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              n_layers=1, vocab=64)
    model = get_model(cfg)
    params = model.init(0, device="cpu").requires_grad_(True)
    mesh = make_host_mesh(2, 1, devices=["cpu", "meta"])
    rep = compression.replicate(params, mesh)
    assert [p.device.type for p in rep.leaves["embedding"].pieces] == [
        "cpu", "meta"]
    assert rep.leaves["embedding"].pieces[0].tensor is params.embedding
    step, _ = compression.make_compressed_train_step(
        model, AdamW(lr=constant(1e-3)), mesh, scheme="none")
    with pytest.raises(ValueError, match="replicate"):
        step(params, None, None, {"tokens": torch.zeros(2, 4, dtype=int),
                                  "labels": torch.zeros(2, 4, dtype=int)})
    with pytest.raises(ValueError, match="scheme"):
        compression.make_compressed_train_step(model, None, mesh,
                                               scheme="fp8")
    with pytest.raises(ValueError, match="axis"):
        compression.make_compressed_train_step(model, None, mesh,
                                               axis="pod")
