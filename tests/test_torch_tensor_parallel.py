"""The tensor-parallel train step: a data row's model slots split heads,
MLP columns and vocab rows (no JAX).

For the float32 smoke configs of the five dense attention-only decoders
(gemma2-2b, phi3-mini-3.8b, stablelm-3b, codeqwen1.5-7b, qwen2-vl-2b) on
``make_host_mesh`` meshes of ``["cpu"] * n`` slots (1 x 4, 2 x 2, 4 x 2,
1 x 8), against the one-device step:

- the loss within rtol 1e-5;
- each gradient leaf within 1e-4 of its own max |g|;
- one step's parameters within 1e-5 (AdamW at eps 1e-3).

1 x 8 leaves the smoke configs' 4 heads replicated (attention runs once,
on slot 0); 1 x 4 replicates gemma2's and qwen2-vl's 2 kv heads (each
slot takes the kv head its q head reads).  Slots on distinct devices
(``cpu:0`` .. ``cpu:3``: each holds its own blocks, and the gradient's
blocks are summed on slot (0, m)) step as one device too.  Under
``launch.dryrun.StepCounter`` each of four slots computes a quarter of
the one-device step's FLOPs, with products a quarter as wide.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.core.index import full_fp32_matmul
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model, transformer
from repro_torch.optim.adamw import AdamW, constant
from repro_torch.train.step import (execution, init_state, make_train_step,
                                    place_train_state, value_and_grad)

DENSE = ["gemma2-2b", "phi3-mini-3.8b", "stablelm-3b", "codeqwen1.5-7b",
         "qwen2-vl-2b"]
MOE = ["qwen3-moe-30b-a3b", "dbrx-132b"]
MESHES = [(1, 4), (2, 2), (4, 2), (1, 8)]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4           # of each leaf's own max |g|
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rules(data, model, devices=None):
    return shd.default_rules(make_host_mesh(
        data, model, devices=devices or ["cpu"] * (data * model)))


def _setup(arch, b=8, s=16, seed=0, **kw):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab, (b, s)).astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg.vocab, (b, s)).astype(np.int32))}
    batch["labels"][1, 5:] = -100
    if cfg.mrope_sections is not None:
        base = torch.arange(s, dtype=torch.int32)
        batch["positions"] = torch.stack(
            [base, base // 2, base // 3])[:, None].repeat(1, b, 1)
    return cfg, get_model(cfg), batch


def _opt():
    return AdamW(lr=constant(1e-3), eps=1e-3)


def _host(x):
    return x.gather("cpu") if isinstance(x, shd.PlacedTensor) else x


def _worst_grad(got: dict, want: dict) -> float:
    worst = 0.0
    for k, w in want.items():
        err = float((_host(got[k]) - w).abs().max())
        limit = GRAD_TOL * float(w.abs().max())
        worst = max(worst, err / limit if limit > 0 else
                    (0.0 if err == 0 else float("inf")))
    return worst


def _params_diff(placed, one) -> float:
    want = dict(one.named_parameters())
    return max(float((p.gather("cpu").detach() - want[k].detach())
                     .abs().max()) for k, p in placed.named_parameters())


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", DENSE)
def test_tensor_parallel_step_equals_one_device(arch, mesh):
    cfg, model, batch = _setup(arch)
    rules = _rules(*mesh)
    assert execution(model, rules) == "tensor-parallel"
    one = init_state(model, _opt(), 0, "cpu")
    placed = place_train_state(init_state(model, _opt(), 0, "cpu"), rules)
    with full_fp32_matmul():
        l1, _, g1 = value_and_grad(model, one.params, batch)
        l2, _, g2 = value_and_grad(model, placed.params, batch)
    np.testing.assert_allclose(float(l2), float(l1), rtol=LOSS_RTOL)
    assert set(g2) == set(g1)
    assert _worst_grad(g2, g1) <= 1.0
    step = make_train_step(model, _opt())
    one, m1 = step(one, batch)
    placed, m2 = step(placed, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=LOSS_RTOL)
    assert _params_diff(placed.params, one.params) <= PARAM_ATOL


@pytest.mark.parametrize("arch, microbatches", [("gemma2-2b", 2),
                                                ("qwen2-vl-2b", 1)])
def test_slots_on_distinct_devices_step_as_one_device(arch, microbatches):
    """``cpu:0`` .. ``cpu:3`` are four devices to the placement: each
    slot holds its own blocks and gathers the rest (copies), and block m
    of a gradient is summed on slot (0, m) (a ``PlacedTensor``); two
    steps equal one device's (gemma2 in two microbatches; M-RoPE's
    [3, B, S] positions do not split into microbatches on one device
    either)."""
    cfg, model, batch = _setup(arch)
    rules = _rules(2, 2, [f"cpu:{i}" for i in range(4)])
    placed = place_train_state(init_state(model, _opt(), 0, "cpu"), rules)
    assert all(p.slices is not None for p in
               placed.params.leaves["layers.0.mixer.wq"].pieces)
    with full_fp32_matmul():
        _, _, g = value_and_grad(model, placed.params, batch)
    wq = g["layers.0.mixer.wq"]
    assert isinstance(wq, shd.PlacedTensor)
    assert [p.device for p in wq.pieces] == [torch.device("cpu", 0),
                                             torch.device("cpu", 1)]
    step = make_train_step(model, _opt(), microbatches=microbatches)
    one = init_state(model, _opt(), 0, "cpu")
    for _ in range(2):
        one, m1 = step(one, batch)
        placed, m2 = step(placed, batch)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=LOSS_RTOL)
    assert _params_diff(placed.params, one.params) <= PARAM_ATOL


def _forward_products():
    """A counter that also records (slot, contracted dim, output dim) of
    each forward matrix product."""
    class Counter(dryrun.StepCounter):
        products: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default) \
                    and torch._C._current_graph_task_id() == -1:
                self.products.append((self._slot(),
                                      func._overloadpacket.__name__,
                                      args[0].shape[-1], args[1].shape[-1]))
            return super().__torch_dispatch__(func, types, args, kwargs)
    Counter.products = []
    return Counter()


def _count(cfg, params, batch):
    counter = _forward_products()
    with counter:
        value_and_grad(get_model(cfg), params, batch)
    return counter


@pytest.mark.parametrize("n_slots", [4, 8])
def test_each_slot_computes_its_share_and_no_product_twice(n_slots):
    """phi3-mini's smoke config (4 heads, 4 kv heads, MLP 128; vocab
    1,024, so that no two products have one shape; remat off, so no
    product is recomputed) on 1 x n_slots slots of the meta device.  On
    4 slots every dim divides: each slot's products over a split dim are
    a quarter as wide (q, k, v 16 of 64 columns, MLP 32 of 128, logits
    256 of 1,024; ``wo`` and ``w_down`` contract 16 of 64 and 32 of
    128), and each slot does a quarter of the one-device
    step's FLOPs.  On 8 slots the 4 heads replicate: attention runs once,
    on slot 0, and the FLOPs over the slots still total the one-device
    step's."""
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                              dtype="float32", remat=False, vocab=1024)
    batch = specs.train_batch_specs(cfg, 4, 32)
    state = init_state(get_model(cfg), _opt(), 0, "meta")
    one = _count(cfg, state.params, batch)
    rules = _rules(1, n_slots, ["meta"] * n_slots)
    tp = _count(cfg, shd.place_module(state.params, rules), batch)
    total = one.flops_by_dtype["float32"]
    per_slot = [tp.slot_flops[m]["float32"] + (
        tp.slot_flops[None]["float32"] if m == 0 else 0)
        for m in range(n_slots)]
    assert sum(per_slot) == tp.flops_by_dtype["float32"] == total > 0
    d, hd, ff, v = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.vocab
    whole = {("bmm", d, 4 * hd), ("mm", d, ff), ("mm", ff, d), ("mm", d, v)}
    assert whole <= {p[1:] for p in one.products}
    for m in range(n_slots):
        got = {p[1:] for p in tp.products if p[0] == m}
        if n_slots == 4:
            assert per_slot[m] * 4 == total
            assert {("bmm", d, hd), ("mm", hd, d), ("mm", d, ff // 4),
                    ("mm", ff // 4, d), ("mm", d, v // 4)} <= got
            assert not got & whole
        else:           # q, k, v, scores, PV and wo: slot 0's alone
            assert {("mm", d, ff // 8), ("mm", ff // 8, d),
                    ("mm", d, v // 8)} <= got
            assert ("bmm", d, 4 * hd) in got if m == 0 \
                else not any(p[0] == "bmm" for p in got)


def test_execution_follows_the_family_and_the_model_axis():
    """The five dense attention-only decoders split over a model axis of
    more than one slot, the two with experts split expert-parallel;
    RG-LRU, RWKV6 and whisper gather rows, and so does everything on a
    data-only mesh."""
    for arch in list_archs():
        model = get_model(get_smoke_config(arch))
        want = "tensor-parallel" if arch in DENSE else \
            "expert-parallel" if arch in MOE else "row-gather"
        assert execution(model, _rules(2, 2)) == want, arch
        assert execution(model, _rules(4, 1)) == "row-gather", arch
        assert execution(model, None) == "row-gather", arch
    assert set(DENSE) | set(MOE) < set(list_archs())


def test_a_leaf_the_step_cannot_split_raises():
    """No fallback gathers a leaf whole in silence: a head_dim split over
    the model axis, heads split where their wo is not, q heads per slot
    that do not align with the kv groups, and experts that the model
    slots do not divide all raise."""
    cfg, model, batch = _setup("phi3-mini-3.8b")
    rules = _rules(1, 4)
    bad = shd.ShardingRules(rules.mesh, {**rules.rules, "heads": None,
                                         "head_dim": ("model",)})
    placed = shd.place_module(init_state(model, _opt(), 0, "cpu").params,
                              bad)
    with pytest.raises(ValueError, match="on dim 2"):
        value_and_grad(model, placed, batch)
    dims = {"layers.0.mixer.wq": 1, "layers.0.mixer.wo": None}
    with pytest.raises(ValueError, match="only some heads"):
        transformer.slot_plan(cfg, 4, dims)
    gqa = dataclasses.replace(cfg, n_heads=12, n_kv_heads=4)
    with pytest.raises(ValueError, match="do not align"):
        transformer.slot_plan(gqa, 6, {"layers.0.mixer.wq": 1,
                                       "layers.0.mixer.wk": None})
    moe = get_smoke_config("qwen3-moe-30b-a3b")
    with pytest.raises(ValueError, match="8 experts do not split over 3"):
        transformer.slot_plan(moe, 3, {})
    assert transformer.slot_plan(moe, 2, {}).n_slots == 2


def test_region_gathers_and_gradient_blocks_add_by_part():
    """``PlacedTensor.region``: a view where the device holds the leaf
    whole, the piece itself where it holds that block, else a copy from
    the pieces; ``add_region_`` adds a part's gradient into the blocks it
    covers, and ``leaf_pieces`` hands each piece its part of a
    ``PlacedTensor`` gradient."""
    t = torch.arange(32.0).reshape(4, 8)
    devs = [torch.device("cpu", i) for i in range(4)]
    rules = shd.default_rules(make_host_mesh(2, 2, devices=devs))
    placed = shd.place(t, shd.NamedSharding(rules.mesh, ("data", "model"),
                                            rules))
    own = placed.region((slice(0, 2), slice(0, 4)), devs[0])
    assert own is placed.pieces[0].tensor
    block = placed.region((slice(0, 4), slice(4, 8)), devs[1])
    assert torch.equal(block, t[:, 4:])
    whole = shd.place(t, shd.NamedSharding(
        make_host_mesh(1, 2, devices=["cpu"] * 2), (None, "model")))
    view = whole.region((slice(1, 3), slice(0, 8)), "cpu")
    assert view.data_ptr() == t[1:3].data_ptr()
    acc = shd.PlacedTensor(placed.sharding, (4, 8), torch.float32, tuple(
        shd.Piece(devs[m], (slice(0, 4), slice(4 * m, 4 * m + 4)),
                  torch.zeros(4, 4)) for m in range(2)))
    shd.add_region_(acc, torch.ones(2, 6), (slice(1, 3), slice(1, 7)))
    shd.add_region_(acc, t, None)
    want = t.clone()
    want[1:3, 1:7] += 1
    assert torch.equal(acc.gather("cpu"), want)
    for piece, g in zip(placed.pieces, (g for *_, g in shd.leaf_pieces(
            placed, grad=acc))):
        assert torch.equal(g, want[piece.slices])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-vl-2b"])
def test_tensor_parallel_step_on_card_equals_cpu(arch):
    """The tensor-parallel step on 2 x 2 slots of ``cuda:0`` (and on 1 x
    2 distinct cards where the machine has two) against the CPU's
    one-device step: the loss to rtol 1e-5, each gradient leaf within
    1e-4 of its own max |g|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    cfg, model, batch = _setup(arch)
    with full_fp32_matmul():
        l1, _, g1 = value_and_grad(
            model, init_state(model, _opt(), 0, "cpu").params, batch)
    meshes = [["cuda:0"] * 4]
    if torch.cuda.device_count() >= 2:
        meshes.append(["cuda:0", "cuda:1"])
    for devs in meshes:
        rules = _rules(len(devs) // 2, 2, devs)
        state = init_state(model, _opt(), 0, "cpu")
        placed = shd.place_module(state.params, rules)
        on_card = {k: v.to("cuda:0") for k, v in batch.items()}
        with full_fp32_matmul():
            l2, _, g2 = value_and_grad(model, placed, on_card)
        np.testing.assert_allclose(float(l2), float(l1), rtol=LOSS_RTOL)
        got = {k: _host(v).cpu() for k, v in g2.items()}
        assert _worst_grad(got, g1) <= 1.0, devs
