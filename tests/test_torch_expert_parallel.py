"""The expert-parallel train step: a config with experts on a model axis
of more than one slot (no JAX).

For the float32 smoke configs of qwen3-moe-30b-a3b (8 experts, top-2)
and dbrx-132b (4 experts, top-2) on ``make_host_mesh`` meshes of
``["cpu"] * n`` slots (2 x 2, 1 x 4, 2 x 4), against the one-device step
on the same global batch, row 0 padded:

- the loss within rtol 1e-5, the aux within rtol 1e-5;
- each gradient leaf within 1e-4 of its own max |g|;
- at the configs' capacity factors (no pair dropped) and at 1.0, where
  pairs drop and which drop depends on the other rows' counts.

The rows' routing put together (``ffn.assemble_dispatch`` of the global
ranks from each row's ranks and the exclusive scan of the rows' counts)
is ``moe_apply``'s dispatch table exactly, and the pairs each owner
computes follow from the counts alone (``ffn.owner_sizes``).  Under
``launch.dryrun.StepCounter`` each slot's expert products are 1/M of its
row's and 1/(D * M) of the one-device step's: no cell twice.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.index import full_fp32_matmul
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ffn, get_model, transformer
from repro_torch.optim.adamw import AdamW, constant
from repro_torch.train.step import (execution, init_state, make_train_step,
                                    place_train_state, row_slots,
                                    value_and_grad)

MOE = ["qwen3-moe-30b-a3b", "dbrx-132b"]
MESHES = [(2, 2), (1, 4), (2, 4)]
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
    batch["labels"][0, 5:] = -100               # row 0 padded
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


def _tables_of(fn) -> list:
    """(``fn()``, each ``ffn.dispatch_table`` it made, in call order)."""
    seen = []

    def spy(*args):
        seen.append(dispatch_table(*args))
        return seen[-1]

    dispatch_table = ffn.dispatch_table
    ffn.dispatch_table = spy
    try:
        return fn(), seen
    finally:
        ffn.dispatch_table = dispatch_table


def _one_device_tables(cfg, params, batch) -> list:
    """``moe_apply``'s dispatch table of each layer of the one-device
    forward."""
    with torch.no_grad():
        return _tables_of(lambda: transformer.loss_fn(params, cfg,
                                                      batch))[1]


def _mesh_tables(cfg, model, placed, batch) -> list:
    """Each layer's dispatch table put together from the global ranks of
    the units (a row's places, its tokens in order) in the mesh step's
    forward (``ffn.assemble_dispatch``)."""
    seen = []

    def spy(flat_e, grank, in_cap, cap, *args):
        seen.append((flat_e, grank, cap))
        return cell_owners(flat_e, grank, in_cap, cap, *args)

    cell_owners = ffn.cell_owners
    ffn.cell_owners = spy
    try:
        with full_fp32_matmul():
            value_and_grad(model, placed, batch)
    finally:
        ffn.cell_owners = cell_owners
    t, k = batch["tokens"].numel(), cfg.moe_top_k
    tables, parts, start = [], [], 0
    for flat_e, grank, cap in seen:
        n = flat_e.shape[0] // k
        parts.append((flat_e, grank, start + torch.arange(n)
                      .repeat_interleave(k)))
        start += n
        if start == t:
            tables.append(ffn.assemble_dispatch(parts, cfg.n_experts, cap,
                                                t))
            parts, start = [], 0
    return tables[:cfg.n_layers]            # the forward's, not remat's


@pytest.mark.parametrize("capacity", [None, 1.0], ids=["cf", "cf1"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", MOE)
def test_expert_parallel_step_equals_one_device(arch, mesh, capacity):
    """Loss, aux, ce and gradients against one device; each layer's
    dispatch table, put together from the rows' global ranks, equal to
    the one-device forward's (ints); pairs dropped at capacity 1.0 only."""
    kw = {} if capacity is None else {"capacity_factor": capacity}
    cfg, model, batch = _setup(arch, **kw)
    rules = _rules(*mesh)
    assert execution(model, rules) == "expert-parallel"
    assert len(row_slots(model, rules, batch)) == mesh[0]
    one = init_state(model, _opt(), 0, "cpu")
    placed = place_train_state(init_state(model, _opt(), 0, "cpu"), rules)
    with full_fp32_matmul():
        l1, m1, g1 = value_and_grad(model, one.params, batch)
        l2, m2, g2 = value_and_grad(model, placed.params, batch)
    np.testing.assert_allclose(float(l2), float(l1), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m2["aux"]), float(m1["aux"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m2["ce"]), float(m1["ce"]),
                               rtol=LOSS_RTOL)
    assert set(g2) == set(g1)
    assert _worst_grad(g2, g1) <= 1.0
    want = _one_device_tables(cfg, one.params, batch)
    got = _mesh_tables(cfg, model, placed.params, batch)
    assert len(got) == len(want) == cfg.n_layers
    for g, w in zip(got, want):
        assert torch.equal(g, w)        # ints: every pair routed alike
    t = batch["tokens"].numel()
    dropped = sum(t * cfg.moe_top_k - int((w < t).sum()) for w in want)
    assert (dropped > 0) == (capacity is not None)


def _row_parts(cfg, x, n_rows, router=None):
    """Each row's (flat_e, global rank, global token) of ``x`` [B, S, d]
    split into ``n_rows`` contiguous rows, as the mesh's MoE ranks them,
    and the rows' [E] counts."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    per = b // n_rows
    rows = []
    for j in range(n_rows):
        xf = x[j * per:(j + 1) * per].reshape(-1, d)
        _, _, top_e = ffn.route(xf.to(torch.float32) @ router, k,
                                cfg.norm_topk)
        rows.append(ffn.expert_ranks(top_e, e))
    counts = np.stack([c.numpy() for _, _, c in rows])
    prior = np.cumsum(counts, 0) - counts
    cap = ffn._capacity(b * s, e, k, cfg.capacity_factor)
    parts = []
    for j, (flat_e, rank, _) in enumerate(rows):
        grank, _ = ffn.global_ranks(rank, flat_e,
                                    torch.from_numpy(prior[j]), cap)
        tok = j * per * s + torch.arange(per * s).repeat_interleave(k)
        parts.append((flat_e, grank, tok))
    return parts, counts, cap


@pytest.mark.parametrize("capacity", [None, 1.0], ids=["cf", "cf1"])
@pytest.mark.parametrize("n_rows", [2, 4])
@pytest.mark.parametrize("arch", MOE)
def test_the_rows_dispatch_table_is_moe_apply_s(arch, n_rows, capacity):
    """The rows' global ranks put the one-device table together exactly
    (ints), dropped pairs included; row-local capacities would not; the
    owners' pair counts from the counts alone equal the devices'."""
    kw = {} if capacity is None else {"capacity_factor": capacity}
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((8, 16, cfg.d_model), generator=gen)
    p = {"router": torch.randn((cfg.d_model, cfg.n_experts), generator=gen)}
    p.update({k: torch.randn((cfg.n_experts,) + shape, generator=gen)
              for k, shape in (("e_gate", (cfg.d_model, cfg.d_ff)),
                               ("e_up", (cfg.d_model, cfg.d_ff)),
                               ("e_down", (cfg.d_ff, cfg.d_model)))})
    _, (want,) = _tables_of(lambda: ffn.moe_apply(
        p, x, top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor,
        norm_topk=cfg.norm_topk))
    parts, counts, cap = _row_parts(cfg, x, n_rows, p["router"])
    got = ffn.assemble_dispatch(parts, cfg.n_experts, cap, 8 * 16)
    assert torch.equal(got, want)
    n_pairs = 8 * 16 * cfg.moe_top_k
    kept = int((want < 8 * 16).sum())
    if capacity is None:
        assert kept == n_pairs
    else:
        assert kept < n_pairs
        # a row ranked against its own capacity alone keeps other pairs
        alone = [ffn.assemble_dispatch(
            [(e_, g - torch.from_numpy(np.cumsum(counts, 0)[j] - counts[j])
              [e_], t)], cfg.n_experts, cap, 8 * 16)
            for j, (e_, g, t) in enumerate(parts)]
        assert sum(int((a < 8 * 16).sum()) for a in alone) > kept
    for n_blocks in (1, 2, cfg.n_experts):
        sizes = ffn.owner_sizes(counts, cap, n_rows, n_blocks)
        for j, (flat_e, grank, _) in enumerate(parts):
            in_cap = grank < cap
            owner, e_loc, c_loc = ffn.cell_owners(
                flat_e, grank, in_cap, cap, n_rows, cfg.n_experts, n_blocks)
            have = torch.bincount(owner, minlength=n_rows * n_blocks + 1)
            assert have[:-1].tolist() == sizes[j].reshape(-1).tolist()
            blocks = ffn.capacity_blocks(cap, n_rows)
            jj = owner[in_cap] // n_blocks
            m = owner[in_cap] % n_blocks
            eb = cfg.n_experts // n_blocks
            assert torch.equal(m * eb + e_loc[in_cap], flat_e[in_cap])
            start = torch.tensor([s_ for s_, _ in blocks])[jj]
            assert torch.equal(start + c_loc[in_cap], grank[in_cap])
            assert bool((c_loc[in_cap] < torch.tensor(
                [n for _, n in blocks])[jj]).all())


def test_capacity_blocks_and_even_counts():
    assert ffn.capacity_blocks(10, 4) == [(0, 3), (3, 3), (6, 2), (8, 2)]
    assert ffn.capacity_blocks(8, 2) == [(0, 4), (4, 4)]
    even = ffn.even_counts([16, 16], 2, 6)
    assert even.tolist() == [[6, 6, 5, 5, 5, 5]] * 2
    assert even.sum() == 64


def test_a_microbatched_step_equals_one_device():
    """Two microbatches on 2 x 2 slots: each microbatch's capacity and
    aux are its own, as on one device."""
    cfg, model, batch = _setup("qwen3-moe-30b-a3b", capacity_factor=1.0)
    opt = _opt()
    step = make_train_step(model, opt, microbatches=2)
    one, m1 = step(init_state(model, opt, 0, "cpu"), batch)
    with shd.use_rules(_rules(2, 2)):
        mesh, m2 = step(init_state(model, opt, 0, "cpu"), batch)
    assert isinstance(mesh.params, shd.PlacedModule)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=LOSS_RTOL)
    want = dict(one.params.named_parameters())
    for k, p in mesh.params.named_parameters():
        np.testing.assert_allclose(p.gather("cpu").detach().numpy(),
                                   want[k].detach().numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_slots_on_distinct_devices_step_as_one_device():
    """``cpu:0`` .. ``cpu:3``: each slot holds its own expert blocks,
    each row's two devices route a half of its tokens each (so the
    dispatch table is put together from four units), the tokens and
    outputs move between devices, and block m of an expert leaf's
    gradient is summed on slot (0, m)."""
    cfg, model, batch = _setup("qwen3-moe-30b-a3b", capacity_factor=1.0)
    rules = _rules(2, 2, [f"cpu:{i}" for i in range(4)])
    placed = place_train_state(init_state(model, _opt(), 0, "cpu"), rules)
    with full_fp32_matmul():
        _, _, g = value_and_grad(model, placed.params, batch)
    eg = g["layers.0.ffn.e_gate"]
    assert isinstance(eg, shd.PlacedTensor)
    one = init_state(model, _opt(), 0, "cpu")
    for got, want in zip(_mesh_tables(cfg, model, placed.params, batch),
                         _one_device_tables(cfg, one.params, batch)):
        assert torch.equal(got, want)   # two units a row: its two cards
    assert [p.device for p in eg.pieces] == [torch.device("cpu", 0),
                                             torch.device("cpu", 1)]
    step = make_train_step(model, _opt())
    for _ in range(2):
        one, m1 = step(one, batch)
        placed, m2 = step(placed, batch)
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                                   rtol=LOSS_RTOL)
    want = dict(one.params.named_parameters())
    assert max(float((p.gather("cpu").detach() - want[k].detach())
                     .abs().max())
               for k, p in placed.params.named_parameters()) <= PARAM_ATOL


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (2, 4)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_each_slot_computes_its_experts_block_once(mesh):
    """Under the cost counter, on the meta device (the moves sized by
    ``ffn.even_counts``; the slabs' shapes do not depend on routing):
    each slot's forward expert products are 1/M of its row's and
    1/(D * M) of the one-device step's, and the slots' sum is the
    one-device step's (no cell twice); the rows' tokens and outputs move
    as "all_to_all"."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              dtype="float32", remat=False)
    model = get_model(cfg)
    batch = {k: torch.empty((8, 16), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    data, n_model = mesh
    counters = []
    for rules in (None, _rules(data, n_model, ["meta"] * (data * n_model))):
        params = init_state(model, _opt(), 0, "meta").params
        if rules is not None:
            params = shd.place_module(params, rules)
            assert len(row_slots(model, rules, batch)) == data
        c = dryrun.StepCounter()
        with c, full_fp32_matmul():
            value_and_grad(model, params, batch)
        counters.append(c)
    whole = sum(v["experts"] for v in counters[0].part_flops.values())
    per = counters[1].part_flops
    cap = ffn._capacity(8 * 16, cfg.n_experts, cfg.moe_top_k,
                        cfg.capacity_factor)
    assert whole == 3 * 2 * cfg.n_experts * cap * cfg.d_model * cfg.d_ff \
        * cfg.n_layers
    assert sum(v["experts"] for v in per.values()) == whole
    assert cap % data == 0
    for j in range(data):
        row = sum(per[j * n_model + m]["experts"] for m in range(n_model))
        for m in range(n_model):
            got = per[j * n_model + m]["experts"]
            assert got * n_model == row
            assert got * data * n_model == whole
    assert "all_to_all" in {k for k, _, _ in counters[1].moves}
    assert not counters[0].moves


def test_a_split_the_step_cannot_make_raises():
    """No fallback: experts the model axis does not divide, an expert
    leaf split on another dim, a router split on its d_model dim, and
    only some expert leaves split all raise."""
    cfg, model, batch = _setup("qwen3-moe-30b-a3b")
    six = dataclasses.replace(cfg, n_experts=6)
    m6 = get_model(six)
    placed = shd.place_module(init_state(m6, _opt(), 0, "cpu").params,
                              _rules(1, 4))
    assert execution(m6, _rules(1, 4)) == "expert-parallel"
    with pytest.raises(ValueError, match="6 experts do not split over 4"):
        value_and_grad(m6, placed, batch)
    with pytest.raises(ValueError, match="do not split"):
        transformer.slot_plan(six, 4, {})
    dims = {"layers.0.ffn.e_gate": 1}
    with pytest.raises(ValueError, match="on dim 1; the step splits it on "
                                         "dim 0"):
        transformer.slot_plan(cfg, 2, dims)
    with pytest.raises(ValueError, match="on dim 0; the step splits it on "
                                         "dim 1"):
        transformer.slot_plan(cfg, 2, {"layers.0.ffn.router": 0})
    with pytest.raises(ValueError, match="only some experts"):
        transformer.slot_plan(cfg, 2, {"layers.0.ffn.e_gate": 0,
                                       "layers.0.ffn.router": None})
    plan = transformer.slot_plan(cfg, 2, {"layers.0.ffn.e_up": 0,
                                          "layers.0.ffn.router": 1})
    assert plan.experts
    assert transformer.slot_slices(plan, cfg, "layers.0.ffn.router",
                                   (64, 8), 1) == (slice(0, 64),
                                                   slice(4, 8))


def test_one_model_slot_and_a_data_only_mesh_gather_rows():
    """A model axis of one slot stays row-gather: the whole batch one
    row group (its rows could not share the capacity and aux)."""
    for arch in MOE:
        cfg, model, batch = _setup(arch)
        for mesh in ((4, 1), (1, 1)):
            assert execution(model, _rules(*mesh)) == "row-gather"
            assert len(row_slots(model, _rules(*mesh), batch)) == 1


def test_launch_train_steps_expert_parallel_on_a_host_mesh(tmp_path,
                                                           capsys):
    state = launch_train.main([
        "--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
        "--host-mesh", "2,2", "--steps", "2", "--batch", "4", "--seq", "16",
        "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "2 x 2 mesh: expert-parallel" in out
    assert isinstance(state.params, shd.PlacedModule)
    assert all(torch.isfinite(p.gather("cpu")).all()
               for p in state.params.parameters())
