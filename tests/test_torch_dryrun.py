"""The port's dry-run (``launch/dryrun.py``) on the CPU, with no JAX.

- Meta-traced FLOPs equal ``torch.utils.flop_counter.FlopCounterMode``
  around the same step run on real CPU tensors (a train step, an exact
  decode step and an HNTL-KV retrieval decode step through
  ``hntl_scan_single``), exactly; the kernel calls the meta trace counts
  are the retrieval layers, and nothing is launched.
- The kernel wrappers' meta branches and cost functions against
  hand-counted bytes and operations (43,011,072 bytes for one
  ``hntl_scan_single`` at P=256 k=16 cap=4096 int16), exactly.
- ``run_cell_extrapolated`` against a full-depth trace of a 6-layer
  dense smoke config: FLOPs, kernel calls and aten ops exactly, bytes to
  1e-9 relative.
- The collective reckoning on a 2 x 2 mesh against a hand count.
- ``roofline``'s terms, the counter's live-bytes peak, and ``main``.
"""
import dataclasses
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import fused_select, hntl_scan
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.models import hntl_attention as H
from repro_torch.optim.adamw import AdamW, constant
from repro_torch.train.step import init_state, make_train_step


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _flops_real(fn, *args) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def _count_meta(fn, *args) -> dryrun.StepCounter:
    counter = dryrun.StepCounter()
    with counter:
        fn(*args)
    return counter


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma2-2b",
                                  "qwen3-moe-30b-a3b", "rwkv6-1.6b",
                                  "whisper-base"])
def test_train_step_meta_flops_equal_real(arch):
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    opt = AdamW(lr=constant(1e-3))
    b, s = 2, 24
    batch = specs.train_batch_specs(cfg, b, s)
    if cfg.family == "encdec":
        batch = {k: _meta((b, 16) + tuple(v.shape[2:]), v.dtype)
                 if k == "frames" else _meta((b, s), v.dtype)
                 for k, v in batch.items()}
    if "patch_embeds" in batch:
        batch["patch_embeds"] = _meta((b, 2, cfg.d_model), torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    real_batch = {k: (torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                    dtype=v.dtype)
                      if not v.dtype.is_floating_point
                      else torch.randn(v.shape, generator=gen).to(v.dtype))
                  for k, v in batch.items()}
    if "positions" in real_batch:
        real_batch["positions"] = torch.arange(s).expand(3, b, s).to(
            torch.int32)
    step = make_train_step(model, opt)
    want = _flops_real(step, init_state(model, opt, 0, "cpu"), real_batch)
    got = _count_meta(step, init_state(model, opt, 0, "meta"), batch)
    assert got.matmul_flops == want > 0
    assert set(got.bytes) >= {"forward", "backward", "reduce", "update"}
    assert got.peak["total"] > 0


def test_exact_decode_meta_flops_equal_real():
    cfg = get_smoke_config("phi3-mini-3.8b")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    tok = torch.tensor([3, 5])
    pos = torch.tensor([7, 9])
    want = _flops_real(model.decode_step, params,
                       tok, model.init_cache(2, 32, "cpu"), pos)
    got = _count_meta(model.decode_step, model.init(0, device="meta"),
                      tok.to("meta"), model.init_cache(2, 32, "meta"),
                      pos.to("meta"))
    assert got.matmul_flops == want > 0
    assert not got.kernels


def test_retrieval_decode_meta_flops_equal_real_and_count_the_scan():
    cfg = specs.long_decode_cfg(get_smoke_config("phi3-mini-3.8b"))
    cfg = dataclasses.replace(cfg, kv_cap=16, kv_tail=16, kv_kt=4,
                              kv_nprobe=2, kv_pool=8)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    b, sealed = 2, 64
    gen = torch.Generator().manual_seed(0)
    shape = (b, sealed, cfg.n_kv_heads, cfg.head_dim)
    caches = [{"mixer": H.build_kv_index(
        torch.randn(shape, generator=gen), torch.randn(shape, generator=gen),
        cfg, device="cpu"), "ffn": ()} for _ in range(cfg.n_layers)]
    tok = torch.tensor([3, 5])
    pos = torch.tensor([sealed + 2, sealed + 5])
    before = hntl_scan.hntl_scan_single.launches
    want = _flops_real(model.decode_step, params, tok, caches, pos)
    metas = [{"mixer": H.kv_index_specs(cfg, b, sealed, torch.float32),
              "ffn": ()} for _ in range(cfg.n_layers)]
    got = _count_meta(model.decode_step, model.init(0, device="meta"),
                      tok.to("meta"), metas, pos.to("meta"))
    assert got.matmul_flops == want > 0
    p = b * cfg.n_kv_heads * (cfg.n_heads // cfg.n_kv_heads) * cfg.kv_nprobe
    per_call = hntl_scan.scan_cost(
        _meta((p, cfg.kv_kt), torch.int32), _meta((p,)),
        _meta((p, cfg.kv_kt, cfg.kv_cap), torch.int16),
        _meta((p, cfg.kv_cap), torch.int32),
        _meta((p, cfg.kv_cap), torch.bool), _meta((p,)), _meta((p,)))
    assert got.kernels == {"hntl_scan_single": {
        "calls": cfg.n_layers, "bytes": cfg.n_layers * per_call[0],
        "ops": cfg.n_layers * per_call[1]}}
    assert got.flops_by_dtype["hntl_scan_single"] == cfg.n_layers \
        * per_call[1]
    assert hntl_scan.hntl_scan_single.launches == before


def _scan_args(p, k, cap, coord=torch.int16, q=None):
    lead = (p,) if q is None else (p, q)
    return (_meta(lead + (k,), torch.int32), _meta(lead),
            _meta((p, k, cap), coord), _meta((p, cap), torch.int32),
            _meta((p, cap), torch.bool), _meta((p,)), _meta((p,)))


def test_scan_costs_equal_hand_counts():
    args = _scan_args(256, 16, 4096)
    # zq 256*16*4 + rq 256*4 + coords 256*16*4096*2 + res 256*4096*4
    # + valid 256*4096 + scale, res_scale 2*256*4 + out 256*4096*4
    assert hntl_scan.scan_cost(*args) == (43_011_072,
                                          256 * 4096 * (2 * 16 + 6))
    assert 43_011_072 == 16_384 + 1_024 + 33_554_432 + 4_194_304 \
        + 1_048_576 + 2_048 + 4_194_304
    nbytes, ops = hntl_scan.scan_cost(*_scan_args(8, 4, 64, torch.int8,
                                                  q=3))
    assert nbytes == 8 * 3 * 4 * 4 + 8 * 3 * 4 + 8 * 4 * 64 + 8 * 64 * 4 \
        + 8 * 64 + 2 * 8 * 4 + 8 * 3 * 64 * 4
    assert ops == 8 * 3 * 64 * (2 * 4 + 6)


def test_scan_meta_branches_check_and_report_without_launching():
    counter = dryrun.StepCounter()
    before = (hntl_scan.hntl_scan_single.launches,
              hntl_scan.hntl_scan.launches)
    with counter:
        out = hntl_scan.hntl_scan_single(*_scan_args(256, 16, 4096))
        outb = hntl_scan.hntl_scan(*_scan_args(4, 8, 32, q=5))
    assert out.is_meta and tuple(out.shape) == (256, 4096)
    assert outb.is_meta and tuple(outb.shape) == (4, 5, 32)
    assert out.dtype == outb.dtype == torch.float32
    assert counter.kernels["hntl_scan_single"] == {
        "calls": 1, "bytes": 43_011_072, "ops": 256 * 4096 * 38}
    assert counter.kernels["hntl_scan"]["calls"] == 1
    assert (hntl_scan.hntl_scan_single.launches,
            hntl_scan.hntl_scan.launches) == before
    bad = list(_scan_args(4, 8, 32))
    bad[1] = _meta((4,), torch.float64)
    with pytest.raises(TypeError, match="rq"):
        hntl_scan.hntl_scan_single(*bad)
    with pytest.raises(ValueError, match="limit"):
        hntl_scan.hntl_scan_single(*_scan_args(2, hntl_scan.MAX_K + 1, 8))
    # no counter: the meta branch reports to nobody and still returns
    assert hntl_scan.hntl_scan_single(*_scan_args(2, 4, 8)).is_meta


def _select_args(q, p, g, k, cap):
    return (_meta((q, p), torch.int32), _meta((q, p, k), torch.int32),
            _meta((q, p)), _meta((q, p), torch.bool),
            _meta((g, k, cap), torch.int16), _meta((g, cap), torch.int32),
            _meta((g, cap), torch.bool), _meta((g, cap), torch.int32),
            _meta((g,)), _meta((g,)))


def test_select_meta_branch_and_cost_equal_hand_counts():
    q, p, g, k, cap, w = 3, 2, 5, 4, 32, 8
    args = _select_args(q, p, g, k, cap)
    counter = dryrun.StepCounter()
    before = fused_select.fused_scan_select.launches
    with counter:
        d, r = fused_select.fused_scan_select(*args, width=w)
    assert d.is_meta and r.is_meta and tuple(d.shape) == (q, w)
    assert (d.dtype, r.dtype) == (torch.float32, torch.int32)
    assert fused_select.fused_scan_select.launches == before
    # min(G, Q * P) = 5 grains of cap * (2k + 0 + 4 + 1) + 12 bytes; the
    # [Q, P] probe arrays (gids 4, zq 4k, rq 4, keep 1); 12 bytes per
    # kept slot; 3k + 7 operations per slot of every pair
    want = (5 * (cap * (2 * k + 4 + 1) + 12)
            + q * p * (4 + 4 * k + 4 + 1) + q * w * 12,
            q * p * cap * (3 * k + 7))
    assert fused_select.select_cost(*args, width=w) == want
    assert counter.kernels["fused_scan_select"] == {
        "calls": 1, "bytes": want[0], "ops": want[1]}
    with pytest.raises(ValueError, match="width"):
        fused_select.fused_scan_select(*args, width=0)


def test_roofline_names_the_largest_term():
    r = dryrun.roofline({"bfloat16": 989e12, "float32": 67e12,
                         "hntl_scan_single": 67e12}, 3.35e12 * 2,
                        {"nvlink_in": 450e9, "nic_out": 50e9 * 4})
    assert r["compute_s"] == pytest.approx(3.0)
    assert r["memory_s"] == pytest.approx(2.0)
    assert r["collective_s"] == pytest.approx(4.0)
    assert r["bottleneck"] == "collective_s"
    assert r["compute_fraction"] == pytest.approx(0.75)


def test_counter_tracks_live_bytes_and_regions():
    a = torch.empty((256,), device="meta", requires_grad=True)
    counter = dryrun.StepCounter()
    with counter:
        b = a * 2.0                           # 1 KiB forward
        c = b * b                             # another
        del b
        loss = c.sum()
        (g,) = torch.autograd.grad(loss, [a])
        g32 = g.to(torch.float64)             # reduce: 2 KiB
        with torch.no_grad():
            a.add_(g32.to(a.dtype))           # update
    assert counter.peak["forward"] >= 2048
    assert counter.peak["reduce"] == 2048
    assert counter.bytes["update"] > 0 and counter.bytes["backward"] > 0
    assert counter.ops["aten.mul.Tensor"] >= 2
    assert counter.flops_by_dtype == {}       # no matmul


N_SCATTER = 96


@pytest.mark.parametrize("case", ["scatter_add_", "scatter_src",
                                  "scatter_value", "index_put_",
                                  "index_add_"])
@pytest.mark.parametrize("dtype", [torch.int64, torch.float32])
def test_scatter_bytes_count_only_the_values_written(case, dtype):
    """An in-place scatter reads its index and values and writes into its
    target as many elements as its values hold; a long index is never
    counted as written, whatever the target's dtype."""
    n, e = N_SCATTER, 40
    target = torch.zeros(e, dtype=dtype, device="meta")
    idx = torch.empty(n, dtype=torch.long, device="meta")
    vals = torch.empty(n, dtype=dtype, device="meta")
    run = {"scatter_add_": lambda: target.scatter_add_(0, idx, vals),
           "scatter_src": lambda: target.scatter_(0, idx, vals),
           "scatter_value": lambda: target.scatter_(0, idx, 1),
           "index_put_": lambda: target.index_put_((idx,), vals),
           "index_add_": lambda: target.index_add_(0, idx, vals)}[case]
    counter = dryrun.StepCounter()
    with counter:
        run()
    item = target.element_size()
    read = 8 * n + (0 if case == "scatter_value" else item * n)
    assert sum(counter.bytes.values()) == read + item * n
    assert sum(counter.ops.values()) == 1


def _smoke(arch, n_layers=None):
    def f(cfg):
        c = get_smoke_config(arch)
        return c if n_layers is None else dataclasses.replace(
            c, n_layers=n_layers)
    return f


def test_a_cell_traces_the_step_the_port_runs_but_rwkv6s_time_mix():
    """A cell's trace (``measurement``) is the runtime step, attention's
    key chunk included; only RWKV6's time-mix takes the chunked form,
    and its record says so."""
    recs = [dryrun.trace_cell("phi3-mini-3.8b", "train_4k",
                              mesh_override=(1, 1), measurement=m,
                              cfg_transform=_smoke("phi3-mini-3.8b", 1))
            for m in (True, False)]
    for key in ("flops_by_dtype", "aten_ops", "hbm_bytes",
                "bytes_by_region"):
        assert recs[0][key] == recs[1][key]
    assert not recs[0]["wkv_chunked"]
    rec = dryrun.trace_cell("rwkv6-1.6b", "train_4k", mesh_override=(1, 1),
                            cfg_transform=_smoke("rwkv6-1.6b", 1))
    assert rec["wkv_chunked"] and rec["flops"] > 0


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_extrapolation_equals_a_full_depth_trace(shape, tmp_path):
    tf = _smoke("phi3-mini-3.8b", 6)
    ext = dryrun.run_cell_extrapolated("phi3-mini-3.8b", shape,
                                       out_dir=str(tmp_path / "x"),
                                       cfg_transform=tf)
    full = dryrun.run_cell("phi3-mini-3.8b", shape, multi_pod=False,
                           out_dir=str(tmp_path / "f"), cfg_transform=tf)
    assert ext["status"] == full["status"] == "ok"
    assert ext["extrap_depths"] == [2, 4]
    assert ext["flops"] == full["flops"] > 0
    assert ext["flops_by_dtype"] == full["flops_by_dtype"]
    assert ext["aten_ops"] == full["aten_ops"]
    assert ext["kernels"] == full["kernels"]
    for key in ("hbm_bytes",):
        assert ext[key] == pytest.approx(full[key], rel=1e-9)
    for k, v in full["collective_bytes"].items():
        assert ext["collective_bytes"][k] == pytest.approx(v, rel=1e-9)
    for k in ("params", "moments", "inputs", "gathered"):
        assert ext["bytes_per_device"][k] == pytest.approx(
            full["bytes_per_device"][k], rel=1e-9)
    assert ext["roofline"]["bottleneck"] == full["roofline"]["bottleneck"]


def _leaf_specs(model, rules):
    return [(p, rules.spec_for_shape(tuple(p.shape),
                                     shd._leaf_logical_axes(n, p.shape)))
            for n, p in model.named_parameters()]


def test_collectives_of_a_train_step_on_2x2_equal_a_hand_count():
    """2 x 2 mesh, one host, the tensor-parallel step (phi3-mini's smoke
    config splits its heads, MLP and vocab over the 2 model slots; remat
    off, so each tensor moves once each way): data rows 0 and 1 (batch
    256 over 2) over slots (0, 1) and (2, 3).  Slot 0 fetches from slot
    2 the other half of its model block of each split leaf and sends its
    own piece there; slot 2 sends slot 0 its gradient parts (the
    parameters' dtype) of model block 0, and slots 1, 2 and 3 their
    gradients of the norms, which every slot computes with; slot 0 sends
    slot 2 its pieces' float32 slices and slots 1 and 3 the norms'.
    Within a row the two slots all-reduce each float32 partial sum and
    the embedding rows (each sends the other half, then half of the
    rounded sum), slot 1 sends slot 0 the loss terms, and the backward
    moves each gradient the other way (model_sum)."""
    def tf(cfg):
        return dataclasses.replace(get_smoke_config("phi3-mini-3.8b"),
                                   remat=False)

    rec = dryrun.trace_cell("phi3-mini-3.8b", "train_4k",
                            mesh_override=(2, 2), cfg_transform=tf)
    mesh = make_host_mesh(2, 2, devices=["meta"] * 4)
    rules = shd.default_rules(mesh)
    cfg = tf(None)
    model = get_model(cfg).init(0, device="meta")
    piece = half = f32 = norms = norm_numel = 0
    for p, spec in _leaf_specs(model, rules):
        size = p.numel() * p.element_size()
        if shd._n_blocks(mesh, spec) == 4:
            piece += size // 4
            half += size // 2
            f32 += p.numel()
        else:
            norms += size
            norm_numel += p.numel()
    b, s, item = 128, 4096, cfg.compute_dtype.itemsize
    act = b * s * cfg.d_model * item
    moved = 6 * cfg.n_layers * act + 2 * act + 8 * b * s
    assert rec["rows"] == 2 and rec["row_batch"] == 128
    assert rec["execution"].startswith("tensor-parallel")
    assert rec["busiest_device"] == 0
    assert rec["collective_bytes"] == {
        "grad_reduce": half + 3 * norms,
        "grad_scatter": f32 + 12 * norm_numel,
        "model_sum": 2 * moved, "param_gather": 2 * piece,
        "total": 2 * piece + half + 3 * norms + f32 + 12 * norm_numel
        + 2 * moved}
    assert rec["link_bytes"] == {
        "nvlink_in": piece + half + 3 * norms + moved,
        "nvlink_out": piece + f32 + 12 * norm_numel + moved,
        "nic_in": 0.0, "nic_out": 0.0}
    assert rec["bytes_per_device"]["gathered"] == half


def test_collectives_of_a_decode_step_on_2x2_equal_a_hand_count():
    """Exact decode, batch 128 over 2 data rows: each cache leaf [128, T,
    KV, hd] is split (data, -, model, -); slot 0 fetches the block of its
    rows that slot 1 holds and sends the replaced cache back there."""
    rec = dryrun.trace_cell("phi3-mini-3.8b", "decode_32k",
                            mesh_override=(2, 2),
                            cfg_transform=_smoke("phi3-mini-3.8b"))
    cfg = get_smoke_config("phi3-mini-3.8b")
    leaf = 128 * 32768 * cfg.n_kv_heads * cfg.head_dim \
        * cfg.compute_dtype.itemsize
    caches = 2 * cfg.n_layers * leaf // 4
    assert rec["busiest_device"] == 0 and rec["rows"] == 2
    assert rec["collective_bytes"]["cache_gather"] == caches
    assert rec["collective_bytes"]["cache_writeback"] == caches
    rules = shd.default_rules(make_host_mesh(2, 2, devices=["meta"] * 4))
    model = get_model(cfg).init(0, device="meta")
    split = sum(p.numel() * p.element_size()
                for p, spec in _leaf_specs(model, rules)
                if shd._n_blocks(rules.mesh, spec) > 1)
    assert rec["bytes_per_device"]["gathered"] == 2 * caches + split


def test_main_writes_records_and_reuses_them(tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.setattr(specs, "get_config", get_smoke_config)
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    out = str(tmp_path / "dryrun")
    argv = ["--arch", "phi3-mini-3.8b", "--shape", "long_500k", "--out",
            out, "--both-meshes"]
    assert dryrun.main(argv) == 0
    for tag in ("pod1", "pod2"):
        with open(os.path.join(out, f"phi3-mini-3.8b__long_500k__{tag}"
                                    ".json")) as f:
            rec = json.load(f)
        assert rec["status"] == "ok" and rec["measurement"] == "extrapolated"
        assert rec["n_chips"] == (256 if tag == "pod1" else 512)
        assert rec["kernels"]["hntl_scan_single"]["calls"] == \
            get_smoke_config("phi3-mini-3.8b").n_layers
        assert rec["roofline"]["bottleneck"] in ("compute_s", "memory_s",
                                                 "collective_s")
        assert rec["execution"].startswith("row-gather")
    assert dryrun.main(argv) == 0
    assert "cached ok" in capsys.readouterr().out


def test_a_moe_train_cell_is_expert_parallel_with_its_experts_split():
    """qwen3-moe's train cell on a 2 x 2 mesh (one smoke layer): the
    record says "expert-parallel"; the busiest device's forward expert
    FLOPs are 1/(D * M) of the whole batch's one-device slab and the
    mesh's sum is that slab (no cell twice); the tokens and outputs
    moved between rows are counted as "all_to_all" collective bytes."""
    arch = "qwen3-moe-30b-a3b"
    rec = dryrun.trace_cell(arch, "train_4k", mesh_override=(2, 2),
                            cfg_transform=_smoke(arch, 1))
    cfg = get_smoke_config(arch)
    t = 256 * 4096
    cap = -(-int(t * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor)
            // 8) * 8
    whole = 3 * 2 * cfg.n_experts * cap * cfg.d_model * cfg.d_ff
    assert rec["execution"].startswith("expert-parallel")
    assert rec["rows"] == 2 and rec["row_batch"] == 128
    assert rec["expert_flops"]["mesh"] == whole
    assert rec["expert_flops"]["device"] * 4 == whole
    assert rec["collective_bytes"]["all_to_all"] > 0
    assert rec["collective_bytes"]["total"] >= \
        rec["collective_bytes"]["all_to_all"] \
        + rec["collective_bytes"]["model_sum"]
    one = dryrun.trace_cell(arch, "train_4k", mesh_override=(1, 1),
                            cfg_transform=_smoke(arch, 1))
    assert one["execution"].startswith("row-gather")
    assert one["expert_flops"]["device"] == whole
    assert "all_to_all" not in one["collective_bytes"]
