"""Where the port runs, and what it imports.

- No module of ``repro_torch`` (nor ``chip_smoke.py`` or
  ``chip_train_controls.py``) imports JAX, the JAX package or
  ``ml_dtypes``: checked on the sources' AST and in a fresh interpreter
  (every module under the package, training's too).
- Entry points run on the card unless asked for the CPU: ``build``, the
  ``interop`` carriers and ``VectorStore`` with no ``device`` and no card
  raise.
- ``gpu``-marked tests hold the CUDA kernels against their plain
  versions on the card (per-probe lists above the shared width too), the
  "kernel" gather plane and HNTL-KV decode against their plain-scan runs,
  and a store's search against its "fused_ref" plane, also after
  compaction and maintenance, and with adaptive routing (warm, cold and
  paged), and a smoke model's prefill, decode, promoted HNTL-KV decode
  and engine on the card against the CPU and the plain scan (phi3-mini;
  qwen3-moe's promoted decode, whisper's retrieval cross-attention and a
  2-slot rwkv6 engine against serving each request alone), and training
  on the card: a float32 smoke model's loss and every gradient against
  the CPU's, and a step over 4 microbatches against one over the whole
  batch; they skip (inside a fixture) where there is no card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.
"""
import ast
import collections
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import index as port_index
from repro_torch.data import synthetic
from repro_torch.kernels import _build
from repro_torch.kernels import fused_select as port_fused
from repro_torch.kernels import hntl_scan as port_scan
from repro_torch.kernels import layout_scan
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import scan_cases, select_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _select_inputs(seed, device, **shape):
    """(args, kwargs) of the fused scan→select contract, on ``device``."""
    return select_cases.split(
        select_cases.random_inputs(seed, coord_range=3000, **shape),
        lambda v: torch.from_numpy(v).to(device))


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "chip_train_controls.py"),
           os.path.join(REPO, "chip_mesh_cards.py"),
           os.path.join(REPO, "chip_trace_margin.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    examples = os.path.join(REPO, "examples")
    out += [os.path.join(examples, f) for f in os.listdir(examples)
            if f.startswith("torch_") and f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = ["repro_torch"] + [
        "repro_torch." + os.path.relpath(p, PKG)[:-3].replace(os.sep, ".")
        .replace(".__init__", "")
        for p in _sources() if p.startswith(PKG)]
    code = ("import importlib, sys\n"
            f"for m in {sorted(set(mods))!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_build_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = synthetic.anisotropic_manifold(n=256, d=16, intrinsic=4, seed=0)
    cfg = repro_torch.HNTLConfig(d=16, k=4, s=2, block=16, n_grains=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.build(x, cfg)
    assert port_index.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["index_from_numpy", "kv_index_from_numpy",
                                   "segment_from_numpy",
                                   "manifest_from_numpy",
                                   "store_from_numpy"])
def test_interop_without_device_needs_a_card(monkeypatch, entry):
    from repro_torch import interop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(interop, entry)({})


def test_store_without_device_needs_a_card(monkeypatch):
    from repro_torch.core import VectorStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = repro_torch.HNTLConfig(d=16, k=4, s=2, block=16, n_grains=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorStore(cfg)
    assert VectorStore(cfg, device="cpu").device == torch.device("cpu")


def test_models_without_device_need_a_card(monkeypatch):
    from repro_torch import interop
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import get_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("phi3-mini-3.8b")
    model = get_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
    for carry in (interop.params_from_numpy, interop.caches_from_numpy):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            carry({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "phi3-mini-3.8b", "--smoke"])
    assert model.init(0, device="cpu").device == torch.device("cpu")


class _OnOtherDevice:
    """A stand-in argument on a device with no kernel and no plain
    version (the meta device now takes the dry-run's branch)."""

    device = torch.device("xpu")


def test_kernel_wrapper_refuses_other_devices():
    args, _ = _select_inputs(0, "meta", q=2, p=2, g=3, k=4, cap=32)
    with pytest.raises(ValueError, match="no kernel"):
        port_fused.fused_scan_select(_OnOtherDevice(), *args[1:], width=8)


def test_scan_wrappers_refuse_other_devices():
    a = scan_cases.panels(0, p=2, q=3, k=4, cap=32)
    args = scan_cases.args(a, lambda v: torch.from_numpy(v).to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        port_scan.hntl_scan(_OnOtherDevice(), *args[1:])
    single = scan_cases.args(scan_cases.single(a),
                             lambda v: torch.from_numpy(v).to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        port_scan.hntl_scan_single(_OnOtherDevice(), *single[1:])


def test_layout_scan_wrappers_refuse_other_devices():
    a = scan_cases.aos(0, p=2, cap=32, k=4)
    args = scan_cases.aos_args(a, torch.from_numpy)
    with pytest.raises(ValueError, match="no kernel"):
        layout_scan.aos_scan(_OnOtherDevice(), *args[1:])
    c = scan_cases.chase(0, n=16, k=4, n_steps=8)
    args = scan_cases.chase_args(c, torch.from_numpy)
    with pytest.raises(ValueError, match="no kernel"):
        layout_scan.pointer_chase_scan(_OnOtherDevice(), *args[1:])


def test_build_recipe_targets_hopper():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert {"fused_select", "hntl_scan", "layout_scan"} <= set(
        _build.source_names())
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")


GPU_CASES = {
    "plain": dict(q=8, p=4, g=12, k=32, cap=384),
    "sketch": dict(q=8, p=4, g=12, k=32, cap=384, s=8),
    "tenant_ragged": dict(q=9, p=5, g=12, k=8, cap=200, s=4, tenants=3,
                          ragged=True),
    "k1": dict(q=4, p=3, g=6, k=1, cap=130, s=2),
    # L = cap < width (at width 300), the scalar-load path (cap % 4 != 0),
    # killed pairs inside the grains' runs of the schedule
    "cap_below_width": dict(q=8, p=4, g=12, k=32, cap=200, s=8),
    "scalar_path_cap_1662": dict(q=8, p=4, g=12, k=16, cap=1662, s=8),
    "ragged_keep_holes": dict(q=16, p=8, g=4, k=8, cap=256, s=4,
                              ragged=True, keep_frac=0.5),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_CASES))
@pytest.mark.parametrize("width", [1, 64, 300])
def test_kernel_equals_plain_version_on_card(cuda_device, case, width):
    args, a = _select_inputs(width, cuda_device, **GPU_CASES[case])
    before = port_fused.fused_scan_select.launches
    d, r = port_fused.fused_scan_select(*args, width=width, **a)
    rd, rr = port_fused.fused_scan_select_ref(*args, width=width, **a)
    torch.cuda.synchronize()
    assert port_fused.fused_scan_select.launches == before + 1
    assert torch.equal(d, rd) and torch.equal(r, rr)


#: Inputs that fill the kernel's candidate buffer again and again: every
#: slot live, and (descending) every slot entering the running top-W; at
#: the widest shared-memory merge and, through ``select_cases.WIDE_CASES``,
#: on the wide paths (lists one below, at and one above the block-sort
#: threshold; the multi-way merge in global scratch: width 8,193 up to
#: P * cap, ties across probes, ragged n_active, the cascade's stage-1
#: form at widths 26,624 and 4,096).
FOLD_CASES = {
    "descending_narrow": (10, lambda: select_cases.descending_inputs(
        q=64, p=32, k=8, cap=2048)),
    "descending_max_width": (port_fused.SMEM_WIDTH, lambda:
                             select_cases.descending_inputs(
                                 q=64, p=32, k=8, cap=2048)),
    "all_live_max_width": (port_fused.SMEM_WIDTH, lambda:
                           select_cases.random_inputs(
                               5, q=64, p=32, g=64, k=32, cap=2048, s=8,
                               keep_frac=1.0, mask_frac=1.0)),
    # every pair in one grain run; equal keys across probes of different
    # grains and of one grain probed twice, every slot entering the pool
    "hot_grain": (64, lambda: select_cases.hot_grain_inputs(
        7, q=32, p=16, g=16, k=32, cap=1664, s=8)),
    "ties_across_probes": (3000, lambda: select_cases.tie_inputs(
        q=8, p=8, g=5, k=8, cap=1100, s=4)),
    **{f"wide_{name}": case
       for name, case in select_cases.WIDE_CASES.items()},
    # per-probe lists longer than a block sort: each pair's sorted runs
    **{f"long_{name}": case
       for name, case in select_cases.LONG_LIST_CASES.items()},
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_kernel_equals_plain_version_when_the_buffer_keeps_filling(
        cuda_device, case):
    width, make = FOLD_CASES[case]
    width = select_cases.resolve_width(width, port_fused.block_sort_length())
    args, a = select_cases.split(
        make(), lambda v: torch.from_numpy(v).to(cuda_device))
    for _ in range(3):        # a fault of ordering need not show every run
        d, r = port_fused.fused_scan_select(*args, width=width, **a)
        rd, rr = port_fused.fused_scan_select_ref(*args, width=width, **a)
        torch.cuda.synchronize()
        assert torch.equal(d, rd) and torch.equal(r, rr)


@pytest.mark.gpu
def test_launch_count_rises_by_one_per_call(cuda_device):
    """One wrapper call is one count, though it runs a schedule sort and
    two kernels."""
    args, a = _select_inputs(2, cuda_device, q=16, p=8, g=12, k=32,
                             cap=256, s=8, ragged=True)
    before = port_fused.fused_scan_select.launches
    for i in range(3):
        port_fused.fused_scan_select(*args, width=32, **a)
        assert port_fused.fused_scan_select.launches == before + i + 1
    port_fused.fused_scan_select_ref(*args, width=32, **a)
    torch.cuda.synchronize()
    assert port_fused.fused_scan_select.launches == before + 3


@pytest.mark.gpu
def test_kernel_refuses_width_beyond_its_limit(cuda_device):
    """Widths 1..max(SMEM_WIDTH, P * cap): above the shared-memory merge
    only up to P * cap; a probe's list min(width, cap) above SMEM_WIDTH
    runs (built from its sorted runs) and equals the plain version."""
    args, _ = _select_inputs(1, cuda_device, q=1, p=1, g=2, k=4, cap=32)
    for width in (0, port_fused.SMEM_WIDTH + 1):
        with pytest.raises(ValueError, match="width"):
            port_fused.fused_scan_select(*args, width=width)
    args, _ = _select_inputs(2, cuda_device, q=2, p=8, g=4, k=4, cap=1100)
    with pytest.raises(ValueError, match="width"):
        port_fused.fused_scan_select(*args, width=8 * 1100 + 1)
    d, _ = port_fused.fused_scan_select(*args, width=8 * 1100)
    assert d.shape == (2, 8 * 1100)
    cap = port_fused.SMEM_WIDTH + 4
    args, _ = _select_inputs(3, cuda_device, q=1, p=2, g=2, k=1, cap=cap)
    for width in (port_fused.SMEM_WIDTH + 1, cap, 2 * cap):
        d, r = port_fused.fused_scan_select(*args, width=width)
        rd, rr = port_fused.fused_scan_select_ref(*args, width=width)
        torch.cuda.synchronize()
        assert torch.equal(d, rd) and torch.equal(r, rr)
    with pytest.raises(ValueError, match="width"):
        port_fused.fused_scan_select(*args, width=2 * cap + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("budgets", [None, (2048, 32)])
@pytest.mark.parametrize("mode", ["A", "B"])
def test_cascade_search_launches_the_kernel_on_card(cuda_device, mode,
                                                    budgets):
    """A "cascade" search on a CUDA density index runs stage 1 through
    fused_scan_select (at budgets=None the wide merge: b1 = P * cap) and
    equals "cascade_ref" (stage 1 on the plain version) bit for bit."""
    from repro_torch.core import planner

    x = synthetic.anisotropic_manifold(n=8192, d=64, intrinsic=8, seed=2)
    q = torch.from_numpy(synthetic.queries_from(x, nq=40)).to(cuda_device)
    cfg = repro_torch.HNTLConfig(d=64, k=8, s=4, block=32, n_grains=16,
                                 nprobe=16, pool=32, bit_alloc="density")
    idx, _ = repro_torch.build(x, cfg, device=cuda_device)
    assert idx.grains.qmaxg is not None
    assert 16 * idx.grains.cap > port_fused.SMEM_WIDTH
    kw = dict(nprobe=16, pool=32, topk=10, mode=mode, budgets=budgets)
    before = port_fused.fused_scan_select.launches
    got = planner.search(idx, q, scan_impl="cascade", **kw)
    torch.cuda.synchronize()
    assert port_fused.fused_scan_select.launches == before + 1
    want = planner.search(idx, q, scan_impl="cascade_ref", **kw)
    assert port_fused.fused_scan_select.launches == before + 1
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.dists, want.dists)


def _mixed_tile(seed, coord_dtype=np.int16):
    """Three 16-query tiles, each with one query at a limb count's edge:
    -32768 and 32767 in tile 0 (2 limbs), one value of 32768 in tile 1 (4
    limbs; its neighbours fit int16) and -2^31 in the second panel, -128
    and 127 in tile 2 (1 limb)."""
    int8 = coord_dtype == np.int8
    a = scan_cases.panels(seed, p=2, q=40, k=32, cap=333,
                          coord_range=128 if int8 else 32768,
                          coord_dtype=coord_dtype)
    z = a["zq"]
    z[0, 3, :4] = [-32768, 32767, -32768, 32767]
    z[0, 17, 5] = 32768
    z[1, 20, :] = -2 ** 31
    z[:, 32:, :] = np.clip(z[:, 32:, :], -128, 127)
    z[:, 32, :2] = [-128, 127]
    return a


#: Scan-kernel cases: (form, inputs).  The JAX package's sweep, int32
#: extremes and wraparound, all-invalid panels, int8 sketch panels and
#: caps off 128; for the batched kernel's byte limbs, query tiles of 1, 2
#: and 4 limbs on int16 and int8 panels, k of 64, of three staged chunks
#: (192) and off 8 (12), one query, five query groups (600), and more
#: panels than one launch takes (65537).
SCAN_GPU_CASES = {
    **{f"batched_{p}x{q}x{k}x{cap}": (
        "batched", lambda p=p, q=q, k=k, cap=cap: scan_cases.panels(
            p + q + k + cap, p=p, q=q, k=k, cap=cap))
       for p, q, k, cap in scan_cases.SWEEP},
    **{f"single_{p}x{k}x{cap}": (
        "single", lambda p=p, k=k, cap=cap: scan_cases.single(
            scan_cases.panels(p + k + cap, p=p, q=1, k=k, cap=cap)))
       for p, k, cap in scan_cases.SINGLE_SWEEP},
    "batched_extremes": ("batched", lambda: scan_cases.extremes(
        p=2, q=3, k=32, cap=200)),
    "single_wraparound": ("single", lambda: scan_cases.single(
        scan_cases.panels(1, p=5, q=1, k=16, cap=333,
                          zq_range=2 ** 31 - 1))),
    "batched_all_invalid": ("batched", lambda: scan_cases.panels(
        2, p=2, q=9, k=16, cap=256, valid_frac=0.0)),
    "batched_int8": ("batched", lambda: scan_cases.panels(
        3, p=3, q=40, k=8, cap=333, coord_range=128, coord_dtype=np.int8)),
    "single_int8": ("single", lambda: scan_cases.single(scan_cases.panels(
        4, p=64, q=1, k=8, cap=1664, coord_range=128, coord_dtype=np.int8))),
    "batched_wraparound": ("batched", lambda: scan_cases.panels(
        6, p=3, q=19, k=16, cap=333, zq_range=2 ** 31 - 1)),
    "batched_int8_wide_zq": ("batched", lambda: scan_cases.panels(
        7, p=3, q=19, k=8, cap=333, zq_range=2 ** 31 - 1, coord_range=128,
        coord_dtype=np.int8)),
    "batched_mixed_tile": ("batched", lambda: _mixed_tile(8)),
    "batched_mixed_tile_int8": ("batched", lambda: _mixed_tile(9, np.int8)),
    "batched_k64": ("batched", lambda: scan_cases.panels(
        10, p=2, q=17, k=64, cap=200)),
    "batched_k192": ("batched", lambda: scan_cases.panels(
        11, p=2, q=20, k=192, cap=140, zq_range=2 ** 31 - 1,
        coord_range=32768)),
    "batched_q1": ("batched", lambda: scan_cases.panels(
        12, p=3, q=1, k=32, cap=257)),
    "batched_q600": ("batched", lambda: scan_cases.panels(
        13, p=2, q=600, k=16, cap=64)),
    "batched_k12": ("batched", lambda: scan_cases.panels(
        14, p=2, q=21, k=12, cap=131, coord_range=128, coord_dtype=np.int8)),
    "batched_p65537": ("batched", lambda: scan_cases.panels(
        15, p=65537, q=1, k=8, cap=8)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SCAN_GPU_CASES))
def test_scan_kernels_equal_plain_versions_on_card(cuda_device, case):
    form, make = SCAN_GPU_CASES[case]
    args = scan_cases.args(make(), lambda v: torch.from_numpy(v).to(
        cuda_device))
    kern, plain = {"batched": (port_scan.hntl_scan, port_ref.hntl_scan_ref),
                   "single": (port_scan.hntl_scan_single,
                              port_ref.hntl_scan_single_ref)}[form]
    before = kern.launches
    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_scan_kernel_refuses_a_wrong_dtype(cuda_device):
    a = scan_cases.single(scan_cases.panels(5, p=2, q=1, k=4, cap=32))
    a["coords"] = a["coords"].astype(np.int32)
    args = scan_cases.args(a, lambda v: torch.from_numpy(v).to(cuda_device))
    with pytest.raises(TypeError, match="coords"):
        port_scan.hntl_scan_single(*args)


_LAYOUT = {"aos": (layout_scan.aos_scan, port_ref.aos_scan_ref,
                   scan_cases.aos_args),
           "chase": (layout_scan.pointer_chase_scan,
                     port_ref.pointer_chase_scan_ref,
                     scan_cases.chase_args)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(scan_cases.LAYOUT_CASES)),
                         ids=[f"{form} {label}" for label, form, *_ in
                              scan_cases.LAYOUT_CASES])
def test_layout_scan_kernels_equal_plain_versions_on_card(cuda_device, case):
    label, form, make, seed, kw = scan_cases.LAYOUT_CASES[case]
    a = make(seed, **kw)
    kern, plain, to_args = _LAYOUT[form]
    args = to_args(a, lambda v: torch.from_numpy(v).to(cuda_device))
    before = kern.launches
    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want), label


@pytest.mark.gpu
def test_layout_scan_kernels_refuse_other_dtypes_on_card(cuda_device):
    a = scan_cases.aos(1, p=2, cap=32, k=4)
    a["coords_aos"] = a["coords_aos"].astype(np.int8)
    args = scan_cases.aos_args(a, lambda v: torch.from_numpy(v).to(
        cuda_device))
    with pytest.raises(TypeError, match=r"coords_aos has dtype torch.int8, expected \(torch.int16, torch.int32\)"):
        layout_scan.aos_scan(*args)
    c = scan_cases.chase(1, n=16, k=4, n_steps=8)
    c["coords_flat"] = c["coords_flat"].astype(np.int64)
    args = scan_cases.chase_args(c, lambda v: torch.from_numpy(v).to(
        cuda_device))
    with pytest.raises(TypeError, match=r"coords_flat has dtype torch.int64, expected \(torch.int16, torch.int32\)"):
        layout_scan.pointer_chase_scan(*args)


@pytest.mark.gpu
def test_core_layout_scans_launch_their_kernels_on_card(cuda_device):
    from repro_torch.core import scan as core_scan

    t2 = scan_cases.table2(n=4096, k=8)
    on = lambda v: torch.from_numpy(v).to(cuda_device)   # noqa: E731
    before = (layout_scan.aos_scan.launches,
              layout_scan.pointer_chase_scan.launches)
    aos = core_scan.aos_scan(*scan_cases.aos_args(t2["aos"], on))
    chase = core_scan.pointer_chase_scan(*scan_cases.chase_args(
        t2["chase"], on))
    torch.cuda.synchronize()
    assert (layout_scan.aos_scan.launches,
            layout_scan.pointer_chase_scan.launches) == (before[0] + 1,
                                                         before[1] + 1)
    soa = port_scan.hntl_scan_single(*scan_cases.args(t2["soa"], on))
    assert torch.equal(aos, soa)
    want = port_ref.pointer_chase_scan_ref(*scan_cases.chase_args(
        t2["chase"], on))
    assert torch.equal(chase, want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["A", "B"])
def test_kernel_plane_equals_ref_plane_on_card(cuda_device, mode):
    x = synthetic.anisotropic_manifold(n=4096, d=64, intrinsic=8, seed=1)
    q = synthetic.queries_from(x, nq=40)
    cfg = repro_torch.HNTLConfig(d=64, k=8, s=4, block=32, n_grains=16,
                                 nprobe=4, pool=32)
    idx, _ = repro_torch.build(x, cfg, device=cuda_device)
    qt = torch.from_numpy(q).to(cuda_device)
    before = port_scan.hntl_scan_single.launches
    got = repro_torch.search(idx, qt, cfg, topk=5, mode=mode,
                             scan_impl="kernel")
    want = repro_torch.search(idx, qt, cfg, topk=5, mode=mode,
                              scan_impl="ref")
    torch.cuda.synchronize()
    assert port_scan.hntl_scan_single.launches == before + 2  # coords, sketch
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.dists, want.dists)


@pytest.mark.gpu
def test_hntl_kv_decode_kernel_path_equals_plain_scan_on_card(cuda_device):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import hntl_attention as H

    cfg = get_smoke_config("phi3-mini-3.8b")
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    shape = (2, 8 * cfg.kv_cap, cfg.n_kv_heads, cfg.head_dim)
    k = torch.randn(shape, generator=gen, device=cuda_device)
    v = torch.randn(shape, generator=gen, device=cuda_device)
    idx = H.build_kv_index(k, v, cfg, device=cuda_device)
    q = torch.randn((2, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=cuda_device)
    pos = torch.full((2,), idx.sealed_len, device=cuda_device)
    before = port_scan.hntl_scan_single.launches
    out, new = H.retrieval_decode_attention(q, k[:, :1], v[:, :1], idx, pos,
                                            cfg)
    plain, plain_new = H.retrieval_decode_attention(
        q, k[:, :1], v[:, :1], idx, pos, cfg, scan_backend="ref")
    torch.cuda.synchronize()
    assert port_scan.hntl_scan_single.launches == before + 1
    assert torch.equal(out, plain)
    assert torch.equal(new.tail_k, plain_new.tail_k)
    assert bool(torch.isfinite(out).all())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["A", "B"])
def test_store_search_equals_fused_ref_on_card(cuda_device, mode):
    """A small store on the card, with deletes, an upsert and a memtable:
    the "fused" plane returns the "fused_ref" plane's ids, through
    ceil(Q/256) kernel calls per search."""
    from repro_torch.core import VectorStore

    x = synthetic.anisotropic_manifold(n=4 * 2048 + 100, d=64, intrinsic=8,
                                       seed=2)
    q = synthetic.queries_from(x, nq=300)
    cfg = repro_torch.HNTLConfig(d=64, k=8, s=4, block=32, n_grains=8,
                                 nprobe=6, pool=32)
    st = VectorStore(cfg, seal_threshold=2048, device=cuda_device)
    tags = 1 << (np.arange(len(x)) % 3)
    for lo in range(0, len(x), 2048):             # one seal per chunk
        st.add(x[lo:lo + 2048], tags=tags[lo:lo + 2048])
    st.delete(np.arange(0, 4 * 2048, 7))
    st.upsert([3], x[3:4] + 0.01)
    assert st.n_segments == 4
    for kw in ({}, {"tag_mask": 0b101}):
        before = port_fused.fused_scan_select.launches
        got = st.search(q, topk=10, mode=mode, **kw)
        torch.cuda.synchronize()
        assert port_fused.fused_scan_select.launches == before + 2
        want = st.search(q, topk=10, mode=mode, scan_impl="fused_ref", **kw)
        assert torch.equal(got.ids, want.ids)
        assert not np.isin(got.ids.cpu().numpy(),
                           np.arange(0, 4 * 2048, 7)).any()


def _held_to_fused_ref(st, q, dead, mode):
    """The "fused" plane returns the "fused_ref" plane's ids through
    ceil(Q/256) kernel calls per search, and no deleted gid."""
    for kw in ({}, {"tag_mask": 0b101}):
        before = port_fused.fused_scan_select.launches
        got = st.search(q, topk=10, mode=mode, **kw)
        torch.cuda.synchronize()
        assert port_fused.fused_scan_select.launches == before + 2
        want = st.search(q, topk=10, mode=mode, scan_impl="fused_ref", **kw)
        assert torch.equal(got.ids, want.ids)
        assert not np.isin(got.ids.cpu().numpy(), dead).any()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["A", "B"])
def test_store_compact_and_maintain_on_card(cuda_device, mode):
    """A small store on the card through compact() (8 -> 2 segments) and
    maintain() (a grain emptied, another hollowed out): after each, the
    "fused" plane equals the "fused_ref" plane."""
    from repro_torch.core import VectorStore

    x = synthetic.anisotropic_manifold(n=8 * 1024 + 100, d=64, intrinsic=8,
                                       seed=3)
    q = synthetic.queries_from(x, nq=300)
    cfg = repro_torch.HNTLConfig(d=64, k=8, s=4, block=32, n_grains=8,
                                 nprobe=6, pool=32)
    st = VectorStore(cfg, seal_threshold=1024, device=cuda_device)
    tags = 1 << (np.arange(len(x)) % 3)
    for lo in range(0, len(x), 1024):             # one seal per full chunk
        st.add(x[lo:lo + 1024], tags=tags[lo:lo + 1024])
    dead = np.arange(0, 8 * 1024, 5)
    st.delete(dead)
    st.upsert([3], x[3:4] + 0.01)
    assert st.n_segments == 8
    assert st.compact() == 2 and st.n_segments == 2
    assert sum(s.n for s in st._segments) == 8 * 1024 - len(dead) - 1
    _held_to_fused_ref(st, q, dead, mode)

    seg, other = st._segments
    ids = seg.index.grains.ids.cpu().numpy()
    valid = seg.index.grains.valid.cpu().numpy()
    gid = seg.global_ids()
    kill = np.concatenate([gid[ids[0][valid[0]]], gid[ids[1][valid[1]][2:]]])
    st.delete(kill)
    rep = st.maintain()
    assert rep.total("retires") >= 1 and rep.total("merges") >= 1
    assert st._segments[0] is not seg and st._segments[1] is other
    _held_to_fused_ref(st, q, np.concatenate([dead, kill]), mode)


@pytest.mark.gpu
def test_select_on_a_mini_plane_equals_plain_version_on_card(cuda_device):
    """A tiered residency pass's shape: a 64-grain chunk plus the trailing
    all-invalid dummy grain, slack probes on the dummy behind n_active,
    a power-of-two query subset."""
    a = select_cases.mini_plane_inputs(4, q=64, p=8, g=65, k=32, cap=384,
                                       s=8)
    args, kw = select_cases.split(
        a, lambda v: torch.from_numpy(v).to(cuda_device))
    for width in (10, 64, 300):
        d, r = port_fused.fused_scan_select(*args, width=width, **kw)
        rd, rr = port_fused.fused_scan_select_ref(*args, width=width, **kw)
        torch.cuda.synchronize()
        assert torch.equal(d, rd) and torch.equal(r, rr)


def _cold_store(dev, cold_dir, **kw):
    from repro_torch.core import VectorStore

    x = synthetic.anisotropic_manifold(n=4 * 1024, d=64, intrinsic=8,
                                       seed=4)
    q = synthetic.queries_from(x, nq=300)
    cfg = repro_torch.HNTLConfig(d=64, k=8, s=4, block=32, n_grains=8,
                                 nprobe=6, pool=32)
    st = VectorStore(cfg, seal_threshold=1024, device=dev, cold_tier=True,
                     cold_dir=str(cold_dir), prefetch_grains=4,
                     residency_interval=3, **kw)
    tags = 1 << (np.arange(len(x)) % 3)
    ts = (np.arange(len(x)) / len(x)).astype(np.float32)
    for lo in range(0, len(x), 1024):              # one seal per chunk
        st.add(x[lo:lo + 1024], tags=tags[lo:lo + 1024], ts=ts[lo:lo + 1024])
    st.delete(np.arange(0, len(x), 9))
    return st, x, q


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["A", "B"])
def test_paged_search_equals_all_warm_on_card(cuda_device, mode, tmp_path):
    """A cold store on the card: under device_budget 0, a few grains and
    more than the tier, every search returns the all-warm plane's ids and
    dists (torch.equal), through the select kernel on every pass."""
    st, _, q = _cold_store(cuda_device, tmp_path)
    filters = ({}, {"tag_mask": 0b101}, {"ts_range": (0.2, 0.7)})
    warm = [st.search(q, topk=10, mode=mode, **kw) for kw in filters]
    for budget in (0, 40_000, 10 ** 12):
        st.device_budget = budget
        for _ in range(2):
            for kw, want in zip(filters, warm):
                before = port_fused.fused_scan_select.launches
                got = st.search(q, topk=10, mode=mode, **kw)
                torch.cuda.synchronize()
                assert port_fused.fused_scan_select.launches > before
                assert torch.equal(got.ids, want.ids)
                assert torch.equal(got.dists, want.dists)
        st.update_residency()
    stats = st.residency_stats()
    assert stats["chunk_dispatches"] > 0 and stats["staged_bytes"] > 0


@pytest.mark.gpu
def test_cold_store_mode_b_equals_warm_store_on_card(cuda_device, tmp_path):
    """The same segments with the raw tier on the card: a cold store's
    Mode B (rows read from the memmaps, re-ranked on the card) equals the
    warm store's bit for bit, on the fused plane and the per-segment
    loop."""
    import dataclasses

    from repro_torch.core import VectorStore

    st, _, q = _cold_store(cuda_device, tmp_path)
    warm = VectorStore(st.cfg, seal_threshold=1024, device=cuda_device)
    warm._segments = [dataclasses.replace(
        s, index=dataclasses.replace(s.index, raw=torch.from_numpy(
            np.array(s.raw_vectors())).to(cuda_device)), cold_path=None)
        for s in st._segments]
    warm._live_seq, warm._epoch = dict(st._live_seq), st._epoch
    warm._next_id = st._next_id
    for kw in ({}, {"fused": False}, {"tag_mask": 0b11}):
        a = st.search(q, topk=10, mode="B", **kw)
        b = warm.search(q, topk=10, mode="B", **kw)
        torch.cuda.synchronize()
        assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)


def _traffic_copy(st):
    """The store's adaptive probe-traffic state, copied (the counters
    only; the entries' segment tuples are shared)."""
    return collections.OrderedDict(
        (k, dict(hit, wins=hit["wins"].copy(),
                 touches=hit["touches"].copy()))
        for k, hit in st._probe_traffic.items())


def _adaptive_on_card(st, q, mode, margin):
    """One adaptive search on the "fused" plane, then the same search on
    "fused_ref" from the same traffic state: (fused, fused_ref, the
    select's launches)."""
    saved = _traffic_copy(st)
    before = port_fused.fused_scan_select.launches
    got = st.search(q, topk=10, mode=mode, adaptive=True,
                    probe_margin=margin)
    torch.cuda.synchronize()
    launches = port_fused.fused_scan_select.launches - before
    after = _traffic_copy(st)
    st._probe_traffic = saved
    want = st.search(q, topk=10, mode=mode, adaptive=True,
                     probe_margin=margin, scan_impl="fused_ref")
    st._probe_traffic = after
    return got, want, launches


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["warm", "cold"])
@pytest.mark.parametrize("mode", ["A", "B"])
def test_adaptive_store_search_equals_fused_ref_on_card(cuda_device, mode,
                                                        tier, tmp_path):
    """Adaptive searches on the card, a warm store and a cold one: every
    width bucket through the select kernel, ids and dists equal to the
    "fused_ref" plane's from the same traffic state, through a sequence
    of searches (the hub set forms); probes are ragged."""
    from repro_torch.core import VectorStore

    st, _, q = _cold_store(cuda_device, tmp_path)
    if tier == "warm":
        warm = VectorStore(st.cfg, seal_threshold=1024, device=cuda_device)
        for lo in range(0, 4 * 1024, 1024):
            warm.add(np.array(st._segments[lo // 1024].raw_vectors()))
        warm.delete(np.arange(0, 4 * 1024, 9))
        st = warm
    for margin in (0.3, 0.1, 0.1):
        got, want, launches = _adaptive_on_card(st, q, mode, margin)
        assert launches >= 2
        assert torch.equal(got.ids, want.ids)
        assert torch.equal(got.dists, want.dists)
    stats = st.probe_stats()
    assert stats["queries"] == 3 * q.shape[0]
    assert 1.0 <= stats["mean_active"] < st.cfg.nprobe
    assert st.hub_grains().size > 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["A", "B"])
def test_paged_adaptive_search_equals_all_warm_on_card(cuda_device, mode,
                                                       tmp_path):
    """A cold store on the card under device_budget 0 and a few grains:
    each adaptive search equals the all-warm adaptive search from the
    same traffic state (ids and dists, torch.equal), with equal probe
    stats after."""
    st, _, q = _cold_store(cuda_device, tmp_path)
    for budget in (0, 40_000):
        for margin in (0.3, 0.1):
            saved = _traffic_copy(st)
            st.device_budget = None
            want = st.search(q, topk=10, mode=mode, adaptive=True,
                             probe_margin=margin)
            stats = st.probe_stats()
            st._probe_traffic = saved
            st.device_budget = budget
            before = port_fused.fused_scan_select.launches
            got = st.search(q, topk=10, mode=mode, adaptive=True,
                            probe_margin=margin)
            torch.cuda.synchronize()
            assert port_fused.fused_scan_select.launches > before
            assert torch.equal(got.ids, want.ids)
            assert torch.equal(got.dists, want.dists)
            assert st.probe_stats() == stats
        st.update_residency()


def _tenant_window(dev, cold_dir, n=64):
    """A registry over ``_cold_store`` with four tenants (each a private
    segment, memtable rows, private deletes and a shared-gid delete) and
    a window of ``n`` requests over them, Mode A and B."""
    from repro_torch.serve import RetrievalRequest, TenantRegistry

    st, x, q = _cold_store(dev, cold_dir)
    reg = TenantRegistry(st, memtable_budget=256, max_live=3)
    rng = np.random.default_rng(6)
    for t in range(4):
        ten = reg.get(f"t{t}")
        ids = ten.add((x[t * 300:(t + 1) * 300] + 0.05 * rng.standard_normal(
            (300, x.shape[1]))).astype(np.float32))
        ten.delete(np.r_[ids[:5], [1 + t]])

    def window(mode):
        return [RetrievalRequest(rid=i, tenant=f"t{i % 4}", q=q[i], topk=10,
                                 mode=mode) for i in range(n)]
    return reg, window


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["A", "B"])
def test_coalesced_fused_equals_fused_ref_on_card(cuda_device, mode,
                                                  tmp_path):
    """A coalesced window on the card: the select kernel with its tenant
    stream (one launch per group), ids and dists equal to the same
    window through the plain version (``torch.equal``)."""
    from repro_torch.serve import coalesced_retrieve

    reg, window = _tenant_window(cuda_device, tmp_path)
    before = port_fused.fused_scan_select.launches
    got = coalesced_retrieve(reg, window(mode), scan_impl="fused")
    torch.cuda.synchronize()
    assert port_fused.fused_scan_select.launches - before == 1
    want = coalesced_retrieve(reg, window(mode), scan_impl="fused_ref")
    for a, b in zip(got, want):
        assert a.result.ids.device.type == "cuda"
        assert torch.equal(a.result.ids, b.result.ids)
        assert torch.equal(a.result.dists, b.result.dists)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["A", "B"])
def test_paged_tenant_window_equals_all_warm_on_card(cuda_device, mode,
                                                     tmp_path):
    """The same coalesced window on the all-warm plane and paged under
    budgets 0 and a few grains: ids and dists ``torch.equal``, through
    the select kernel on every pass."""
    from repro_torch.serve import coalesced_retrieve

    reg, window = _tenant_window(cuda_device, tmp_path)
    warm = coalesced_retrieve(reg, window(mode))
    for budget in (0, 40_000):
        reg.base.device_budget = budget
        before = port_fused.fused_scan_select.launches
        got = coalesced_retrieve(reg, window(mode))
        torch.cuda.synchronize()
        assert port_fused.fused_scan_select.launches > before
        for a, b in zip(got, warm):
            assert torch.equal(a.result.ids, b.result.ids), budget
            assert torch.equal(a.result.dists, b.result.dists), budget
    assert reg.base.residency_stats()["chunk_dispatches"] > 0


@pytest.mark.gpu
def test_select_reads_the_last_tenant_row_on_card(cuda_device):
    """Every query on the last row of a tenant mask of more than 2^31
    bytes: the kernel's row offset is 64-bit, and its result equals the
    plain version's."""
    args, a = _select_inputs(21, cuda_device, q=16, p=4, g=4, k=8, cap=256,
                             s=4)
    t_n = (1 << 31) // (4 * 256) + 1
    tm = torch.zeros((t_n, 4, 256), dtype=torch.bool, device=cuda_device)
    tm[-1] = torch.rand((4, 256), device=cuda_device) < 0.5
    a.update(tenant_mask=tm, tenant_ix=torch.full(
        (16,), t_n - 1, dtype=torch.int32, device=cuda_device))
    d, r = port_fused.fused_scan_select(*args, width=64, **a)
    rd, rr = port_fused.fused_scan_select_ref(*args, width=64, **a)
    torch.cuda.synchronize()
    assert torch.equal(d, rd) and torch.equal(r, rr)
    assert bool((r >= 0).any())


def _sharded_store(dev):
    """A small store on the card: 4 sealed segments of 2,048 rows (8
    grains each), deletes, an upsert, a 100-row memtable."""
    from repro_torch.core import VectorStore

    x = synthetic.anisotropic_manifold(n=4 * 2048 + 100, d=64, intrinsic=8,
                                       seed=2)
    q = synthetic.queries_from(x, nq=300)
    cfg = repro_torch.HNTLConfig(d=64, k=8, s=4, block=32, n_grains=8,
                                 nprobe=6, pool=32)
    st = VectorStore(cfg, seal_threshold=2048, device=dev)
    tags = 1 << (np.arange(len(x)) % 3)
    for lo in range(0, len(x), 2048):             # one seal per chunk
        st.add(x[lo:lo + 2048], tags=tags[lo:lo + 2048])
    st.delete(np.arange(0, 4 * 2048, 7))
    st.upsert([3], x[3:4] + 0.01)
    return st, q


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("mode", ["A", "B"])
def test_sharded_fused_equals_fused_ref_on_card(cuda_device, shards, mode):
    """The sharded plane on ``["cuda:0"] * n``: the select kernel once per
    shard and 256-query batch (the counter rises by n_shards * 2 for 300
    queries), ids and dists ``torch.equal`` to the same mesh's
    "fused_ref" plane, no deleted gid."""
    from repro_torch.launch.mesh import make_search_mesh

    st, q = _sharded_store(cuda_device)
    mesh = make_search_mesh(shards, devices=["cuda:0"] * shards)
    for kw in ({}, {"tag_mask": 0b101}):
        before = port_fused.fused_scan_select.launches
        got = st.search(q, topk=10, mode=mode, mesh=mesh, **kw)
        torch.cuda.synchronize()
        assert port_fused.fused_scan_select.launches == before + 2 * shards
        want = st.search(q, topk=10, mode=mode, mesh=mesh,
                         scan_impl="fused_ref", **kw)
        assert got.ids.device.type == "cuda"
        assert torch.equal(got.ids, want.ids)
        assert torch.equal(got.dists, want.dists)
        assert not np.isin(got.ids.cpu().numpy(),
                           np.arange(0, 4 * 2048, 7)).any()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["A", "B"])
def test_sharded_exhaustive_ids_equal_across_shard_counts_on_card(
        cuda_device, mode):
    """At exhaustive knobs the sharded plane's ids are the fused plane's
    for 1, 2, 4 and 8 shards on one card."""
    from repro_torch.launch.mesh import make_search_mesh

    st, q = _sharded_store(cuda_device)
    ex = dict(nprobe=sum(s.index.grains.n_grains for s in st._segments),
              pool=st.n_vectors)
    base = st.search(q[:64], topk=10, mode=mode, **ex)
    for n in (1, 2, 4, 8):
        got = st.search(q[:64], topk=10, mode=mode, **ex,
                        mesh=make_search_mesh(n, devices=["cuda:0"] * n))
        assert torch.equal(got.ids, base.ids), n


@pytest.mark.gpu
def test_sharded_mesh_on_other_devices_raises_on_card(cuda_device):
    """A store on the card searched with CPU slots (and a CPU store with
    card slots) raises; nothing runs on the CPU in silence."""
    from repro_torch.core import VectorStore
    from repro_torch.launch.mesh import make_search_mesh

    st, q = _sharded_store(cuda_device)
    with pytest.raises(ValueError, match="do not match"):
        st.search(q, mesh=make_search_mesh(2, devices=["cpu"] * 2))
    cpu = VectorStore(st.cfg, seal_threshold=2048, device="cpu")
    cpu.add(np.asarray(q[:64].cpu().numpy() if torch.is_tensor(q) else
                       q[:64], np.float32))
    cpu.seal()
    with pytest.raises(ValueError, match="do not match"):
        cpu.search(q[:4], mesh=make_search_mesh(2, devices=["cuda:0"] * 2))


def _smoke_model(device, arch="phi3-mini-3.8b", **kw):
    """A float32 smoke model (phi3-mini by default) on ``device`` (seed
    0, drawn on the CPU, then moved: ``nn.Module.to`` moves the module
    itself)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    model = get_model(cfg)
    return cfg, model, model.init(0, device="cpu").to(device)


@pytest.mark.gpu
def test_model_prefill_and_decode_on_card_equal_cpu(cuda_device):
    cfg, model, params = _smoke_model(cuda_device)
    _, _, cpu_params = _smoke_model("cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 20)))
    got, caches = model.prefill(params, tokens[:, :12], max_len=20)
    want, cpu_caches = model.prefill(cpu_params, tokens[:, :12], max_len=20)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for t in range(12, 16):
        pos = torch.full((2,), t)
        got, caches = model.decode_step(params, tokens[:, t], caches, pos)
        want, cpu_caches = model.decode_step(cpu_params, tokens[:, t],
                                             cpu_caches, pos)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert got.device.type == "cuda"


class _PlainScan:
    """Stands in for ``hntl_attention``'s ``ops``: the scan on its plain
    version."""

    @staticmethod
    def scan_single(*args, backend=None):
        from repro_torch.kernels import ops

        return ops.scan_single(*args, backend="ref")


@pytest.mark.gpu
def test_promoted_model_decode_launches_the_scan_per_layer_on_card(
        cuda_device, monkeypatch):
    from repro_torch.models import hntl_attention as H
    from repro_torch.serve.engine import promote_to_retrieval

    cfg, model, params = _smoke_model(cuda_device, n_layers=3,
                                      kv_nprobe=2, kv_pool=32)
    s = 4 * cfg.kv_cap + 3
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, s)))
    _, caches = model.prefill(params, tokens, max_len=s + 8)
    promoted = promote_to_retrieval(model, caches, cache_len=s)
    del caches
    assert all(isinstance(c["mixer"], H.KVIndex) for c in promoted)
    tok, pos = torch.tensor([5, 9]), torch.full((2,), s)
    before = port_scan.hntl_scan_single.launches
    got, new = model.decode_step(params, tok, promoted, pos)
    torch.cuda.synchronize()
    assert port_scan.hntl_scan_single.launches == before + cfg.n_layers
    monkeypatch.setattr(H, "ops", _PlainScan)
    plain, plain_new = model.decode_step(params, tok, promoted, pos)
    assert port_scan.hntl_scan_single.launches == before + cfg.n_layers
    assert torch.equal(got, plain)
    assert all(torch.equal(a["mixer"].tail_k, b["mixer"].tail_k)
               for a, b in zip(new, plain_new))
    assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
def test_engine_decodes_two_requests_on_card(cuda_device):
    from repro_torch.serve.engine import ServeEngine

    cfg, model, params = _smoke_model(cuda_device)
    engine = ServeEngine(model, params, n_slots=2, max_len=64)
    assert engine.caches[0]["mixer"]["k"].device.type == "cuda"
    reqs = [engine.submit(np.arange(3, 9 + i), max_new=5) for i in range(2)]
    engine.run_to_completion()
    assert all(r.done and len(r.out) == 5 for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)


@pytest.mark.gpu
def test_moe_promoted_decode_equals_plain_scan_on_card(cuda_device,
                                                       monkeypatch):
    """qwen3-moe's smoke model: prefill, promote its attention layers to
    HNTL-KV, one decode step launches the scan once per layer and equals
    (``torch.equal``) the same step through the plain scan."""
    from repro_torch.models import hntl_attention as H
    from repro_torch.serve.engine import promote_to_retrieval

    cfg, model, params = _smoke_model(cuda_device, "qwen3-moe-30b-a3b",
                                      kv_nprobe=2, kv_pool=32)
    s = 4 * cfg.kv_cap + 3
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, s)))
    _, caches = model.prefill(params, tokens, max_len=s + 8)
    promoted = promote_to_retrieval(model, caches, cache_len=s)
    del caches
    assert all(isinstance(c["mixer"], H.KVIndex) for c in promoted)
    tok, pos = torch.tensor([5, 9]), torch.full((2,), s)
    before = port_scan.hntl_scan_single.launches
    got, _ = model.decode_step(params, tok, promoted, pos)
    torch.cuda.synchronize()
    assert port_scan.hntl_scan_single.launches == before + cfg.n_layers
    monkeypatch.setattr(H, "ops", _PlainScan)
    plain, _ = model.decode_step(params, tok, promoted, pos)
    assert torch.equal(got, plain)
    assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
def test_whisper_retrieval_step_equals_plain_scan_on_card(cuda_device,
                                                          monkeypatch):
    """whisper's smoke model: encode 64 frames, seal them into per-layer
    cross indexes (4 grains, 2 probed), one ``decode_step_retrieval``
    launches the scan once per decoder layer and equals the same step
    through the plain scan."""
    from repro_torch.models import encdec
    from repro_torch.models import hntl_attention as H

    cfg, model, params = _smoke_model(cuda_device, "whisper-base",
                                      kv_pool=16)
    frames = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 4 * cfg.kv_cap, cfg.d_model)).astype(np.float32)).to(cuda_device)
    mem = model.encode(params, frames)
    idx = encdec.build_cross_index(params, cfg, mem)
    sc = encdec.init_self_cache(cfg, 2, cuda_device)
    tok, pos = torch.tensor([3, 7]), torch.zeros(2, dtype=torch.long)
    before = port_scan.hntl_scan_single.launches
    got, _ = encdec.decode_step_retrieval(params, cfg, tok, sc, idx, pos)
    torch.cuda.synchronize()
    assert port_scan.hntl_scan_single.launches == before + cfg.n_layers
    monkeypatch.setattr(H, "ops", _PlainScan)
    plain, _ = encdec.decode_step_retrieval(params, cfg, tok, sc, idx, pos)
    assert torch.equal(got, plain)
    assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
def test_two_slot_rwkv_engine_equals_solo_on_card(cuda_device):
    """Each slot isolated on the card: 3 requests through 2 slots get the
    tokens each gets alone, from a fresh engine of the same 2 slots (the
    same batch shape, so a row's products round the same way)."""
    from repro_torch.serve.engine import ServeEngine

    cfg, model, params = _smoke_model(cuda_device, "rwkv6-1.6b")
    prompts = [np.random.default_rng(20 + i).integers(0, cfg.vocab, size=6)
               for i in range(3)]

    def served(n_slots, ps):
        engine = ServeEngine(model, params, n_slots=n_slots, max_len=32)
        reqs = [engine.submit(p, max_new=5) for p in ps]
        engine.run_to_completion()
        assert all(r.done and len(r.out) == 5 for r in reqs)
        return [r.out for r in reqs]

    alone = [served(2, [p])[0] for p in prompts]
    assert served(2, prompts) == alone


@pytest.mark.gpu
def test_train_loss_and_grads_on_card_equal_cpu(cuda_device):
    """phi3-mini's float32 smoke model (remat on): the card's loss to rtol
    1e-5 and every gradient within 1e-4 * its own max |g_cpu| of the
    CPU's."""
    from repro_torch.core.index import full_fp32_matmul
    from repro_torch.data.tokens import MarkovLM

    cfg, model, params = _smoke_model(cuda_device)
    _, _, cpu_params = _smoke_model("cpu")
    batch = MarkovLM(vocab=cfg.vocab, seed=0).batch(0, 2, 32)
    out = {}
    for p in (params, cpu_params):
        p.requires_grad_(True)
        named = dict(p.named_parameters())
        with full_fp32_matmul():
            loss, _ = model.loss(p, {k: torch.from_numpy(v).to(
                p.device) for k, v in batch.items()})
            grads = torch.autograd.grad(loss, list(named.values()))
        out[p.device.type] = (float(loss.detach()), dict(zip(named, grads)))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for k, g in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k].cpu(), g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()),
                                   msg=lambda m, k=k: f"{k}: {m}")


class _GradCapture:
    """An optimizer that keeps a copy of the gradients ``update`` is
    given."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, *args):
        self.grads = {k: v.clone() for k, v in grads.items()}
        return self.opt.update(grads, *args)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "qwen3-moe-30b-a3b"])
def test_mesh_step_on_card_equals_one_slot(cuda_device, arch):
    """A step on a 2 x 2 mesh of card slots (one row padded) equals the
    one-slot step: the float32 gradients the optimizer is given within
    1e-4 of each leaf's max |g|, the loss within rtol 1e-5, the
    parameters within 1e-5 (AdamW at eps 1e-3); the placed leaves are
    the state's own tensors."""
    from repro_torch.data.tokens import MarkovLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import AdamW, constant
    from repro_torch.train.step import (TrainState, make_train_step,
                                        place_train_state)

    cfg, model, _ = _smoke_model(cuda_device, arch)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             MarkovLM(vocab=cfg.vocab, seed=2).batch(0, 8, 16).items()}
    batch["labels"][0, 4:] = -100
    rules = shd.default_rules(make_host_mesh(2, 2,
                                             devices=[cuda_device] * 4))
    out = []
    for mesh in (False, True):
        opt = _GradCapture(AdamW(lr=constant(1e-3), eps=1e-3))
        params = _smoke_model(cuda_device, arch)[2].requires_grad_(True)
        state = TrainState(params, opt.init(params), 0)
        if mesh:
            ptr = params.embedding.data_ptr()
            state = place_train_state(state, rules)
            assert state.params.leaves["embedding"].pieces[0].tensor \
                .data_ptr() == ptr
        state, metrics = make_train_step(model, opt)(state, batch)
        named = {k: (v.gather(cuda_device) if mesh else v).detach()
                 for k, v in state.params.named_parameters()}
        out.append((float(metrics["loss"]), named, opt.grads))
    (l1, p1, g1), (l2, p2, g2) = out
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    for k, g in g1.items():
        torch.testing.assert_close(g2[k], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()),
                                   msg=lambda m, k=k: f"{k}: {m}")
        torch.testing.assert_close(p2[k], p1[k], rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_microbatches_on_card_equal_one_batch(cuda_device):
    """One step over 4 microbatches equals one over the whole batch on the
    card: the averaged float32 gradients the optimizer is given within
    1e-4 of each leaf's max |g| (a first Adam step at eps 1e-8 moves each
    element by about lr whatever its gradient, so the parameters alone
    would not see a dropped microbatch), the loss and the parameters
    within ``tests/test_train.py::test_microbatch_equivalence``'s
    tolerances."""
    from repro_torch.data.tokens import MarkovLM
    from repro_torch.optim.adamw import AdamW, constant
    from repro_torch.train.step import TrainState, make_train_step

    cfg, model, _ = _smoke_model(cuda_device)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             MarkovLM(vocab=cfg.vocab, seed=2).batch(0, 8, 16).items()}
    out, grads = [], []
    for n in (1, 4):
        opt = _GradCapture(AdamW(lr=constant(1e-3), max_grad_norm=None))
        params = _smoke_model(cuda_device)[2].requires_grad_(True)
        state = TrainState(params, opt.init(params), 0)
        state, metrics = make_train_step(model, opt, microbatches=n)(state,
                                                                     batch)
        out.append((float(metrics["loss"]), state.params))
        grads.append(opt.grads)
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()),
                                   msg=lambda m, k=k: f"{k}: {m}")
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=2e-2)
    for (k, a), (_, b) in zip(out[0][1].named_parameters(),
                              out[1][1].named_parameters()):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=5e-2,
                                   atol=4e-3)
