"""Where the port runs, and what it imports.

- No module of ``repro_torch`` (nor ``chip_smoke.py``) imports JAX or the
  JAX package: checked on the sources' AST and in a fresh interpreter.
- Entry points run on the card unless asked for the CPU: ``build`` with
  no ``device`` and no card raises.
- ``gpu``-marked tests hold the CUDA kernel against its plain version on
  the card; they skip (inside a fixture) where there is no card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.core import index as port_index
from repro_torch.data import synthetic
from repro_torch.kernels import _build
from repro_torch.kernels import fused_select as port_fused
from repro_torch.kernels import select_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _select_inputs(seed, device, **shape):
    """(args, kwargs) of the fused scan→select contract, on ``device``."""
    return select_cases.split(
        select_cases.random_inputs(seed, coord_range=3000, **shape),
        lambda v: torch.from_numpy(v).to(device))


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
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


def test_kernel_wrapper_refuses_other_devices():
    args, _ = _select_inputs(0, "meta", q=2, p=2, g=3, k=4, cap=32)
    with pytest.raises(ValueError, match="no kernel"):
        port_fused.fused_scan_select(*args, width=8)


def test_build_recipe_targets_hopper():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "fused_select" in _build.source_names()
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
#: slot live, and (descending) every slot entering the running top-W.
FOLD_CASES = {
    "descending_narrow": (10, lambda: select_cases.descending_inputs(
        q=64, p=32, k=8, cap=2048)),
    "descending_max_width": (port_fused.MAX_WIDTH, lambda:
                             select_cases.descending_inputs(
                                 q=64, p=32, k=8, cap=2048)),
    "all_live_max_width": (port_fused.MAX_WIDTH, lambda:
                           select_cases.random_inputs(
                               5, q=64, p=32, g=64, k=32, cap=2048, s=8,
                               keep_frac=1.0, mask_frac=1.0)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_kernel_equals_plain_version_when_the_buffer_keeps_filling(
        cuda_device, case):
    width, make = FOLD_CASES[case]
    args, a = select_cases.split(
        make(), lambda v: torch.from_numpy(v).to(cuda_device))
    for _ in range(3):        # a fault of ordering need not show every run
        d, r = port_fused.fused_scan_select(*args, width=width, **a)
        rd, rr = port_fused.fused_scan_select_ref(*args, width=width, **a)
        torch.cuda.synchronize()
        assert torch.equal(d, rd) and torch.equal(r, rr)


@pytest.mark.gpu
def test_kernel_refuses_width_beyond_its_limit(cuda_device):
    args, _ = _select_inputs(1, cuda_device, q=1, p=1, g=2, k=4, cap=32)
    with pytest.raises(ValueError, match="width"):
        port_fused.fused_scan_select(*args, width=port_fused.MAX_WIDTH + 1)
