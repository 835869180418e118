"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/<name>-<hash>.so``
at the root of the checkout, the hash covering the sources (every
``csrc/*.cu`` and ``*.cuh``) and the flags, so an edited source rebuilds
and an unchanged one loads from disk.  The libraries have a plain C
interface and are loaded with ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds.  ``build_all`` starts one ``nvcc`` per
source, all at once.

Nothing here runs at import: the CPU-only test machines have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class Built:
    """One compiled source: its library, the nvcc wall time of this
    process's build (0.0 when it was already on disk) and what
    ``-Xptxas -v`` reported (registers, shared memory, spills)."""

    name: str
    path: Path
    seconds: float
    ptxas: str


_BUILT: Dict[str, Built] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def source_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _paths(name: str):
    stem = BUILD_DIR / f"{name}-{_digest(name)}"
    return stem.with_suffix(".so"), stem.with_suffix(".ptxas.txt")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile every named source (default: all) that is not on disk yet,
    one nvcc process per source, started together.  Raises with the
    compiler's output if any build fails."""
    names = list(source_names() if names is None else names)
    todo = {}
    for name in names:
        if name in _BUILT:
            continue
        so, log = _paths(name)
        if so.exists():
            _BUILT[name] = Built(name, so, 0.0,
                                 log.read_text() if log.exists() else "")
        else:
            todo[name] = (so, log)
    if not todo:
        return {n: _BUILT[n] for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, (so, _) in todo.items():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        so, log = todo[name]
        if proc.returncode != 0:
            failed.append(
                f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, so)
        _BUILT[name] = Built(name, so, seconds, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: _BUILT[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name].path))
        _LIBS[name] = lib
    return lib
