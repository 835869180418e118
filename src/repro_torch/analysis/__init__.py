"""The port's hygiene gate, in two halves.

The static half is hntlint restated for PyTorch: an AST pass
(stdlib-only: it imports neither torch nor the package it lints) with
the JAX package's rule ids and pragma syntax:

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch \\
        chip_smoke.py examples --strict-baseline

  H001  no tensor made at module scope
  H002  (no counterpart: the port compiles nothing)
  H003  no Python if/while/assert on a tensor in data-plane code
  H004  no inline 3e38-magnitude sentinel outside core/types.py (also in
        the kernels' CUDA sources)
  H005  no host materialisation or data-dependent shape in data-plane
        code (sanitize.fetch is the one sanctioned read)
  H006  PLANE_FIELD_AXES <-> the plane classes' tensor fields, 1:1
  H007  no out-of-place tensor op whose result is dropped

See :mod:`repro_torch.analysis.rules` for each rule's contract and
:mod:`repro_torch.analysis.callgraph` for what "data-plane" reaches.

The runtime half is :mod:`repro_torch.analysis.sanitize`
(``sync_guard``, ``fetch``, ``place``, ``install``): the port's
``jax.transfer_guard``, imported on its own because it needs torch.

Suppression: a ``# hntlint: ok H004`` comment on the flagged line
suppresses that rule there (``# hntlint: ok`` suppresses every rule);
deliberate findings are kept in ``baseline.json`` next to this package,
keyed on stable (rule, path, key) triples, each with its reason.  The
JAX package's ``repro.analysis`` is the reference.
"""
from .engine import Finding, Project, SourceFile, analyze_paths, collect_files
from .baseline import load_baseline, split_by_baseline

__all__ = [
    "Finding", "Project", "SourceFile", "analyze_paths", "collect_files",
    "load_baseline", "split_by_baseline",
]
