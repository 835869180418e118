"""The dry-run's input shardings against the JAX package's, on both
production meshes: the last five archs (sorted) of every shape
(``torch_dryrun_parity.check_cell_shardings``; the first five in
``test_torch_dryrun_shardings.py``).
"""
import pytest

jax = pytest.importorskip("jax")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import list_archs  # noqa: E402

import torch_dryrun_parity as P  # noqa: E402

ARCHS = sorted(list_archs())[5:]
CELLS = [(m, a, s) for m in P.MESHES for a in ARCHS for s in REF_SHAPES]


@pytest.fixture(scope="module")
def cells():
    return P.build_cells(ARCHS)


@pytest.mark.parametrize("mesh_name,arch,shape", CELLS)
def test_cell_shardings_equal_the_reference(mesh_name, arch, shape, cells):
    P.check_cell_shardings(mesh_name, arch, shape, cells)
