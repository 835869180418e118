"""The dry-run's input shardings against the JAX package's, on both
production meshes, with no devices: the first five archs (sorted) of
every shape on the 16 x 16 and the 2 x 16 x 16 mesh
(``torch_dryrun_parity.check_cell_shardings``; the rest in
``test_torch_dryrun_shardings_more.py``).
"""
import pytest

jax = pytest.importorskip("jax")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import list_archs  # noqa: E402

import torch_dryrun_parity as P  # noqa: E402

ARCHS = sorted(list_archs())[:5]
CELLS = [(m, a, s) for m in P.MESHES for a in ARCHS for s in REF_SHAPES]


@pytest.fixture(scope="module")
def cells():
    return P.build_cells(ARCHS)


@pytest.mark.parametrize("mesh_name,arch,shape", CELLS)
def test_cell_shardings_equal_the_reference(mesh_name, arch, shape, cells):
    P.check_cell_shardings(mesh_name, arch, shape, cells)


def test_long_cells_put_the_sequence_on_the_data_axis():
    """batch 1: the data axis takes the raw tiers' sequence (520,192
    tokens), not the 127 grains it does not divide; kv heads take the
    model axis."""
    from repro_torch.launch import specs
    from repro_torch.models import hntl_attention as H

    _, rules = P.rules_for("16x16", "long_500k")
    _, inputs, cfg = specs.build_cell("phi3-mini-3.8b", "long_500k")
    got = specs.cell_in_shardings(inputs, cfg, rules, "long_decode", 1)
    idx = got[2][0]["mixer"]
    assert isinstance(idx, H.KVIndex)
    assert idx.coords.spec == (None, "model", None, None, None)
    assert idx.k_raw.spec == (None, "data", "model", None)
    assert got[1].spec == (None,) and got[3].spec == (None,)
