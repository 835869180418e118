"""Shared inputs for the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages: the
JAX package (``repro``, the reference) and the port (``repro_torch``).
"""
import dataclasses
import functools

import jax  # the parity test modules importorskip it first
import numpy as np
import torch

from repro.core import HNTLConfig as JaxConfig
from repro.core import index as jax_index
from repro.data import synthetic as jax_synthetic
from repro_torch.interop import config_from_dict, index_from_numpy
from repro_torch.kernels import select_cases

#: The port tests' small shape: d=16, k=4, s=2, G=8, block=16.
SMALL = dict(d=16, k=4, s=2, block=16, n_grains=8, nprobe=4, pool=32)


def corpus(n: int = 2048, nq: int = 8, seed: int = 0):
    x = jax_synthetic.anisotropic_manifold(n=n, d=SMALL["d"], intrinsic=4,
                                           seed=seed)
    return x, jax_synthetic.queries_from(x, nq=nq)


def jax_config(**kw) -> JaxConfig:
    return JaxConfig(**{**SMALL, **kw})


def jax_build(x, cfg: JaxConfig, **kw):
    """(index, info) from the JAX package's build."""
    return jax_index.build(x, cfg, **kw)


def numpy_tree(index):
    """The JAX index with every leaf turned into a numpy array."""
    return jax.tree.map(np.asarray, index)


def port_index(index, device="cpu"):
    return index_from_numpy(numpy_tree(index), device)


def port_config(cfg: JaxConfig):
    return config_from_dict(dataclasses.asdict(cfg))


#: Random inputs of the fused scan→select contract at the parity tests'
#: value ranges (small coordinates, scales near 1e-3).
select_inputs = functools.partial(select_cases.random_inputs, coord_range=200,
                                  scale_range=(1e-3, 2e-3))


def to_torch(a: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in a.items()}
