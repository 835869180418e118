"""Carry an index built by the JAX package across to this one.

``index_from_numpy`` takes the JAX ``HNTLIndex`` after its leaves were
turned into numpy arrays (``jax.tree.map(np.asarray, index)``), or the same
structure as nested mappings under the JAX field names, and returns this
package's ``HNTLIndex`` with every dtype and shape kept:

  coords i16, res i32, sketch i8, ids i32, valid bool, qmaxg i32, ts f32,
  basis/mu/scale/... f32, sizes i32; tags u32 -> int64 (value-preserving,
  see ``GrainStore.tags``).

This module imports neither JAX nor the JAX package: it reads attributes
or keys by name.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

from .core.types import GrainStore, HNTLConfig, HNTLIndex, RoutingPlane


def _field(tree: Any, name: str):
    if isinstance(tree, Mapping):
        return tree.get(name)
    return getattr(tree, name, None)


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)   # a copy: leaves may be read-only


def index_from_numpy(tree: Any, device="cpu") -> HNTLIndex:
    """JAX ``HNTLIndex`` with numpy leaves -> this package's ``HNTLIndex``."""
    routing = _field(tree, "routing")
    grains = _field(tree, "grains")
    plane = RoutingPlane(
        **{f.name: _tensor(_field(routing, f.name), device)
           for f in dataclasses.fields(RoutingPlane)})
    store = GrainStore(
        **{f.name: _tensor(_field(grains, f.name), device)
           for f in dataclasses.fields(GrainStore)})
    return HNTLIndex(routing=plane, grains=store,
                     raw=_tensor(_field(tree, "raw"), device))


def config_from_dict(d: Mapping) -> HNTLConfig:
    """An ``HNTLConfig`` from a mapping of its fields (for example
    ``dataclasses.asdict`` of the JAX config); unknown keys raise."""
    names = {f.name for f in dataclasses.fields(HNTLConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown HNTLConfig fields: {unknown}")
    return HNTLConfig(**dict(d))
