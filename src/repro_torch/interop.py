"""Carry indexes and configurations built by the JAX package across.

``index_from_numpy`` takes the JAX ``HNTLIndex`` after its leaves were
turned into numpy arrays (``jax.tree.map(np.asarray, index)``), or the same
structure as nested mappings under the JAX field names, and returns this
package's ``HNTLIndex`` with every dtype and shape kept:

  coords i16, res i32, sketch i8, ids i32, valid bool, qmaxg i32, ts f32,
  basis/mu/scale/... f32, sizes i32; tags u32 -> int64 (value-preserving,
  see ``GrainStore.tags``).

``kv_index_from_numpy`` does the same for an HNTL-KV ``KVIndex``
(bf16 leaves stay bf16, ``None`` leaves stay ``None``);
``config_from_dict`` and ``model_config_from_dict`` rebuild the two
configuration dataclasses from ``dataclasses.asdict`` of the JAX ones.

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
from .models.config import LayerSpec, ModelConfig
from .models.hntl_attention import KVIndex


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
    if a.dtype.name == "bfloat16":          # numpy's bf16 extension type
        return torch.tensor(a.view(np.int16), device=device) \
            .view(torch.bfloat16)
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
    return _from_dict(HNTLConfig, d)


def kv_index_from_numpy(tree: Any, device="cpu") -> KVIndex:
    """JAX ``KVIndex`` with numpy leaves -> this package's ``KVIndex``."""
    return KVIndex(**{f.name: _tensor(_field(tree, f.name), device)
                      for f in dataclasses.fields(KVIndex)})


def _from_dict(cls, d: Mapping):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {unknown}")
    return cls(**dict(d))


def model_config_from_dict(d: Mapping) -> ModelConfig:
    """A ``ModelConfig`` from a mapping of its fields (for example
    ``dataclasses.asdict`` of the JAX one, whose ``pattern`` holds
    mappings); unknown keys raise."""
    d = dict(d)
    if "pattern" in d:
        d["pattern"] = tuple(
            p if isinstance(p, LayerSpec) else _from_dict(LayerSpec, p)
            for p in d["pattern"])
    if d.get("mrope_sections") is not None:
        d["mrope_sections"] = tuple(d["mrope_sections"])
    return _from_dict(ModelConfig, d)
