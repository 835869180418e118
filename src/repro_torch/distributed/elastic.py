"""Elastic re-meshing: survive device loss or a resize without data loss.

This package's port of the JAX package's ``distributed/elastic.py``.
Checkpoints are mesh-agnostic (saved whole, see ``checkpoint/manager.py``),
so the cold path is a restore onto the new mesh
(``CheckpointManager.restore(..., shardings=)``).  This module adds the
hot path: ``remesh_train_state`` lays a live train state out on a new
mesh directly, placing each leaf by the new rules; a device that holds a
leaf whole on both meshes keeps it as it is (no copy, no host round
trip).

``shrink_mesh`` builds the largest usable (data, model) mesh from the
surviving devices, shrinking the data axis (pure DP capacity) and keeping
the model axis intact (so TP-sharded weights keep their layout and only
the batch is re-balanced: the cheap direction).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from torch import nn

from ..launch.mesh import AXIS_NAMES, Mesh
from .sharding import (PlacedModule, ShardingRules, default_rules,
                       infer_param_specs, place_module, place_tree)


def shrink_mesh(devices: Sequence, model_parallel: int,
                axis_names=AXIS_NAMES) -> Mesh:
    """The largest (data, ``model_parallel``) mesh of the surviving
    ``devices`` (repeats allowed, as in every mesh of this package)."""
    n = len(devices)
    data = n // model_parallel if model_parallel > 0 else 0
    if data < 1:
        raise ValueError(
            f"{n} devices cannot host model axis {model_parallel}")
    devs = list(devices)
    return Mesh(devices=tuple(
        tuple(devs[r * model_parallel:(r + 1) * model_parallel])
        for r in range(data)), axis_names=tuple(axis_names))


def reshard_tree(tree, new_rules: ShardingRules,
                 spec_tree: Optional[dict] = None):
    """Place every leaf of ``tree`` (a module, a ``PlacedModule`` or
    {name: tensor or ``PlacedTensor``}) on ``new_rules.mesh``.
    ``spec_tree`` ({name: spec}) defaults to the inferred parameter specs
    (parameters and moments share them)."""
    if spec_tree is None:
        spec_tree = infer_param_specs(tree, new_rules)
    if isinstance(tree, (nn.Module, PlacedModule)):
        return place_module(tree, new_rules, spec_tree)
    return place_tree(tree, new_rules, spec_tree)


def remesh_train_state(state, new_mesh: Mesh, *,
                       rules: Optional[ShardingRules] = None):
    """Lay a ``TrainState`` out on ``new_mesh`` after the mesh changed
    (device loss or growth); ``count`` and ``step`` carry across as they
    are."""
    rules = rules or default_rules(new_mesh)
    opt = state.opt_state
    return dataclasses.replace(
        state, params=reshard_tree(state.params, rules),
        opt_state={"m": reshard_tree(opt["m"], rules),
                   "v": reshard_tree(opt["v"], rules),
                   "count": opt["count"]})
