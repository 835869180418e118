"""Search meshes for the grain-sharded search plane.

The JAX package's ``repro.launch.mesh.make_search_mesh`` is the reference.
There one controller drives a ``jax.sharding.Mesh`` and ``shard_map`` runs
the search body once per mesh slot; here one process drives a
``SearchMesh`` whose slots are ``torch.device`` s, and the planner runs the
body once per slot (``planner.search_stacked_sharded``).  A slot is one
card where there are enough cards; repeated slots (``["cuda:0"] * 4``, or
``["cpu"] * 4`` for the plain path) put several shards on one device, the
counterpart of the JAX package's forced host devices.  No process group is
involved: two NCCL ranks cannot share a card, and the reference serves
from one process.

``make_production_mesh`` and ``make_host_mesh`` (the model meshes) are not
ported (ROADMAP Queue A item 11c).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

AXIS_NAMES = ("data", "model")


def normalize_device(device) -> torch.device:
    """A device with its index spelled out (``"cuda"`` is the current card),
    so a slot compares equal to the device its tensors report."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        dev = torch.device("cuda", idx)
    return dev


@dataclasses.dataclass(frozen=True)
class SearchMesh:
    """A (data, model) grid of devices: ``devices[b][s]`` is the slot of
    query row b and grain shard s (with the default ``grain_axis="model"``).
    Frozen and hashable: the store keys its sharded planes on it."""

    devices: tuple                      # [data][model] of torch.device
    axis_names: tuple = AXIS_NAMES

    def __post_init__(self):
        rows = tuple(tuple(normalize_device(d) for d in row)
                     for row in self.devices)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("SearchMesh needs a non-empty rectangular grid "
                             "of devices")
        object.__setattr__(self, "devices", rows)
        if tuple(self.axis_names) != AXIS_NAMES:
            raise ValueError(f"SearchMesh axes are {AXIS_NAMES}, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as a JAX mesh gives it."""
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def distinct_devices(self) -> tuple:
        """The devices of the mesh, each once, in slot order."""
        return tuple(dict.fromkeys(d for row in self.devices for d in row))


def make_search_mesh(shards: int, *, batch: int = 1,
                     devices: Optional[Sequence] = None) -> SearchMesh:
    """(data, model) mesh for the distributed search plane: grain panels
    shard over the ``model`` axis (``shards``-way), query batches over the
    ``data`` axis (``batch``-way).

    devices=None takes the first ``shards * batch`` CUDA cards and raises
    when there are fewer, as the reference raises; it never doubles up in
    silence.  ``devices=`` takes an explicit list of ``shards * batch``
    devices in row-major (data, model) order; repeats are allowed: N
    shards on one card (``["cuda:0"] * N``), or ``["cpu"] * N`` for the
    plain path."""
    if shards < 1 or batch < 1:
        raise ValueError(f"shards and batch must be >= 1, got {shards}, "
                         f"{batch}")
    need = shards * batch
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise ValueError(
                f"search mesh needs {need} devices ({batch} data x {shards} "
                f"model), found {have} CUDA devices; pass devices= with "
                f"{need} entries (repeats allowed: ['cuda:0'] * {need} puts "
                f"every shard on one card, ['cpu'] * {need} runs the plain "
                f"path)")
        devs = [torch.device("cuda", i) for i in range(need)]
    else:
        devs = list(devices)
        if len(devs) != need:
            raise ValueError(f"search mesh needs {need} devices ({batch} "
                             f"data x {shards} model), devices= has "
                             f"{len(devs)}")
    return SearchMesh(devices=tuple(
        tuple(devs[b * shards:(b + 1) * shards]) for b in range(batch)))
