"""Meshes: the search plane's, the host meshes and the production meshes.

The JAX package's ``repro.launch.mesh`` is the reference.  There one
controller drives a ``jax.sharding.Mesh``; here one process drives a
``Mesh`` whose slots are ``torch.device`` s.  The search plane runs its
body once per slot (``planner.search_stacked_sharded``); the train step
on a mesh computes once per data row and places parameters and moments
on the slots (``distributed.sharding``, ``train.step``).  A slot is one
card where there are enough cards; repeated slots (``["cuda:0"] * 4``, or
``["cpu"] * 4`` for the plain path) put several slots on one device, the
counterpart of the JAX package's forced host devices.  No process group
is involved: two NCCL ranks cannot share a card, and the reference runs
from one controller.

Every mesh function here returns the same frozen grid:
``make_search_mesh``, ``make_host_mesh`` (data x model) and
``make_production_mesh`` (16 x 16, or 2 x 16 x 16 with the ``pod`` axis
in front).  Without ``devices=``
each takes the first cards and raises when there are too few; it never
repeats a card in silence.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

AXIS_NAMES = ("data", "model")
POD_AXIS_NAMES = ("pod", "data", "model")


def normalize_device(device) -> torch.device:
    """A device with its index spelled out (``"cuda"`` is the current card),
    so a slot compares equal to the device its tensors report."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        dev = torch.device("cuda", idx)
    return dev


def _grid(devices, depth: int):
    """``devices`` as nested tuples of normalized devices, ``depth`` levels
    deep, every level rectangular; raises otherwise."""
    if depth == 0:
        if isinstance(devices, (list, tuple)):
            raise ValueError("Mesh needs one device per slot")
        return normalize_device(devices)
    if not isinstance(devices, (list, tuple)) or not devices:
        raise ValueError("Mesh needs a non-empty rectangular grid of devices")
    rows = tuple(_grid(r, depth - 1) for r in devices)
    if depth > 1 and len({_dims(r) for r in rows}) != 1:
        raise ValueError("Mesh needs a non-empty rectangular grid of devices")
    return rows


def _dims(grid) -> tuple:
    out = []
    while isinstance(grid, tuple):
        out.append(len(grid))
        grid = grid[0]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices over ``axis_names``: (data, model), or (pod,
    data, model) for the multi-pod production mesh.  ``devices[b][s]`` is
    the slot of data row b and model column s (``devices[p][b][s]`` with
    a pod axis).  Frozen and hashable: the store keys its sharded planes
    on it."""

    devices: tuple
    axis_names: tuple = AXIS_NAMES

    def __post_init__(self):
        names = tuple(self.axis_names)
        if names not in (AXIS_NAMES, POD_AXIS_NAMES):
            raise ValueError(f"Mesh axes are {AXIS_NAMES} or "
                             f"{POD_AXIS_NAMES}, got {self.axis_names}")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "devices", _grid(self.devices, len(names)))

    @property
    def shape(self) -> dict:
        """{axis name: size}, as a JAX mesh gives it."""
        return dict(zip(self.axis_names, _dims(self.devices)))

    @property
    def size(self) -> int:
        return math.prod(_dims(self.devices))

    def coords(self) -> list:
        """Every slot's coordinates, in row-major order."""
        out = [()]
        for n in _dims(self.devices):
            out = [c + (i,) for c in out for i in range(n)]
        return out

    def device_at(self, coords) -> torch.device:
        d = self.devices
        for i in coords:
            d = d[i]
        return d

    def flat_devices(self) -> tuple:
        """The slots' devices in row-major order."""
        return tuple(self.device_at(c) for c in self.coords())

    def distinct_devices(self) -> tuple:
        """The devices of the mesh, each once, in slot order."""
        return tuple(dict.fromkeys(self.flat_devices()))


#: The search plane's name for the (data, model) grid.
SearchMesh = Mesh


def _devices_for(need: int, devices: Optional[Sequence], what: str) -> list:
    """``devices`` (exactly ``need`` of them, repeats allowed) or the first
    ``need`` cards, raising when there are fewer."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise ValueError(
                f"{what} needs {need} devices, found {have} CUDA devices; "
                f"pass devices= with {need} entries (repeats allowed: "
                f"['cuda:0'] * {need} puts every slot on one card, "
                f"['cpu'] * {need} runs the plain path)")
        return [torch.device("cuda", i) for i in range(need)]
    devs = list(devices)
    if len(devs) != need:
        raise ValueError(f"{what} needs {need} devices, devices= has "
                         f"{len(devs)}")
    return devs


def _reshape(devs: list, shape: tuple):
    if len(shape) == 1:
        return tuple(devs)
    step = len(devs) // shape[0]
    return tuple(_reshape(devs[i * step:(i + 1) * step], shape[1:])
                 for i in range(shape[0]))


def make_search_mesh(shards: int, *, batch: int = 1,
                     devices: Optional[Sequence] = None) -> Mesh:
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
    devs = _devices_for(shards * batch, devices,
                        f"search mesh ({batch} data x {shards} model)")
    return Mesh(devices=_reshape(devs, (batch, shards)))


def make_host_mesh(data: int = 1, model: int = 1, *,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A small (data, model) mesh (tests, examples, ``launch.train
    --host-mesh``): the grid ``make_search_mesh(model, batch=data)``
    builds, so the search plane takes it too."""
    if data < 1 or model < 1:
        raise ValueError(f"data and model must be >= 1, got {data}, "
                         f"{model}")
    devs = _devices_for(data * model, devices,
                        f"host mesh ({data} data x {model} model)")
    return Mesh(devices=_reshape(devs, (data, model)))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """16 x 16 (data, model): one pod of 256 devices; or 2 x 16 x 16
    (pod, data, model): 512.  The search plane refuses the pod mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = POD_AXIS_NAMES if multi_pod else AXIS_NAMES
    devs = _devices_for(math.prod(shape), devices,
                        f"production mesh {'x'.join(map(str, shape))}")
    return Mesh(devices=_reshape(devs, shape), axis_names=names)
