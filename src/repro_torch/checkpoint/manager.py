"""Atomic, async, keep-N checkpointing.

This package's port of the JAX package's ``checkpoint/manager.py``, with
its on-disk layout.  Per step:  <dir>/step_<n>/
    manifest.json     — step, and each leaf's name, file, shape and dtype
    leaf_<i>.npy      — one file per leaf, saved whole

- atomic: written to ``.tmp-step_<n>`` then ``os.rename``d (POSIX-atomic),
  so a crash mid-save never corrupts the latest checkpoint;
- async: ``save(..., blocking=False)`` snapshots to host memory (a copy,
  so training may overwrite its tensors in place meanwhile), then writes
  on a background thread; ``wait()`` joins it;
- keep-N: older checkpoints are removed after a successful save.

A tree is a ``TrainState`` or any dataclass, mapping, list or tuple of
tensors, Python numbers and ``nn.Module``s (each parameter a leaf, by
its dotted name).  numpy has no bfloat16, so a bf16 leaf is
stored as its uint16 bits with ``"dtype": "bfloat16"`` in the manifest
and viewed back on restore (the reference's files, written through
``ml_dtypes``, read back the same way).

``restore(target)`` reads into ``target``'s structure, casting each leaf
to the target leaf's dtype.  Tensors are overwritten in place (a module's
parameters too), on their own device: restoring a 38 GB train state
needs no second copy of it.  A tensor on the ``meta`` device stands for
shape and dtype alone (as the reference's ``ShapeDtypeStruct``) and is
replaced by a new CPU tensor.

Checkpoints stay whole on disk whatever mesh wrote them: a state placed
on a mesh (``distributed.sharding.PlacedModule`` / ``PlacedTensor``) is
gathered leaf by leaf on save, and a placed target is written piece by
piece.  ``restore(target, shardings=)`` is the reference's cross-mesh
(elastic) restore: each leaf with a ``NamedSharding`` is placed on that
sharding's mesh (a module's parameters, given {name: sharding}, become a
``PlacedModule``), whatever mesh the checkpoint was written from.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from collections.abc import Mapping
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from ..distributed.sharding import (NamedSharding, PlacedModule,
                                    PlacedTensor, module_of_placed, place)

BF16 = "bfloat16"


def _map_leaves(tree, fn: Callable, path: str = "", shard=None):
    """``tree`` rebuilt with every leaf replaced by ``fn(name, leaf,
    sharding)``; names follow ``jax.tree_util.keystr`` (``.field``,
    ``['key']``, ``[i]``), a module's parameters ``.<dotted name>``.
    ``shard`` is a tree of shardings walked alongside (a module's is
    {parameter name: sharding}), or None.  A module is returned as it is
    (``fn`` may write into its parameters) unless it has shardings: then
    it becomes a ``PlacedModule`` of ``fn``'s placed leaves, under the
    rules its shardings came from."""
    if isinstance(tree, (nn.Module, PlacedModule)):
        out = {}
        for name, p in tree.named_parameters():
            out[name] = fn(f"{path}.{name}", p,
                           None if shard is None else shard[name])
        if shard is None:
            return tree
        return module_of_placed(tree, out, shard)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(getattr(tree, f.name), fn,
                                f"{path}.{f.name}",
                                None if shard is None
                                else getattr(shard, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn, f"{path}[{k!r}]",
                               None if shard is None else shard[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, f"{path}[{i}]",
                                      None if shard is None else shard[i])
                          for i, v in enumerate(tree))
    return fn(path, tree, shard)


def _to_host(leaf):
    """(numpy copy, manifest dtype) of one leaf (a placed leaf gathered
    whole)."""
    if isinstance(leaf, PlacedTensor):
        leaf = leaf.gather("cpu")
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _from_file(path: str, entry: dict):
    """A leaf file as a tensor (numpy dtypes) with bf16 viewed back."""
    arr = np.load(os.path.join(path, entry["file"]))
    if entry["dtype"] == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        raise ValueError(f"leaf {entry['name']!r}: dtype {entry['dtype']} "
                         "cannot be read without ml_dtypes")
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- write
    def _write(self, host, step: int):
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = os.path.join(self.directory, f".tmp-step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (name, (arr, dtype)) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"name": name, "file": fname,
                 "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, tree: Any, step: int, *, blocking: bool = True):
        """Snapshot to host and write; non-blocking if blocking=False."""
        host = []
        _map_leaves(tree, lambda name, leaf, _: host.append(
            (name, _to_host(leaf))))
        if blocking:
            with self._lock:
                self._write(host, step)
            return
        self.wait()

        def work():
            with self._lock:
                self._write(host, step)
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------- read
    def all_steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Read step ``step`` (default: the latest) into the structure of
        ``target``, each leaf cast to the target leaf's dtype; tensors
        are written in place (see the module's docstring).  ``shardings``:
        an optional tree matching ``target`` (a module's entry is {name:
        ``NamedSharding``}, ``train.step.state_shardings`` builds one for
        a train state) whose leaves place the read leaves on another
        mesh: the cross-mesh (elastic) restore."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {e["name"]: e for e in manifest["leaves"]}

        def load(name, tgt, sharding):
            if name not in by_name:
                raise KeyError(f"checkpoint step {step} has no leaf "
                               f"{name!r}")
            t = _from_file(path, by_name[name])
            shape = tuple(tgt.shape) if hasattr(tgt, "shape") else ()
            if tuple(t.shape) != shape:
                raise ValueError(f"leaf {name!r}: checkpoint shape "
                                 f"{tuple(t.shape)}, target {shape}")
            if isinstance(sharding, NamedSharding):
                t = t.to(tgt.dtype)
                param = isinstance(tgt, nn.Parameter) or (
                    isinstance(tgt, PlacedTensor) and tgt.is_parameter)
                return place(t.requires_grad_(tgt.requires_grad), sharding,
                             param=param)
            if isinstance(tgt, PlacedTensor):
                return tgt.copy_(t)
            if torch.is_tensor(tgt):
                if tgt.is_meta:
                    return t.to(tgt.dtype)
                with torch.no_grad():
                    tgt.copy_(t)
                return tgt
            return type(tgt)(t.item())

        return _map_leaves(target, load, shard=shardings)
