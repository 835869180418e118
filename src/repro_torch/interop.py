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
``segment_from_numpy`` and ``manifest_from_numpy`` carry a JAX store's
sealed ``Segment`` (its index leaves numpy arrays) and ``Manifest``
across, so ``VectorStore.search(q, manifest=...)`` searches exactly what
the JAX store searched; ``store_from_numpy`` carries a whole JAX
``VectorStore`` across (segments, memtable, mutation table, counters), so
``compact()`` and ``maintain()`` run on the same state in both packages.
A cold segment's raw rows are copied into a cold file of this package's
own (in ``cold_dir``, refcounted like a sealed one): the JAX package's
file belongs to its store's refcount, which would unlink it under this
package's segments (or this package's finalizer under the JAX store's);
``sharded_from_numpy`` carries a JAX ``ShardedStackedSegments``
(``repro.core.store.shard_segments``' host layout) across for
``planner.search_stacked_sharded``;
``params_from_numpy`` and ``caches_from_numpy`` carry a JAX model's
parameter tree and serving caches across (their ``[n_groups, ...]``
stacked leaves unstacked into the port's unrolled layers; for the
encoder-decoder, the ``[L, ...]`` stacks of each side's layers, of its
self and cross caches and of a cross ``KVIndex``);
``train_state_from_numpy`` carries a JAX ``TrainState`` (parameters, AdamW
moments, count and step) across, its moments unstacked the same way and
keyed by the port's parameter names;
``config_from_dict`` and ``model_config_from_dict``
rebuild the two configuration dataclasses from ``dataclasses.asdict`` of
the JAX ones.

Like every entry point, these put their tensors on the card unless
``device="cpu"`` is passed, and raise when there is no card.

This module imports neither JAX nor the JAX package: it reads attributes
or keys by name.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import uuid
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch

from .core.index import resolve_device
from .core import store as store_mod
from .core.store import Manifest, Segment, VectorStore
from .core.types import (GrainStore, HNTLConfig, HNTLIndex, RoutingPlane,
                         ShardedStackedSegments)
from .models.config import LayerSpec, ModelConfig
from .models.encdec import EncDec
from .models.hntl_attention import KVIndex
from .models.transformer import Transformer


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


def index_from_numpy(tree: Any, device=None) -> HNTLIndex:
    """JAX ``HNTLIndex`` with numpy leaves -> this package's ``HNTLIndex``."""
    device = resolve_device(device)
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


def sharded_from_numpy(tree: Any, device=None) -> ShardedStackedSegments:
    """JAX ``ShardedStackedSegments`` with numpy leaves (its index, the
    permuted ``gid_of_row`` and the optional ``live`` bitmap) -> this
    package's, every dtype and shape kept."""
    device = resolve_device(device)
    return ShardedStackedSegments(
        index=index_from_numpy(_field(tree, "index"), device),
        gid_of_row=_tensor(_field(tree, "gid_of_row"), device),
        live=_tensor(_field(tree, "live"), device))


def _host(tree: Any, name: str) -> Optional[np.ndarray]:
    a = _field(tree, name)
    return None if a is None else np.array(a)


def segment_from_numpy(seg: Any, device=None, *,
                       cold_dir: Optional[str] = None,
                       cold_tag: Optional[str] = None) -> Segment:
    """A JAX store's sealed ``Segment`` (its index leaves numpy arrays) ->
    this package's ``Segment``; the per-row host arrays are copied as they
    are.  A cold segment's rows are copied into a new cold file in
    ``cold_dir`` (default: a new temporary directory), named with
    ``cold_tag`` (default: a random one), which this package owns."""
    device = resolve_device(device)
    n, d = int(_field(seg, "n")), int(_field(seg, "d") or 0)
    src = _field(seg, "cold_path")
    path = None
    if src is not None:
        path = os.path.join(
            cold_dir or tempfile.mkdtemp(prefix="aperon_cold_"),
            f"seg{int(_field(seg, 'seg_id')):06d}_"
            f"{cold_tag or uuid.uuid4().hex[:8]}.raw")
        store_mod._write_cold_file(path, np.memmap(
            src, dtype=np.float32, mode="r", shape=(n, d)))
    with store_mod._cold_construction(path) as adopt:
        out = Segment(
            seg_id=int(_field(seg, "seg_id")),
            index=index_from_numpy(_field(seg, "index"), device),
            n=n, id_base=int(_field(seg, "id_base")),
            tags=_host(seg, "tags"), ts=_host(seg, "ts"),
            id_map=_host(seg, "id_map"),
            seq=_host(seg, "seq"), expire=_host(seg, "expire"),
            cold_path=path, d=d)
        adopt(out)
    return out


def manifest_from_numpy(man: Any, device=None, *,
                        cold_dir: Optional[str] = None) -> Manifest:
    """A JAX store's ``Manifest`` -> this package's: every segment carried
    across (cold ones into files of this package in ``cold_dir``); the
    memtable rows, the mutation table, writer and epoch unchanged."""
    device = resolve_device(device)
    if cold_dir is None and any(_field(s, "cold_path") is not None
                                for s in _field(man, "segments")):
        cold_dir = tempfile.mkdtemp(prefix="aperon_cold_")
    return Manifest(
        segments=tuple(segment_from_numpy(s, device, cold_dir=cold_dir)
                       for s in _field(man, "segments")),
        mem_n=int(_field(man, "mem_n")),
        **{name: tuple(_field(man, name) or ())
           for name in ("mem", "mem_tags", "mem_ts", "mem_ids", "mem_seq",
                        "mem_expire")},
        mut_gid=_host(man, "mut_gid"), mut_seq=_host(man, "mut_seq"),
        writer=str(_field(man, "writer") or ""),
        epoch=int(_field(man, "epoch") or 0))


#: The host state of a store that ``store_from_numpy`` copies as it is:
#: the memtable rows and their tables, the mutation table and the counters.
_STORE_STATE = ("_mem", "_mem_tags", "_mem_ts", "_mem_ids", "_mem_seq",
                "_mem_expire", "_live_seq", "_epoch", "_next_id",
                "_next_seq", "_next_seg", "_maint_epoch")


def store_from_numpy(store: Any, device=None, *,
                     cold_dir: Optional[str] = None) -> VectorStore:
    """A JAX ``VectorStore`` -> this package's, read by attribute: the same
    config, seal threshold, clock, cold tier and residency knobs, every
    sealed segment carried across (``segment_from_numpy``; cold files
    copied into the new store's own ``cold_dir``), and copies of the
    memtable rows, the mutation table and the epoch, id, seq, segment and
    maintenance counters."""
    device = resolve_device(device)
    cfg = _field(store, "cfg")
    out = VectorStore(
        config_from_dict(cfg if isinstance(cfg, Mapping)
                         else dataclasses.asdict(cfg)),
        seal_threshold=int(_field(store, "seal_threshold")),
        clock=_field(store, "_clock"), device=device,
        cold_tier=bool(_field(store, "cold_tier")), cold_dir=cold_dir,
        device_budget=_field(store, "device_budget"),
        residency_interval=int(_field(store, "residency_interval") or 64),
        prefetch_grains=int(_field(store, "prefetch_grains") or 64))
    out._segments = [segment_from_numpy(s, device, cold_dir=out._cold_dir,
                                        cold_tag=out._cold_tag)
                     for s in _field(store, "_segments")]
    for name in _STORE_STATE:
        v = _field(store, name)
        setattr(out, name, type(v)(v) if isinstance(v, (list, dict))
                else int(v))
    return out


def config_from_dict(d: Mapping) -> HNTLConfig:
    """An ``HNTLConfig`` from a mapping of its fields (for example
    ``dataclasses.asdict`` of the JAX config); unknown keys raise."""
    return _from_dict(HNTLConfig, d)


def kv_index_from_numpy(tree: Any, device=None) -> KVIndex:
    """JAX ``KVIndex`` with numpy leaves -> this package's ``KVIndex``."""
    device = resolve_device(device)
    return KVIndex(**{f.name: _tensor(_field(tree, f.name), device)
                      for f in dataclasses.fields(KVIndex)})


def _map_tree(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    return fn(tree)


def _unstack(tree, n: int) -> list:
    """A tree of ``[n, ...]`` stacked leaves -> n trees, one per slice."""
    return [_map_tree(tree, lambda a, i=i: a[i]) for i in range(n)]


def _layer_trees(tree: Any, cfg: ModelConfig):
    """The reference's per-layer trees in layer order: group g's
    ``groups["l{i}"]`` sliced at g, then the ``tail``."""
    groups = _field(tree, "groups") or {}
    out = []
    for g in range(cfg.n_groups):
        for i in range(len(cfg.pattern)):
            out.append(_map_tree(groups[f"l{i}"], lambda a, g=g: a[g]))
    return out + list(_field(tree, "tail") or ())


def params_from_numpy(tree: Any, cfg: ModelConfig, device=None):
    """A JAX model's parameter tree (numpy leaves, for example
    ``jax.tree.map(np.asarray, params)``) -> this package's
    ``Transformer`` (the stacked groups unrolled) or, for the
    encoder-decoder, ``EncDec`` (each side's stacked layers unrolled);
    every dtype kept."""
    device = resolve_device(device)

    def conv(a):
        return _tensor(a, device)

    if cfg.family == "encdec":
        enc, dec = _field(tree, "enc"), _field(tree, "dec")
        top = {"enc": {"final_ln": _map_tree(enc["final_ln"], conv)},
               "dec": {k: _map_tree(dec[k], conv)
                       for k in ("embedding", "pos_embedding", "final_ln")}}
        return EncDec(
            cfg, top,
            [_map_tree(lt, conv)
             for lt in _unstack(enc["layers"], cfg.n_enc_layers)],
            [_map_tree(lt, conv)
             for lt in _unstack(dec["layers"], cfg.n_layers)])
    top = {k: _map_tree(_field(tree, k), conv)
           for k in ("embedding", "final_norm", "lm_head")
           if _field(tree, k) is not None}
    return Transformer(cfg, top, [_map_tree(lt, conv)
                                  for lt in _layer_trees(tree, cfg)])


def train_state_from_numpy(state: Any, cfg: ModelConfig, device=None):
    """A JAX ``TrainState`` (``params``, ``opt_state`` {"m", "v",
    "count"}, ``step``; numpy leaves) -> this package's
    ``train.step.TrainState``: the parameters through
    ``params_from_numpy`` with gradients on, the moments as {name:
    tensor} under the same names, count and step as ints."""
    from .train.step import TrainState

    params = params_from_numpy(_field(state, "params"), cfg, device)
    params.requires_grad_(True)
    opt = _field(state, "opt_state")
    opt_state = {k: {n: t.detach() for n, t in params_from_numpy(
        opt[k], cfg, device).named_parameters()} for k in ("m", "v")}
    opt_state["count"] = int(opt["count"])
    return TrainState(params=params, opt_state=opt_state,
                      step=int(_field(state, "step")))


def _is_kv_index(tree) -> bool:
    return _field(tree, "centroids") is not None


def _slice_state(tree, i: int):
    """Slice i of a stacked layer state: a ``KVIndex`` (as a mapping of
    its fields, ``None`` leaves kept) or a tree of arrays."""
    if _is_kv_index(tree):
        return {f.name: (None if _field(tree, f.name) is None
                         else _field(tree, f.name)[i])
                for f in dataclasses.fields(KVIndex)}
    return _map_tree(tree, lambda a: a[i])


def _state(tree, device):
    """One layer's state -> tensors: a ``KVIndex`` through
    ``kv_index_from_numpy``, any other tree leaf by leaf (``()`` kept)."""
    if _is_kv_index(tree):
        return kv_index_from_numpy(tree, device)
    return _map_tree(tree, lambda a: _tensor(a, device))


def caches_from_numpy(tree: Any, cfg: ModelConfig, device=None) -> list:
    """A JAX model's serving caches (numpy leaves) -> this package's list
    of per-layer caches.

    For a decoder: ``{"mixer", "ffn"}`` per layer, each group's slice of
    the stacked caches, then the tail: linear ``{"k", "v"}`` caches,
    ``KVIndex`` caches (through ``kv_index_from_numpy``), RG-LRU
    ``{"h", "conv"}`` and RWKV6 ``{"s", "shift"}`` states with the
    channel-mix's ``{"shift"}`` under ``"ffn"``.  For the encoder-decoder
    (``family == "encdec"``): one of its ``[L, ...]`` stacks (a self or
    cross cache ``{"k", "v"}``, or a cross ``KVIndex``) -> L entries."""
    device = resolve_device(device)
    if cfg.family == "encdec":
        return [_state(_slice_state(tree, li), device)
                for li in range(cfg.n_layers)]
    groups = _field(tree, "groups") or {}
    layers = [{part: _slice_state(groups[f"l{i}"][part], g)
               for part in ("mixer", "ffn")}
              for g in range(cfg.n_groups) for i in range(len(cfg.pattern))]
    layers += list(_field(tree, "tail") or ())
    return [{part: _state(lc[part], device) for part in ("mixer", "ffn")}
            for lc in layers]


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
