"""Logical-axis sharding rules, and placement on a ``Mesh``.

This package's port of the JAX package's ``repro.distributed.sharding``
(the reference).  A ``ShardingRules`` maps logical axis names onto mesh
axes with the reference's per-dimension divisibility fallback (a logical
axis that does not divide its dim, or whose mesh axis an earlier dim
already took, is replicated).  A spec is a tuple with one entry per dim:
``None``, a mesh axis name, or a tuple of names (the reference's
``PartitionSpec``).

The model half: ``default_rules`` (DP / FSDP / TP / EP over (data,
model), the batch over (pod, data) on the multi-pod mesh),
``infer_param_specs`` from each parameter's last name
(``_PARAM_AXES``), ``use_rules`` / ``active_rules`` / ``constrain``.
The port's parameters are unrolled, so ``layers.3.mixer.wq`` gets the
trailing-dim spec of the reference's stacked ``groups/l*/mixer/wq``
without its leading ``None``.

Placement (``place``, ``PlacedTensor``, ``place_module``,
``PlacedModule``): each leaf is split by its spec and block s lies on its
slot's device.  A device that holds every block of a leaf keeps the leaf
whole and its slots' shards are views of it, so N slots on one card
cost one copy, not N; a device that holds some blocks keeps each of them
once.  A gather back to a device returns the whole leaf itself where it
lies there already.  ``PlacedTensor.region`` is any part of a leaf on a
device: a model slot takes its block of the dim split over "model"
(``model_dim``) gathered over the data axis only, a view where the
device holds the leaf whole.

Three executions of a train step (``train.step.execution``): the dense
attention-only decoders split their compute over the model axis (heads,
MLP columns and vocab rows per model slot, the row-parallel products
summed over the row's slots: ``models.transformer.SlotParams``); those
with experts split it too, each slot its block of the experts (dim 0 of
``e_gate`` / ``e_up`` / ``e_down``, dim 1 of the router), the rows
stepping together (expert-parallel); every other family (RG-LRU,
RWKV6, the encoder-decoder) computes each data row with the whole
parameters gathered on the row's first slot (``PlacedModule.module_on``),
so the model axis shards its storage only.  None goes through
``constrain``: the models call it nowhere.

The search half places the grain-sharded plane: ``search_plane_rules``
maps the plane's logical axes ("grains", "rows",
``core.types.PLANE_FIELD_AXES``) onto a mesh axis, and
``shard_search_plane`` places each field's dim-0 chunk s on the device of
the slots of shard s.  Where the reference gets one global array sharded
over the mesh, the port gets a ``PlacedPlane``: per mesh slot, a 1-shard
``ShardedStackedSegments`` of views on that slot's device.  A field is
placed once per distinct device: the chunks a device holds are grouped
into contiguous runs, each run is copied once (or not at all when the
field already lies there) and every shard takes a dim-0 view of it.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.types import (GrainStore, HNTLIndex, PLANE_FIELD_AXES,
                          RoutingPlane, ShardedStackedSegments)
from ..launch.mesh import AXIS_NAMES, Mesh


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """A mesh plus a logical -> mesh-axis map.  ``grain_axis`` is the axis
    the search plane's grain chunks are indexed by; the other axis of the
    mesh carries query rows."""

    mesh: Mesh
    rules: dict
    grain_axis: str = "model"

    def mesh_axes(self, logical: Optional[str]):
        if logical is None:
            return None
        axes = self.rules.get(logical)
        if axes is None:
            return None
        return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)

    def axis_size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def spec_for_shape(self, shape, logical_axes) -> tuple:
        """The spec of a ``shape`` whose dims carry ``logical_axes``, with
        the reference's fallback per dim: an axis that does not divide
        its dim, or whose mesh axes an earlier dim took, replicates."""
        if len(shape) != len(logical_axes):
            raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                             f"logical axes {tuple(logical_axes)}")
        out, used = [], set()
        for dim, name in zip(shape, logical_axes):
            axes = self.mesh_axes(name)
            if axes is None or any(a in used for a in axes) \
                    or dim % self.axis_size(axes) != 0:
                out.append(None)
            else:
                out.append(axes[0] if len(axes) == 1 else tuple(axes))
                used.update(axes)
        return tuple(out)

    def sharding_for_shape(self, shape, logical_axes) -> "NamedSharding":
        return NamedSharding(self.mesh,
                             self.spec_for_shape(shape, logical_axes), self)

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.grain_axis]

    @property
    def n_rows(self) -> int:
        """Query rows of the mesh: the size of the axis besides the grain
        axis."""
        return self.mesh.size // self.n_shards

    def slot_device(self, row: int, shard: int) -> torch.device:
        """The device of (query row, grain shard)."""
        if self.grain_axis == "model":
            return self.mesh.devices[row][shard]
        return self.mesh.devices[shard][row]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where each block of a leaf lies.  ``rules``, when
    the sharding came from a ``ShardingRules``, are those rules: a module
    placed by such shardings steps under them."""

    mesh: Mesh
    spec: tuple
    rules: Optional["ShardingRules"] = dataclasses.field(
        default=None, compare=False, repr=False)


# ---------------------------------------------------------------------------
# Default rule tables and the active-rules context
# ---------------------------------------------------------------------------


def default_rules(mesh: Mesh, *, seq_sharded: bool = False,
                  serve_params: bool = False) -> ShardingRules:
    """The standard scheme: batch (and, with ``seq_sharded``, seq) over
    the data axes, heads / mlp / vocab / experts over model (TP / EP) and
    the parameters' d_model dim over data (FSDP).  On the multi-pod mesh
    the batch goes over (pod, data) and the pod axis never appears in a
    parameter's spec.  ``serve_params`` replicates parameters over data
    (TP only)."""
    multi_pod = "pod" in mesh.shape
    data_axes = ("pod", "data") if multi_pod else ("data",)
    rules = {
        # activations
        "batch": data_axes,
        "seq": data_axes if seq_sharded else None,
        "act_embed": None,          # d_model stays unsharded in activations
        "act_heads": ("model",),
        "act_kv_heads": ("model",),
        "act_mlp": ("model",),
        "act_vocab": ("model",),
        "act_experts": ("model",),
        # parameters
        "embed": None if serve_params else ("data",),  # FSDP dim
        "heads": ("model",),         # TP
        "kv_heads": ("model",),
        "mlp": ("model",),
        "vocab": ("model",),
        "experts": ("model",),       # EP
        "head_dim": None,
        "conv": None,
        "rnn": ("model",),           # RG-LRU / RWKV channel dim
        "lora": None,
    }
    return ShardingRules(mesh=mesh, rules=rules)


_ACTIVE: list = []


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Make ``rules`` the active rules inside the block: ``train.step``'s
    step and the ``Trainer`` then run on its mesh."""
    _ACTIVE.append(rules)
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def active_rules() -> Optional[ShardingRules]:
    return _ACTIVE[-1] if _ACTIVE else None


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Annotate an activation with logical axes: ``x`` itself.  With
    active rules the axes are checked against ``x``'s rank (the spec is
    computed).  It splits nothing: where the reference's SPMD partitioner
    splits at its ``constrain`` points, the port's tensor-parallel step
    computes each model slot's part explicitly
    (``models.transformer.SlotParams``), and the other families compute
    whole tensors on a row's device (the module's docstring)."""
    rules = active_rules()
    if rules is not None:
        rules.spec_for_shape(x.shape, logical_axes)
    return x


# ---------------------------------------------------------------------------
# Parameter spec inference (last name + shape)
# ---------------------------------------------------------------------------

# last name -> logical axes of the *trailing* dims (leading dims -> None)
_PARAM_AXES = {
    # attention
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    # dense mlp
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    # moe
    "router": ("embed", "experts"),
    "e_gate": ("experts", "embed", "mlp"),
    "e_up": ("experts", "embed", "mlp"),
    "e_down": ("experts", "mlp", "embed"),
    # embeddings
    "embedding": ("vocab", "embed"),
    "lm_head": ("vocab", "embed"),
    "pos_embedding": (None, "embed"),
    # rg-lru / rwkv
    "w_in": ("embed", "rnn"),
    "w_gate_rnn": ("embed", "rnn"),
    "w_out": ("rnn", "embed"),
    "conv_w": ("conv", "rnn"),
    "lambda_p": ("rnn",),
    "gate_w": ("rnn", None),
    "gate_b": ("rnn",),
    "tm_w": ("embed", "mlp"),
    "cm_w": ("embed", "mlp"),
    "cm_w2": ("mlp", "embed"),
    "lora_a": ("embed", "lora"),
    "lora_b": ("lora", "embed"),
}


def _leaf_logical_axes(name: str, shape) -> tuple:
    axes = _PARAM_AXES.get(name.rsplit(".", 1)[-1])
    if axes is None:
        # norm scales / biases / scalars: replicate
        return (None,) * len(shape)
    if len(axes) < len(shape):          # leading dims
        return (None,) * (len(shape) - len(axes)) + tuple(axes)
    if len(axes) > len(shape):          # squeezed trailing dims
        return tuple(axes[-len(shape):]) if len(shape) else ()
    return tuple(axes)


def _named_leaves(params) -> list:
    """[(name, leaf)] of a module, a ``PlacedModule`` or a {name: leaf}
    mapping (tensors, placed tensors, or anything with a ``shape``)."""
    if isinstance(params, (nn.Module, PlacedModule)):
        return list(params.named_parameters())
    return list(params.items())


def infer_param_specs(params, rules: ShardingRules) -> dict:
    """{name: spec} of a model's parameters (a module, a ``PlacedModule``
    or {name: tensor}; meta tensors do: no allocation) or of its moments,
    which share the names."""
    return {name: rules.spec_for_shape(
                tuple(leaf.shape), _leaf_logical_axes(name, leaf.shape))
            for name, leaf in _named_leaves(params)}


def infer_param_shardings(params, rules: ShardingRules) -> dict:
    return {name: NamedSharding(rules.mesh, spec, rules)
            for name, spec in infer_param_specs(params, rules).items()}


# ---------------------------------------------------------------------------
# Placement of model trees
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _slot_block(mesh: Mesh, spec: tuple, coords: tuple) -> tuple:
    """Slot ``coords``'s block index per dim: its coordinates along the
    dim's mesh axes, row-major (the first axis major)."""
    pos = dict(zip(mesh.axis_names, coords))
    out = []
    for entry in spec:
        j = 0
        for a in _entry_axes(entry):
            j = j * mesh.shape[a] + pos[a]
        out.append(j)
    return tuple(out)


def _block_slices(mesh: Mesh, spec: tuple, shape: tuple,
                  block: tuple) -> tuple:
    out = []
    for entry, dim, j in zip(spec, shape, block):
        n = math.prod(mesh.shape[a] for a in _entry_axes(entry))
        out.append(slice(j * (dim // n), (j + 1) * (dim // n)))
    return tuple(out)


def _n_blocks(mesh: Mesh, spec: tuple) -> int:
    return math.prod(math.prod(mesh.shape[a] for a in _entry_axes(e))
                     for e in spec)


def spec_model_dim(spec: tuple) -> Optional[int]:
    """The dim a spec splits over the "model" axis (None: replicated over
    it).  A dim split over "model" and another axis at once raises: a
    model slot's block is then no block of one axis."""
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if "model" in axes:
            if len(axes) > 1:
                raise ValueError(f"dim {i} is split over {axes}, not over "
                                 "\"model\" alone")
            return i
    return None


def _full(shape) -> tuple:
    return tuple(slice(0, n) for n in shape)


def _intersect(a: tuple, b: tuple) -> Optional[tuple]:
    """The common part of two blocks (slices per dim), or None."""
    out = []
    for x, y in zip(a, b):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if lo >= hi:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def _relative(part: tuple, block: tuple) -> tuple:
    """``part`` (inside ``block``) as slices of ``block``'s own tensor."""
    return tuple(slice(p.start - b.start, p.stop - b.start)
                 for p, b in zip(part, block))


def add_region_(acc, g: torch.Tensor, slices: Optional[tuple]) -> None:
    """Add ``g``, the gradient of part ``slices`` of a leaf (None: the
    whole leaf), into ``acc``: a float32 tensor of the whole leaf, or a
    ``PlacedTensor`` of float32 blocks, each block taking the part of
    ``g`` it covers, moved to its device."""
    if not isinstance(acc, PlacedTensor):
        dst = acc if slices is None else acc[slices]
        dst.add_(g.to(acc.device))
        return
    want = _full(acc.shape) if slices is None else tuple(slices)
    for p in acc.pieces:
        block = _full(acc.shape) if p.slices is None else p.slices
        cut = _intersect(block, want)
        if cut is not None:
            p.tensor[_relative(cut, block)].add_(
                g[_relative(cut, want)].to(p.device))


@dataclasses.dataclass(frozen=True)
class Piece:
    """One storage of a placed leaf: the whole leaf (``slices`` None) or
    one block of it, on ``device``."""

    device: torch.device
    slices: Optional[tuple]
    tensor: torch.Tensor


class PlacedTensor:
    """A leaf placed on a mesh by its spec.  ``pieces`` hold every storage
    once; ``shard(coords)`` is a slot's block, a view of its piece."""

    def __init__(self, sharding: NamedSharding, shape: tuple,
                 dtype: torch.dtype, pieces: tuple):
        self.sharding, self.shape, self.dtype = sharding, tuple(shape), dtype
        self.pieces = pieces

    def __repr__(self) -> str:
        return (f"PlacedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, pieces={len(self.pieces)})")

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    @property
    def requires_grad(self) -> bool:
        return self.pieces[0].tensor.requires_grad

    @property
    def is_parameter(self) -> bool:
        """Whether its pieces are ``nn.Parameter``s: a module's leaf."""
        return isinstance(self.pieces[0].tensor, nn.Parameter)

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def whole_on(self, device) -> Optional[torch.Tensor]:
        """The whole leaf where ``device`` holds it, else None."""
        device = torch.device(device)
        for p in self.pieces:
            if p.slices is None and p.device == device:
                return p.tensor
        return None

    def shard(self, coords) -> torch.Tensor:
        """The block of slot ``coords``: a view of its device's piece."""
        mesh = self.sharding.mesh
        dev = mesh.device_at(coords)
        sl = _block_slices(mesh, self.spec, self.shape,
                           _slot_block(mesh, self.spec, coords))
        whole = self.whole_on(dev)
        if whole is not None:
            return whole[sl]
        for p in self.pieces:
            if p.device == dev and p.slices == sl:
                return p.tensor
        raise KeyError(f"no piece of slot {coords} on {dev}")

    @torch.no_grad()
    def copy_(self, t: torch.Tensor) -> "PlacedTensor":
        """Write the whole leaf ``t`` into every piece, in place."""
        for p in self.pieces:
            p.tensor.copy_(t if p.slices is None else t[p.slices])
        return self

    def gather(self, device) -> torch.Tensor:
        """The whole leaf on ``device``: the piece itself where ``device``
        holds it whole, else one copy."""
        return self.region(None, device)

    @property
    def model_dim(self) -> Optional[int]:
        """The dim split over the "model" axis (``spec_model_dim``)."""
        return spec_model_dim(self.spec)

    def region(self, slices: Optional[tuple], device) -> torch.Tensor:
        """Part ``slices`` of the leaf (one slice per dim; None: the whole
        leaf) on ``device``: a view where ``device`` holds the leaf whole
        (the piece itself for the whole leaf), the piece itself where it
        holds exactly that block, else one copy made from a whole piece
        or from the blocks that cover the part."""
        device = torch.device(device)
        want = _full(self.shape) if slices is None else tuple(slices)
        whole = self.whole_on(device)
        if whole is not None:
            return whole if slices is None else whole[want]
        for p in self.pieces:
            if p.device == device and p.slices == want:
                return p.tensor
        for p in self.pieces:
            if p.slices is None:
                return p.tensor.detach()[want].to(device)
        out = torch.empty(tuple(s.stop - s.start for s in want),
                          dtype=self.dtype, device=device)
        filled = 0
        for p in self.pieces:
            cut = _intersect(p.slices, want)
            if cut is not None:
                out[_relative(cut, want)] = \
                    p.tensor.detach()[_relative(cut, p.slices)].to(device)
                filled += math.prod(s.stop - s.start for s in cut)
        if filled < out.numel():
            raise KeyError(f"the pieces of a {self.shape} leaf do not "
                           f"cover {want}")
        return out


def place(t, sharding: NamedSharding, *, param: bool = False) -> PlacedTensor:
    """Place ``t`` (a tensor on any device, or a ``PlacedTensor`` on any
    mesh) by ``sharding``: a device that holds every block gets the whole
    leaf (``t`` itself where it lies there already), any other device
    each of its blocks once.  ``param``: whole pieces are parameters
    (``nn.Parameter``, gradients as ``t``'s), so a module can take them."""
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    shape = tuple(t.shape)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not fit shape {shape}")
    need: dict = {}
    for c in mesh.coords():
        need.setdefault(mesh.device_at(c), set()).add(
            _slot_block(mesh, spec, c))
    n_blocks = _n_blocks(mesh, spec)
    grad = bool(getattr(t, "requires_grad", False))
    src = None
    pieces = []
    for dev, blocks in need.items():
        if len(blocks) == n_blocks:
            whole = t.gather(dev) if isinstance(t, PlacedTensor) \
                else (t if t.device == dev else t.detach().to(dev))
            if param and not isinstance(whole, nn.Parameter):
                whole = nn.Parameter(whole, requires_grad=grad)
            pieces.append(Piece(dev, None, whole))
            continue
        if src is None:
            src = t.gather(t.pieces[0].device) \
                if isinstance(t, PlacedTensor) else t.detach()
        for b in sorted(blocks):
            sl = _block_slices(mesh, spec, shape, b)
            pieces.append(Piece(dev, sl, src[sl].to(dev).contiguous()))
    return PlacedTensor(sharding, shape, t.dtype, tuple(pieces))


def zeros_like_leaf(like, dtype: torch.dtype):
    """Zeros of ``like``'s shape in ``dtype``, where ``like`` lies: on its
    device, or placed as it is (a ``PlacedTensor``)."""
    if not isinstance(like, PlacedTensor):
        return torch.zeros(like.shape, dtype=dtype, device=like.device)
    return PlacedTensor(like.sharding, like.shape, dtype, tuple(
        Piece(p.device, p.slices, torch.zeros(p.tensor.shape, dtype=dtype,
                                              device=p.device))
        for p in like.pieces))


def leaf_pieces(param, *others, grad: torch.Tensor):
    """(parameter, *others, gradient) per storage of one leaf: the
    tensors themselves, or for a ``PlacedTensor`` each piece of it and of
    ``others`` (placed alike) with its slice of ``grad`` (the whole
    gradient, or a ``PlacedTensor`` of its blocks) moved to the piece's
    device.  An update of plain tensors, piece by piece, updates the
    placed leaf."""
    if not isinstance(param, PlacedTensor):
        yield (param, *others, grad)
        return
    for i, p in enumerate(param.pieces):
        if isinstance(grad, PlacedTensor):
            g = grad.region(p.slices, p.device)
        else:
            g = (grad if p.slices is None else grad[p.slices]).to(p.device)
        yield (p.tensor, *(o.pieces[i].tensor for o in others), g)


def meta_template(module: nn.Module) -> nn.Module:
    """A copy of ``module`` whose parameters are meta tensors (no bytes):
    the structure ``PlacedModule.module_on`` fills in."""
    memo = {id(p): nn.Parameter(torch.empty_like(p, device="meta"),
                                requires_grad=p.requires_grad)
            for p in module.parameters()}
    return copy.deepcopy(module, memo)


def _with_parameters(template: nn.Module, params: dict) -> nn.Module:
    module = copy.deepcopy(template)
    for name, p in params.items():
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner) if owner else module, leaf, p)
    return module


class PlacedModule:
    """A model's parameters placed on a mesh: {name: ``PlacedTensor``}
    under the names of the module they came from.  ``module_on(device)``
    is a module of whole parameters on ``device``."""

    def __init__(self, template: nn.Module, leaves: dict,
                 rules: ShardingRules):
        self.template, self.leaves, self.rules = template, leaves, rules
        self._on: dict = {}

    def named_parameters(self):
        return iter(self.leaves.items())

    def parameters(self):
        return iter(self.leaves.values())

    def module_on(self, device) -> nn.Module:
        """A module whose parameters are the whole leaves on ``device``:
        the placed parameters themselves where ``device`` holds them whole
        (the module is kept, so its parameters move with every update in
        place), else gathered copies (a new module each call)."""
        device = torch.device(device)
        if device in self._on:
            return self._on[device]
        wholes = {k: v.whole_on(device) for k, v in self.leaves.items()}
        if all(isinstance(w, nn.Parameter) for w in wholes.values()):
            self._on[device] = _with_parameters(self.template, wholes)
            return self._on[device]
        return _with_parameters(self.template, {
            k: nn.Parameter(v.gather(device), requires_grad=True)
            for k, v in self.leaves.items()})


def module_of_placed(module, leaves: dict,
                     shardings: dict) -> PlacedModule:
    """A ``PlacedModule`` of ``module``'s structure (an ``nn.Module`` or a
    ``PlacedModule``) whose parameters are ``leaves``, placed by
    ``shardings`` ({name: ``NamedSharding``}), under the rules those
    shardings came from (the mesh's default rules for shardings built by
    hand)."""
    template = module.template if isinstance(module, PlacedModule) \
        else meta_template(module)
    first = next(iter(shardings.values()))
    return PlacedModule(template, leaves,
                        first.rules or default_rules(first.mesh))


def place_module(module, rules: ShardingRules,
                 specs: Optional[dict] = None) -> PlacedModule:
    """``module`` (an ``nn.Module`` or a ``PlacedModule`` on any mesh)
    placed by ``specs`` (default ``infer_param_specs``)."""
    specs = specs if specs is not None else infer_param_specs(module, rules)
    shardings = {name: NamedSharding(rules.mesh, spec, rules)
                 for name, spec in specs.items()}
    return module_of_placed(module, {
        name: place(p, shardings[name], param=True)
        for name, p in module.named_parameters()}, shardings)


def place_tree(tree: Mapping, rules: ShardingRules,
               specs: Optional[dict] = None) -> dict:
    """{name: tensor or ``PlacedTensor``} placed by ``specs`` (default
    ``infer_param_specs``): moments, gradients."""
    specs = specs if specs is not None else infer_param_specs(tree, rules)
    return {name: place(t, NamedSharding(rules.mesh, specs[name], rules))
            for name, t in tree.items()}


# ---------------------------------------------------------------------------
# Search-plane rules (the distributed HNTL data plane)
# ---------------------------------------------------------------------------


def search_plane_rules(mesh: Mesh, *,
                       grain_axis: str = "model") -> ShardingRules:
    """Logical-axis rules for the grain-sharded search plane: "grains"
    (panels, routing, liveness, tenant bitmaps) and "rows" (the permuted
    raw tier and id table) split along ``grain_axis``.  Queries are not
    placed through the rules: ``planner.search_stacked_sharded``'s
    ``batch_axis`` splits them over the other axis.

    Every shard stays fully resident: tiered residency
    (``device_budget=``) is the single-device answer to the same capacity
    problem, and the store refuses the two together; ``shard_hot_sets``
    gives the partition a per-shard residency mode would use."""
    if mesh.axis_names != AXIS_NAMES:
        raise ValueError(f"the search plane runs on a {AXIS_NAMES} mesh, "
                         f"got {mesh.axis_names}")
    if grain_axis not in mesh.axis_names:
        raise ValueError(f"grain_axis {grain_axis!r} is not an axis of the "
                         f"mesh {mesh.axis_names}")
    return ShardingRules(mesh=mesh, rules={"grains": (grain_axis,),
                                           "rows": (grain_axis,)},
                         grain_axis=grain_axis)


def search_plane_specs(tree, rules: ShardingRules):
    """The specs of a search-plane tree (``StackedSegments``,
    ``ShardedStackedSegments``, ``HNTLIndex``): {field: spec or subtree}
    by field name, each tensor split on dim 0 by its field's logical axis
    in ``PLANE_FIELD_AXES`` (trailing dims replicated); ``None`` fields
    stay ``None``."""
    def walk(node, field):
        if node is None:
            return None
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return {f.name: walk(getattr(node, f.name), f.name)
                    for f in dataclasses.fields(node)}
        if isinstance(node, (list, tuple)):
            return [walk(v, field) for v in node]
        if not hasattr(node, "shape"):
            return None
        shape = tuple(node.shape)
        axes = (PLANE_FIELD_AXES.get(field),) + (None,) * (len(shape) - 1) \
            if shape else ()
        return rules.spec_for_shape(shape, axes)
    return walk(tree, None)


def check_mesh_devices(mesh: Mesh, device) -> None:
    """Refuse a mesh whose slots are another kind of device than the
    plane's (a store on the card searched on CPU slots, or the reverse):
    the search never moves to the CPU in silence."""
    want = torch.device(device).type
    bad = [d for d in mesh.distinct_devices() if d.type != want]
    if bad:
        raise ValueError(
            f"mesh slots {[str(d) for d in bad]} do not match the plane's "
            f"device ({torch.device(device)}); build the mesh on "
            f"{want} devices (make_search_mesh(..., devices=[...]))")


def _place(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: itself when it lies there already, else one copy
    (through pinned memory from the host to a card)."""
    if t.device == dev:
        return t
    if t.device.type == "cpu" and dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _chunks_on(t: torch.Tensor, dev: torch.device, need: list, chunk: int,
               dim: int) -> dict:
    """{chunk index: view of chunk i of ``t`` along ``dim`` on ``dev``} for
    the sorted chunk indices ``need``, each contiguous run placed once."""
    out, i = {}, 0
    while i < len(need):
        j = i
        while j + 1 < len(need) and need[j + 1] == need[j] + 1:
            j += 1
        lo, hi = need[i], need[j] + 1
        run = _place(t.narrow(dim, lo * chunk, (hi - lo) * chunk), dev)
        for c in range(lo, hi):
            v = run.narrow(dim, (c - lo) * chunk, chunk)
            out[c] = v if v.is_contiguous() else v.contiguous()
        i = j + 1
    return out


def _place_logical(arr, rules: ShardingRules, logical: Optional[str],
                   dim: int) -> tuple:
    """Place one array by its logical axis: [row][shard] of tensors on the
    slots' devices.  An axis absent from the rules, or a dim the axis size
    does not divide, is replicated (the reference's fallback)."""
    t = torch.from_numpy(np.ascontiguousarray(arr)) \
        if isinstance(arr, np.ndarray) else arr
    axes = rules.mesh_axes(logical)
    n_rows, n_shards = rules.n_rows, rules.n_shards
    split = axes is not None and t.shape[dim] % rules.axis_size(axes) == 0
    n_chunks = n_shards if split else 1
    chunk = t.shape[dim] // n_chunks if split else t.shape[dim]
    need: dict = {}
    for r in range(n_rows):
        for s in range(n_shards):
            need.setdefault(rules.slot_device(r, s), set()).add(
                s if split else 0)
    placed = {dev: _chunks_on(t, dev, sorted(cs), chunk, dim)
              for dev, cs in need.items()}
    return tuple(tuple(placed[rules.slot_device(r, s)][s if split else 0]
                       for s in range(n_shards)) for r in range(n_rows))


def shard_plane_field(arr, rules: ShardingRules, field: str, *,
                      dim: int = 0) -> tuple:
    """Place ONE plane field on the mesh by its declared logical axis
    (``PLANE_FIELD_AXES``): [row][shard] of tensors, shard s's chunk on
    that slot's device.  The mutation path swaps the per-epoch ``live``
    bitmap into a placed plane this way without re-placing any other
    field.  ``dim``: the dimension that carries the axis (the tenant
    stack [T, G, cap] passes 1; the tenant axis stays whole)."""
    return _place_logical(arr, rules, PLANE_FIELD_AXES.get(field), dim)


@dataclasses.dataclass(frozen=True)
class PlacedPlane:
    """A ``ShardedStackedSegments`` placed on a mesh: ``slots[r][s]`` is
    shard s's slice for query row r, a 1-shard ``ShardedStackedSegments``
    on that slot's device (``index`` of G_l grains whose ids are rows of
    its own ``raw``/``gid_of_row`` slice)."""

    rules: ShardingRules
    slots: tuple
    g_local: int
    rows_local: int

    @property
    def n_shards(self) -> int:
        return self.rules.n_shards

    @property
    def cap(self) -> int:
        return self.slots[0][0].index.grains.cap

    @property
    def warm(self) -> bool:
        return self.slots[0][0].index.raw is not None

    def field(self, name: str) -> tuple:
        """[row][shard] of one placed field (``raw``, ``gid_of_row``,
        ``live`` or a grain panel)."""
        def get(sl):
            if name in ("gid_of_row", "live"):
                return getattr(sl, name)
            if name == "raw":
                return sl.index.raw
            if name in ("centroids", "sizes"):
                return getattr(sl.index.routing, name)
            return getattr(sl.index.grains, name)
        return tuple(tuple(get(sl) for sl in row) for row in self.slots)

    def with_live(self, live: Optional[tuple]) -> "PlacedPlane":
        """The same placement with a placed ``live`` field swapped in
        (None: everything live)."""
        return dataclasses.replace(self, slots=tuple(
            tuple(dataclasses.replace(
                sl, live=None if live is None else live[r][s])
                for s, sl in enumerate(row))
            for r, row in enumerate(self.slots)))

    def nbytes(self) -> int:
        """Device bytes the placement holds: each distinct storage once."""
        seen, total = set(), 0

        def visit(t):
            nonlocal total
            if t is None:
                return
            st = t.untyped_storage()
            key = (str(t.device), st.data_ptr())
            if key not in seen:
                seen.add(key)
                total += st.nbytes()

        for row in self.slots:
            for sl in row:
                for f in dataclasses.fields(GrainStore):
                    visit(getattr(sl.index.grains, f.name))
                visit(sl.index.routing.centroids)
                visit(sl.index.routing.sizes)
                visit(sl.index.raw)
                visit(sl.gid_of_row)
                visit(sl.live)
        return total


def shard_search_plane(plane: ShardedStackedSegments, rules: ShardingRules,
                       *, reuse: Optional[dict] = None) -> PlacedPlane:
    """Place a ``ShardedStackedSegments`` on the mesh, every field split
    by ``PLANE_FIELD_AXES`` (host numpy or tensors on any device go
    straight to their slots; one tensor object is placed once, so the
    routing centroids share the grains' ``mu``).

    ``reuse``: optional {field: already-placed [row][shard] field} for
    ``raw`` and ``gid_of_row``: the store's maintenance delta path.  A
    refit-only maintenance epoch rewrites grain panels but keeps row
    ownership, so the previous placement's row fields are handed back
    here and nothing of theirs moves; the caller proves their content
    unchanged (``store._reusable_row_leaves``)."""
    check_mesh_devices(rules.mesh, plane.gid_of_row.device
                       if isinstance(plane.gid_of_row, torch.Tensor)
                       else "cpu")
    reuse = {k: v for k, v in (reuse or {}).items() if v is not None}
    n_shards = rules.n_shards
    g_total = plane.index.grains.n_grains
    if g_total % n_shards or plane.rows_total % n_shards:
        raise ValueError(
            f"a {n_shards}-shard mesh needs the grain and row axes padded "
            f"to a multiple of {n_shards} (store.shard_segments), got "
            f"{g_total} grains and {plane.rows_total} rows")
    memo: dict = {}

    def place(name, arr, dim=0):
        if arr is None:
            return None
        if name in reuse:
            return reuse[name]
        key = id(arr)
        if key not in memo:
            memo[key] = (arr, shard_plane_field(arr, rules, name, dim=dim))
        return memo[key][1]

    g = plane.index.grains
    grains = {f.name: place(f.name, getattr(g, f.name))
              for f in dataclasses.fields(GrainStore)}
    cents = place("centroids", plane.index.routing.centroids)
    sizes = place("sizes", plane.index.routing.sizes)
    raw = place("raw", plane.index.raw)
    gid = place("gid_of_row", plane.gid_of_row)
    live = place("live", plane.live)

    def at(v, r, s):
        return None if v is None else v[r][s]

    slots = tuple(tuple(
        ShardedStackedSegments(
            index=HNTLIndex(
                routing=RoutingPlane(centroids=cents[r][s],
                                     sizes=sizes[r][s]),
                grains=GrainStore(**{k: at(v, r, s)
                                     for k, v in grains.items()}),
                raw=at(raw, r, s)),
            gid_of_row=gid[r][s], live=at(live, r, s))
        for s in range(n_shards)) for r in range(rules.n_rows))
    return PlacedPlane(rules=rules, slots=slots,
                       g_local=g_total // n_shards,
                       rows_local=plane.rows_total // n_shards)


def shard_hot_sets(hot_slots, n_grains: int, n_shards: int) -> list:
    """Split a global hot-grain set into per-shard local hot sets.

    The grain-sharded plane partitions grains into ``n_shards``
    contiguous ranges of ``n_grains // n_shards``.  Given the tiered
    residency manager's global hot set, returns per-shard arrays of local
    grain indices: what each shard would keep resident under a per-shard
    device budget (an accounting helper; the sharded plane is
    all-resident, see ``search_plane_rules``)."""
    if n_shards <= 0 or n_grains % n_shards != 0:
        raise ValueError(
            f"n_shards must divide n_grains: {n_shards} vs {n_grains}")
    hot = np.unique(np.asarray(hot_slots, np.int64))
    if hot.size and (hot[0] < 0 or hot[-1] >= n_grains):
        raise ValueError(f"hot slot out of range [0, {n_grains})")
    per = n_grains // n_shards
    return [hot[(hot // per) == s] - s * per for s in range(n_shards)]
