"""Placement of the grain-sharded search plane on a ``SearchMesh``.

The search-plane half of the JAX package's ``repro.distributed.sharding``
(the reference): ``ShardingRules`` maps the plane's logical axes
("grains", "rows", ``core.types.PLANE_FIELD_AXES``) onto a mesh axis, and
``shard_search_plane`` places each field's dim-0 chunk s on the device of
the slots of shard s.  Where the reference gets one global array sharded
over the mesh, the port gets a ``PlacedPlane``: per mesh slot, a 1-shard
``ShardedStackedSegments`` of views on that slot's device.

A field is placed once per distinct device: the chunks a device holds are
grouped into contiguous runs, each run is copied once (or not at all when
the field already lies there) and every shard takes a dim-0 view of it.
So N shards on one card cost one plane, not N, and on several cards each
card holds only its own shards' chunks.

The model rules (``default_rules``, ``constrain``, ``infer_param_specs``)
are not ported (ROADMAP Queue A item 11c).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core.types import (GrainStore, HNTLIndex, PLANE_FIELD_AXES,
                          RoutingPlane, ShardedStackedSegments)
from ..launch.mesh import SearchMesh


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """A mesh plus the logical -> mesh-axis map of the search plane.
    ``grain_axis`` is the axis the grain chunks are indexed by; the other
    axis of the mesh carries query rows."""

    mesh: SearchMesh
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


def search_plane_rules(mesh: SearchMesh, *,
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
    if grain_axis not in mesh.axis_names:
        raise ValueError(f"grain_axis {grain_axis!r} is not an axis of the "
                         f"mesh {mesh.axis_names}")
    return ShardingRules(mesh=mesh, rules={"grains": (grain_axis,),
                                           "rows": (grain_axis,)},
                         grain_axis=grain_axis)


def check_mesh_devices(mesh: SearchMesh, device) -> None:
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
