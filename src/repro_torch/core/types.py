"""Core datatypes of the PyTorch HNTL index.

The index is a set of plain frozen dataclasses of tensors, mirroring the
JAX package's pytrees field for field, so a JAX-built index converts leaf
by leaf (``repro_torch.interop``).  Every tensor of one index lies on one
device; search runs there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

# Pruned/invalid-slot distance sentinel.  A slot is pruned iff its distance
# is >= BIG / 2; real squared distances never approach that.  The one copy
# of the literal in this package: every other module imports it.
BIG = 3.0e38


@dataclasses.dataclass(frozen=True)
class HNTLConfig:
    """Static configuration of an HNTL index.

    Mirrors the paper's notation: ambient dim ``d``, tangent dim ``k``,
    residual sketch dim ``s``, block size ``B``, grain count ``G``.
    """

    d: int = 768                 # ambient dimensionality
    k: int = 32                  # local tangent (PCA) dimensionality
    s: int = 8                   # residual sketch dimensionality (0 = off)
    block: int = 128             # Block-SoA block size B
    n_grains: int = 64           # G — number of grains (routing plane size)
    nprobe: int = 8              # top-P grains visited per query
    pool: int = 20               # candidate pool C handed to the re-ranker
    envelope_frac: float = 0.25  # saturation fraction that prunes a grain
    coord_bits: int = 16         # quantized coordinate width (int16)
    # Quantile of |z| used to set the quantization scale Delta per grain.
    scale_quantile: float = 0.9995
    # Safety factor: scale covers scale_mult * quantile(|z|).
    scale_mult: float = 1.25
    kmeans_iters: int = 25
    seed: int = 0
    # "fixed" = coord_bits everywhere; "density" = per-grain int4/int8 from
    # the build's variance-capture statistics, recorded in GrainStore.qmaxg.
    bit_alloc: str = "fixed"
    int4_captured_min: float = 0.85
    int4_min_rows: int = 8
    # Adaptive query-time routing knobs (``search(adaptive=True)``,
    # ``core.routing``).
    probe_margin: float = 1.0
    min_probes: int = 1
    hub_size: int = 4

    @property
    def qmax(self) -> int:
        return (1 << (self.coord_bits - 1)) - 1  # 32767 for int16

    @property
    def bytes_per_vector(self) -> int:
        """DRAM bytes per vector in the compact index (paper §3.2: 66 B)."""
        return 2 * self.k + (self.s if self.s else 0) + 2

    @property
    def block_bytes(self) -> int:
        """Eq. 7: BlockBytes = B * (2k + s + 6)."""
        return self.block * (2 * self.k + self.s + 6)


@dataclasses.dataclass(frozen=True)
class RoutingPlane:
    """Level-1 routing: grain centroids in the ambient space."""

    centroids: torch.Tensor    # [G, d] f32
    sizes: torch.Tensor        # [G] i32 — live vectors per grain

    @property
    def n_grains(self) -> int:
        return self.centroids.shape[0]


@dataclasses.dataclass(frozen=True)
class GrainStore:
    """Level-2 pointerless Block-SoA storage, padded to ``cap`` slots per
    grain; ``valid`` masks the padding.  ``coords`` is dimension-major
    ([G, k, cap]) so one grain's coordinate j is a contiguous run of slots.
    """

    coords: torch.Tensor                  # [G, k, cap] i16
    res: torch.Tensor                     # [G, cap] i32
    sketch: Optional[torch.Tensor]        # [G, s, cap] i8 or None
    ids: torch.Tensor                     # [G, cap] i32 (-1 = padding)
    valid: torch.Tensor                   # [G, cap] bool
    basis: torch.Tensor                   # [G, d, k] f32
    mu: torch.Tensor                      # [G, d] f32
    scale: torch.Tensor                   # [G] f32
    res_scale: torch.Tensor               # [G] f32
    sketch_basis: Optional[torch.Tensor]  # [G, d, s] f32 or None
    sketch_scale: Optional[torch.Tensor]  # [G] f32 or None
    # Mixed-recall tags.  The JAX package stores u32; here they are int64,
    # which holds every u32 value unchanged and supports all tensor ops.
    tags: Optional[torch.Tensor] = None   # [G, cap] i64
    ts: Optional[torch.Tensor] = None     # [G, cap] f32
    qmaxg: Optional[torch.Tensor] = None  # [G] i32 per-grain quant magnitude

    @property
    def n_grains(self) -> int:
        return self.coords.shape[0]

    @property
    def k(self) -> int:
        return self.coords.shape[1]

    @property
    def cap(self) -> int:
        return self.coords.shape[2]


@dataclasses.dataclass(frozen=True)
class HNTLIndex:
    """A complete, immutable HNTL index (one segment)."""

    routing: RoutingPlane
    grains: GrainStore
    raw: Optional[torch.Tensor]  # [N, d] f32 or None (Mode A-only index)

    @property
    def n_vectors(self) -> int:
        return int(self.raw.shape[0]) if self.raw is not None else -1

    @property
    def device(self) -> torch.device:
        return self.grains.coords.device


@dataclasses.dataclass(frozen=True)
class StackedSegments:
    """All sealed segments of a store fused into one searchable index.

    Each segment's ``GrainStore`` is padded to a common ``(G_max, cap_max)``
    shape and stacked on a leading segment axis, kept fused as
    ``[S*G_max, ...]``, so the whole stack routes and scans like a single
    ``HNTLIndex``: one planner call for any number of segments.

    ``index.grains.ids`` holds flat rows of the concatenated raw tier
    ``index.raw`` [N_total, d]; ``gid_of_row`` translates a flat row to the
    store's global id.  Padding grains have ``routing.sizes == 0`` (never
    routed) and ``valid == False`` (never scanned).

    ``live`` [S*G_max, cap] bool is the mutation epoch's liveness (False =
    tombstoned, shadowed by an upsert or expired), or None when all is
    live.  The store swaps it in with ``dataclasses.replace``: a delete
    never re-stacks the plane.
    """

    index: HNTLIndex           # fused view: [S*G_max] grains, ids = flat rows
    gid_of_row: torch.Tensor   # [N_total] i32: flat raw row -> global id
    row_offset: torch.Tensor   # [S+1] i32: raw-row range of each segment
    live: Optional[torch.Tensor] = None

    @property
    def n_segments(self) -> int:
        return self.row_offset.shape[0] - 1


@dataclasses.dataclass(frozen=True)
class ShardedStackedSegments:
    """A stacked plane re-laid-out for an N-way grain-sharded mesh.

    The fused grain axis is padded to a multiple of the shard count and
    split into contiguous chunks, one per shard; the raw tier is permuted
    so that every grain's member rows live in its owning shard's row
    slice, so a shard's Mode B re-rank reads only its own slice.  Grain
    ``ids`` hold rows local to the owning shard's slice, and
    ``gid_of_row`` is laid out per shard the same way (-1 on per-shard
    padding rows), so ids translate to global ids before the merge.

    Every tensor is split on dim 0 by ``PLANE_FIELD_AXES``: grain panels
    along the padded grain axis, ``raw``/``gid_of_row`` along the
    permuted row axis.  ``live`` [n*G_l, cap] is chunked like the panels.
    One shard's slice of a placed plane is itself a 1-shard
    ``ShardedStackedSegments`` (``distributed.sharding``).
    """

    index: HNTLIndex           # [n*G_l] grains, ids = shard-local raw rows
    gid_of_row: torch.Tensor   # [n*rows_per_shard] i32: permuted row -> gid
    live: Optional[torch.Tensor] = None

    @property
    def rows_total(self) -> int:
        return self.gid_of_row.shape[0]


# The logical axis of each plane field, by name: dim 0 of every leaf (the
# tenant stack [T, G, cap] on dim 1), trailing dims replicated.  "grains"
# fields split along the padded grain axis, "rows" fields along the
# permuted raw-row axis; ``distributed.sharding.search_plane_rules`` maps
# them onto a mesh axis.  The JAX package's ``SEARCH_PLANE_AXES``.
PLANE_FIELD_AXES = {
    "coords": "grains", "res": "grains", "sketch": "grains", "ids": "grains",
    "valid": "grains", "basis": "grains", "mu": "grains", "scale": "grains",
    "res_scale": "grains", "sketch_basis": "grains", "sketch_scale": "grains",
    "tags": "grains", "ts": "grains", "qmaxg": "grains",
    "centroids": "grains", "sizes": "grains",
    "live": "grains", "tenant_live": "grains", "hub_mask": "grains",
    "raw": "rows", "gid_of_row": "rows",
}


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Top-k result of a (batched) query."""

    ids: torch.Tensor          # [Q, topk] i32
    dists: torch.Tensor        # [Q, topk] f32 (Mode A approx, Mode B exact)


def tree_bytes(tree: Any) -> int:
    """Total bytes of all tensors in a (nested) dataclass of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0
