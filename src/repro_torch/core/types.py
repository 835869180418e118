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
    # Adaptive query-time routing knobs (not ported yet; kept so a config
    # round-trips between the two packages unchanged).
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
