"""HNTL core in PyTorch: build an index and search it in Mode A or B, alone
or as the sealed segments of a ``VectorStore``, which compacts and
maintains them."""
from .types import (HNTLConfig, HNTLIndex, GrainStore, RoutingPlane,
                    SearchResult, tree_bytes)
from .index import build, search, BuildInfo, int32_safe_qmax
from .scanplane import (ScanPlane, get_scan_plane, register_scan_plane,
                        scan_plane_names)
from .maintenance import MaintenancePolicy, MaintenanceReport
from .store import Manifest, Segment, VectorStore, stack_segments

__all__ = ["HNTLConfig", "HNTLIndex", "GrainStore", "RoutingPlane",
           "SearchResult", "tree_bytes", "build", "search", "BuildInfo",
           "int32_safe_qmax", "ScanPlane", "get_scan_plane",
           "register_scan_plane", "scan_plane_names", "Manifest", "Segment",
           "VectorStore", "stack_segments", "MaintenancePolicy",
           "MaintenanceReport"]
