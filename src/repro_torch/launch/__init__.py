"""Meshes for the grain-sharded search plane (``mesh.make_search_mesh``)."""
from .mesh import SearchMesh, make_search_mesh

__all__ = ["SearchMesh", "make_search_mesh"]
