"""Meshes (``mesh.make_search_mesh``, ``make_host_mesh``,
``make_production_mesh``) and the launchers."""
from .mesh import (Mesh, SearchMesh, make_host_mesh, make_production_mesh,
                   make_search_mesh)

__all__ = ["Mesh", "SearchMesh", "make_host_mesh", "make_production_mesh",
           "make_search_mesh"]
