"""Sharding rules and placement on a mesh (``sharding``), compressed
data-parallel steps (``compression``) and elastic re-meshing
(``elastic``)."""
from .sharding import (NamedSharding, PlacedModule, PlacedPlane,
                       PlacedTensor, ShardingRules, active_rules, constrain,
                       default_rules, infer_param_shardings,
                       infer_param_specs, place, place_module, place_tree,
                       search_plane_rules, search_plane_specs,
                       shard_hot_sets, shard_plane_field, shard_search_plane,
                       use_rules)

__all__ = ["NamedSharding", "PlacedModule", "PlacedPlane", "PlacedTensor",
           "ShardingRules", "active_rules", "constrain", "default_rules",
           "infer_param_shardings", "infer_param_specs", "place",
           "place_module", "place_tree", "search_plane_rules",
           "search_plane_specs", "shard_hot_sets", "shard_plane_field",
           "shard_search_plane", "use_rules"]
