"""The grain-sharded search plane's placement (``sharding``)."""
from .sharding import (PlacedPlane, ShardingRules, search_plane_rules,
                       shard_hot_sets, shard_plane_field, shard_search_plane)

__all__ = ["PlacedPlane", "ShardingRules", "search_plane_rules",
           "shard_hot_sets", "shard_plane_field", "shard_search_plane"]
