"""Logical-axis sharding on a ``DeviceMesh`` (counterpart of
``src/repro/sharding``)."""
from .api import (RULES, MeshContext, attn_q_names, get_context,
                  kv_cache_names, set_context, shard, shard_zero1,
                  use_mesh_context, zero1_spec)

__all__ = ["RULES", "MeshContext", "attn_q_names", "get_context",
           "kv_cache_names", "set_context", "shard", "shard_zero1",
           "use_mesh_context", "zero1_spec"]
