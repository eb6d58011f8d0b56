"""Sharding rules: the model half's parameter, batch and KV-cache specs
and their placements, and device placement on the one-process grid (the
sharded composite's flattened apex scan and the data pipeline's
batches)."""

from repro_torch.sharding.rules import (
    DeviceGrid,
    DeviceMesh,
    NamedSharding,
    PartitionSpec,
    ShardLayout,
    apex_table_specs,
    batch_spec,
    gcn_param_specs,
    kv_cache_specs,
    lm_param_specs,
    make_scaleout_mesh,
    place_rows,
    recsys_param_specs,
    to_named_shardings,
)

__all__ = [
    "lm_param_specs",
    "gcn_param_specs",
    "recsys_param_specs",
    "kv_cache_specs",
    "batch_spec",
    "to_named_shardings",
    "PartitionSpec",
    "NamedSharding",
    "DeviceMesh",
    "DeviceGrid",
    "ShardLayout",
    "apex_table_specs",
    "make_scaleout_mesh",
    "place_rows",
]
