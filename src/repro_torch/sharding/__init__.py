"""Device placement on the one-process grid: the sharded composite's flattened
apex scan and the data pipeline's batches."""

from repro_torch.sharding.rules import DeviceGrid, ShardLayout, apex_table_specs, make_scaleout_mesh, place_rows

__all__ = ["DeviceGrid", "ShardLayout", "apex_table_specs", "make_scaleout_mesh", "place_rows"]
