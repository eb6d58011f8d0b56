"""Device placement of the sharded composite's flattened apex scan."""

from repro_torch.sharding.rules import DeviceGrid, ShardLayout, apex_table_specs, make_scaleout_mesh

__all__ = ["DeviceGrid", "ShardLayout", "apex_table_specs", "make_scaleout_mesh"]
