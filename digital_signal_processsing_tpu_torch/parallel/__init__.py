from .mesh import (  # noqa: F401
    CHANNEL_AXIS,
    TIME_AXIS,
    HostSteps,
    Mesh,
    Sharding,
    batch_sharding,
    make_mesh,
    make_time_mesh,
    planar_sharding,
    time_sharding,
)
from .multihost import assert_same_across_hosts, initialize_multihost, topology_summary  # noqa: F401
from .pipeline import (  # noqa: F401
    chain_halo,
    sharded_chain,
    sharded_chain_planar,
    sharded_wideband,
    wideband_halo,
)
from .pipeline_parallel import pipelined_fir_cascade  # noqa: F401
from .ring_pallas import (  # noqa: F401
    fused_ring_windowed_shard,
    ring_shift_right,
    ring_shift_right_shard,
)
from .sharded_fir import sharded_fir_filter  # noqa: F401
from .sharded_scan import sharded_cumsum, sharded_moving_average  # noqa: F401
from .sharded_tv import sharded_lpc_synthesis, sharded_sosfilt_tv  # noqa: F401

__all__ = [
    "TIME_AXIS",
    "CHANNEL_AXIS",
    "Mesh",
    "Sharding",
    "HostSteps",
    "make_mesh",
    "make_time_mesh",
    "time_sharding",
    "planar_sharding",
    "batch_sharding",
    "initialize_multihost",
    "topology_summary",
    "assert_same_across_hosts",
    "chain_halo",
    "sharded_chain",
    "sharded_chain_planar",
    "wideband_halo",
    "sharded_wideband",
    "pipelined_fir_cascade",
    "ring_shift_right_shard",
    "ring_shift_right",
    "fused_ring_windowed_shard",
    "sharded_fir_filter",
    "sharded_moving_average",
    "sharded_cumsum",
    "sharded_sosfilt_tv",
    "sharded_lpc_synthesis",
]
