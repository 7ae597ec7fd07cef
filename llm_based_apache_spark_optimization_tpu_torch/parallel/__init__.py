"""Device mesh, TP/SP/DP sharding specs, explicit collectives, and the step
channel that lets rank 0's host loops drive the other ranks."""

from .mesh import Mesh, make_mesh  # noqa: F401
from .multihost import (  # noqa: F401
    global_mesh,
    init_distributed,
    is_primary,
    process_local_batch,
)
from .sharding import (  # noqa: F401
    P,
    batch_spec,
    cache_spec,
    constrain_cache,
    gather_batch,
    paged_pool_spec,
    param_specs,
    shard_batch,
    shard_params,
    specs_for_params,
    validate_tp,
)
