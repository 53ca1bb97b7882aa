"""Distribution: sharding rules, collectives, pipeline parallelism
(rank-local SPMD over ``torch.distributed``; see ``sharding``).  The
reference's ``compat.py`` is a shim over JAX versions and has no
counterpart here."""
from repro_torch.parallel.sharding import (  # noqa: F401
    AxisRules,
    P,
    PartitionSpec,
    batch_pspec,
    cache_pspec,
    current_rules,
    gather_full,
    local_slice,
    logical_pspec,
    param_pspec,
    sharding_rules,
    zero1_pspec,
)
