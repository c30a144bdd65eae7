"""Sharding rules and mesh placement (counterpart of ``repro.sharding``)."""

from .placement import (  # noqa: F401
    NamedSharding,
    ShardedParams,
    ShardedTensor,
    named,
    place,
    place_tree,
    reduce_max,
    reduce_sum,
)
from .rules import (  # noqa: F401
    ShardingRules,
    act_pspec,
    active_rules,
    batch_pspecs,
    cache_pspecs,
    constrain_activation,
    make_rules,
    make_serving_rules,
    opt_state_pspecs,
    param_pspec,
    params_pspecs,
    use_rules,
)
