"""sharding of the PyTorch/CUDA port (twin of ``repro.sharding``): the
logical-axis rules and per-model specs of the LM zoo (``spec_for``,
``param_specs``, ``cache_specs``, ...), which read only a mesh's shape,
and the rules that cut a rank's shard of a ``BinnedData`` out of the
whole; placing LM tensors by the specs (``named``, ``tree_shardings``:
``Placement`` records that cut a rank's block and gather it back), which
the sharded LM step (``launch.steps``) holds its parameters by."""
from repro_torch.sharding.policy import (
    cache_specs,
    data_specs,
    divisible_batch_axes,
    optimizer_state_specs,
    param_specs,
)
from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    PartitionSpec,
    Placement,
    batch_axes,
    block,
    gbdt_data_specs,
    map_specs,
    named,
    reshard,
    serving_rules,
    shard_bins,
    spec_for,
    tree_shardings,
)

__all__ = [
    "DEFAULT_RULES",
    "PartitionSpec",
    "Placement",
    "batch_axes",
    "block",
    "cache_specs",
    "data_specs",
    "divisible_batch_axes",
    "gbdt_data_specs",
    "map_specs",
    "named",
    "optimizer_state_specs",
    "param_specs",
    "reshard",
    "serving_rules",
    "shard_bins",
    "spec_for",
    "tree_shardings",
]
