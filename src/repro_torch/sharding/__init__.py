"""sharding of the PyTorch/CUDA port (twin of ``repro.sharding``): the
logical-axis rules and per-model specs of the LM zoo (``spec_for``,
``param_specs``, ``cache_specs``, ...), which read only a mesh's shape,
and the rules that cut a rank's shard of a ``BinnedData`` out of the
whole. Placing LM tensors by the specs (the reference's ``named`` and
``tree_shardings``) and the sharded LM step are ROADMAP.md A10."""
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
    batch_axes,
    block,
    gbdt_data_specs,
    serving_rules,
    shard_bins,
    spec_for,
)

__all__ = [
    "DEFAULT_RULES",
    "PartitionSpec",
    "batch_axes",
    "block",
    "cache_specs",
    "data_specs",
    "divisible_batch_axes",
    "gbdt_data_specs",
    "optimizer_state_specs",
    "param_specs",
    "serving_rules",
    "shard_bins",
    "spec_for",
]
