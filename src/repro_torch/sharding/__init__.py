"""sharding of the PyTorch/CUDA port (twin of the GBDT part of
``repro.sharding``): the rules that cut a rank's shard of a ``BinnedData``
out of the whole. The LM rules (``serving_rules``, ``spec_for``,
``tree_shardings``, ``batch_axes``) and ``sharding/policy.py`` are
ROADMAP.md A9/A10."""
from repro_torch.sharding.rules import block, gbdt_data_specs, shard_bins

__all__ = ["block", "gbdt_data_specs", "shard_bins"]
