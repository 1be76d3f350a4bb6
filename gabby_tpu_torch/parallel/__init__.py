"""Tensor- and data-parallel serving (counterpart of gabby_tpu/parallel/):
the dp x tp grid of processes, partition rules and the rank-local slicer,
the model's and the data axis's collectives, the plan broadcast that keeps
ranks in lockstep, sequence-parallel prefill (sp.py) and ring attention
(ring.py)."""

from gabby_tpu_torch.parallel.mesh import (TPGroup, choose_backend,
                                           init_distributed, local_group)
from gabby_tpu_torch.parallel.sharding import (
    PARAM_RULES, bind_group, local_config, param_specs, shard_params,
    sharded_put_fn, slot_block)

__all__ = [
    "TPGroup", "choose_backend", "init_distributed", "local_group",
    "PARAM_RULES", "bind_group", "local_config", "param_specs",
    "shard_params", "sharded_put_fn", "slot_block",
]
