"""Tensor-parallel serving (counterpart of gabby_tpu/parallel/): process
groups, partition rules and the rank-local slicer, the model's
collectives, and the plan broadcast that keeps ranks in lockstep. The
data axis (dp, sequence-parallel prefill, ring attention) is not yet
ported."""

from gabby_tpu_torch.parallel.mesh import (TPGroup, choose_backend,
                                           init_distributed, local_group)
from gabby_tpu_torch.parallel.sharding import (
    PARAM_RULES, bind_group, local_config, param_specs, shard_params,
    sharded_put_fn)

__all__ = [
    "TPGroup", "choose_backend", "init_distributed", "local_group",
    "PARAM_RULES", "bind_group", "local_config", "param_specs",
    "shard_params", "sharded_put_fn",
]
