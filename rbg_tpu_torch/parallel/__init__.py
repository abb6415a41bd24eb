"""The parallel plane on ``torch.distributed`` (``rbg_tpu/parallel``): device
meshes, the Megatron sharding rules and their collectives, ring attention
over ``sp`` and the GPipe pipeline over ``pp``."""

from rbg_tpu_torch.parallel.mesh import AXES, make_mesh, mesh_from_spec
from rbg_tpu_torch.parallel.sharding import (
    cache_specs, logits_spec, named, param_specs, shard_pytree, tokens_spec,
)

__all__ = [
    "AXES", "make_mesh", "mesh_from_spec",
    "param_specs", "cache_specs", "tokens_spec", "logits_spec",
    "shard_pytree", "named",
]
