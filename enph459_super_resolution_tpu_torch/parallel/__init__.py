"""Mesh parallelism: dp/sp/tp training shardings, tiled halo-exchange
spatial compute, GPipe-style pipeline parallelism, expert-split MoE.

Everything runs in one process over a :class:`Mesh` whose positions may
repeat a device (:mod:`.spmd` says how)."""

from .mesh import (Mesh, batch_sharding, make_mesh, parse_mesh_spec,
                   parse_sp_spec, replicated, shard_params_leading,
                   shard_params_tp, shard_train_step, sp_mesh)
from .moe import (moe_apply, shard_params_ep, shard_params_ep_named,
                  stack_experts)
from .pipeline import (make_pipelined_edsr_apply, pipeline_apply,
                       shard_edsr_pp_params, shard_params_pp, stack_stages)
from .spmd import MeshTensor, Sharding
from .tiled import halo_exchange, sharded_ibp, solve_sharded, tiled_apply

__all__ = [
    "Mesh", "MeshTensor", "Sharding", "batch_sharding", "make_mesh",
    "parse_mesh_spec", "parse_sp_spec", "replicated", "shard_params_leading",
    "shard_params_tp", "shard_train_step", "sp_mesh",
    "halo_exchange", "sharded_ibp", "solve_sharded", "tiled_apply",
    "make_pipelined_edsr_apply", "pipeline_apply", "shard_edsr_pp_params",
    "shard_params_pp", "stack_stages",
    "moe_apply", "shard_params_ep", "shard_params_ep_named", "stack_experts",
]
