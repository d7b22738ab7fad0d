"""Mesh parallelism, the spatial half so far: device meshes and the tiled
halo-exchange compute (``tiled_apply``, the sharded IBP and its solve).
The dp/tp training shardings, pipeline parallelism and expert-sharded MoE
come later (ROADMAP Queue 1 item 9)."""

from .mesh import Mesh, make_mesh, parse_mesh_spec, parse_sp_spec, sp_mesh
from .tiled import halo_exchange, sharded_ibp, solve_sharded, tiled_apply

__all__ = [
    "Mesh", "make_mesh", "parse_mesh_spec", "parse_sp_spec", "sp_mesh",
    "halo_exchange", "sharded_ibp", "solve_sharded", "tiled_apply",
]
