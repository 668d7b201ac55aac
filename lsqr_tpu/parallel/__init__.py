"""Distributed solves over device meshes (no reference analogue — the
reference is serial Fortran; see SURVEY.md §2.2 and sharding.py for the
design)."""

from .distributed import global_mesh, initialize_distributed, lsqr_multihost
from .sharding import (
    ShardedCOO,
    cgls_sharded,
    cgls_sharded_2d,
    cgls_sharded_dia,
    craig_sharded_dia,
    lsmr_sharded_dia,
    craig_sharded_2d,
    lsmr_sharded_2d,
    craig_sharded,
    lsmr_sharded,
    lsqr_multidamp_sharded,
    lsqr_sharded,
    lsqr_sharded_2d,
    lsqr_sharded_dia,
    lsqr_sharded_zdia,
    make_mesh,
    make_mesh_2d,
    shard_coo,
)

__all__ = [
    "make_mesh",
    "shard_coo",
    "ShardedCOO",
    "lsqr_multidamp_sharded",
    "lsqr_sharded",
    "lsqr_sharded_dia",
    "lsqr_sharded_zdia",
    "lsqr_sharded_2d",
    "lsmr_sharded",
    "craig_sharded",
    "cgls_sharded",
    "lsmr_sharded_2d",
    "craig_sharded_2d",
    "cgls_sharded_2d",
    "lsmr_sharded_dia",
    "craig_sharded_dia",
    "cgls_sharded_dia",
    "make_mesh_2d",
    "global_mesh",
    "initialize_distributed",
    "lsqr_multihost",
]
