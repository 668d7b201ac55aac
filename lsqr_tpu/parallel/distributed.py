"""Multi-host entry points.

The reference is single-process (SURVEY.md §2.2); across several hosts the
pattern is single-program multiple-data: every process runs this same
program, ``jax.distributed.initialize`` wires up the runtime, and the mesh
in :mod:`lsqr_tpu.parallel.sharding` simply spans all devices of all
processes — XLA hands the two per-iteration collectives to NCCL (NVLink
within a host, the network across hosts). Run one process per host (it
drives all of the host's cards) or one per card.

These helpers cannot be integration-tested in a single-host environment;
they are thin, standard wiring kept separate from the (heavily tested)
sharding math in sharding.py.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from ..config import LSQROptions
from ..ops.coo import COOOperator
from .sharding import ShardedCOO, lsqr_sharded, shard_coo

__all__ = ["initialize_distributed", "global_mesh", "lsqr_multihost"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the JAX distributed runtime (idempotent). Without a
    cluster manager that JAX recognises, pass ``coordinator_address``
    (e.g. ``"localhost:<port>"`` on one host), ``num_processes`` and
    ``process_id`` explicitly."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        # already initialized
        pass


def global_mesh(axis_name: str = "rows") -> Mesh:
    """A 1-D mesh over ALL devices of ALL processes (u/b row-sharded across
    all processes; within-host devices are adjacent, so the transpose-product
    psum's ring segments stay on NVLink before crossing hosts)."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def lsqr_multihost(A, b, damp: float = 0.0, **kwargs):
    """Row-partitioned solve over every device of every host. Call from all
    processes with identical (replicated) inputs; returns the replicated
    result on each.

    This is :func:`lsqr_tpu.parallel.lsqr_sharded` with the global mesh."""
    mesh = kwargs.pop("mesh", None) or global_mesh(
        kwargs.get("axis_name", "rows")
    )
    return lsqr_sharded(A, b, damp, mesh=mesh, **kwargs)
