"""Multi-host process-group setup.

The reference has no multi-process story (SURVEY.md §2). On a multi-host
cluster each host runs this same program; ``jax.distributed.initialize``
forms the process group, after which ``jax.devices()`` spans every host and
the meshes built in parallel/mesh.py cover them all — the landmark-psum in
sharded BA becomes a cross-host collective with no code changes (XLA
inserts the collectives from the same shard_map programs validated on the
virtual CPU mesh in CI).

Single-host environments (this CI) skip initialization gracefully.
"""
from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join the multi-host process group if one is configured.

    Configuration via args or env (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID). Returns True if distributed mode is active.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if not coordinator_address or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(axis_name: str):
    """1-D mesh over every device of every host in the process group."""
    from . import mesh as mesh_mod
    return mesh_mod.make_mesh(axis_name)
