"""Device mesh construction and sharding helpers.

The reference has no distributed execution of any kind (SURVEY.md §2
"parallelism strategies": one render thread + one mutex). The rebuild's
distributed axes are new design:

  * ``hyp``  — RANSAC hypothesis batches sharded across chips, combined with
    a global arg-best reduction (parallel/sharded_ransac.py).
  * ``map``  — landmark/observation blocks sharded for distributed BA; the
    reduced camera system is psum'd across the mesh
    (parallel/sharded_ba.py).

On GPUs XLA hands the collectives to NCCL; in tests they run on a virtual
``xla_force_host_platform_device_count`` CPU mesh (tests/conftest.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_name: str, num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_leading(mesh: Mesh, axis_name: str):
    """NamedSharding that splits the leading array axis across the mesh."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
