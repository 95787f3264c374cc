"""Device-sharded map storage + sharded search-by-projection.

BASELINE config 4 ("full KITTI 00, 1 host, sharded map"): the map's point
axis is partitioned across the device mesh, so the per-frame
search-by-projection pass — the map-scaling hot path, the analogue of the
reference's whole-map projection loop (reference src/vslam.cpp:129-161) —
runs as D independent shard-local scans followed by one cross-shard
arg-best reduction. Map capacity then scales with the mesh instead of one
device's memory, and association time scales ~1/D at large map sizes.

Layout: contiguous blocks — shard i owns global slots [i*Cs, (i+1)*Cs).
Because the insert cursor is monotone and ``compact`` packs alive points to
the front, a young map concentrates on the low shards; ``point_map.associate``
loops only over blocks below each shard's insert cursor, so empty shards
are nearly free and the imbalance costs nothing until the map actually
spans shards (at which point it is balanced — the config-4 regime).

Tie-break parity with the single-device path: ``associate`` resolves ties
toward the lowest slot id (ascending block scan + argmin); the cross-shard
combine picks the lowest global id among shards achieving the global minimum
distance, so sharded == single-device bit-for-bit.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MapConfig, MatchingConfig
from ..core.types import MapState
from ..mapping import point_map
from ..mapping.point_map import AssociationResult


def map_state_specs(axis_name: str) -> MapState:
    """PartitionSpec pytree for a MapState sharded along the point axis.
    Use with jax.device_put / jit in_shardings so insert/cull/compact run
    under sharding propagation without manual collectives."""
    # desc is point-major flat (C*K, 8): splitting its row axis across D
    # shards hands each shard exactly its points' contiguous archive rows
    return MapState(
        pt=P(axis_name),
        desc=P(axis_name),
        desc_count=P(axis_name),
        alive=P(axis_name),
        last_seen=P(axis_name),
        prov=P(axis_name),
        size=P(),
    )


def shard_map_state(mesh: Mesh, axis_name: str, m: MapState) -> MapState:
    """device_put the map with its point axis split across the mesh."""
    specs = map_state_specs(axis_name)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), m, specs
    )


def associate_sharded(
    mesh: Mesh,
    axis_name: str,
    m: MapState,
    P_mat,                   # (3, 4) current-frame projection matrix
    kp_uv,                   # (N, 2)
    kp_desc,                 # (N, 8)
    kp_free,                 # (N,)
    map_cfg: MapConfig,
    match_cfg: MatchingConfig,
    width: int,
    height: int,
    frame_idx=None,          # () i32 — enables the reacq tier (point_map)
) -> AssociationResult:
    """Search-by-projection with the map sharded over ``axis_name``.

    Each shard runs the blocked single-device kernel on its slots, then the
    per-keypoint (distance, global id) winners combine with two pmin passes
    (distance first, then lowest global id among the distance minima).
    Keypoint arrays are replicated; outputs are replicated.
    """
    D = mesh.shape[axis_name]
    C = m.capacity
    assert C % D == 0, (C, D)
    Cs = C // D
    assert Cs % map_cfg.block_size == 0, (Cs, map_cfg.block_size)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(map_state_specs(axis_name), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,  # outputs are replicated post-pmin; checker can't prove
    )
    def run(lm: MapState, P_mat, kp_uv, kp_desc, kp_free):
        i = jax.lax.axis_index(axis_name)
        start = i * Cs
        # shard-local view: local cursor = how far the global cursor reaches
        # into this shard's slot range
        local = lm.replace(size=jnp.clip(lm.size - start, 0, Cs))
        res = point_map.associate(
            local, P_mat, kp_uv, kp_desc, kp_free,
            map_cfg, match_cfg, width, height, frame_idx=frame_idx,
        )
        gid = jnp.where(res.point_id >= 0, start + res.point_id, jnp.int32(C))
        gmin = jax.lax.pmin(res.distance, axis_name)           # (N,)
        cand = jnp.where((res.distance == gmin) & (gid < C), gid, jnp.int32(C))
        gbest = jax.lax.pmin(cand, axis_name)
        return AssociationResult(
            point_id=jnp.where(gbest < C, gbest, -1),
            distance=gmin,
        )

    return run(m, P_mat, kp_uv, kp_desc, kp_free)
