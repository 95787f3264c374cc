"""Device-resident chunked frame loop: ``lax.scan`` over T tracking steps.

The per-frame driver (pipeline/slam.py SLAMSystem.process) dispatches one
program per frame and synchronously ``device_get``s the full TrackOutput —
including five (N, 2)/(N,) per-match arrays — then makes the keyframe
decision on host, so a host round trip sits between every two frames.

This driver moves the loop itself onto the device:

  * T tracking steps run as ONE ``lax.scan`` program;
  * the keyframe decision (a threshold on two scalars,
    reference src/vslam.cpp:253-260's display cadence is the analogue) and
    the keyframe-ring insertion run INSIDE the scan;
  * map maintenance (LRU evict + compact + id remap) runs inside the scan
    under ``lax.cond`` when the insert cursor crosses the high-water mark —
    the same trigger the host driver uses;
  * only per-frame SCALARS (pose + counters) leave the device, once per
    chunk; the per-match annotation arrays never do (fetch them on demand
    from a single extra step if visualization asks).

Window-BA cadence: BA events stay on the host ORCHESTRATOR between chunks
(the solve itself is device compute). With ``chunk_frames`` aligned to
``keyframe_every * local_ba_every`` the BA events fire at exactly the same
frames as the per-frame driver, so the two drivers produce the same
trajectory up to the compiler's reduction tiling (asserted in
tests/test_scan_driver.py).

Frames come either from a pre-staged (T, H, W) device array (real data,
uploaded once per chunk) or from an on-device renderer callback (synthetic
endurance — zero per-frame transfer; datasets/synthetic_device.py).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import VSLAMConfig
from ..mapping import point_map
from . import keyframes as kf_mod
from . import tracker


class ChunkScalars(NamedTuple):
    """Per-frame scalar outputs of one chunk (everything the host driver
    logs, minus the per-match annotation arrays)."""
    pose: jnp.ndarray              # (T, 4, 4)
    num_matches: jnp.ndarray       # (T,)
    num_inliers: jnp.ndarray
    num_associated: jnp.ndarray
    num_tracked_map: jnp.ndarray
    num_tracked_prov: jnp.ndarray
    num_pnp_inliers: jnp.ndarray
    num_refined: jnp.ndarray
    num_promoted: jnp.ndarray
    num_new_points: jnp.ndarray
    num_dropped_inserts: jnp.ndarray
    map_size: jnp.ndarray
    map_alive: jnp.ndarray
    scale: jnp.ndarray
    success: jnp.ndarray
    is_keyframe: jnp.ndarray
    ran_maintenance: jnp.ndarray


def _maintenance(m, prev_map_id, obs_pid, min_free: int):
    """Evict + compact + remap (same sequence as slam._map_maintenance)."""
    m = point_map.evict_lru(m, min_free)
    m2, remap = point_map.compact(m)
    return (m2, point_map.remap_ids(prev_map_id, remap),
            point_map.remap_ids(obs_pid, remap))


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "high_water", "min_free", "render_fn"))
def run_chunk(state: tracker.TrackerState, store: kf_mod.KeyframeStore,
              frames, cfg: VSLAMConfig, high_water: int, min_free: int,
              render_fn=None):
    """Track a chunk of frames in one compiled program.

    Args:
      state: tracker state (device).
      store: keyframe ring (device).
      frames: (T, H, W) stacked images, or — with ``render_fn`` — a (T,)
        pytree of per-frame renderer inputs (e.g. (T, 4, 4) GT poses for
        the on-device synthetic renderer).
      render_fn: optional staged callable mapping one element of ``frames``
        to an (H, W) image ON DEVICE (closure may capture scene arrays).
      high_water / min_free: maintenance trigger/target, same semantics as
        SLAMSystem.
    Returns (state, store, ChunkScalars).
    """
    kfe = cfg.pipeline.keyframe_every
    min_ratio = cfg.pipeline.keyframe_min_inlier_ratio

    def step(carry, x):
        st, sr = carry
        img = render_fn(x) if render_fn is not None else x
        # host-driver equivalence: SLAMSystem.process numbers frames with
        # its own counter, which equals the tracker's pre-step frame_idx
        frame_no = st.frame_idx
        st2, out = tracker._step_impl(
            st, img, cfg, tracker.default_map_ops(
                cfg, cfg.camera.width, cfg.camera.height))

        # keyframe decision (slam.py:process, on device): the FLAG matches
        # the host driver's log; insertion additionally requires success
        ratio = out.num_inliers.astype(jnp.float32) / jnp.maximum(
            out.num_matches.astype(jnp.float32), 1.0)
        is_kf = (frame_no % kfe == 0) | (ratio < min_ratio)
        do_insert = is_kf & out.success
        sr2 = jax.lax.cond(
            do_insert,
            lambda s: kf_mod.insert_keyframe(
                s, st2.pose, frame_no, st2.prev.uv, st2.prev_map_id,
                st2.prev.mask),
            lambda s: s,
            sr,
        )

        # map maintenance at the high-water mark (slam.py trigger)
        need_maint = st2.map.size >= high_water

        def do_maint(args):
            st_, sr_ = args
            m2, pid2, obs2 = _maintenance(st_.map, st_.prev_map_id,
                                          sr_.obs_pid, min_free)
            return (st_.replace(map=m2, prev_map_id=pid2),
                    sr_.replace(obs_pid=obs2,
                                obs_mask=sr_.obs_mask & (obs2 >= 0)))

        st3, sr3 = jax.lax.cond(need_maint, do_maint, lambda a: a,
                                (st2, sr2))

        scal = ChunkScalars(
            pose=out.pose,
            num_matches=out.num_matches,
            num_inliers=out.num_inliers,
            num_associated=out.num_associated,
            num_tracked_map=out.num_tracked_map,
            num_tracked_prov=out.num_tracked_prov,
            num_pnp_inliers=out.num_pnp_inliers,
            num_refined=out.num_refined,
            num_promoted=out.num_promoted,
            num_new_points=out.num_new_points,
            num_dropped_inserts=out.num_dropped_inserts,
            map_size=out.map_size,
            map_alive=out.map_alive,
            scale=out.scale,
            success=out.success,
            is_keyframe=do_insert,
            ran_maintenance=need_maint,
        )
        return (st3, sr3), scal

    (state, store), scalars = jax.lax.scan(step, (state, store), frames)
    return state, store, scalars
