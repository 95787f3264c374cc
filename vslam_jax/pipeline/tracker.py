"""The per-frame tracking step: the jitted heart of the SLAM pipeline.

Functional rebuild of the reference's inline main() loop body
(reference src/vslam.cpp:53-290): extract -> match -> RANSAC F -> E -> (R, t)
-> pose chain -> match-id propagation -> search-by-projection association ->
triangulation -> reprojection gate -> map insert. One ``track_step`` call is
one XLA program; the frame-to-frame loop stays on the host (inherently
sequential — frame t needs pose t-1; throughput comes from inside-frame
batch parallelism, SURVEY.md §7 "hard parts").

Improvements over the reference (deliberate, per SURVEY.md §7):
  * world-frame-consistent map (the reference triangulates every pair in the
    *previous camera's* frame and inserts those coordinates directly into the
    global map, src/vslam.cpp:123-125,186 — mixing frames);
  * PnP map tracking with SCALE FACTORIZATION: map anchors (pose-only GN,
    geometry/pnp.py, maturity-weighted) govern rotation, direction and
    lateral drift — the modes landmarks genuinely pin down — while the
    step MAGNITUDE follows the motion model + absolute map-ratio clamp;
    committing |t_pnp| from self-triangulated anchors closes a measured
    scale-feedback loop (step 7b). Which path GOVERNS is regime-dependent
    and honest: on anchor-rich scenes PnP commits nearly every frame; on
    exploration it corrects the essential chain when its support clears
    the commit gate (the reference uses unit translation every step,
    src/helpers.cpp:12);
  * proper cheirality, triangulation gates, argmin association.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


from ..config import VSLAMConfig
from ..core import camera as cam
from ..core import lie
from ..core.types import (FrameFeatures, MapState, empty_features, empty_map,
                          pytree_dataclass,
                          PT_XYZ, PT_CONF, PT_FIRST_UV, PT_FIRST_C,
                          PT_FIRST_P)
from ..frontend.frame import extract_features
from ..geometry import pnp, ransac, triangulation
from ..mapping import point_map
from ..matching import matcher


@pytree_dataclass
class TrackerState:
    pose: jnp.ndarray          # (4, 4) T_wc of the latest tracked frame
    prev: FrameFeatures        # features of the latest frame
    prev_map_id: jnp.ndarray   # (N,) i32 map point id per previous-frame kp
    map: MapState
    frame_idx: jnp.ndarray     # () i32
    scale: jnp.ndarray         # () f32 — running translation scale estimate
    key: jnp.ndarray           # PRNG key; per-frame keys fold in frame_idx
                               # inside the jit (no host-side split dispatch)
    vel: jnp.ndarray           # (4, 4) last successful relative motion
                               # T_{t-1 -> t} (world-chained); the
                               # constant-velocity motion model used to
                               # extrapolate through tracking failures
    # Delayed-triangulation / widest-baseline-refinement tracks (step 8):
    # each keypoint carries the pixel + camera of its FIRST observation
    # along the match chain. Unmapped keypoints triangulate into the map
    # once accumulated parallax clears the insertion gate; mapped keypoints
    # keep re-triangulating their landmark whenever parallax grows, so a
    # landmark's depth converges to its widest-baseline estimate.
    # Per-frame-baseline triangulation is measurably depth-biased (see
    # _step_impl step 8) and the bias compounds through the map.
    pend_uv: jnp.ndarray       # (N, 2) f32 pixel at first observation
    pend_P: jnp.ndarray        # (N, 3, 4) f32 projection matrix at first obs
    pend_C: jnp.ndarray       # (N, 3) f32 camera center (world) at first obs
    pend_desc: jnp.ndarray     # (N, 8) u32 descriptor at first observation —
                               # the track's identity card (see step 8)
    pend_par: jnp.ndarray      # (N,) f32 best parallax (rad) achieved so far
    pend_valid: jnp.ndarray    # (N,) bool — keypoint carries a live track
    prev_flow: jnp.ndarray     # (N, 2) f32 — per-keypoint image flow of the
                               # last match hop (median-filled for fresh
                               # detections); predicts this frame's position
                               # for the detector's track-carry (step 1b)


class TrackOutput(NamedTuple):
    pose: jnp.ndarray
    num_matches: jnp.ndarray
    num_inliers: jnp.ndarray
    num_cheirality: jnp.ndarray
    num_associated: jnp.ndarray
    num_tracked_map: jnp.ndarray  # keypoints carrying a FULL map id into PnP
    num_tracked_prov: jnp.ndarray  # keypoints bound to provisional landmarks
                                   # (association-only anchors, not in PnP)
    num_pnp_inliers: jnp.ndarray  # PnP inliers of the committed refine
    num_refined: jnp.ndarray      # landmarks re-triangulated this frame (8b)
    num_promoted: jnp.ndarray     # provisional landmarks promoted to full
    num_new_points: jnp.ndarray
    num_dropped_inserts: jnp.ndarray  # inserts lost to a full map this frame
    map_size: jnp.ndarray
    map_alive: jnp.ndarray     # alive landmarks within the cursor
    scale: jnp.ndarray
    scale_med: jnp.ndarray     # () f32 absolute map-ratio scale measurement
                               # (median z_map/z_rel over mature anchors)
    n_scale_support: jnp.ndarray  # () i32 supports behind scale_med
    success: jnp.ndarray
    # per-match data for frame annotation (reference draws keypoints, match
    # lines and reprojected circles on the live window, src/vslam.cpp:90-230)
    uv1: jnp.ndarray           # (N, 2) prev-frame keypoint of each match row
    uv2: jnp.ndarray           # (N, 2) current-frame keypoint
    match_mask: jnp.ndarray    # (N,) RANSAC-inlier match rows
    kp_uv: jnp.ndarray         # (N, 2) current-frame keypoints
    kp_mask: jnp.ndarray       # (N,)


def init_state(cfg: VSLAMConfig, seed: int = 0) -> TrackerState:
    n = cfg.frontend.max_keypoints
    return TrackerState(
        pose=jnp.eye(4, dtype=jnp.float32),
        prev=empty_features(n),
        prev_map_id=jnp.full((n,), -1, jnp.int32),
        map=empty_map(cfg.map.capacity, cfg.map.obs_per_point),
        frame_idx=jnp.zeros((), jnp.int32),
        scale=jnp.ones((), jnp.float32),
        key=jax.random.PRNGKey(seed),
        vel=jnp.eye(4, dtype=jnp.float32),
        pend_uv=jnp.zeros((n, 2), jnp.float32),
        pend_P=jnp.zeros((n, 3, 4), jnp.float32),
        pend_C=jnp.zeros((n, 3), jnp.float32),
        pend_desc=jnp.zeros((n, 8), jnp.uint32),
        pend_par=jnp.zeros((n,), jnp.float32),
        pend_valid=jnp.zeros((n,), bool),
        prev_flow=jnp.zeros((n, 2), jnp.float32),
    )


def _hamming_rows(d1, d2):
    """Row-wise Hamming distance of packed (N, 8) uint32 descriptors."""
    return jnp.sum(jax.lax.population_count(d1 ^ d2), axis=1).astype(jnp.int32)


def pnp_commit_ok(prev_pose, T_pnp, scale, pose_ok, num_inliers, rmse,
                  min_inliers):
    """Whether the PnP-refined pose may be COMMITTED (step 7b).

    Trust region on the committed motion: a marginal refine (order
    min_inliers supports) can slide far along the weakly conditioned
    forward direction while still reporting its supports as inliers
    (measured: a 1.8 -> 4.6 unit step on 15 borderline supports, which
    then poisoned the motion model and the run). A step more than 2x the
    motion model's magnitude is not refinement; keep the candidate.

    Relocalization (pose_ok false — e.g. the first real frame after a
    blackout has a black previous frame, so frame-to-frame matching and
    propagation are empty and only map association feeds PnP): accept a
    smaller support set, compensating with a strict convergence gate —
    a sub-1.5px pose-only fit on >= 8 genuine landmarks re-anchors
    reliably, and the trust region still bounds the step.

    Standalone (pure, jittable) so tests/test_guards.py can construct the
    runaway-refine pathology directly.
    """
    step_pnp = jnp.linalg.norm((lie.inv_T(prev_pose) @ T_pnp)[:3, 3])
    pnp_sane = step_pnp <= 2.0 * jnp.maximum(scale, 1e-2)
    need = jnp.where(pose_ok, min_inliers, jnp.minimum(min_inliers, 8))
    converged = pose_ok | (rmse < 1.5)
    return (num_inliers >= need) & pnp_sane & converged


def _masked_median(x, mask, fallback):
    """Median of x where mask, else fallback. Static-shape via sort."""
    big = jnp.where(mask, x, jnp.inf)
    s = jnp.sort(big)
    n = mask.sum()
    mid = jnp.maximum(n - 1, 0) // 2
    med = s[jnp.clip(mid, 0, x.shape[0] - 1)]
    return jnp.where(n > 0, med, fallback)


def _masked_medians(cols, masks, fallbacks):
    """Columnwise masked medians of cols (N, k) — one sort kernel for all k
    columns (columnwise identical to ``_masked_median``; the step needs
    three medians and one sort launch replaces three)."""
    big = jnp.where(masks, cols, jnp.inf)
    s = jnp.sort(big, axis=0)
    n = masks.sum(axis=0)
    mid = jnp.clip(jnp.maximum(n - 1, 0) // 2, 0, cols.shape[0] - 1)
    med = jnp.take_along_axis(s, mid[None, :], axis=0)[0]
    return jnp.where(n > 0, med, fallbacks)


@functools.partial(jax.jit, static_argnames=("cfg", "seed"))
def bootstrap(img, cfg: VSLAMConfig, seed: int = 0) -> TrackerState:
    """Initialize from the first frame (reference src/vslam.cpp:67-69)."""
    H, W = cfg.camera.height, cfg.camera.width
    feats = extract_features(img, cfg.frontend, H, W)
    st = init_state(cfg, seed)
    # every first-frame keypoint opens a delayed-triangulation track
    K = jnp.asarray(cfg.camera.K())
    P0 = cam.projection_matrix(K, st.pose)
    n = cfg.frontend.max_keypoints
    return st.replace(
        prev=feats, frame_idx=jnp.ones((), jnp.int32),
        pend_uv=feats.uv,
        pend_P=jnp.broadcast_to(P0[None], (n, 3, 4)),
        pend_C=jnp.broadcast_to(st.pose[:3, 3][None], (n, 3)),
        pend_desc=feats.desc,
        pend_par=jnp.zeros((n,), jnp.float32),
        pend_valid=feats.mask,
    )


class MapOps(NamedTuple):
    """Map-operation interface the tracking step is written against.

    The default (single-device) binding forwards to mapping/point_map; the
    sharded binding (parallel/sharded_tracker.py) runs the same step INSIDE
    ``shard_map`` with the map's point axis split across a mesh — shard-local
    scatters/gathers plus explicit collectives — so a sharded run is
    bit-identical to the single-device run (every non-map stage executes the
    same replicated program per device).
    """
    observe: object          # (m, ids, desc, valid, frame) -> m
    associate: object        # (m, P2, uv, desc, free, frame) -> AssociationResult
    gather_pt: object        # (m, ids) -> (N, PT_COLS) packed payload rows
                             # (0 where id invalid) — xyz, conf and the
                             # founding-observation record in ONE gather /
                             # ONE cross-shard psum (see core/types.py PT_*)
    gather_prov: object      # (m, ids) -> (N,) bool (False where id invalid)
    insert: object           # (m, xyz, color, desc, valid, frame, prov,
                             #  first_uv, first_P, first_C, conf) -> m
    update_xyz: object       # (m, ids, xyz, valid, promote, conf) -> m
                             # (landmark refine; promote rows clear prov;
                             #  valid rows record the new conf)
    cull: object             # (m, frame) -> m
    alive_count: object      # (m) -> () i32
    global_capacity: int     # total map capacity across all shards


def default_map_ops(cfg: VSLAMConfig, W: int, H: int) -> MapOps:
    def update_xyz(m, ids, xyz, valid, promote, conf):
        dst = jnp.where(valid, ids, m.capacity)
        pdst = jnp.where(promote, ids, m.capacity)
        # gather-modify-scatter of FULL packed rows: a column-sliced scatter
        # (.at[dst, 0:4]) lowered to a serial per-row while loop of
        # dynamic-update-slices on the whole (C, 24) array on the earlier
        # accelerator; the full-row scatter avoids it (re-race on the H100
        # pending). Duplicate dst rows stay consistent (each update writes
        # its own complete row).
        rows = m.pt[jnp.clip(dst, 0, m.capacity - 1)]
        rows = jnp.concatenate([xyz, conf[:, None], rows[:, 4:]], axis=1)
        return m.replace(
            pt=m.pt.at[dst].set(rows, mode="drop"),
            prov=m.prov.at[pdst].set(False, mode="drop"))

    def gather_pt(m, ids):
        rows = m.pt[jnp.clip(ids, 0, m.capacity - 1)]
        return jnp.where((ids >= 0)[:, None], rows, 0.0)

    return MapOps(
        observe=point_map.add_observations,
        associate=lambda m, P2, uv, desc, free, frame: point_map.associate(
            m, P2, uv, desc, free, cfg.map, cfg.matching, W, H,
            frame_idx=frame),
        gather_pt=gather_pt,
        gather_prov=lambda m, ids: (
            m.prov[jnp.clip(ids, 0, m.capacity - 1)] & (ids >= 0)),
        insert=point_map.insert_points,
        update_xyz=update_xyz,
        cull=point_map.cull_stale,
        alive_count=lambda m: (
            m.alive & (jnp.arange(m.capacity) < m.size)).sum(),
        global_capacity=cfg.map.capacity,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "map_axis"))
def track_step(state: TrackerState, img, cfg: VSLAMConfig,
               mesh=None, map_axis: str = "map"):
    """Track one new frame. Returns (new_state, TrackOutput).

    The RANSAC key derives from state.key + frame index inside the jit —
    the host dispatches exactly one program per frame.

    With ``mesh`` (a jax.sharding.Mesh carrying ``map_axis``), the map's
    point axis lives sharded across the mesh — BASELINE config 4's
    operating mode: the whole step runs under ``shard_map``
    (parallel/sharded_tracker.py) with search-by-projection as shard-local
    scans + a cross-shard arg-best over ICI, and insert/observe/cull as
    shard-local scatters. Map capacity then scales with the mesh instead of
    one device's memory; trajectories are bit-identical across mesh sizes and
    match the unsharded compilation to f32 tolerance
    (tests/test_sharded_tracking.py).
    """
    if mesh is not None:
        from ..parallel import sharded_tracker
        return sharded_tracker.run_sharded(state, img, cfg, mesh, map_axis)
    H, W = cfg.camera.height, cfg.camera.width
    return _step_impl(state, img, cfg, default_map_ops(cfg, W, H))


def _step_impl(state: TrackerState, img, cfg: VSLAMConfig, ops: MapOps,
               pose_fn=None):
    """The tracking step body, parameterized over the map backend.

    ``pose_fn``: optional replacement for the robust relative-pose stage
    (same signature as the ransac.ransac_pose call below) — the sharded
    tracking mode passes the hypothesis-sharded variant
    (parallel/sharded_ransac.ransac_pose_hypsharded) so the dominant
    stage's cost scales ~1/D across the mesh instead of replicating.
    """
    H, W = cfg.camera.height, cfg.camera.width
    K = jnp.asarray(cfg.camera.K())
    N = cfg.frontend.max_keypoints
    GC = ops.global_capacity
    key = jax.random.fold_in(state.key, state.frame_idx)

    # 1. features ---------------------------------------------------------
    # 1b. mapped-track carry: project each mapped keypoint's landmark
    # through the constant-velocity pose and hand the predictions to the
    # detector, which re-localizes them at the nearby response maximum
    # with budget priority (features.detect_with_carry). The per-tile
    # top-k detector is not repeatable for marginal corners — measured
    # 33%/frame mapped-track match loss, 77% of it detector misses — and
    # every lost mapped track thins the PnP anchor set and the keyframe
    # observations window BA runs on. Prediction (not the previous pixel)
    # is what bounds the search radius: the landmark depth and the motion
    # model are both known BEFORE extraction, so the window only covers
    # motion-model error, not optical flow.
    if cfg.frontend.track_carry:
        # every valid keypoint is carried at its FLOW-extrapolated position
        # (per-keypoint image flow of the last match hop, state.prev_flow);
        # mapped keypoints upgrade to the exact landmark projection through
        # the constant-velocity pose (depth known). Either way the
        # detector's search window only covers prediction error, not flow.
        carry_uv = state.prev.uv + state.prev_flow
        pred_pose = state.pose @ state.vel
        T_cw_pred = lie.inv_T(pred_pose)
        Xm_prev = ops.gather_pt(state.map, state.prev_map_id)[:, PT_XYZ]
        Xc_pred = jnp.einsum("ij,nj->ni", T_cw_pred[:3, :3], Xm_prev) \
            + T_cw_pred[:3, 3]
        zp = Xc_pred[:, 2]
        uvw = Xc_pred @ K.T
        uv_m = uvw[:, :2] / jnp.where(jnp.abs(zp) < 1e-6, 1e-6, zp)[:, None]
        use_m = (state.prev_map_id >= 0) & (zp > 0.1)
        carry_uv = jnp.where(use_m[:, None], uv_m, carry_uv)
        carry_mask = (state.prev.mask
                      & (carry_uv[:, 0] >= 0) & (carry_uv[:, 0] < W)
                      & (carry_uv[:, 1] >= 0) & (carry_uv[:, 1] < H))
        feats = extract_features(img, cfg.frontend, H, W,
                                 carry_uv, carry_mask)
    else:
        feats = extract_features(img, cfg.frontend, H, W)

    # 2. frame-to-frame matching (reference src/Frame.cpp:82-105), guided
    # by keypoint pixels (consecutive video frames: a spatial window around
    # each source keypoint bounds the candidates; see matcher.match)
    mres = matcher.match(
        state.prev.desc, state.prev.mask, feats.desc, feats.mask,
        cfg.matching, uv1=state.prev.uv, uv2=feats.uv
    )
    uv1 = state.prev.uv                       # (N, 2)
    uv2 = feats.uv[mres.idx2]                 # (N, 2) aligned by match
    m_valid = mres.mask

    # 3. robust F -> E -> (R, t), cheirality-aware selection ---------------
    rres = (pose_fn or ransac.ransac_pose)(
        key, uv1, uv2, m_valid, K,
        num_hypotheses=cfg.ransac.num_hypotheses,
        inlier_threshold=cfg.ransac.inlier_threshold,
        min_inliers=cfg.ransac.min_inliers,
    )
    R, t_unit, votes = rres.R, rres.t, rres.votes
    pose_ok = rres.success

    # 4. monocular scale from re-observed map points ----------------------
    # Triangulate inlier matches in the *previous camera frame* at unit
    # baseline, compare predicted depths of already-mapped points.
    P1_rel = jnp.concatenate([K, jnp.zeros((3, 1))], axis=1)
    P2_rel = K @ jnp.concatenate([R, t_unit[:, None]], axis=1)
    X_rel, w_rel = triangulation.triangulate_dlt(P1_rel, P2_rel, uv1, uv2)
    z_rel = X_rel[:, 2]
    # map-predicted depth of prev-frame keypoints that carry a map id
    # (provisional landmarks excluded: their depth is not yet trustworthy
    # and the scale median must not conform to it — MapState.prov)
    pid_prev = state.prev_map_id
    has_map = ((pid_prev >= 0) & rres.inliers
               & ~ops.gather_prov(state.map, pid_prev))
    Xm = ops.gather_pt(state.map, pid_prev)[:, PT_XYZ]
    T_cw_prev = lie.inv_T(state.pose)
    Xm_c = jnp.einsum("ij,nj->ni", T_cw_prev[:3, :3], Xm) + T_cw_prev[:3, 3]
    z_map = Xm_c[:, 2]
    ratio = z_map / jnp.maximum(z_rel, 1e-6)
    ratio_ok = has_map & (z_rel > 0.05) & (z_map > 0.05) & jnp.isfinite(ratio) \
        & (ratio > 1e-3) & (ratio < 1e3)
    # Long-run robustness (endurance regime): the reference step magnitude
    # is the motion model's LAST COMMITTED step — re-anchored every frame
    # to the PnP-committed motion (7b), so the ratio median below is a
    # one-shot measurement, never a compounding chain. (The median itself
    # is ~1% biased low per frame — z_rel is a small-parallax
    # triangulation — and chaining it through state.scale decayed the
    # world scale exponentially, measured 1.0 -> 0.05 over 200 corridor
    # frames.) Below 8 supports the median is noise — hold the reference —
    # and a single frame must not step the magnitude by more than 2x
    # (measured: zero-association frames spiked the raw median 10x).
    n_ratio = ratio_ok.sum()
    scale_ref = jnp.linalg.norm(state.vel[:3, 3])
    scale_ref = jnp.where(scale_ref > 1e-6, scale_ref, state.scale)
    # one sort kernel serves all three step medians: the scale ratio here
    # and the two flow components of step 6 (hop depends only on the match)
    hop = feats.uv[mres.idx2] - state.prev.uv            # (N, 2) by source
    meds = _masked_medians(
        jnp.stack([ratio, hop[:, 0], hop[:, 1]], axis=1),
        jnp.stack([ratio_ok, m_valid, m_valid], axis=1),
        jnp.stack([scale_ref, jnp.zeros(()), jnp.zeros(())]))
    med, med_fx, med_fy = meds[0], meds[1], meds[2]
    # The candidate magnitude IS the motion model; the measured median only
    # clamps it (gross-change guard after relocalization / speed jumps).
    # Using the median directly re-introduced a compounding ~1%/frame
    # downward push: z_rel is a unit-baseline (small-parallax) triangulation
    # whose depth noise skews the ratio low, and the forward-translation
    # direction is exactly where PnP (7b) is weakly conditioned, so the
    # candidate bias survived into the committed pose.
    scale = jnp.where(n_ratio >= 8,
                      jnp.clip(scale_ref, 0.5 * med, 2.0 * med), scale_ref)
    scale = jnp.clip(scale, 1e-3, 1e3)
    # First tracked pair defines world scale = 1.
    scale = jnp.where(state.frame_idx <= 1, 1.0, scale)

    # 5. pose chain (reference src/vslam.cpp:88, made convention-correct).
    # On failure: TRUE constant-velocity — extrapolate the last successful
    # relative motion (the reference crashes; holding the pose would park the
    # camera and blow up re-acquisition error after a blackout).
    T_c2c1 = lie.make_T(R, scale * t_unit)     # cam1 coords -> cam2 coords
    T_c1c2 = lie.inv_T(T_c2c1)                 # relative motion
    new_pose = state.pose @ T_c1c2
    new_pose = jnp.where(pose_ok, new_pose, state.pose @ state.vel)

    # 6. map-id propagation along matches (reference src/vslam.cpp:111-118)
    prop_src = jnp.where(m_valid & (pid_prev >= 0), pid_prev, -1)
    map_id2 = jnp.full((N,), -1, jnp.int32)
    tgt = jnp.where(prop_src >= 0, mres.idx2, N)   # N = drop
    map_id2 = map_id2.at[tgt].set(prop_src, mode="drop")
    # pending-track propagation: every matched keypoint (mapped or not)
    # inherits the first-observation record of its source keypoint (the
    # track survives re-detection; cross-checked matching keeps idx2 unique
    # among valid). Mapped keypoints keep it for widest-baseline landmark
    # refinement (step 8).
    #
    # Every f32 per-match payload rides ONE packed scatter: idx2 is unique
    # among valid rows (cross-check), and each payload's gated no-op value
    # equals its destination's initial value (zeros for the pend record and
    # the inlier flag, the median flow for new_flow), so gating the VALUE
    # instead of the index is equivalent to the per-payload masked scatters
    # it replaces — 7 scatter kernels fold into 1.
    pend_src = m_valid & state.pend_valid
    g = pend_src[:, None]
    ftgt = jnp.where(m_valid, mres.idx2, N)
    payload = jnp.concatenate([
        jnp.where(g, state.pend_uv, 0.0),              # 0:2   pend_uv
        jnp.where(g, state.pend_P.reshape(N, 12), 0.0),  # 2:14  pend_P
        jnp.where(g, state.pend_C, 0.0),               # 14:17 pend_C
        jnp.where(g, state.pend_par[:, None], 0.0),    # 17    pend_par
        g.astype(jnp.float32),                         # 18    pend_valid
        hop,                                           # 19:21 flow of the hop
        (m_valid & rres.inliers)[:, None].astype(jnp.float32),  # 21 inlier
    ], axis=1)
    # fresh detections (no hop) get the median matched flow — the global
    # image motion is the best prior for their first carry prediction
    init = jnp.concatenate([
        jnp.zeros((N, 19), jnp.float32),
        jnp.broadcast_to(jnp.stack([med_fx, med_fy]), (N, 2)),
        jnp.zeros((N, 1), jnp.float32),
    ], axis=1)
    packed = init.at[ftgt].set(payload, mode="drop")
    pend_uv = packed[:, 0:2]
    pend_P = packed[:, 2:14].reshape(N, 3, 4)
    pend_C = packed[:, 14:17]
    pend_par = packed[:, 17]
    pend_valid = packed[:, 18] > 0.5
    new_flow = packed[:, 19:21]
    # epipolar consistency this frame, per current keypoint (used in step 8)
    inl_kp = packed[:, 21] > 0.5
    pend_desc = jnp.zeros((N, 8), jnp.uint32).at[ftgt].set(
        jnp.where(g, state.pend_desc, 0), mode="drop")

    # propagated points get a fresh observation descriptor recorded
    new_map = ops.observe(
        state.map, map_id2, feats.desc, map_id2 >= 0, state.frame_idx
    )

    # 7. search-by-projection association (reference src/vslam.cpp:129-161).
    # ``new_pose`` here is only a CANDIDATE: the essential-chained pose on
    # success, the constant-velocity extrapolation on failure. It seeds the
    # projection window; the committed pose comes from the map (7b).
    P2 = cam.projection_matrix(K, new_pose)
    kp_free = feats.mask & (map_id2 < 0)
    assoc = ops.associate(new_map, P2, feats.uv, feats.desc, kp_free,
                          state.frame_idx)
    assoc_found = assoc.point_id >= 0

    # 7b. PnP map tracking (geometry/pnp.py): pose-only GN over every
    # keypoint that carries a FULL map id (propagated along matches +
    # freshly associated), maturity-weighted — 3D->2D anchoring of
    # rotation, direction and lateral drift to the map. The committed
    # step MAGNITUDE stays with the scale estimator (see the scale
    # factorization below): both pure chains compound multiplicatively
    # when they own scale — the essential chain through its per-frame
    # scale estimate (measured ~1%/frame decay, r03) and the PnP chain
    # through self-triangulated anchor depths (measured 1.5%/frame, r05)
    # — so each mode is governed by the signal that
    # actually observes it. The same refine doubles as blackout
    # relocalization (pose_ok false: the extrapolated candidate
    # re-acquires the surviving map at full anchor authority); the
    # reference has no recovery path at all (SURVEY.md §5,
    # src/Frame.cpp:56).
    pnp_ids = jnp.where(assoc_found, assoc.point_id, map_id2)
    pnp_prov = ops.gather_prov(new_map, pnp_ids)
    # provisional landmarks inform association (identity) but must not
    # anchor the pose: their low-parallax depths are exactly the biased
    # measurements PnP would conform to (MapState.prov). EXCEPT during
    # relocalization (pose_ok False): a young map may hold ONLY
    # provisional landmarks, and a biased re-anchor beats extrapolating
    # blind — the convergence gate (pnp_commit_ok rmse < 1.5) still
    # rejects a bad fit.
    pnp_mask = (pnp_ids >= 0) & feats.mask & (~pnp_prov | ~pose_ok)
    # one packed gather serves the PnP anchors' xyz AND conf (PT_* layout)
    rows_pnp = ops.gather_pt(new_map, pnp_ids)
    X_pnp = rows_pnp[:, PT_XYZ]
    # MATURITY-WEIGHTED anchoring: each anchor's residual is weighted by
    # conf^2/(conf^2 + conf0^2) — inverse depth-variance (sigma_z ~
    # pixel-noise/parallax), so a freshly promoted minimal-span anchor
    # informs the pose at ~1/5 the weight of a wide-baseline one instead
    # of dominating it (VERDICT r04 next #1(a): "marginal anchors inform
    # but don't dominate").
    conf0 = jnp.deg2rad(6.0)
    pnp_conf = rows_pnp[:, PT_CONF]
    pnp_w = pnp_conf ** 2 / (pnp_conf ** 2 + conf0 ** 2)
    # Relocalization (pose_ok False — e.g. first real frame after a
    # blackout): anchors run at FULL authority. The maturity weighting
    # exists to keep young anchors from dominating a healthy chain; after
    # a tracking loss there is no chain to protect, the surviving map IS
    # the signal, and the strict convergence gate (rmse < 1.5,
    # pnp_commit_ok) already rejects a bad re-anchor.
    pnp_w = jnp.where(pose_ok, pnp_w, jnp.ones_like(pnp_w))
    pr = pnp.refine_pose(
        lie.inv_T(new_pose), X_pnp, feats.uv, pnp_mask, K, iters=8,
        inlier_px=cfg.triangulation.reproj_threshold_sq ** 0.5 * 1.5,
        weights=pnp_w)
    T_pnp = lie.inv_T(pr.T_cw)
    # SCALE FACTORIZATION of the committed pose: PnP governs rotation,
    # direction, and lateral/vertical anchoring to the map (the drift
    # modes landmarks actually pin down), but its step MAGNITUDE is
    # re-gauged to the scale estimate (step 4: motion model clamped by
    # the absolute map-ratio band). Monocular forward step scale is the
    # one direction PnP anchors CANNOT be trusted on in exploration:
    # every anchor is triangulated from the recent pose chain, so anchor
    # depth errors correlate with the chain's own scale, and committing
    # |t_pnp| closes a positive feedback loop — measured on the 150-frame
    # corridor: committed step scale 1.63 -> 0.18 (-1.5%/frame), ATE
    # 0.10 -> 9.0, reproducible across promotion policies (one-shot
    # geometric, multi-view structure refine) and PnP itself measured
    # UNBIASED on ground-truth anchors (0.9992 +- 0.005) — the loop, not
    # the solver, is the disease. Scale corrections instead come from
    # the absolute map-ratio clamp and from accepted window-BA events
    # with a solid old-landmark bridge (pipeline/slam.py re-gauge).
    # Relocalization (pose_ok False) commits the RAW PnP pose: there the
    # absolute position vs surviving old landmarks IS the signal.
    dT = lie.inv_T(state.pose) @ T_pnp
    t_mag = jnp.linalg.norm(dT[:3, 3])
    dT_scaled = dT.at[:3, 3].set(
        dT[:3, 3] * jnp.where(t_mag > 1e-6, scale / jnp.maximum(t_mag, 1e-6),
                              1.0))
    # PnP-correction low-pass (PipelineConfig.pnp_blend): commit only a
    # fraction of the correction relative to the essential candidate —
    # persistent corrections integrate over a few frames, single-frame
    # anchor noise is attenuated. Full correction during relocalization.
    alpha = cfg.pipeline.pnp_blend
    if alpha < 1.0:
        xi_corr = lie.se3_log(lie.inv_T(new_pose) @ (state.pose @ dT_scaled))
        T_blend = new_pose @ lie.se3_exp(alpha * xi_corr)
        T_commit = jnp.where(pose_ok, T_blend, T_pnp)
    else:
        T_commit = jnp.where(pose_ok, state.pose @ dT_scaled, T_pnp)
    # the trust region gates the RAW solve (a diverged GN must not slip
    # through just because its magnitude gets sanitized by the re-gauge)
    pnp_ok = pnp_commit_ok(state.pose, T_pnp, scale, pose_ok,
                           pr.num_inliers, pr.rmse,
                           cfg.ransac.min_inliers)
    new_pose = jnp.where(pnp_ok, T_commit, new_pose)
    track_ok = pose_ok | pnp_ok

    assoc_ok = assoc_found & track_ok
    map_id2 = jnp.where(assoc_ok, assoc.point_id, map_id2)
    new_map = ops.observe(new_map, assoc.point_id, feats.desc,
                          assoc_ok, state.frame_idx)

    # 8. DELAYED triangulation of new world points ------------------------
    # (reference src/vslam.cpp:186-251 triangulates every consecutive pair
    # at 1-frame baseline. Measured with the real front-end at GROUND-TRUTH
    # poses on the synthetic corridor: median z_est/z_true = 0.990 at
    # baseline 1 vs 0.998 at baseline 3 — small-parallax triangulation
    # noise skews the inserted depths LOW, and a ~1%/generation shrink
    # compounds exponentially through insert -> track -> insert (observed:
    # map scale 1.0 -> 0.05 over 200 corridor frames, with or without BA,
    # whether poses chain by essential-matrix scale or PnP). So: each
    # unmapped keypoint carries its FIRST observation (pend_uv/pend_P,
    # propagated along the match chain in step 6) and triangulates against
    # the CURRENT view only once parallax clears
    # cfg.triangulation.min_parallax_deg.)
    P2 = cam.projection_matrix(K, new_pose)   # PnP may have moved the camera
    C2 = new_pose[:3, 3]
    X_w, w_abs = triangulation.triangulate_dlt(pend_P, P2, pend_uv, feats.uv)
    ray1 = X_w - pend_C
    ray2 = X_w - C2[None, :]
    cos_par = jnp.sum(ray1 * ray2, axis=1) / jnp.maximum(
        jnp.linalg.norm(ray1, axis=1) * jnp.linalg.norm(ray2, axis=1), 1e-9)
    par_ok = cos_par < jnp.cos(
        jnp.deg2rad(cfg.triangulation.min_parallax_deg))
    # provisional tier: a much lower parallax bar admits young tracks into
    # the map EARLY (flagged MapState.prov — association-only until
    # promoted at the full bar in 8b); see TriangulationConfig
    if cfg.triangulation.prov_parallax_deg > 0:
        par_ok_ins = cos_par < jnp.cos(
            jnp.deg2rad(cfg.triangulation.prov_parallax_deg))
    else:
        par_ok_ins = par_ok
    # TRACK IDENTITY gate: the current descriptor must still match the
    # track's FIRST observation. A chained match can hop to a nearby corner
    # (per-hop mis-association compounds over a track's life), and for
    # forward motion such identity drift is epipolar-consistent but
    # depth-wrong — the apparent parallax it inflates is precisely what a
    # threshold trigger selects for. Measured with ORACLE poses on the
    # synthetic corridor: without this gate the map's depth scale is 0.93x
    # truth by frame 10 and 0.56x by frame 50; drifted tracks pass every
    # geometric gate because radial drift rides the epipolar line.
    id_dist = _hamming_rows(pend_desc, feats.desc)
    id_ok = id_dist <= cfg.triangulation.track_id_hamming_max
    cand = (pend_valid & feats.mask & (map_id2 < 0) & inl_kp & track_ok
            & id_ok)
    quality = triangulation.triangulation_gate(
        pend_P, P2, pend_C, C2, X_w, pend_uv, feats.uv, w_abs,
        reproj_threshold_sq=cfg.triangulation.reproj_threshold_sq,
        min_depth=cfg.triangulation.min_depth,
        max_depth=cfg.triangulation.max_depth,
        min_parallax_cos=2.0,   # parallax handled by par_ok above
    )
    insert = cand & par_ok_ins & quality
    ins_prov = insert & ~par_ok     # below full maturity -> provisional
    # enough baseline but geometrically inconsistent: dead track, re-anchor
    restart = cand & par_ok_ins & ~quality
    # color: sample the image at the keypoint (grayscale -> replicated RGB;
    # the reference samples BGR with a row/col swap bug, src/vslam.cpp:248)
    xi = jnp.clip(feats.uv[:, 0].astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(feats.uv[:, 1].astype(jnp.int32), 0, H - 1)
    gray = img[yi, xi]
    color = jnp.stack([gray, gray, gray], axis=1)
    parallax_ins = jnp.arccos(jnp.clip(cos_par, -1.0, 1.0))
    new_map = ops.insert(new_map, X_w, color, feats.desc, insert,
                         state.frame_idx, ins_prov,
                         pend_uv, pend_P, pend_C, parallax_ins)

    # 8b. ONE-SHOT widest-baseline landmark refinement: a MAPPED keypoint
    # whose live track has reached DOUBLE its insertion parallax
    # re-triangulates its landmark once (same first-obs record, current
    # view) and then freezes — the landmark's depth gets the unbiased
    # wide-baseline estimate (undoing the small-parallax insertion bias for
    # exactly the landmarks PnP anchors to), but does NOT keep re-conforming
    # to the live pose chain. (Continuous refinement was measured to destroy
    # the map's anchoring property: landmark depths re-triangulated against
    # drifting poses track the drift, PnP conforms to the moved landmarks,
    # and the loop ran scale 1.0 -> 13 in 40 frames. After the one shot,
    # window BA owns the landmark.) The quality gate (reprojection in BOTH
    # views) also rejects refinements whose stored first-obs camera has
    # been invalidated by BA window corrections.
    FROZEN = 1e3   # pend_par sentinel: landmark already refined
    parallax = parallax_ins
    mapped_ok = (pend_valid & feats.mask & (map_id2 >= 0) & track_ok
                 & quality & id_ok)
    prov_id = ops.gather_prov(new_map, map_id2)
    # GEOMETRIC PROMOTION: a provisional landmark whose track has
    # accumulated enough parallax (across breaks — the re-bind restore
    # below keeps the founding record) re-triangulates at that wide
    # baseline and clears its prov flag. The bar is SUPPLY-ADAPTIVE
    # (TriangulationConfig): promote_parallax_deg normally, relaxed to
    # promote_parallax_lo_deg while this frame's live full-anchor count
    # (pnp_mask, step 7b) is below anchor_target — exploration regimes
    # starve for anchors and measurably prefer the lower bar, while
    # observation-dense regimes have anchors to spare and measurably
    # prefer the accuracy of the higher one. Promotion must not fire at
    # minimal parallax regardless of supply: minimal-parallax anchors
    # carry a ~1% low depth bias that compounds through the
    # anchor->pose->insert loop (measured: committed step scale
    # 1.64 -> 0.15 over 150 corridor frames).
    n_full_anchors = pnp_mask.sum()
    promote_bar = jnp.where(
        n_full_anchors < cfg.triangulation.anchor_target,
        jnp.deg2rad(cfg.triangulation.promote_parallax_lo_deg),
        jnp.deg2rad(cfg.triangulation.promote_parallax_deg))
    promote = mapped_ok & prov_id & (parallax > promote_bar)
    refine = (mapped_ok & ~prov_id
              & (pend_par < FROZEN)
              & (parallax > 2.0 * pend_par)
              & (parallax >
                 2.0 * jnp.deg2rad(cfg.triangulation.min_parallax_deg)))
    new_map = ops.update_xyz(new_map, map_id2, X_w, refine | promote,
                             promote, parallax)

    # retire uncorroborated stale landmarks (map hygiene; the reference's
    # map only ever grows)
    new_map = ops.cull(new_map, state.frame_idx)

    # newly inserted points: give their keypoints the new map ids
    offs = jnp.cumsum(insert.astype(jnp.int32)) - 1
    new_ids = jnp.where(insert, state.map.size + offs, -1)
    new_ids = jnp.where(new_ids < GC, new_ids, -1)
    map_id2 = jnp.where(insert & (new_ids >= 0), new_ids, map_id2)
    n_dropped = (insert & (state.map.size + offs >= GC)).sum()
    n_alive = ops.alive_count(new_map)

    # pending-track refresh: mapped keypoints KEEP their record (it feeds
    # 8b refinement while the track lives); immature tracks keep waiting;
    # fresh detections, restarted tracks, and re-associated keypoints with
    # no record re-anchor at this frame's committed pose (only on tracked
    # frames — an extrapolated failure pose must not seed tracks)
    # identity-drifted tracks restart too — their record is worthless
    restart = restart | (pend_valid & feats.mask & ~id_ok)
    keep = pend_valid & ~restart
    start_new = feats.mask & ~keep & track_ok
    # RE-BIND RESTORE: a keypoint whose fresh segment starts already bound
    # to a PROVISIONAL landmark (re-acquired via association after a break)
    # restores the landmark's map-held founding record (MapState.first_*)
    # instead of re-anchoring at this frame — so parallax maturity (and
    # with it promotion to a PnP anchor) accumulates across detector
    # misses. Identity across the break was vouched by the association
    # gates (radius + recency + Hamming); the segment identity card
    # (pend_desc) is the CURRENT descriptor, so the per-segment drift gate
    # (id_ok, step 8) keeps operating on the new segment. Full landmarks
    # re-bound after a break deliberately re-anchor at this frame: their
    # one-shot widest-baseline refine is keyed on pend_par, and restoring
    # would re-trigger it against the drifting live pose chain (the
    # continuous-refinement pathology, step 8b note).
    prov_now = ops.gather_prov(new_map, map_id2)
    rows_id2 = ops.gather_pt(new_map, map_id2)
    f_uv = rows_id2[:, PT_FIRST_UV]
    f_C = rows_id2[:, PT_FIRST_C]
    f_P = rows_id2[:, PT_FIRST_P].reshape(N, 3, 4)
    restore = start_new & (map_id2 >= 0) & prov_now
    pend_uv = jnp.where(keep[:, None], pend_uv,
                        jnp.where(restore[:, None], f_uv, feats.uv))
    pend_P = jnp.where(keep[:, None, None], pend_P,
                       jnp.where(restore[:, None, None], f_P,
                                 jnp.broadcast_to(P2[None], (N, 3, 4))))
    pend_C = jnp.where(keep[:, None], pend_C,
                       jnp.where(restore[:, None], f_C,
                                 jnp.broadcast_to(C2[None], (N, 3))))
    pend_desc = jnp.where(keep[:, None], pend_desc, feats.desc)
    pend_par = jnp.where(keep, pend_par, 0.0)
    pend_par = jnp.where(insert, parallax, pend_par)
    pend_par = jnp.where(promote, parallax, pend_par)  # future 8b at 2x this
    pend_par = jnp.where(refine, FROZEN, pend_par)   # one shot only
    pend_valid = keep | start_new

    # Rotation low-pass (PipelineConfig.rot_smooth): blend the committed
    # rotation toward the constant-velocity prediction on healthy tracked
    # frames — the independent per-frame rotation noise random-walks to
    # several degrees of yaw over hundreds of frames (the dominant
    # long-corridor error term; scale stays flat to 0.1%), while the
    # prediction already carries any steady turn rate.
    beta = cfg.pipeline.rot_smooth
    if beta > 0:
        R_pred = (state.pose @ state.vel)[:3, :3]
        R_meas = new_pose[:3, :3]
        dw = lie.so3_log(R_pred.T @ R_meas)
        R_blend = R_pred @ lie.so3_exp((1.0 - beta) * dw)
        use_blend = pose_ok & jnp.isfinite(R_blend).all()
        new_pose = jnp.where(use_blend,
                             new_pose.at[:3, :3].set(R_blend), new_pose)

    # SO(3) re-projection of the committed pose: the pose is a product
    # chain (~a dozen float32 4x4 products per frame through the PnP
    # path), and rotation non-orthogonality compounds MULTIPLICATIVELY —
    # measured singular-value inflation 1.0 -> 1.07 in 30 frames once PnP
    # commits densely, scaling every chained step (committed scale ran to
    # 24x). One Newton sweep per frame pins it at machine precision
    # (lie.orthonormalize_T).
    new_pose = lie.orthonormalize_T(new_pose)

    # non-finite backstop: whatever path produced the committed pose, a
    # NaN/inf must never enter the chain (it would poison every downstream
    # frame, the map, and the trajectory export) — hold the previous pose
    # and report the frame failed instead.
    finite = jnp.isfinite(new_pose).all()
    new_pose = jnp.where(finite, new_pose, state.pose)
    track_ok = track_ok & finite

    # motion model: the relative step actually taken this frame, updated only
    # on success (during failures the extrapolation keeps replaying it)
    new_vel = jnp.where(track_ok, lie.inv_T(state.pose) @ new_pose, state.vel)
    # state.scale records the committed step magnitude (the next frame's
    # scale_ref fallback when vel is degenerate, and the logged diagnostic)
    step_len = jnp.linalg.norm(new_vel[:3, 3])
    scale = jnp.where(track_ok & (step_len > 1e-6),
                      jnp.clip(step_len, 1e-3, 1e3), scale)
    out = TrackOutput(
        pose=new_pose,
        num_matches=m_valid.sum(),
        num_inliers=rres.num_inliers,
        num_cheirality=jnp.max(votes),
        num_associated=assoc_ok.sum(),
        num_tracked_map=pnp_mask.sum(),
        num_tracked_prov=((pnp_ids >= 0) & feats.mask & pnp_prov).sum(),
        num_pnp_inliers=pr.num_inliers,
        num_refined=refine.sum(),
        num_promoted=promote.sum(),
        num_new_points=insert.sum() - n_dropped,
        num_dropped_inserts=n_dropped,
        map_size=new_map.size,
        map_alive=n_alive,
        scale=scale,
        scale_med=med,
        n_scale_support=n_ratio.astype(jnp.int32),
        success=track_ok,
        uv1=uv1,
        uv2=uv2,
        match_mask=rres.inliers,
        kp_uv=feats.uv,
        kp_mask=feats.mask,
    )
    new_state = TrackerState(
        pose=new_pose,
        prev=feats,
        prev_map_id=map_id2,
        map=new_map,
        frame_idx=state.frame_idx + 1,
        scale=scale,
        key=state.key,
        vel=new_vel,
        pend_uv=pend_uv,
        pend_P=pend_P,
        pend_C=pend_C,
        pend_desc=pend_desc,
        pend_par=pend_par,
        pend_valid=pend_valid,
        prev_flow=new_flow,
    )
    return new_state, out
