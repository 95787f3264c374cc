"""Full SLAM system: tracking + keyframing + sliding-window BA.

Host-side orchestrator around the jitted kernels — the structured
replacement for the reference's 300-line main() (reference src/vslam.cpp:12-300).
The host loop only moves images in and scalars out; all numeric work is
compiled. Visualization consumes immutable snapshots (``snapshot``) instead
of the reference's mutex-shared raw pointers (src/vslam.cpp:264-276,
the data race documented in SURVEY.md §3.4).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import VSLAMConfig
from ..mapping import point_map
from ..optimizer import ba
from ..utils.metrics import MetricsLogger
from . import keyframes, tracker


@jax.jit
def _window_gate_stats(problem, sel_prov):
    """All pre-solve window gate quantities as four scalars, so the host
    pays ONE device fetch per BA attempt instead of pulling the problem's
    observation arrays to the host (the chunked driver attempts one event
    per chunk)."""
    fixed = problem.cam_fixed
    ofree_cam = ~fixed[problem.obs_cam]
    pm = problem.point_mask[:, None]
    n_obs_free = (problem.obs_mask & ofree_cam & pm).sum()
    n_free = (problem.cam_mask & ~problem.cam_fixed).sum()
    nfix = (fixed[problem.obs_cam] & problem.obs_mask).sum(axis=1)
    nfree_o = (ofree_cam & problem.obs_mask).sum(axis=1)
    deep = problem.point_mask & (nfix >= 2) & (nfree_o >= 1)
    deep_obs = (problem.obs_mask & deep[:, None]).sum()
    bridge = ((fixed[problem.obs_cam] & problem.obs_mask).any(axis=1)
              & (ofree_cam & problem.obs_mask).any(axis=1)
              & problem.point_mask & ~sel_prov)
    solid_obs = (fixed[problem.obs_cam] & problem.obs_mask
                 & bridge[:, None]).sum()
    return (n_obs_free.astype(jnp.int32), n_free.astype(jnp.int32),
            deep_obs.astype(jnp.int32), solid_obs.astype(jnp.int32))


@jax.jit
def _map_maintenance(m, prev_map_id, obs_pid, min_free):
    """Evict LRU landmarks until >= min_free slots are reclaimable, compact
    the map, and remap every id holder (tracker + keyframe observations)."""
    m = point_map.evict_lru(m, min_free)
    m2, remap = point_map.compact(m)
    return (m2,
            point_map.remap_ids(prev_map_id, remap),
            point_map.remap_ids(obs_pid, remap))


class SLAMSystem:
    """Monocular SLAM over a frame stream."""

    def __init__(self, cfg: VSLAMConfig, metrics_path: Optional[str] = None,
                 seed: int = 0, enable_ba: bool = True, mesh=None):
        """``mesh``: optional jax.sharding.Mesh carrying the map axis
        (cfg.mesh.axis_map). When given, the live map's point axis is
        sharded across it for the whole run — tracking, maintenance, BA
        problem build and write-back all operate on the sharded arrays
        (BASELINE config 4: full sequence, one host, map sharded across
        chips)."""
        self.cfg = cfg
        self.metrics = MetricsLogger(metrics_path)
        self.enable_ba = enable_ba
        self._seed = seed
        self.mesh = mesh
        self._map_axis = cfg.mesh.axis_map
        if mesh is not None:
            assert self._map_axis in mesh.shape, (mesh, self._map_axis)
            n = mesh.shape[self._map_axis]
            assert cfg.map.capacity % n == 0, (cfg.map.capacity, n)
            assert (cfg.map.capacity // n) % cfg.map.block_size == 0, \
                "per-shard capacity must be a multiple of the block size"
        self.state: Optional[tracker.TrackerState] = None
        # ring holds up to max_keyframes so global BA can cover the full run
        self.kf_store = keyframes.empty_store(
            ring_size=max(cfg.pipeline.max_keyframes, 2 * cfg.ba.window),
            n_kp=cfg.frontend.max_keypoints,
        )
        self.trajectory: List[np.ndarray] = []
        self.frame_idx = 0
        self._kf_count = 0
        self._K = jnp.asarray(cfg.camera.K())
        self.last_ba_stats = None
        self.last_output = None
        # map maintenance: compact when the cursor passes the high-water
        # mark, reclaiming at least min_free slots (evicting LRU landmarks
        # if culling alone freed too few)
        cap = cfg.map.capacity
        # Headroom must cover a worst-case single-frame insert burst
        # (bounded by the keypoint budget) or inserts drop silently before
        # the post-step maintenance can run; at production capacities
        # cap//10 dominates and this is the old 0.9 * cap.
        headroom = max(cap // 10, min(cap // 2, cfg.frontend.max_keypoints))
        self._maint_high_water = cap - headroom
        # min_free must clear the high-water mark with slack, or one
        # maintenance pass leaves size above it and maintenance re-fires
        # every frame, perpetually evicting live anchors (measured at
        # cap=1024: headroom 256 > the old cap//8=128 floor -> 174
        # maintenance runs in 500 frames and the tracker lost its map).
        self._maint_min_free = max(cap // 8, headroom + max(cap // 16, 1))
        self.dropped_inserts_total = 0
        self.maintenance_runs = 0

    # ------------------------------------------------------------------
    def process(self, img) -> Dict:
        """Feed one grayscale frame (H, W) float32 in [0, 1]."""
        t0 = time.perf_counter()
        img = jnp.asarray(img, jnp.float32)
        if self.state is None:
            self.state = tracker.bootstrap(img, self.cfg, seed=self._seed)
            if self.mesh is not None:
                self.state = self.state.replace(map=self._shard_map(
                    self.state.map))
            self.trajectory.append(np.eye(4, dtype=np.float32))
            info = {"kind": "frame", "frame": 0, "bootstrap": True,
                    "wall_s": time.perf_counter() - t0}
            self.metrics.log(**info)
            self.frame_idx = 1
            return info

        self.state, out = tracker.track_step(
            self.state, img, self.cfg, mesh=self.mesh,
            map_axis=self._map_axis)
        # one bulk device->host transfer for all scalars + the pose
        out = jax.device_get(out)
        self.last_output = out
        pose = np.asarray(out.pose)
        self.trajectory.append(pose)

        inlier_ratio = float(out.num_inliers) / max(float(out.num_matches), 1.0)
        is_kf = (
            self.frame_idx % self.cfg.pipeline.keyframe_every == 0
            or inlier_ratio < self.cfg.pipeline.keyframe_min_inlier_ratio
        )
        ran_ba = False
        if is_kf and bool(out.success):
            self.kf_store = keyframes.insert_keyframe(
                self.kf_store,
                self.state.pose,
                jnp.int32(self.frame_idx),
                self.state.prev.uv,
                self.state.prev_map_id,
                self.state.prev.mask,
            )
            self._kf_count += 1
            se = self.cfg.ba.structure_every
            if (self.enable_ba and se > 0 and self._kf_count >= 3
                    and self._kf_count % se == 0):
                self._refine_structure()
            if (
                self.enable_ba
                and self._kf_count >= 3
                and self._kf_count % self.cfg.pipeline.local_ba_every == 0
            ):
                ran_ba = True
                self._run_window_ba()

        self.dropped_inserts_total += int(out.num_dropped_inserts)
        ran_maintenance = False
        if int(out.map_size) >= self._maint_high_water:
            before = int(out.map_size)
            m2, pid2, obs2 = _map_maintenance(
                self.state.map, self.state.prev_map_id,
                self.kf_store.obs_pid, self._maint_min_free,
            )
            if self.mesh is not None:
                # compaction re-lays the point axis; re-pin the sharding so
                # subsequent steps keep the map split across the mesh
                m2 = self._shard_map(m2)
            self.state = self.state.replace(map=m2, prev_map_id=pid2)
            self.kf_store = self.kf_store.replace(
                obs_pid=obs2, obs_mask=self.kf_store.obs_mask & (obs2 >= 0)
            )
            self.maintenance_runs += 1
            ran_maintenance = True
            self.metrics.log(kind="map_maintenance", frame=self.frame_idx,
                             size_before=before, size_after=int(m2.size))

        info = {
            "kind": "frame",
            "frame": self.frame_idx,
            "num_matches": int(out.num_matches),
            "num_inliers": int(out.num_inliers),
            "num_associated": int(out.num_associated),
            "num_tracked_map": int(out.num_tracked_map),
            "num_tracked_prov": int(out.num_tracked_prov),
            "num_pnp_inliers": int(out.num_pnp_inliers),
            "num_refined": int(out.num_refined),
            "num_promoted": int(out.num_promoted),
            "num_new_points": int(out.num_new_points),
            "num_dropped_inserts": int(out.num_dropped_inserts),
            "map_size": int(out.map_size),
            "map_alive": int(out.map_alive),
            "scale": float(out.scale),
            "success": bool(out.success),
            "keyframe": bool(is_kf),
            "ran_ba": ran_ba,
            "ran_maintenance": ran_maintenance,
            "wall_s": time.perf_counter() - t0,
        }
        self.metrics.log(**info)
        self.frame_idx += 1
        return info

    # ------------------------------------------------------------------
    def process_chunk(self, inputs, render_fn=None) -> Dict:
        """Feed T frames as ONE device-resident program (pipeline/
        scan_driver.py): tracking, keyframe decisions + ring insertion,
        and map maintenance all run inside a single ``lax.scan``; only
        per-frame scalars come back to the host (one transfer per chunk).

        ``inputs``: (T, H, W) stacked frames, or with ``render_fn`` a
        (T,)-leading pytree of renderer inputs (e.g. ground-truth poses
        for the on-device synthetic renderer — zero per-frame transfer).

        Window BA fires at chunk boundaries; with the chunk length
        aligned to keyframe_every * local_ba_every the events land on
        exactly the frames the per-frame driver would pick, and the two
        drivers' trajectories agree (tests/test_scan_driver.py).
        Unsupported with a sharded-map mesh (the per-frame path covers
        that mode).
        """
        from . import scan_driver
        assert self.mesh is None, "chunked driver: single-device map only"
        t0 = time.perf_counter()
        if self.state is None:
            first = render_fn(jax.tree.map(lambda x: x[0], inputs)) \
                if render_fn is not None else inputs[0]
            self.state = tracker.bootstrap(
                jnp.asarray(first, jnp.float32), self.cfg, seed=self._seed)
            self.trajectory.append(np.eye(4, dtype=np.float32))
            self.metrics.log(kind="frame", frame=0, bootstrap=True,
                             wall_s=time.perf_counter() - t0)
            self.frame_idx = 1
            inputs = jax.tree.map(lambda x: x[1:], inputs)
            if jax.tree.leaves(inputs)[0].shape[0] == 0:
                return {"frames": 1}

        self.state, self.kf_store, sc = scan_driver.run_chunk(
            self.state, self.kf_store, inputs, self.cfg,
            self._maint_high_water, self._maint_min_free,
            render_fn=render_fn)
        sc = jax.device_get(sc)          # one bulk transfer per chunk
        T = int(sc.pose.shape[0])
        for i in range(T):
            self.trajectory.append(np.asarray(sc.pose[i]))
            self.metrics.log(
                kind="frame", frame=self.frame_idx,
                num_matches=int(sc.num_matches[i]),
                num_inliers=int(sc.num_inliers[i]),
                num_associated=int(sc.num_associated[i]),
                num_tracked_map=int(sc.num_tracked_map[i]),
                num_tracked_prov=int(sc.num_tracked_prov[i]),
                num_pnp_inliers=int(sc.num_pnp_inliers[i]),
                num_refined=int(sc.num_refined[i]),
                num_promoted=int(sc.num_promoted[i]),
                num_new_points=int(sc.num_new_points[i]),
                num_dropped_inserts=int(sc.num_dropped_inserts[i]),
                map_size=int(sc.map_size[i]),
                map_alive=int(sc.map_alive[i]),
                scale=float(sc.scale[i]),
                success=bool(sc.success[i]),
                keyframe=bool(sc.is_keyframe[i]),
                ran_ba=False,
                ran_maintenance=bool(sc.ran_maintenance[i]),
            )
            self.frame_idx += 1
        self.dropped_inserts_total += int(sc.num_dropped_inserts.sum())
        self.maintenance_runs += int(sc.ran_maintenance.sum())
        n_new_kf = int(sc.is_keyframe.sum())
        kf_before = self._kf_count
        self._kf_count += n_new_kf
        ran_ba = False
        if (self.enable_ba and self._kf_count >= 3
                and (self._kf_count // self.cfg.pipeline.local_ba_every
                     > max(kf_before, 2)
                     // self.cfg.pipeline.local_ba_every)):
            ran_ba = True
            self._run_window_ba()
        info = {"frames": T, "ran_ba": ran_ba,
                "wall_s": time.perf_counter() - t0}
        return info

    # ------------------------------------------------------------------
    def _shard_map(self, m):
        from ..parallel import sharded_map
        return sharded_map.shard_map_state(self.mesh, self._map_axis, m)

    # ------------------------------------------------------------------
    @staticmethod
    def _pin_window_gauge(wp, solved):
        """Divide out the scale factor window BA applied to the free
        cameras (see _run_window_ba). Host-side numpy; returns a corrected
        BAProblem with free-camera centers and landmarks rescaled about the
        newest anchored camera's center. Rotations are untouched."""
        import jax.numpy as jnp

        valid = np.asarray(wp.win_valid)
        fixed = np.asarray(wp.problem.cam_fixed)
        free = valid & ~fixed
        if free.sum() == 0 or (valid & fixed).sum() == 0:
            return solved, 1.0
        # Is the scale direction actually observed? Count anchored-camera
        # observations of landmarks that FREE cameras also observe: those
        # are the constraints that tie the free sub-window's scale to the
        # fixed gauge. With a healthy bridge the solver's scale moves are
        # signal — pinning them away was measured to WORSEN keyframe ATE
        # (0.097 -> 0.159 on the 24-frame window-BA test scene). The
        # ratchet this projection exists for lives in the exploration
        # regime, where landmarks leave the view within a keyframe gap and
        # the bridge is a handful of observations.
        obs_cam = np.asarray(wp.problem.obs_cam)
        obs_mask = np.asarray(wp.problem.obs_mask)
        pmask = np.asarray(wp.problem.point_mask)
        obs_fixed = fixed[obs_cam] & obs_mask
        obs_free = (~fixed[obs_cam]) & obs_mask
        bridging = obs_fixed.any(axis=1) & obs_free.any(axis=1) & pmask
        # Only NON-PROVISIONAL bridging landmarks certify the scale
        # direction as observed: a provisional landmark's init is a
        # low-parallax depth whose error IS in the scale direction, so
        # bridges through it tie the free sub-window to noise, not to the
        # gauge (measured: provisional-rich windows passed the old count,
        # events were accepted, and the re-anchored scale ratcheted —
        # ATE 21 at a 2-keyframe BA cadence on the 150-frame corridor).
        solid = bridging & ~np.asarray(wp.sel_prov)
        if int(obs_fixed[solid].sum()) >= 30:
            return solved, 1.0
        T_cw_old = np.asarray(wp.problem.T_cw)
        T_cw_new = np.asarray(solved.T_cw)
        C_old = -np.einsum("wji,wj->wi", T_cw_old[:, :3, :3],
                           T_cw_old[:, :3, 3])
        C_new = -np.einsum("wji,wj->wi", T_cw_new[:, :3, :3],
                           T_cw_new[:, :3, 3])
        # scale factor = median baseline ratio over consecutive valid pairs
        # whose LATER camera is free (the section BA could move)
        idx = np.where(valid)[0]
        ratios = []
        for a, b in zip(idx[:-1], idx[1:]):
            if not free[b]:
                continue
            d_old = np.linalg.norm(C_old[b] - C_old[a])
            d_new = np.linalg.norm(C_new[b] - C_new[a])
            if d_old > 1e-6 and d_new > 1e-6:
                ratios.append(d_new / d_old)
        if not ratios:
            return solved, 1.0
        s = float(np.median(ratios))
        # Engage only beyond 2%: small factors are legitimate refinement
        # (scale IS partially observed through anchored-cam observations);
        # re-scaling them out was measured to WORSEN keyframe ATE on short
        # well-conditioned runs. The ratchet this guard exists for moves
        # 5-30% per event.
        if not np.isfinite(s) or not (0.2 < s < 5.0) or abs(s - 1.0) < 0.02:
            return solved, s
        # pivot at the newest anchored valid camera (BA cannot have moved it)
        anch = np.where(valid & fixed)[0]
        pivot = C_new[anch[-1]]
        C_fix = pivot[None] + (C_new - pivot[None]) / s
        R = T_cw_new[:, :3, :3]
        t_fix = -np.einsum("wij,wj->wi", R, C_fix)
        T_out = T_cw_new.copy()
        T_out[free, :3, 3] = t_fix[free]
        # Rescale ONLY landmarks observed by free cameras (ADVICE r03):
        # landmarks seen exclusively by anchored cameras were solved
        # against unmoved poses — dividing them by s would make them
        # inconsistent with those cameras, and accepted events write the
        # corrupted rows back to the live map.
        X = np.asarray(solved.points)
        pt_free = obs_free.any(axis=1) & pmask
        X_fix = np.where(pt_free[:, None],
                         pivot[None] + (X - pivot[None]) / s, X)
        return solved.replace(T_cw=jnp.asarray(T_out),
                              points=jnp.asarray(X_fix)), s

    # ------------------------------------------------------------------
    @staticmethod
    def _window_starved(wp) -> tuple:
        """Observation-starvation guard: a window whose free cameras carry
        almost no live observations is (near-)unconstrained — the solver
        can move cameras freely at ~zero cost, the trust-region baseline
        is itself junk, and an accepted wander write-back poisons the
        pose chain (measured: scale 1 -> 150 by frame 114 on a sparse
        corridor, ending in non-finite poses). Returns
        (starved, n_obs_free, n_free); tests/test_guards.py constructs
        the pathology directly.

        Counts observations made BY FREE CAMERAS — anchored-camera
        observations constrain nothing the solver can move, so a window
        whose free cameras are empty must be starved however many
        observations its anchors carry."""
        fixed = np.asarray(wp.problem.cam_fixed)
        obs_free_cam = ~fixed[np.asarray(wp.problem.obs_cam)]
        n_obs = int(np.asarray(
            (np.asarray(wp.problem.obs_mask) & obs_free_cam
             & np.asarray(wp.problem.point_mask)[:, None]).sum()))
        n_free = int(np.asarray(
            (wp.win_valid & ~np.asarray(wp.problem.cam_fixed)).sum()))
        return n_obs < 8 * max(n_free, 1), n_obs, n_free

    @staticmethod
    def _ba_event_accepted(wp, solved) -> tuple:
        """Trust region on the whole (re-gauged) BA outcome: a window
        camera moving further than half its inter-keyframe baseline is
        correction noise, not refinement — reject the event, keep
        tracking's state. Returns (accepted, max_move, median_baseline);
        tests/test_guards.py constructs both branches directly.

        Motion is measured between camera CENTERS (C = -R^T t), not the
        T_cw translation columns: t = -R*C couples rotation and position,
        so a milliradian rotation refinement of a camera far from the
        world origin changes t by ~|C|*dtheta while the camera barely
        moves — a ||dt|| trust region would reject every late-run event
        of a long outbound trajectory."""
        T_old = np.asarray(wp.problem.T_cw)
        T_new = np.asarray(solved.T_cw)
        C_old = -np.einsum("wji,wj->wi", T_old[:, :3, :3], T_old[:, :3, 3])
        C_new = -np.einsum("wji,wj->wi", T_new[:, :3, :3], T_new[:, :3, 3])
        valid = np.asarray(wp.win_valid)
        move = np.linalg.norm(C_new - C_old, axis=1)[valid]
        steps = np.linalg.norm(np.diff(C_old[valid], axis=0), axis=1)
        baseline = float(np.median(steps)) if len(steps) else 1.0
        max_move = float(move.max()) if len(move) else 0.0
        # CORRECTION DEADBAND (round-5): also reject events whose
        # correction is below 8% of the inter-keyframe baseline. A window
        # solve always finds SOME sub-noise-floor adjustment, but a
        # partial write-back (the problem caps landmarks at max_points,
        # and anchors outside the window are untouched) moves only the
        # in-window subset of the map — bifurcating it into two
        # micro-frames no single pose can fit. Measured on the dense-box
        # revisit: each accepted micro-event (moves 0.06-0.19x baseline)
        # collapsed the subsequent PnP inlier count 54 -> 6 over the next
        # 8 frames and the run's ATE went 0.17 -> 0.72; with the
        # deadband, micro-polish is rejected and BA fires only on
        # corrections that exceed the bifurcation cost.
        return (max(0.08 * baseline, 1e-3) <= max_move
                <= max(0.5 * baseline, 1e-3)), max_move, baseline

    # ------------------------------------------------------------------
    def _refine_structure(self):
        """Structure-only window refinement (BAConfig.structure_every).

        Builds the same sliding-window problem as window BA but with EVERY
        camera fixed (free_tail=0), so the LM solve reduces to batched
        multi-view triangulation of the window's landmarks against the
        tracked keyframe poses — the whole keyframe baseline, not the
        minimal parallax of a single track segment. Poses are untouched
        (no gauge, no T_corr, trajectory provably unaffected); only
        PROVISIONAL landmark positions are written back, and those solved
        with >= 3 surviving observations whose rays span the full
        min_parallax_deg are PROMOTED to PnP anchors
        (MapState.prov semantics)."""
        import dataclasses
        cfg = self.cfg
        ba_cfg = dataclasses.replace(cfg.ba, iterations=6)
        wp = keyframes.build_window_problem(
            self.kf_store, self.state.map, cfg.replace(ba=ba_cfg),
            free_tail=0, prov_min_obs=2,
        )
        solved, stats = ba.solve_robust(
            wp.problem, self._K, ba_cfg, reject_px=3.0, rounds=2)
        # Promotion span bars tied to the GEOMETRIC promote bar (half of
        # it for 3+-obs landmarks, the full bar for 2-obs ones via the
        # doubled gate in apply_structure_result) — NOT to the much lower
        # insertion bar: on an observation-dense scene the window is full
        # of far landmarks with many obs but tiny ray spans, and
        # promoting at the 2 deg insertion bar flooded PnP with weak
        # anchors whose aggregate weight outvoted the strong ones
        # (measured on the dense-box revisit: ATE 0.17 -> 1.19 from
        # structure refinement alone at the 2 deg bar).
        new_map, n_promoted = keyframes.apply_structure_result(
            self.state.map, wp, solved,
            jnp.deg2rad(0.5 * cfg.triangulation.promote_parallax_deg))
        if self.mesh is not None:
            new_map = self._shard_map(new_map)
        self.state = self.state.replace(map=new_map)
        self.metrics.log(kind="structure_refine", frame=self.frame_idx,
                         initial_cost=float(stats.initial_cost),
                         final_cost=float(stats.final_cost),
                         promoted=int(n_promoted))

    # ------------------------------------------------------------------
    def _run_window_ba(self):
        # prov_min_obs=99: provisional landmarks are EXCLUDED from the
        # pose-moving window solve. Their biased low-parallax inits pull
        # the free cameras' weakly observable scale direction (measured:
        # with them included, every accepted event re-gauged scale 0.89-
        # 0.97 and the corridor ATE tripled vs structure-refine alone);
        # estimating them is _refine_structure's job, and they enter this
        # problem only after promotion.
        wp = keyframes.build_window_problem(
            self.kf_store, self.state.map, self.cfg,
            free_tail=self.cfg.ba.free_cams, prov_min_obs=99,
        )
        # All pre-solve gate statistics in ONE device fetch (the numpy
        # guards each pulled observation arrays to the host).
        n_obs, n_free, deep_obs, solid_obs = (
            int(x) for x in jax.device_get(
                _window_gate_stats(wp.problem, wp.sel_prov)))
        # starvation guard: a window whose FREE cameras carry almost no
        # live observations is (near-)unconstrained (see _window_starved,
        # kept for the direct pathology tests)
        if n_obs < 8 * max(n_free, 1):
            self.metrics.log(kind="ba", frame=self.frame_idx,
                             skipped="starved", n_obs=n_obs, n_free=n_free,
                             ba_result_accepted=False)
            return
        # EXPLORATION GATE (the round-5 scale-aware acceptance): a
        # pose-moving solve is only worth running when the window carries
        # DEEP revisit evidence — solid (non-provisional) landmarks
        # observed by >= 2 anchored AND >= 1 free camera. Those
        # observations are what tie the free cameras' scale to the past
        # gauge; without them the solve can only redistribute the young
        # observations' noise, and accepted exploration events were
        # measured to COMPOUND it (600-frame corridor: ATE 0.47 -> 18.6
        # with 22 accepted events; per-event kfATE deltas individually
        # small). Measured separation on the two regimes: corridor
        # deep_obs 4-99 per window vs dense-revisit 195-523 — the 120 bar
        # sits between with clear margin on both sides.
        if deep_obs < 120:
            self.metrics.log(kind="ba", frame=self.frame_idx,
                             skipped="shallow", deep_obs=deep_obs,
                             ba_result_accepted=False)
            return
        solved, stats = ba.solve_robust(
            wp.problem, self._K, self.cfg.ba, reject_px=5.0, rounds=2
        )
        # Monocular gauge pinning. During pure exploration most window
        # landmarks are seen ONLY by the free (newest) cameras, so the
        # anchored cameras barely constrain the similarity gauge's scale
        # direction: each solve can slide the free sub-window slightly
        # along it at near-zero cost, tracking then conforms to the moved
        # landmarks (PnP), and the slide RATCHETS event over event
        # (measured on the 200-frame corridor: steps 0.9 -> 287 by frame
        # 100 with BA on, dead flat with BA off). Project the slide out
        # explicitly: divide the solved free-section baselines by the scale
        # factor BA applied to them, pivoting at the newest anchored
        # camera, which BA cannot move. Where scale IS well observed the
        # measured factor is ~1 and this is a no-op.
        solved, gauge_s = self._pin_window_gauge(wp, solved)
        ba_accepted, max_move, baseline = self._ba_event_accepted(wp, solved)
        s_corr = 1.0
        if ba_accepted:
            self.kf_store, new_map, T_corr = keyframes.apply_window_result(
                self.kf_store, self.state.map, wp, solved
            )
            if self.mesh is not None:
                new_map = self._shard_map(new_map)
            # RE-GAUGE THE MOTION MODEL: the scale factor BA applied to the
            # newest keyframe gap is an absolute measurement of the
            # tracker's current scale error, tied through the window's
            # anchored cameras to the past gauge. Propagating it into
            # state.vel / state.scale is the restoring force that arrests
            # the slow multiplicative contraction of map-anchored
            # tracking: without it, BA corrected keyframe POSES while the
            # velocity state kept its drifted scale, the drift resumed
            # immediately, and the loop collapsed anyway (measured on the
            # 150-frame corridor at a 2-keyframe BA cadence: committed
            # step scale 1.63 -> 0.18, ATE 21, with every pre-collapse
            # event individually net-positive).
            T_old = np.asarray(wp.problem.T_cw)
            T_new = np.asarray(solved.T_cw)
            C_old = -np.einsum("wji,wj->wi", T_old[:, :3, :3],
                               T_old[:, :3, 3])
            C_new = -np.einsum("wji,wj->wi", T_new[:, :3, :3],
                               T_new[:, :3, 3])
            # Only a window whose scale direction is genuinely observed —
            # >= 30 anchored-camera observations of NON-provisional
            # bridging landmarks (same bar as the gauge-pin test) — may
            # re-gauge the tracker's scale (solid_obs comes from the
            # single pre-solve gate fetch). Exploration windows, whose
            # solve can only ratify the young observations' drift
            # (measured: s_corr 0.89-0.97 every event during a scale
            # collapse), leave the motion model alone.
            idx = np.where(np.asarray(wp.win_valid))[0]
            if (self.cfg.ba.rescale_motion_model and solid_obs >= 30
                    and len(idx) >= 2):
                a, b = idx[-2], idx[-1]
                g_old = float(np.linalg.norm(C_old[b] - C_old[a]))
                g_new = float(np.linalg.norm(C_new[b] - C_new[a]))
                if g_old > 1e-6 and g_new > 1e-6:
                    s_corr = float(np.clip(g_new / g_old, 0.5, 2.0))
            vel = np.asarray(self.state.vel).copy()
            vel[:3, 3] *= s_corr
            self.state = self.state.replace(
                map=new_map, pose=T_corr @ self.state.pose,
                vel=jnp.asarray(vel),
                scale=jnp.asarray(float(self.state.scale) * s_corr,
                                  jnp.float32),
            )
        self.last_ba_stats = stats
        self.metrics.log(
            kind="ba",
            frame=self.frame_idx,
            initial_cost=float(stats.initial_cost),
            final_cost=float(stats.final_cost),
            accepted=int(np.asarray(stats.accepted).sum()),
            ba_result_accepted=ba_accepted,
            max_cam_move=max_move,
            median_baseline=baseline,
            gauge_s=gauge_s,
            scale_corr=s_corr,
            dropped_points=int(wp.n_dropped_points),
            dropped_obs=int(wp.n_dropped_obs),
            evicted_keyframes=int(wp.n_evicted_keyframes),
        )

    # ------------------------------------------------------------------
    def run_global_ba(self, mesh=None, axis_name: str = "map",
                      iterations: Optional[int] = None,
                      reject_px: float = 2.0, huber_delta: float = 1.5):
        """Global BA over every retained keyframe (vs the sliding window).

        Defaults are tighter than window BA (reject 2 px, Huber 1.5): over a
        full sequence the ~1% gross-outlier association tail systematically
        bends the trajectory unless rejected hard (measured: ATE 0.15 with
        5 px rejection vs 0.03 with 2 px on the 24-frame synthetic run).

        The problem is SIZED TO THE SEQUENCE, not to the sliding-window
        caps: landmark count and obs-slot depth are computed from the
        keyframe store on the host (rounded up to shape buckets so compile
        caches hit) so that a full run optimizes with ZERO truncation —
        wp.n_dropped_points == wp.n_dropped_obs == 0, logged below. The
        Schur assembly stays one-hot (matmuls) up to 256 cameras and falls
        back to scatter-add beyond that memory ceiling
        (BAConfig.schur_assembly="auto").

        With a mesh, runs the landmark-sharded distributed solver
        (parallel/sharded_ba.py).
        """
        import dataclasses
        cfg = self.cfg
        # ---- host-side sizing from the actual observation graph ----------
        pid = np.asarray(self.kf_store.obs_pid)
        msk = np.asarray(self.kf_store.obs_mask) \
            & (np.asarray(self.kf_store.kf_order) >= 0)[:, None]
        live = pid[msk & (pid >= 0)]
        if live.size:
            n_unique = int(np.unique(live).size)
            max_obs = int(np.bincount(live).max())
        else:
            n_unique, max_obs = 1, 2
        bucket = lambda n, q: int(-(-max(n, 1) // q) * q)
        P = min(bucket(n_unique, 1024), int(self.state.map.capacity))
        Kslots = bucket(max_obs, 8)
        ba_cfg = dataclasses.replace(
            cfg.ba,
            iterations=iterations or cfg.ba.iterations,
            huber_delta=huber_delta,
            max_obs_per_point=Kslots,
        )
        wp = keyframes.build_window_problem(
            self.kf_store, self.state.map, cfg.replace(ba=ba_cfg),
            window=self.kf_store.ring_size, max_points=P,
        )
        if mesh is not None:
            from ..parallel import sharded_ba
            # rejection round on host, then the sharded solve
            p, _ = ba.solve_robust(wp.problem, self._K, ba_cfg,
                                   reject_px=reject_px, rounds=2)
            solved, stats = sharded_ba.solve_sharded(
                mesh, axis_name, p, self._K, ba_cfg
            )
        else:
            solved, stats = ba.solve_robust(
                wp.problem, self._K, ba_cfg, reject_px=reject_px, rounds=3
            )
        self.kf_store, new_map, T_corr = keyframes.apply_window_result(
            self.kf_store, self.state.map, wp, solved
        )
        if self.mesh is not None:
            new_map = self._shard_map(new_map)
        self.state = self.state.replace(
            map=new_map, pose=T_corr @ self.state.pose
        )
        self.last_ba_stats = stats
        self.last_global_ba_coverage = {
            "max_points": P,
            "obs_slots": Kslots,
            "unique_landmarks": n_unique,
            "dropped_points": int(wp.n_dropped_points),
            "dropped_obs": int(wp.n_dropped_obs),
            "evicted_keyframes": int(wp.n_evicted_keyframes),
        }
        self.metrics.log(kind="global_ba",
                         initial_cost=float(stats.initial_cost),
                         final_cost=float(stats.final_cost),
                         **self.last_global_ba_coverage)
        return stats

    # ------------------------------------------------------------------
    def poses(self) -> np.ndarray:
        """(F, 4, 4) per-frame T_wc trajectory (odometry output)."""
        return np.stack(self.trajectory)

    def keyframe_poses(self) -> np.ndarray:
        """(Nkf, 4, 4) optimized keyframe poses, ordered by keyframe number."""
        order = np.asarray(self.kf_store.kf_order)
        sel = order >= 0
        idx = np.argsort(order[sel])
        return np.asarray(self.kf_store.poses)[sel][idx]

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Immutable map/trajectory snapshot for visualization/export
        (replaces the reference's mutex-guarded DisplayState handoff)."""
        m = self.state.map
        size = int(m.size)
        alive = np.asarray(m.alive)[:size]
        return {
            "points": np.asarray(m.xyz)[:size][alive],
            "colors": np.asarray(m.color)[:size][alive],
            "poses": self.poses(),
            "keyframe_poses": self.keyframe_poses(),
        }
