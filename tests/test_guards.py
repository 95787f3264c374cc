"""Dedicated regression tests for the round-3 stability guards.

VERDICT r03 weak #4: each guard was justified by one measured incident on
one synthetic corridor, with no unit test constructing its pathological
condition — a retune of any constant was unfalsifiable. Each test here
builds the pathology DIRECTLY (hand-built problems/states, no long runs)
and fails if its guard's constant is disabled or materially loosened.

Guards under test (constants in parentheses):
  (a) monocular gauge pinning      (bridge >= 30 obs, 2% engage band)
      pipeline/slam.py::SLAMSystem._pin_window_gauge
  (b) observation-starvation skip  (8x free-camera obs floor)
      pipeline/slam.py::SLAMSystem._window_starved
  (c) PnP commit trust region      (2x motion-model step bound)
      pipeline/tracker.py::pnp_commit_ok
  (d) BA-event trust region        (0.5x median-baseline move bound)
      pipeline/slam.py::SLAMSystem._ba_event_accepted
  (e) track-identity gate          (56-bit first-obs Hamming bound)
      pipeline/tracker.py step 8 (black-box through track_step)
"""
import numpy as np
import jax
import jax.numpy as jnp

from vslam_jax.config import small_config
from vslam_jax.datasets import synthetic
from vslam_jax.optimizer.ba import BAProblem
from vslam_jax.pipeline import tracker
from vslam_jax.pipeline.keyframes import WindowProblem
from vslam_jax.pipeline.slam import SLAMSystem

CFG = small_config()


# ---------------------------------------------------------------------------
# hand-built window problems for (a), (b), (d)
# ---------------------------------------------------------------------------
def _window(n_cams=6, n_free=2, n_pts=64, k_obs=4,
            bridge_obs=0, free_only_pts=None):
    """A straight-line window: camera i at (0, 0, i), identity rotations.

    ``bridge_obs``: number of observations of free-AND-fixed-observed
    landmarks made by FIXED cameras (the gauge-pinning bridge strength).
    ``free_only_pts``: landmarks observed only by free cameras (default:
    the rest).
    """
    C = n_cams
    T_cw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    for i in range(C):
        T_cw[i, :3, 3] = [0, 0, -float(i)]   # R=I -> t = -C_center
    cam_fixed = np.zeros(C, bool)
    cam_fixed[: C - n_free] = True

    obs_cam = np.zeros((n_pts, k_obs), np.int32)
    obs_mask = np.zeros((n_pts, k_obs), bool)
    # bridge landmarks: observed by the newest fixed cam AND a free cam
    n_bridge = max(bridge_obs, 0)
    for p in range(n_bridge):
        obs_cam[p, 0] = C - n_free - 1       # newest fixed
        obs_cam[p, 1] = C - 1                # newest free
        obs_mask[p, :2] = True
    # remaining landmarks: free cameras only
    for p in range(n_bridge, n_pts):
        obs_cam[p, 0] = C - n_free
        obs_cam[p, 1] = C - 1
        obs_mask[p, :2] = True

    points = np.zeros((n_pts, 3), np.float32)
    points[:, 2] = np.linspace(5.0, 20.0, n_pts)
    problem = BAProblem(
        T_cw=jnp.asarray(T_cw),
        cam_fixed=jnp.asarray(cam_fixed),
        cam_mask=jnp.ones(C, bool),
        points=jnp.asarray(points),
        point_mask=jnp.ones(n_pts, bool),
        obs_cam=jnp.asarray(obs_cam),
        obs_uv=jnp.zeros((n_pts, k_obs, 2), jnp.float32),
        obs_mask=jnp.asarray(obs_mask),
    )
    return WindowProblem(
        problem=problem,
        win_slots=jnp.arange(C, dtype=jnp.int32),
        win_valid=jnp.ones(C, bool),
        sel_pid=jnp.arange(n_pts, dtype=jnp.int32),
        sel_prov=jnp.zeros(n_pts, bool),
        n_dropped_points=jnp.zeros((), jnp.int32),
        n_dropped_obs=jnp.zeros((), jnp.int32),
        n_evicted_keyframes=jnp.zeros((), jnp.int32),
    )


def _scaled_solution(wp, s):
    """A solved window whose FREE section baselines were stretched by s
    (the gauge-slide ratchet's signature), landmarks moved with them."""
    T = np.asarray(wp.problem.T_cw).copy()
    fixed = np.asarray(wp.problem.cam_fixed)
    C_cent = -np.einsum("wji,wj->wi", T[:, :3, :3], T[:, :3, 3])
    pivot = C_cent[np.where(fixed)[0][-1]]
    C_new = C_cent.copy()
    for i in range(len(T)):
        if not fixed[i]:
            C_new[i] = pivot + s * (C_cent[i] - pivot)
    T[:, :3, 3] = -np.einsum("wij,wj->wi", T[:, :3, :3], C_new)
    X = np.asarray(wp.problem.points)
    X_new = pivot[None] + s * (X - pivot[None])
    return wp.problem.replace(T_cw=jnp.asarray(T),
                              points=jnp.asarray(X_new)), pivot


# ---------------------------------------------------------------------------
# (a) gauge pinning
# ---------------------------------------------------------------------------
class TestGaugePinning:
    def test_engages_on_starved_bridge(self):
        """A window whose fixed->free bridge is a handful of observations
        and whose free section slid 1.5x must be re-gauged: free camera
        baselines restored, landmarks rescaled about the pivot."""
        wp = _window(bridge_obs=5)            # 10 bridge obs < 30 floor
        solved, pivot = _scaled_solution(wp, 1.5)
        out, s = SLAMSystem._pin_window_gauge(wp, solved)
        assert abs(s - 1.5) < 0.05, s
        # free-camera centers restored to the pre-slide baselines
        np.testing.assert_allclose(np.asarray(out.T_cw),
                                   np.asarray(wp.problem.T_cw), atol=1e-4)
        # landmarks (all free-observed here) rescaled back about the pivot
        np.testing.assert_allclose(np.asarray(out.points),
                                   np.asarray(wp.problem.points), atol=1e-3)

    def test_noop_on_healthy_bridge(self):
        """>= 30 bridge observations: scale IS observed — the measured
        factor is treated as signal and the solution passes through."""
        wp = _window(bridge_obs=40)           # 80 bridge obs >= 30 floor
        solved, _ = _scaled_solution(wp, 1.5)
        out, s = SLAMSystem._pin_window_gauge(wp, solved)
        assert s == 1.0
        np.testing.assert_array_equal(np.asarray(out.T_cw),
                                      np.asarray(solved.T_cw))

    def test_noop_inside_engage_band(self):
        """A 1% slide is legitimate refinement (2% engage band)."""
        wp = _window(bridge_obs=5)
        solved, _ = _scaled_solution(wp, 1.01)
        out, s = SLAMSystem._pin_window_gauge(wp, solved)
        np.testing.assert_array_equal(np.asarray(out.T_cw),
                                      np.asarray(solved.T_cw))

    def test_anchored_only_landmarks_not_rescaled(self):
        """ADVICE r03: landmarks observed ONLY by anchored cameras were
        solved against unmoved poses — the 1/s rescale must not touch
        them (it would desynchronize them from their cameras and the
        corruption is written back to the live map on accept)."""
        wp = _window(bridge_obs=5)
        # rewire the last 16 landmarks to fixed-only observations
        obs_cam = np.asarray(wp.problem.obs_cam).copy()
        obs_cam[-16:, 0] = 0
        obs_cam[-16:, 1] = 1
        wp = wp._replace(problem=wp.problem.replace(
            obs_cam=jnp.asarray(obs_cam)))
        solved, _ = _scaled_solution(wp, 1.5)
        out, s = SLAMSystem._pin_window_gauge(wp, solved)
        assert abs(s - 1.5) < 0.05, s
        # fixed-only landmarks keep the SOLVED coordinates
        np.testing.assert_array_equal(np.asarray(out.points)[-16:],
                                      np.asarray(solved.points)[-16:])
        # free-observed landmarks are rescaled
        assert not np.allclose(np.asarray(out.points)[:5],
                               np.asarray(solved.points)[:5])


# ---------------------------------------------------------------------------
# (b) observation starvation
# ---------------------------------------------------------------------------
class TestStarvationSkip:
    def test_fires_on_near_empty_window(self):
        wp = _window(n_pts=64)
        # keep only 10 live observations for 2 free cams: 10 < 8*2
        mask = np.zeros_like(np.asarray(wp.problem.obs_mask))
        mask[:5, :2] = True
        wp = wp._replace(problem=wp.problem.replace(
            obs_mask=jnp.asarray(mask)))
        starved, n_obs, n_free = SLAMSystem._window_starved(wp)
        assert starved and n_obs == 10 and n_free == 2

    def test_quiet_on_healthy_window(self):
        wp = _window(n_pts=64)                # 128 obs >= 8*2
        starved, n_obs, n_free = SLAMSystem._window_starved(wp)
        assert not starved and n_obs == 128


# ---------------------------------------------------------------------------
# (c) PnP commit trust region
# ---------------------------------------------------------------------------
class TestPnPTrustRegion:
    def _commit(self, step, scale, pose_ok=True, n_inl=100, rmse=0.1):
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = step                         # forward slide
        return bool(tracker.pnp_commit_ok(
            jnp.eye(4), jnp.asarray(T), jnp.asarray(scale, jnp.float32),
            jnp.asarray(pose_ok), jnp.asarray(n_inl, jnp.int32),
            jnp.asarray(rmse, jnp.float32), CFG.ransac.min_inliers))

    def test_rejects_runaway_step(self):
        """The measured incident: a 1.8 -> 4.6-unit slide on borderline
        supports. 4.6 > 2 x 1.8 must be rejected however many inliers
        the refine claims."""
        assert not self._commit(step=4.6, scale=1.8)

    def test_accepts_sane_step(self):
        assert self._commit(step=1.5, scale=1.8)

    def test_reloc_needs_convergence(self):
        """pose_ok=False (blackout reacquire): 8 genuine supports with a
        sub-1.5px fit re-anchor; a non-converged fit must not."""
        assert self._commit(step=0.5, scale=1.0, pose_ok=False,
                            n_inl=8, rmse=0.8)
        assert not self._commit(step=0.5, scale=1.0, pose_ok=False,
                                n_inl=8, rmse=2.5)
        assert not self._commit(step=0.5, scale=1.0, pose_ok=False,
                                n_inl=5, rmse=0.8)


# ---------------------------------------------------------------------------
# (d) BA-event trust region
# ---------------------------------------------------------------------------
class TestBAEventTrustRegion:
    def test_rejects_half_baseline_move(self):
        wp = _window()                        # baselines = 1.0
        T = np.asarray(wp.problem.T_cw).copy()
        T[-1, 2, 3] -= 0.6                    # one camera moves 0.6 > 0.5
        solved = wp.problem.replace(T_cw=jnp.asarray(T))
        ok, max_move, baseline = SLAMSystem._ba_event_accepted(wp, solved)
        assert not ok and abs(max_move - 0.6) < 1e-5 and baseline == 1.0

    def test_accepts_small_correction(self):
        wp = _window()
        T = np.asarray(wp.problem.T_cw).copy()
        T[-1, 2, 3] -= 0.3                    # 0.3 <= 0.5 x baseline
        solved = wp.problem.replace(T_cw=jnp.asarray(T))
        ok, _, _ = SLAMSystem._ba_event_accepted(wp, solved)
        assert ok


# ---------------------------------------------------------------------------
# (e) track-identity gate (black-box through track_step)
# ---------------------------------------------------------------------------
class TestTrackIdentityGate:
    def test_kills_drifted_tracks(self):
        """Flip ~128 descriptor bits of every pending track (far past the
        56-bit identity bound): the next step must insert NOTHING from
        those tracks (they are identity-dead) and re-anchor them at the
        current frame, while the uncorrupted control keeps inserting."""
        K = CFG.camera.K()
        W, H = CFG.camera.width, CFG.camera.height
        scene = synthetic.make_scene(num_points=600, seed=0,
                                     extent=(14, 6, 40), z_min=6.0)
        poses = synthetic.make_trajectory(6, step=0.6, seed=0)
        frames = synthetic.render_sequence(K, poses, scene, W, H)
        st = tracker.bootstrap(jnp.asarray(frames[0]), CFG)
        for i in range(1, 4):
            st, out = tracker.track_step(st, jnp.asarray(frames[i]), CFG)

        # control: the mature tracks insert on the next frame
        ctl, out_ctl = tracker.track_step(st, jnp.asarray(frames[4]), CFG)
        assert int(out_ctl.num_new_points) > 0, int(out_ctl.num_new_points)

        # corrupt every pending track's identity card
        rng = np.random.RandomState(3)
        flip = rng.randint(0, 2 ** 32, (1, 8), dtype=np.uint32) \
            & rng.randint(0, 2 ** 32, (1, 8), dtype=np.uint32)
        bad = st.replace(pend_desc=st.pend_desc ^ jnp.asarray(flip))
        cor, out_cor = tracker.track_step(bad, jnp.asarray(frames[4]), CFG)
        assert int(out_cor.num_new_points) == 0, int(out_cor.num_new_points)
        # drifted tracks re-anchored: their identity card is now the
        # CURRENT frame's descriptor (restart), not the corrupted one
        pv = np.asarray(cor.pend_valid)
        same = (np.asarray(cor.pend_desc)[pv]
                == np.asarray(cor.prev.desc)[pv]).all(axis=1)
        assert same.mean() > 0.95, same.mean()
