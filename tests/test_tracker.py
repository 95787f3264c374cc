"""End-to-end tracking tests on rendered synthetic sequences.

The analogue of the reference's (absent) integration tests: track a
rendered sequence with exact ground truth and bound the Sim(3)-aligned ATE
(SURVEY.md §4 'implications')."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vslam_jax.config import small_config
from vslam_jax.datasets import synthetic
from vslam_jax.pipeline import tracker
from vslam_jax.utils import evaluate

CFG = small_config()
K = CFG.camera.K()
W, H = CFG.camera.width, CFG.camera.height


def _track_sequence(num_frames=8, step=0.6, n_points=600, seed=0):
    scene = synthetic.make_scene(num_points=n_points, seed=seed,
                                 extent=(14, 6, 40), z_min=6.0)
    poses = synthetic.make_trajectory(num_frames, step=step, seed=seed)
    frames = synthetic.render_sequence(K, poses, scene, W, H)
    st = tracker.bootstrap(jnp.asarray(frames[0]), CFG)
    outs = []
    est = [np.eye(4, dtype=np.float32)]
    for i in range(1, num_frames):
        st, out = tracker.track_step(st, jnp.asarray(frames[i]), CFG)
        outs.append(out)
        est.append(np.asarray(out.pose))
    return np.stack(est), poses, outs, st


class TestTracker:
    def test_two_frame_pose(self):
        est, gt, outs, st = _track_sequence(num_frames=2)
        out = outs[0]
        assert bool(out.success)
        assert int(out.num_inliers) > 30, int(out.num_inliers)
        # Delayed triangulation: the first tracked pair mostly OPENS tracks
        # (insertion waits for parallax); the close, high-parallax subset may
        # insert immediately.
        assert int(st.pend_valid.sum()) > 30, int(st.pend_valid.sum())
        # relative pose direction vs ground truth
        rel_est = np.linalg.inv(est[0]) @ est[1]
        rel_gt = np.linalg.inv(gt[0]) @ gt[1]
        t_est = rel_est[:3, 3] / np.linalg.norm(rel_est[:3, 3])
        t_gt = rel_gt[:3, 3] / np.linalg.norm(rel_gt[:3, 3])
        ang = np.degrees(np.arccos(np.clip(np.dot(t_est, t_gt), -1, 1)))
        assert ang < 5.0, ang
        dR = rel_est[:3, :3].T @ rel_gt[:3, :3]
        rot_err = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert rot_err < 1.0, rot_err

    def test_sequence_ate(self):
        est, gt, outs, st = _track_sequence(num_frames=8)
        for o in outs:
            assert bool(o.success)
        rmse, _, _ = evaluate.ate_rmse(est, gt.astype(np.float64))
        # 8 frames, 0.5m steps -> ~3.5m path; sub-0.15m aligned ATE
        assert rmse < 0.15, rmse

    def test_map_reuse(self):
        est, gt, outs, st = _track_sequence(num_frames=6)
        # association + propagation should re-observe existing points
        reused = [int(o.num_associated) for o in outs]
        sizes = [int(o.map_size) for o in outs]
        # Delayed triangulation (tracker step 8): tracks insert only after
        # clearing the 2-deg parallax gate, so the first ~2 frames mostly
        # open tracks and steady-state insertion is ~10/frame at this
        # scene density (measured 47 after 6 frames; threshold leaves
        # headroom for RANSAC sampling jitter).
        assert sizes[-1] > 40, sizes
        # map grows but not by full match count every frame (points re-used)
        assert sizes[-1] < sum(int(o.num_matches) for o in outs)
        # scale stays near 1 on a ~constant-step trajectory
        scales = [float(o.scale) for o in outs]
        assert all(0.5 < s < 2.0 for s in scales[1:]), scales
