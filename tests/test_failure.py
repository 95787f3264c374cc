"""Failure injection (SURVEY.md §5 failure handling).

Two scenarios the reference cannot survive (it crashes on any unexpected
frame, reference src/Frame.cpp:56, and has no persistence at all):

  * hard kill mid-sequence DURING a window-BA cadence: a worker subprocess
    is SIGKILLed between periodic checkpoints; the parent resumes from the
    last complete checkpoint and must land bit-close to an uninterrupted run.
  * sensor dropout: a run of black frames mid-sequence. Tracking must report
    failure, extrapolate the pose with the constant-velocity motion model
    (TrackerState.vel), never NaN, re-acquire within a few frames after
    imagery returns (map-based relocalization, geometry/pnp.py), and drift
    strictly less than a hold-pose fallback would.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from vslam_jax.config import small_config
from vslam_jax.datasets import synthetic
from vslam_jax.pipeline import slam
from vslam_jax.utils import checkpoint

CFG = small_config()
K = CFG.camera.K()
W, H = CFG.camera.width, CFG.camera.height


def _frames(n, seed=4):
    scene = synthetic.make_scene(num_points=600, seed=seed, extent=(14, 6, 40),
                                 z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, seed=seed)
    return synthetic.render_sequence(K, poses, scene, W, H), poses


class TestKillResumeMidBA:
    """Checkpoint each frame, resume from one taken mid-BA-cadence.

    small_config: keyframe_every=2, local_ba_every=2, first BA at kf#4
    (frame 8) — frame 9's checkpoint sits between BA events, so the resumed
    run must re-enter the cadence correctly (next BA at frame 12).
    """

    def test_resume_mid_cadence_matches(self, tmp_path):
        frames, _ = _frames(16)
        full = slam.SLAMSystem(CFG, seed=7)
        full_ba_frames = [i for i in range(16)
                          if full.process(frames[i]).get("ran_ba")]
        assert full_ba_frames, "test premise: window BA must run"

        first = slam.SLAMSystem(CFG, seed=7)
        resume_at = full_ba_frames[0] + 1        # strictly between BA events
        for i in range(resume_at):
            first.process(frames[i])
        ckpt = str(tmp_path / "state")
        checkpoint.save_state(ckpt, first)
        del first                                 # "killed"

        resumed = slam.SLAMSystem(CFG, seed=7)
        checkpoint.load_state(ckpt, resumed)
        resumed_ba_frames = [i for i in range(resume_at, 16)
                             if resumed.process(frames[i]).get("ran_ba")]
        np.testing.assert_allclose(full.poses(), resumed.poses(), atol=1e-4)
        assert resumed_ba_frames == [f for f in full_ba_frames
                                     if f >= resume_at]

    @pytest.mark.slow
    def test_sigkill_worker_resume(self, tmp_path):
        """A real OS-level kill: the worker checkpoints every frame and is
        SIGKILLed mid-run; resuming from its last complete checkpoint must
        continue to the end with a sane trajectory."""
        worker = textwrap.dedent("""
            import sys, json
            import numpy as np
            import jax
            jax.config.update("jax_platforms", "cpu")
            sys.path.insert(0, sys.argv[1] + "/tests")
            from test_failure import _frames, CFG
            from vslam_jax.pipeline import slam
            from vslam_jax.utils import checkpoint
            frames, _ = _frames(16)
            s = slam.SLAMSystem(CFG, seed=7)
            for i in range(16):
                s.process(frames[i])
                checkpoint.save_state(sys.argv[2] + f"/ck_{i:03d}", s)
                print(f"CKPT {i}", flush=True)
        """)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
        p = subprocess.Popen(
            [sys.executable, "-c", worker, repo, str(tmp_path)],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        # wait until at least 5 checkpoints exist, then SIGKILL mid-flight
        seen = 0
        deadline = time.time() + 300
        while seen < 5 and time.time() < deadline:
            line = p.stdout.readline()
            if line.startswith("CKPT"):
                seen = int(line.split()[1]) + 1
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
        assert seen >= 5, "worker never checkpointed"

        cks = sorted(d for d in os.listdir(tmp_path) if d.startswith("ck_"))
        assert cks
        frames, _ = _frames(16)
        # the SIGKILL can land mid-write: fall back to older checkpoints
        # until one loads cleanly (exactly what a real resume does)
        resumed = None
        for name in reversed(cks):
            try:
                cand = slam.SLAMSystem(CFG, seed=7)
                checkpoint.load_state(os.path.join(str(tmp_path), name), cand)
                resumed = cand
                last_idx = int(name.split("_")[1].split(".")[0])
                break
            except Exception:
                continue
        assert resumed is not None, "no loadable checkpoint survived the kill"
        for i in range(last_idx + 1, 16):
            info = resumed.process(frames[i])
            assert np.isfinite(resumed.poses()[-1]).all()
        assert len(resumed.poses()) == 16
        # uninterrupted oracle
        full = slam.SLAMSystem(CFG, seed=7)
        for i in range(16):
            full.process(frames[i])
        # 2e-3 not 1e-4: the checkpoint prefix ran in a DIFFERENT OS process
        # (XLA:CPU reduction partitioning is thread-count-dependent across
        # processes, ~1e-7 input jitter), and the pose-only refine in
        # tracker step 7b amplifies along its weakly conditioned forward
        # direction; the in-process resume test above keeps 1e-4.
        np.testing.assert_allclose(full.poses(), resumed.poses(), atol=2e-3)


class TestSensorDropout:
    def test_blackout_recovers(self):
        frames, _ = _frames(14, seed=5)
        frames = [np.asarray(f) for f in frames]
        for i in (6, 7, 8):
            frames[i] = np.zeros_like(frames[i])   # dead sensor

        s = slam.SLAMSystem(CFG, seed=3)
        infos = [s.process(f) for f in frames]

        # during the blackout: tracking reports failure, poses stay finite
        # (constant-velocity fallback holds the last pose; the reference
        # would abort inside cvtColor, src/Frame.cpp:56)
        blackout = [infos[i] for i in (6, 7, 8)]
        assert not any(i["success"] for i in blackout[1:]), blackout
        assert all(np.isfinite(p).all() for p in s.poses())

        # after imagery returns: re-acquires within 2 frames and finishes
        # the sequence tracking successfully
        post = [i for i in infos[10:] if i.get("kind") == "frame"]
        assert any(i["success"] for i in infos[9:12]), infos[9:12]
        assert post[-1]["success"]
        assert all(np.isfinite(p).all() for p in s.poses())

    def test_blackout_extrapolates_not_holds(self):
        """Constant-velocity is real motion, not hold-pose: during a blackout
        the pose keeps advancing at roughly the pre-blackout step, and the
        end-of-blackout position error vs ground truth is strictly smaller
        than the error a frozen (hold-pose) fallback would leave."""
        frames, gt = _frames(14, seed=5)
        frames = [np.asarray(f) for f in frames]
        for i in (6, 7, 8):
            frames[i] = np.zeros_like(frames[i])

        s = slam.SLAMSystem(CFG, seed=3)
        infos = [s.process(f) for f in frames]
        poses = s.poses()
        est_pos = poses[:, :3, 3]
        gt_pos = gt[:, :3, 3]

        # the blackout frames keep moving (hold-pose would freeze them)
        step_pre = np.linalg.norm(est_pos[5] - est_pos[4])
        for i in (6, 7, 8):
            step = np.linalg.norm(est_pos[i] - est_pos[i - 1])
            assert step > 0.4 * step_pre, (i, step, step_pre)

        # scale-align on the clean prefix (monocular scale is only defined
        # up to the first baseline), then compare end-of-blackout drift
        # against what holding the frame-5 pose would have left.
        ln = lambda p: np.linalg.norm(np.diff(p, axis=0), axis=1).sum()
        scl = ln(gt_pos[:6]) / max(ln(est_pos[:6]), 1e-9)
        err_extrap = np.linalg.norm(scl * est_pos[8] - gt_pos[8])
        err_hold = np.linalg.norm(scl * est_pos[5] - gt_pos[8])
        assert err_extrap < 0.7 * err_hold, (err_extrap, err_hold)

    def test_relocalization_reacquires_on_first_real_frame(self):
        """After the blackout, frame-to-frame matching has nothing to match
        against (the previous frame was black) — yet the map survived, so
        pose-only PnP on extrapolated-pose associations must re-anchor on the
        FIRST real frame, not after a second frame-pair."""
        frames, _ = _frames(14, seed=5)
        frames = [np.asarray(f) for f in frames]
        for i in (6, 7, 8):
            frames[i] = np.zeros_like(frames[i])
        s = slam.SLAMSystem(CFG, seed=3)
        infos = [s.process(f) for f in frames]
        assert infos[9]["success"], infos[9]

    def test_severe_blur_never_nan(self):
        """Heavy blur (low-texture): success may drop, outputs stay finite."""
        frames, _ = _frames(8, seed=6)
        frames = [np.asarray(f) for f in frames]
        # box-blur frames 3-5 hard (11x11, 3 passes)
        for i in (3, 4, 5):
            f = frames[i]
            for _ in range(3):
                from scipy import ndimage  # available via torch env? fall back
                f = ndimage.uniform_filter(f, size=11)
            frames[i] = f.astype(np.float32)

        s = slam.SLAMSystem(CFG, seed=3)
        for f in frames:
            s.process(f)
        assert all(np.isfinite(p).all() for p in s.poses())
        assert np.isfinite(float(s.state.scale))
