"""Device-resident chunked driver (pipeline/scan_driver.py) vs the
per-frame driver: same trajectory, same keyframes, same metrics.

The chunked driver exists to close the step-vs-system throughput gap
(VERDICT r04 next #3 — the per-frame driver's per-frame device_get +
host keyframe decision bounded the on-chip system at 4.65 fps while the
tracking step ran at 85 fps). Equivalence with the per-frame driver is
the correctness contract that makes its speed claim meaningful.
"""
import dataclasses

import numpy as np
import pytest

from vslam_jax.config import small_config
from vslam_jax.datasets import synthetic
from vslam_jax.pipeline import slam

pytestmark = pytest.mark.quick

CFG = small_config()
K = CFG.camera.K()
W, H = CFG.camera.width, CFG.camera.height


def _scene(num_frames, seed=2):
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 45), z_min=6.0)
    poses = synthetic.make_trajectory(num_frames, step=0.6, yaw_rate=0.01,
                                      seed=seed)
    frames = synthetic.render_sequence(K, poses, scene, W, H)
    return frames, poses


def _frame_rows(s):
    return [r for r in s.metrics.records
            if r.get("kind") == "frame" and "success" in r]


class TestChunkedDriver:
    def test_matches_per_frame_driver_no_ba(self):
        frames, _ = _scene(17)
        a = slam.SLAMSystem(CFG, enable_ba=False)
        for f in frames:
            a.process(f)
        b = slam.SLAMSystem(CFG, enable_ba=False)
        # uneven chunks on purpose: boundaries must not matter
        b.process_chunk(np.asarray(frames[:7]))   # bootstrap + 6 tracked
        b.process_chunk(np.asarray(frames[7:12]))
        b.process_chunk(np.asarray(frames[12:]))

        pa, pb = a.poses(), b.poses()
        assert pa.shape == pb.shape
        # same program content; scan-vs-single compilation may retile f32
        # reductions, so equality is to tolerance, not bitwise
        assert np.allclose(pa, pb, atol=5e-3), np.abs(pa - pb).max()
        ra, rb = _frame_rows(a), _frame_rows(b)
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert x["keyframe"] == y["keyframe"], (x, y)
            assert x["success"] == y["success"], (x, y)
            assert abs(x["num_inliers"] - y["num_inliers"]) <= 3, (x, y)
        assert (np.asarray(a.kf_store.kf_order) >= 0).sum() == \
            (np.asarray(b.kf_store.kf_order) >= 0).sum()

    def test_matches_per_frame_driver_with_ba(self):
        # chunk aligned to keyframe_every * local_ba_every so window-BA
        # events land on the same frames as the per-frame driver
        frames, gt = _scene(25)
        cfg = CFG
        align = cfg.pipeline.keyframe_every * cfg.pipeline.local_ba_every
        a = slam.SLAMSystem(cfg, enable_ba=True)
        for f in frames:
            a.process(f)
        b = slam.SLAMSystem(cfg, enable_ba=True)
        b.process_chunk(np.asarray(frames[:align + 1]))  # bootstrap+align
        for s0 in range(align + 1, len(frames), align):
            b.process_chunk(np.asarray(frames[s0:s0 + align]))
        pa, pb = a.poses(), b.poses()
        assert pa.shape == pb.shape
        assert np.allclose(pa, pb, atol=2e-2), np.abs(pa - pb).max()
        ba_a = [r for r in a.metrics.records if r.get("kind") == "ba"]
        ba_b = [r for r in b.metrics.records if r.get("kind") == "ba"]
        assert len(ba_a) == len(ba_b), (len(ba_a), len(ba_b))

    def test_on_device_renderer_inputs(self):
        # render_fn path: inputs are GT poses, frames rendered inside the
        # compiled chunk (the zero-transfer endurance mode)
        import jax
        import jax.numpy as jnp
        from vslam_jax.datasets import synthetic_device

        n = 12
        poses = synthetic.make_trajectory(n, step=0.6, seed=3)
        xyz, patches = synthetic_device.make_corridor_scene_device(
            jax.random.PRNGKey(3), jnp.asarray(poses), 1200)
        Kj = jnp.asarray(K)

        def render(pose):
            return synthetic_device.render_frame_device(
                xyz, patches, Kj, pose, W, H)

        s = slam.SLAMSystem(CFG, enable_ba=False)
        s.process_chunk(jnp.asarray(poses[:6]), render_fn=render)
        s.process_chunk(jnp.asarray(poses[6:]), render_fn=render)
        rows = _frame_rows(s)
        assert len(rows) == n - 1
        assert sum(r["success"] for r in rows) >= n - 3
        assert np.isfinite(s.poses()).all()
