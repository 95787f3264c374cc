"""Checkpoint/resume: save mid-sequence, restore into a fresh system, and
verify the resumed run is bit-identical to an uninterrupted one."""
import numpy as np
import pytest
import jax

from vslam_jax.config import small_config
from vslam_jax.datasets import synthetic
from vslam_jax.pipeline import slam
from vslam_jax.utils import checkpoint

CFG = small_config()
K = CFG.camera.K()
W, H = CFG.camera.width, CFG.camera.height


@pytest.mark.slow
def test_resume_matches_uninterrupted(tmp_path):
    scene = synthetic.make_scene(num_points=600, seed=4, extent=(14, 6, 40),
                                 z_min=6.0)
    poses = synthetic.make_trajectory(12, step=0.6, seed=4)
    frames = synthetic.render_sequence(K, poses, scene, W, H)

    # uninterrupted run (fixed seeds: SLAMSystem key chain is deterministic)
    full = slam.SLAMSystem(CFG, seed=7)
    for i in range(12):
        full.process(frames[i])

    # interrupted at frame 6 -> checkpoint -> fresh system -> resume
    first = slam.SLAMSystem(CFG, seed=7)
    for i in range(6):
        first.process(frames[i])
    ckpt = str(tmp_path / "state")
    checkpoint.save_state(ckpt, first)

    resumed = slam.SLAMSystem(CFG, seed=7)
    checkpoint.load_state(ckpt, resumed)
    for i in range(6, 12):
        resumed.process(frames[i])

    np.testing.assert_allclose(full.poses(), resumed.poses(), atol=1e-5)
    assert int(resumed.state.map.size) == int(full.state.map.size)
    assert resumed._kf_count == full._kf_count
