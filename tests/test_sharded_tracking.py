"""Sharded-map TRACKING as a pipeline mode (BASELINE config 4).

Round 2 proved the sharded-association primitive (test_parallel.py); this
proves the full pipeline runs with the map's point axis sharded across a
mesh for an entire tracked sequence — insert, observe, cull, maintenance,
window BA and write-back all operating on the sharded arrays — with:

  * the RANSAC hypothesis batch ALSO sharded over the mesh by default
    (MeshConfig.shard_hypotheses; parallel/sharded_ransac.py
    ransac_pose_hypsharded) — the mode is faster per step, not just
    bigger. Runs then agree across mesh sizes and vs unsharded to f32
    tolerance (per-device hypothesis-slice shapes differ across mesh
    sizes, so XLA's reduction tiling drifts stage-1 scores at epsilon);
  * with shard_hypotheses=False, bit-identical trajectories across mesh
    sizes (2 == 4 devices): all non-map compute is replicated per device
    and map collectives are exact (lexicographic int arg-best;
    one-contributor psum gathers), so the numbers cannot depend on the
    device count;
  * identical per-frame tracking DECISIONS (matches, inliers, associations,
    map sizes, success) vs the unsharded pipeline, and poses equal to f32
    compilation tolerance. Bitwise equality vs the UNSHARDED program is not
    attainable: with >1 device XLA's SPMD partitioner pass re-tiles float
    contractions even for fully replicated shard_map bodies (measured:
    ransac_pose alone moves ~5e-5 under an n=2 mesh with replicated
    in/out specs), which is compilation noise, not a pipeline difference.
"""
import numpy as np
import pytest

import jax

pytestmark = pytest.mark.slow  # multi-minute mesh runs

from vslam_jax.config import small_config
from vslam_jax.datasets import synthetic
from vslam_jax.parallel import mesh as mesh_mod
from vslam_jax.pipeline import slam

CFG = small_config()
K = CFG.camera.K()
W, H = CFG.camera.width, CFG.camera.height


def _frames(n, seed=11):
    scene = synthetic.make_scene(num_points=700, seed=seed,
                                 extent=(14, 6, 40), z_min=6.0)
    poses = synthetic.make_trajectory(n, step=0.6, seed=seed)
    return synthetic.render_sequence(K, poses, scene, W, H), poses


def _run(mesh, frames, enable_ba=True):
    s = slam.SLAMSystem(CFG, seed=2, enable_ba=enable_ba, mesh=mesh)
    infos = [s.process(f) for f in frames]
    return s, infos


def test_sharded_tracking_matches_unsharded():
    frames, _ = _frames(12)
    ref, ref_infos = _run(None, frames)
    poses_by_n = {}
    for n_dev in (2, 4):
        mesh = mesh_mod.make_mesh(CFG.mesh.axis_map, n_dev)
        shd, shd_infos = _run(mesh, frames)
        poses_by_n[n_dev] = shd.poses()

        # equivalent per-frame association/tracking decisions. Counts sit
        # on hard thresholds (Sampson inlier test, parallax gate), so the
        # f32 compilation drift of the module docstring can flip a
        # borderline element either way — equality up to a few counts, not
        # bitwise.
        for a, b in zip(ref_infos[1:], shd_infos[1:]):
            assert a["num_matches"] == b["num_matches"]
            assert abs(a["num_inliers"] - b["num_inliers"]) <= 3, (a, b)
            assert abs(a["num_associated"] - b["num_associated"]) <= 3, (a, b)
            assert abs(a["map_size"] - b["map_size"]) <= 8, (a, b)
            assert a["success"] == b["success"]

        np.testing.assert_allclose(ref.poses(), shd.poses(), atol=5e-3)

        # the map genuinely lived sharded: leaves report the mesh sharding
        xyz = shd.state.map.xyz
        assert len(xyz.sharding.device_set) == n_dev, xyz.sharding

    # consistent across mesh sizes. With hypothesis sharding (the default)
    # the per-device slice shapes differ between D=2 and D=4, so stage-1
    # scores drift at f32 epsilon — tolerance, not bitwise.
    np.testing.assert_allclose(poses_by_n[2], poses_by_n[4], atol=5e-3)


def test_sharded_tracking_bit_identical_when_replicated():
    """With shard_hypotheses=False every non-map stage is replicated and
    map collectives are exact — trajectories CANNOT depend on the device
    count (the r03 capacity-only mode's property, retained as an option)."""
    import dataclasses
    cfg = CFG.replace(mesh=dataclasses.replace(CFG.mesh,
                                               shard_hypotheses=False))
    frames, _ = _frames(8)
    poses_by_n = {}
    for n_dev in (2, 4):
        mesh = mesh_mod.make_mesh(cfg.mesh.axis_map, n_dev)
        s = slam.SLAMSystem(cfg, seed=2, enable_ba=False, mesh=mesh)
        for f in frames:
            s.process(f)
        poses_by_n[n_dev] = s.poses()
    np.testing.assert_array_equal(poses_by_n[2], poses_by_n[4])


def test_sharded_tracking_through_maintenance():
    """Eviction + compaction + re-pin keeps tracking correct when the
    sharded map churns past capacity (the config-4 long-run regime)."""
    import dataclasses
    # capacity sized to the parallax-gated insertion rate (~4/frame) so a
    # 22-frame run genuinely overflows it; 128/4 devices = 32-slot shards
    cfg = CFG.replace(map=dataclasses.replace(CFG.map, capacity=128,
                                              block_size=32))
    frames, _ = _frames(22, seed=13)
    mesh = mesh_mod.make_mesh(cfg.mesh.axis_map, 4)

    ref = slam.SLAMSystem(cfg, seed=2, enable_ba=False)
    shd = slam.SLAMSystem(cfg, seed=2, enable_ba=False, mesh=mesh)
    for f in frames:
        ref.process(f)
        shd.process(f)
    assert shd.maintenance_runs >= 1, "premise: maintenance must trigger"
    assert shd.dropped_inserts_total == 0
    # f32 compilation drift (see module docstring) compounds over 22 frames
    # of pose chaining + churn; the runs must stay equivalent, not bitwise
    np.testing.assert_allclose(ref.poses(), shd.poses(), atol=5e-2)
    assert abs(int(shd.state.map.size) - int(ref.state.map.size)) <= 16


def test_cli_mesh_flag(tmp_path):
    from vslam_jax import cli
    rc = cli.main([
        "run", "--synthetic", "--small", "--frames", "8", "--mesh", "2",
        "--seed", "3", "--out", str(tmp_path / "out"), "--platform", "cpu",
    ])
    assert rc == 0
    assert (tmp_path / "out" / "summary.json").exists()
