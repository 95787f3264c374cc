"""Sharding tests on the 8-device virtual CPU mesh: sharded RANSAC and
distributed BA must agree with their single-device counterparts."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vslam_jax.config import BAConfig
from vslam_jax.optimizer import ba
from vslam_jax.parallel import mesh as mesh_mod
from vslam_jax.parallel import sharded_ba, sharded_ransac
from tests.test_geometry import _two_view_setup
from tests.test_ba import _make_problem, K as BA_K


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, jax.devices()
    return mesh_mod.make_mesh("shard", 8)


class TestShardedRansac:
    @pytest.mark.slow
    def test_matches_quality_of_single_device(self, mesh8):
        K, T1, T2, uv1, uv2, vis, _, is_out = _two_view_setup(
            noise=0.3, outlier_frac=0.4
        )
        res = sharded_ransac.ransac_fundamental_sharded(
            mesh8, "shard", jax.random.PRNGKey(0),
            jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(vis),
            num_hypotheses=512,
        )
        assert bool(res.success)
        inl = np.asarray(res.inliers)
        true_inl = vis & ~is_out
        precision = (inl & true_inl).sum() / max(inl.sum(), 1)
        recall = (inl & true_inl).sum() / max(true_inl.sum(), 1)
        assert precision > 0.9, precision
        assert recall > 0.7, recall

    @pytest.mark.slow
    @pytest.mark.parametrize("n_dev", [2, 8])
    def test_pose_hypsharded_selects_same_model(self, n_dev):
        """ransac_pose with the hypothesis batch sharded over a mesh must
        pick the same model the unsharded program picks from the SAME
        global sample batch (identical key -> identical (H, 8) sets; union
        of per-device top-k contains the global top-k; stage-2 full-N
        re-scoring is replicated). Ref: the cross-device reduction the
        reference's CUDA sketch gestures at, src/ransac.cu:20-24."""
        import functools
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from vslam_jax.geometry import ransac as ransac_mod

        K, T1, T2, uv1, uv2, vis, _, is_out = _two_view_setup(
            noise=0.3, outlier_frac=0.3
        )
        uv1, uv2, vis = map(jnp.asarray, (uv1, uv2, vis))
        Kj = jnp.asarray(K, jnp.float32)
        key = jax.random.PRNGKey(3)
        H = 512

        ref = ransac_mod.ransac_pose(
            key, uv1, uv2, vis, Kj, num_hypotheses=H)

        mesh = mesh_mod.make_mesh("shard", n_dev)

        @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P(), P()),
                           out_specs=P(), check_vma=False)
        def run(uv1, uv2, vis):
            return sharded_ransac.ransac_pose_hypsharded(
                "shard", n_dev, key, uv1, uv2, vis, Kj, num_hypotheses=H)

        res = run(uv1, uv2, vis)
        assert bool(res.success)
        # same selected model -> same physically-consistent inlier decisions
        # (bool masks are robust to the SPMD f32 re-tiling drift) and the
        # same refined pose to f32 tolerance
        agree = (np.asarray(res.inliers) == np.asarray(ref.inliers)).mean()
        assert agree > 0.99, agree
        np.testing.assert_allclose(np.asarray(res.R), np.asarray(ref.R),
                                   atol=1e-3)
        np.testing.assert_allclose(np.asarray(res.t), np.asarray(ref.t),
                                   atol=1e-3)


class TestShardedMap:
    def _populated_map(self, capacity=1024, n_pts=700, seed=0):
        from vslam_jax.core.types import empty_map
        from vslam_jax.mapping import point_map

        rng = np.random.RandomState(seed)
        m = empty_map(capacity, 2)
        xyz = rng.randn(n_pts, 3).astype(np.float32) * np.array([8, 4, 10],
                                                                np.float32)
        xyz[:, 2] += 15.0
        desc = rng.randint(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)
        m = point_map.insert_points(
            m, jnp.asarray(xyz), jnp.zeros((n_pts, 3), jnp.float32),
            jnp.asarray(desc), jnp.ones(n_pts, bool))
        # a few dead slots, as after culling
        kill = jnp.asarray(rng.rand(capacity) < 0.05)
        m = m.replace(alive=m.alive & ~kill)
        return m, xyz, desc, rng

    def test_associate_parity_with_single_device(self, mesh8):
        from vslam_jax.config import MapConfig, MatchingConfig
        from vslam_jax.mapping import point_map
        from vslam_jax.parallel import sharded_map

        m, xyz, desc, rng = self._populated_map()
        W, H = 640, 480
        K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
        P_mat = jnp.asarray(np.hstack([K, np.zeros((3, 1), np.float32)]))
        # keypoints = projections of a subset of map points + noise, with
        # near-identical descriptors so associations actually fire
        n_kp = 256
        sel = rng.choice(700, n_kp, replace=False)
        uvw = (np.hstack([xyz[sel], np.ones((n_kp, 1), np.float32)])
               @ np.asarray(P_mat).T)
        kp_uv = uvw[:, :2] / uvw[:, 2:3] + rng.randn(n_kp, 2) * 0.5
        kp_desc = desc[sel].copy()
        kp_desc[:, 0] ^= 1  # 1-bit perturbation
        kp_free = np.ones(n_kp, bool)
        kp_free[::7] = False

        map_cfg = MapConfig(capacity=1024, obs_per_point=2, block_size=64)
        match_cfg = MatchingConfig()
        args = (P_mat, jnp.asarray(kp_uv.astype(np.float32)),
                jnp.asarray(kp_desc), jnp.asarray(kp_free))
        ref = point_map.associate(m, *args, map_cfg, match_cfg, W, H)
        got = sharded_map.associate_sharded(
            mesh8, "shard", sharded_map.shard_map_state(mesh8, "shard", m),
            *args, map_cfg=map_cfg, match_cfg=match_cfg, width=W, height=H)
        np.testing.assert_array_equal(np.asarray(got.point_id),
                                      np.asarray(ref.point_id))
        np.testing.assert_array_equal(np.asarray(got.distance),
                                      np.asarray(ref.distance))
        # and a meaningful number of associations really happened (many
        # synthetic points legitimately fall outside the frustum)
        assert int((np.asarray(ref.point_id) >= 0).sum()) > 40

    def test_sharded_insert_preserves_sharding(self, mesh8):
        """insert_points under jit with a sharded map: XLA's sharding
        propagation keeps the point axis distributed (config-4 storage)."""
        from vslam_jax.mapping import point_map
        from vslam_jax.parallel import sharded_map

        m, _, _, rng = self._populated_map()
        ms = sharded_map.shard_map_state(mesh8, "shard", m)
        B = 64
        xyz = jnp.asarray(rng.randn(B, 3).astype(np.float32))
        desc = jnp.asarray(rng.randint(0, 2 ** 32, (B, 8), dtype=np.uint32))

        out_sh = sharded_map.map_state_specs("shard")
        ins = jax.jit(
            point_map.insert_points,
            out_shardings=jax.tree.map(
                lambda s: jax.sharding.NamedSharding(mesh8, s), out_sh),
        )
        m2 = ins(ms, xyz, jnp.zeros((B, 3), jnp.float32), desc,
                 jnp.ones(B, bool))
        assert int(m2.size) == int(m.size) + B
        spec = m2.xyz.sharding.spec
        assert spec[0] == "shard", spec
        # payload parity with the unsharded path
        ref = point_map.insert_points(
            m, xyz, jnp.zeros((B, 3), jnp.float32), desc, jnp.ones(B, bool))
        np.testing.assert_allclose(np.asarray(m2.xyz), np.asarray(ref.xyz))


class TestShardedBA:
    def test_matches_single_device_solution(self, mesh8):
        # 256 points divisible by 8
        problem, T_cw_true, xyz_true, seen = _make_problem(
            n_points=256, noise_px=0.3
        )
        cfg = BAConfig(iterations=8)
        ref, ref_stats = ba.solve(problem, jnp.asarray(BA_K), cfg)
        dist, dist_stats = sharded_ba.solve_sharded(
            mesh_mod.make_mesh("shard", 8), "shard", problem,
            jnp.asarray(BA_K), cfg,
        )
        # identical math => near-identical results (fp reduction order differs)
        np.testing.assert_allclose(
            float(dist_stats.final_cost), float(ref_stats.final_cost),
            rtol=0.05,
        )
        np.testing.assert_allclose(
            np.asarray(dist.T_cw), np.asarray(ref.T_cw), atol=5e-3
        )

    def test_converges_on_mesh(self, mesh8):
        problem, T_cw_true, xyz_true, seen = _make_problem(
            n_points=256, noise_px=0.3
        )
        solved, stats = sharded_ba.solve_sharded(
            mesh_mod.make_mesh("shard", 8), "shard", problem,
            jnp.asarray(BA_K), BAConfig(iterations=10),
        )
        assert float(stats.final_cost) < float(stats.initial_cost) * 0.1
        terr = np.linalg.norm(
            np.asarray(solved.T_cw)[:, :3, 3] - T_cw_true[:, :3, 3], axis=1
        )[2:]
        iterr = np.linalg.norm(
            np.asarray(problem.T_cw)[:, :3, 3] - T_cw_true[:, :3, 3], axis=1
        )[2:]
        assert terr.mean() < iterr.mean() * 0.3
