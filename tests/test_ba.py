"""Bundle adjustment convergence tests on synthetic problems (the oracle
pattern of SURVEY.md §4 applied to the component the reference never built)."""
import numpy as np
import jax
import jax.numpy as jnp

from vslam_jax.config import BAConfig
from vslam_jax.core import lie
from vslam_jax.datasets import synthetic
from vslam_jax.optimizer import ba

K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]], np.float32)
W, H = 320, 240


def _make_problem(
    n_cams=6, n_points=200, k_obs=6, noise_px=0.5,
    pose_noise=0.02, point_noise=0.10, seed=0,
):
    """Synthetic BA problem: ground truth + perturbed initialization."""
    rng = np.random.RandomState(seed)
    poses_wc = synthetic.make_trajectory(n_cams, step=0.8, seed=seed)
    scene = synthetic.make_scene(num_points=n_points, seed=seed,
                                 extent=(10, 5, 30), z_min=6.0)
    xyz = scene.xyz

    obs_cam = np.full((n_points, k_obs), -1, np.int32)
    obs_uv = np.zeros((n_points, k_obs, 2), np.float32)
    obs_mask = np.zeros((n_points, k_obs), bool)
    for p in range(n_points):
        slot = 0
        for c in range(n_cams):
            if slot >= k_obs:
                break
            uv, z = synthetic.project_w(K, poses_wc[c], xyz[p : p + 1])
            u, v = uv[0]
            if z[0] > 1.0 and 0 <= u < W and 0 <= v < H:
                obs_cam[p, slot] = c
                obs_uv[p, slot] = [u + rng.randn() * noise_px,
                                   v + rng.randn() * noise_px]
                obs_mask[p, slot] = True
                slot += 1
    seen = obs_mask.sum(1) >= 2

    # Perturb initialization (except gauge cams 0, 1)
    T_cw = np.stack([np.linalg.inv(p) for p in poses_wc]).astype(np.float32)
    T_cw_init = T_cw.copy()
    for c in range(2, n_cams):
        xi = rng.randn(6).astype(np.float32) * pose_noise
        T_cw_init[c] = np.asarray(lie.se3_exp(jnp.asarray(xi))) @ T_cw_init[c]
    pts_init = xyz + rng.randn(*xyz.shape).astype(np.float32) * point_noise

    cam_fixed = np.zeros(n_cams, bool)
    cam_fixed[:2] = True
    problem = ba.BAProblem(
        T_cw=jnp.asarray(T_cw_init),
        cam_fixed=jnp.asarray(cam_fixed),
        cam_mask=jnp.ones(n_cams, bool),
        points=jnp.asarray(pts_init),
        point_mask=jnp.asarray(seen),
        obs_cam=jnp.asarray(np.where(obs_cam < 0, 0, obs_cam)),
        obs_uv=jnp.asarray(obs_uv),
        obs_mask=jnp.asarray(obs_mask),
    )
    return problem, T_cw, xyz, seen


class TestBA:
    def test_converges_to_ground_truth(self):
        problem, T_cw_true, xyz_true, seen = _make_problem()
        cfg = BAConfig(iterations=12)
        solved, stats = ba.solve(problem, jnp.asarray(K), cfg)
        assert float(stats.final_cost) < float(stats.initial_cost) * 0.05, (
            float(stats.initial_cost), float(stats.final_cost))
        # camera translation error shrinks vs initialization
        def terr(T):
            return np.linalg.norm(np.asarray(T)[:, :3, 3] - T_cw_true[:, :3, 3], axis=1)
        init_err = terr(problem.T_cw)[2:].mean()
        final_err = terr(solved.T_cw)[2:].mean()
        assert final_err < init_err * 0.3, (init_err, final_err)
        # NOTE: landmark 3D error is NOT asserted against ground truth here —
        # BA minimizes reprojection error, and with forward-dominant motion
        # the ML landmark depth error at 0.5 px noise exceeds the artificial
        # 0.10 m init perturbation. Exact landmark recovery is asserted in
        # test_exact_recovery_zero_noise.

    def test_exact_recovery_zero_noise(self):
        problem, T_cw_true, xyz_true, seen = _make_problem(noise_px=0.0)
        solved, stats = ba.solve(problem, jnp.asarray(K), BAConfig(iterations=15))
        assert float(stats.final_cost) < 1e-2
        perr = np.linalg.norm(np.asarray(solved.points) - xyz_true, axis=1)[seen]
        assert np.median(perr) < 1e-3, np.median(perr)
        terr = np.linalg.norm(
            np.asarray(solved.T_cw)[:, :3, 3] - T_cw_true[:, :3, 3], axis=1
        )
        assert terr.max() < 1e-3, terr

    def test_gauge_cams_untouched(self):
        problem, T_cw_true, _, _ = _make_problem()
        solved, _ = ba.solve(problem, jnp.asarray(K), BAConfig(iterations=5))
        np.testing.assert_allclose(
            np.asarray(solved.T_cw[:2]), np.asarray(problem.T_cw[:2]), atol=0
        )

    def test_perfect_init_stays(self):
        problem, T_cw_true, xyz_true, seen = _make_problem(
            noise_px=0.0, pose_noise=0.0, point_noise=0.0
        )
        solved, stats = ba.solve(problem, jnp.asarray(K), BAConfig(iterations=4))
        assert float(stats.final_cost) <= float(stats.initial_cost) + 1e-3
        np.testing.assert_allclose(
            np.asarray(solved.T_cw), np.asarray(problem.T_cw), atol=1e-3
        )

    def test_robust_to_outlier_observations(self):
        problem, T_cw_true, xyz_true, seen = _make_problem(seed=3)
        # corrupt 5% of observations badly
        rng = np.random.RandomState(9)
        uv = np.asarray(problem.obs_uv).copy()
        m = np.asarray(problem.obs_mask)
        corrupt = (rng.rand(*m.shape) < 0.05) & m
        uv[corrupt] += rng.uniform(30, 80, (corrupt.sum(), 2))
        problem2 = problem.replace(obs_uv=jnp.asarray(uv))
        solved, stats = ba.solve_robust(
            problem2, jnp.asarray(K), BAConfig(iterations=8), reject_px=5.0, rounds=2
        )
        def terr(T):
            return np.linalg.norm(np.asarray(T)[:, :3, 3] - T_cw_true[:, :3, 3], axis=1)
        assert terr(solved.T_cw)[2:].mean() < terr(problem.T_cw)[2:].mean() * 0.5, (
            terr(problem.T_cw)[2:].mean(), terr(solved.T_cw)[2:].mean())
