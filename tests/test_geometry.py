"""Oracle-based tests for the two-view geometry stack (SURVEY.md §4 pattern:
randomized property tests against exact synthetic ground truth)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vslam_jax.core import lie
from vslam_jax.datasets import synthetic
from vslam_jax.geometry import epipolar, ransac, triangulation


def _two_view_setup(seed=0, noise=0.0, n_points=300, outlier_frac=0.0):
    K = np.array([[400.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1.0]], np.float32)
    rng = np.random.RandomState(seed)
    scene = synthetic.make_scene(num_points=n_points, seed=seed, extent=(20, 8, 40), z_min=5.0)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, :3] = synthetic._yaw_matrix(0.03)
    T2[:3, 3] = [0.5, 0.05, 0.8]
    uv1, uv2, vis, xyz = synthetic.correspondences(
        K, T1, T2, scene.xyz, 640, 480, noise_px=noise, seed=seed
    )
    if outlier_frac > 0:
        n_out = int(len(uv1) * outlier_frac)
        out_idx = rng.choice(len(uv1), n_out, replace=False)
        uv2 = uv2.copy()
        uv2[out_idx] = rng.uniform([0, 0], [640, 480], (n_out, 2)).astype(np.float32)
        is_outlier = np.zeros(len(uv1), bool)
        is_outlier[out_idx] = True
    else:
        is_outlier = np.zeros(len(uv1), bool)
    return K, T1, T2, uv1, uv2, vis, xyz, is_outlier


def _true_fundamental(K, T1, T2):
    T_21 = np.linalg.inv(T2) @ T1  # cam1 -> cam2
    R, t = T_21[:3, :3], T_21[:3, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    K_inv = np.linalg.inv(K)
    F = K_inv.T @ E @ K_inv
    return F / np.linalg.norm(F)


class TestLie:
    def test_exp_log_roundtrip(self):
        rng = np.random.RandomState(3)
        # keep |w| < pi: so3_log returns the canonical representative
        d = rng.randn(64, 3)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        w = jnp.asarray(d * rng.uniform(0.0, 3.0, (64, 1)), jnp.float32)
        R = lie.so3_exp(w)
        # orthonormal, det 1
        I = jnp.eye(3)[None]
        np.testing.assert_allclose(R @ jnp.swapaxes(R, -1, -2), np.tile(I, (64, 1, 1)), atol=1e-5)
        w2 = lie.so3_log(R)
        np.testing.assert_allclose(np.asarray(w), np.asarray(w2), atol=1e-4)

    def test_se3_roundtrip(self):
        rng = np.random.RandomState(4)
        xi = jnp.asarray(rng.randn(32, 6), jnp.float32)
        T = lie.se3_exp(xi)
        xi2 = lie.se3_log(T)
        np.testing.assert_allclose(np.asarray(xi), np.asarray(xi2), atol=1e-4)

    def test_inv(self):
        xi = jnp.asarray(np.random.RandomState(5).randn(8, 6), jnp.float32)
        T = lie.se3_exp(xi)
        I = lie.inv_T(T) @ T
        np.testing.assert_allclose(np.asarray(I), np.tile(np.eye(4), (8, 1, 1)), atol=1e-5)


class TestEightPoint:
    def test_recovers_true_F(self):
        K, T1, T2, uv1, uv2, vis, _, _ = _two_view_setup(noise=0.0)
        idx = np.where(vis)[0][:8]
        F_true = _true_fundamental(K, T1, T2)

        # High-accuracy path (LAPACK SVD of A): tight entrywise bound.
        F_svd = np.asarray(epipolar.fundamental_from_8pt(
            jnp.asarray(uv1[idx]), jnp.asarray(uv2[idx]), method="svd"))
        err = min(np.abs(F_svd - F_true).max(), np.abs(F_svd + F_true).max())
        assert err < 1e-4, err

        # hot path (Jacobi + Rayleigh-Ritz null vector): this minimal
        # sample is near-degenerate (sigma_8 ~ 1e-2), so f32 normal-equation
        # formation alone bounds entrywise accuracy near 1e-3 — what matters
        # for RANSAC is the epipolar residual the model induces, which must
        # be essentially zero on the true correspondences (gate is 2 px^2).
        F = np.asarray(epipolar.fundamental_from_8pt(
            jnp.asarray(uv1[idx]), jnp.asarray(uv2[idx])))
        err = min(np.abs(F - F_true).max(), np.abs(F + F_true).max())
        assert err < 5e-3, err
        e = np.asarray(epipolar.sampson_error(
            jnp.asarray(F), jnp.asarray(uv1), jnp.asarray(uv2)))
        assert np.median(e[vis]) < 1e-3, np.median(e[vis])

    def test_sampson_zero_for_perfect(self):
        K, T1, T2, uv1, uv2, vis, _, _ = _two_view_setup(noise=0.0)
        F_true = jnp.asarray(_true_fundamental(K, T1, T2), jnp.float32)
        e = np.asarray(epipolar.sampson_error(F_true, jnp.asarray(uv1), jnp.asarray(uv2)))
        assert np.median(e[vis]) < 1e-2


class TestRansac:
    def test_finds_inliers_with_outliers(self):
        K, T1, T2, uv1, uv2, vis, _, is_out = _two_view_setup(
            noise=0.3, outlier_frac=0.4
        )
        res = ransac.ransac_fundamental(
            jax.random.PRNGKey(0),
            jnp.asarray(uv1),
            jnp.asarray(uv2),
            jnp.asarray(vis),
            num_hypotheses=512,
            inlier_threshold=2.0,
        )
        assert bool(res.success)
        inl = np.asarray(res.inliers)
        true_inl = vis & ~is_out
        # Most detected inliers are genuine
        precision = (inl & true_inl).sum() / max(inl.sum(), 1)
        recall = (inl & true_inl).sum() / max(true_inl.sum(), 1)
        assert precision > 0.9, precision
        assert recall > 0.7, recall

    def test_sampling_valid_only_and_mostly_distinct(self):
        mask = jnp.ones(100, bool).at[50:].set(False)
        idx = np.asarray(
            ransac.sample_minimal_sets(
                jax.random.PRNGKey(1), mask.astype(jnp.float32), 256, 8
            )
        )
        # never samples masked-out indices
        assert (idx < 50).all()
        # duplicates within a set are allowed but must be rare
        # (p ≈ S²/2n = 64/100 per set here, far lower at real n≈thousands)
        dup_rows = sum(len(set(r.tolist())) < 8 for r in idx)
        assert dup_rows < 0.5 * len(idx), dup_rows
        # coverage: all valid indices get sampled somewhere
        assert len(set(idx.reshape(-1).tolist())) == 50


class TestRecoverPose:
    def test_cheirality_selects_true_motion(self):
        K, T1, T2, uv1, uv2, vis, _, _ = _two_view_setup(noise=0.2)
        F_true = jnp.asarray(_true_fundamental(K, T1, T2), jnp.float32)
        E = epipolar.essential_from_fundamental(F_true, jnp.asarray(K))
        R, t, votes = epipolar.recover_pose(
            E, jnp.asarray(K), jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(vis)
        )
        T_21 = np.linalg.inv(T2) @ T1
        R_true, t_true = T_21[:3, :3], T_21[:3, 3]
        t_true = t_true / np.linalg.norm(t_true)
        np.testing.assert_allclose(np.asarray(R), R_true, atol=5e-3)
        np.testing.assert_allclose(np.asarray(t), t_true, atol=5e-3)

class TestTriangulation:
    def test_recovers_3d_points(self):
        K, T1, T2, uv1, uv2, vis, xyz, _ = _two_view_setup(noise=0.0)
        from vslam_jax.core import camera as cam
        P1 = np.asarray(cam.projection_matrix(jnp.asarray(K), jnp.asarray(T1)))
        P2 = np.asarray(cam.projection_matrix(jnp.asarray(K), jnp.asarray(T2)))
        X, w = triangulation.triangulate_dlt(
            jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(uv1), jnp.asarray(uv2)
        )
        X = np.asarray(X)
        err = np.linalg.norm(X[vis] - xyz[vis], axis=1)
        assert np.median(err) < 1e-2, np.median(err)

    def test_gate_rejects_bad(self):
        K, T1, T2, uv1, uv2, vis, xyz, _ = _two_view_setup(noise=0.0)
        from vslam_jax.core import camera as cam
        P1 = cam.projection_matrix(jnp.asarray(K), jnp.asarray(T1))
        P2 = cam.projection_matrix(jnp.asarray(K), jnp.asarray(T2))
        # corrupt half the uv2 observations
        uv2_bad = uv2.copy()
        uv2_bad[::2] += 50.0
        X, w = triangulation.triangulate_dlt(P1, P2, jnp.asarray(uv1), jnp.asarray(uv2_bad))
        ok = np.asarray(
            triangulation.triangulation_gate(
                P1, P2, jnp.asarray(T1[:3, 3]), jnp.asarray(T2[:3, 3]),
                X, jnp.asarray(uv1), jnp.asarray(uv2_bad), w,
            )
        )
        # corrupted rows rejected, clean visible rows mostly kept
        assert ok[::2][vis[::2]].mean() < 0.1
        assert ok[1::2][vis[1::2]].mean() > 0.8


class TestRansacPose:
    def test_recovers_motion_with_outliers(self):
        K, T1, T2, uv1, uv2, vis, xyz, is_out = _two_view_setup(
            seed=5, noise=0.3, outlier_frac=0.2)
        res = ransac.ransac_pose(
            jax.random.PRNGKey(1), jnp.asarray(uv1), jnp.asarray(uv2),
            jnp.asarray(vis), jnp.asarray(K))
        assert bool(res.success)
        T_21 = np.linalg.inv(T2) @ T1
        R_gt, t_gt = T_21[:3, :3], T_21[:3, 3] / np.linalg.norm(T_21[:3, 3])
        R = np.asarray(res.R)
        rot_err = np.degrees(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1)))
        t_err = np.degrees(np.arccos(np.clip(float(np.asarray(res.t) @ t_gt), -1, 1)))
        assert rot_err < 0.5, rot_err
        assert t_err < 5.0, t_err
        # outliers largely excluded from the physical consensus
        inl = np.asarray(res.inliers)
        assert inl[is_out].mean() < 0.1
        assert inl[vis & ~is_out].mean() > 0.7

    def test_forward_motion_not_fooled_by_false_inlier(self):
        """Near-forward motion: count-only F-RANSAC can pick a physically
        wrong model covering one extra false match; cheirality-aware scoring
        must not (regression for the 59-deg translation failure)."""
        K = np.array([[200.0, 0, 128.0], [0, 200.0, 96.0], [0, 0, 1.0]],
                     np.float32)
        scene = synthetic.make_scene(num_points=400, seed=2,
                                     extent=(14, 6, 40), z_min=6.0)
        T1 = np.eye(4, dtype=np.float32)
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, 3] = [0.02, 0.015, 0.6]  # nearly pure forward
        uv1, uv2, vis, _ = synthetic.correspondences(
            K, T1, T2, scene.xyz, 256, 192, noise_px=0.4, seed=2)
        # a few gross false matches
        rng = np.random.RandomState(0)
        bad = rng.choice(len(uv1), 6, replace=False)
        uv2 = uv2.copy()
        uv2[bad] = rng.uniform([0, 0], [256, 192], (6, 2)).astype(np.float32)
        t_gt = T2[:3, 3].copy()
        t_gt = -(T2[:3, :3].T @ t_gt)  # cam2<-cam1 translation
        t_gt /= np.linalg.norm(t_gt)
        errs = []
        for seed in range(6):
            res = ransac.ransac_pose(
                jax.random.PRNGKey(seed), jnp.asarray(uv1), jnp.asarray(uv2),
                jnp.asarray(vis), jnp.asarray(K))
            errs.append(np.degrees(np.arccos(np.clip(
                float(np.asarray(res.t) @ t_gt), -1, 1))))
        # Context: count-only selection gave ~59 deg; the oracle LINEAR fit
        # on the true inliers gives ~40 deg at this noise (t direction is
        # weakly observable near-forward); GN refinement's ML optimum is
        # ~1.4 deg. Require clearly-better-than-linear on every seed and
        # near-ML typical behavior.
        assert np.median(errs) < 10.0, errs
        assert max(errs) < 35.0, errs
