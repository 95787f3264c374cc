"""Frontend tests: detector localization against known landmark projections,
descriptor repeatability across views, matcher oracle checks."""
import numpy as np
import jax
import jax.numpy as jnp

from vslam_jax.config import FrontendConfig, MatchingConfig
from vslam_jax.datasets import synthetic
from vslam_jax.frontend import frame as frame_mod
from vslam_jax.frontend.descriptors import pack_bits, unpack_bits
from vslam_jax.matching import hamming, matcher

W, H = 256, 192
K = np.array([[200.0, 0, 128.0], [0, 200.0, 96.0], [0, 0, 1.0]], np.float32)
CFG = FrontendConfig(max_keypoints=256, grid_rows=4, grid_cols=4, border=17)


def _render_pair(seed=0, n_points=160):
    scene = synthetic.make_scene(num_points=n_points, seed=seed,
                                 extent=(10, 5, 30), z_min=6.0)
    poses = synthetic.make_trajectory(2, step=0.5, seed=seed)
    img1 = synthetic.render_frame(K, poses[0], scene, W, H)
    img2 = synthetic.render_frame(K, poses[1], scene, W, H)
    return scene, poses, img1, img2


class TestPacking:
    def test_pack_unpack_roundtrip(self):
        rng = np.random.RandomState(0)
        bits = jnp.asarray(rng.rand(16, 256) > 0.5)
        packed = pack_bits(bits)
        assert packed.shape == (16, 8) and packed.dtype == jnp.uint32
        un = unpack_bits(packed)
        np.testing.assert_array_equal(np.asarray(un), np.asarray(bits).astype(np.int8))


class TestHamming:
    def test_matmul_equals_popcount(self):
        rng = np.random.RandomState(1)
        d1 = jnp.asarray(rng.randint(0, 2 ** 32, (64, 8), dtype=np.uint32))
        d2 = jnp.asarray(rng.randint(0, 2 ** 32, (48, 8), dtype=np.uint32))
        a = np.asarray(hamming.hamming_popcount(d1, d2))
        b = np.asarray(hamming.hamming_matmul(d1, d2))
        np.testing.assert_array_equal(a, b)
        # numpy oracle
        bits1 = np.unpackbits(np.asarray(d1).view(np.uint8), axis=1)
        bits2 = np.unpackbits(np.asarray(d2).view(np.uint8), axis=1)
        oracle = (bits1[:, None, :] != bits2[None, :, :]).sum(-1)
        np.testing.assert_array_equal(a, oracle)


class TestDetector:
    def test_localizes_landmarks(self):
        scene, poses, img1, _ = _render_pair()
        feats = frame_mod.extract_features(jnp.asarray(img1), CFG, H, W)
        uv = np.asarray(feats.uv)[np.asarray(feats.mask)]
        assert len(uv) > 40, len(uv)
        # each detection should be near a true projected landmark center
        proj, z = synthetic.project_w(K, poses[0], scene.xyz)
        vis = (z > 0) & (proj[:, 0] > 20) & (proj[:, 0] < W - 20) \
            & (proj[:, 1] > 20) & (proj[:, 1] < H - 20)
        d = np.linalg.norm(uv[:, None, :] - proj[None, vis, :], axis=2).min(axis=1)
        frac_close = (d < 2.0).mean()
        assert frac_close > 0.8, frac_close

    def test_grid_distribution_cap(self):
        scene, poses, img1, _ = _render_pair()
        feats = frame_mod.extract_features(jnp.asarray(img1), CFG, H, W)
        uv = np.asarray(feats.uv)[np.asarray(feats.mask)]
        th, tw = H // CFG.grid_rows, W // CFG.grid_cols
        k_tile = CFG.max_keypoints // (CFG.grid_rows * CFG.grid_cols)
        for r in range(CFG.grid_rows):
            for c in range(CFG.grid_cols):
                in_tile = (
                    (uv[:, 1] >= r * th) & (uv[:, 1] < (r + 1) * th)
                    & (uv[:, 0] >= c * tw) & (uv[:, 0] < (c + 1) * tw)
                ).sum()
                assert in_tile <= k_tile + 2  # subpixel shift slack


class TestMatching:
    def test_two_view_descriptor_matches_follow_geometry(self):
        scene, poses, img1, img2 = _render_pair()
        f1 = frame_mod.extract_features(jnp.asarray(img1), CFG, H, W)
        f2 = frame_mod.extract_features(jnp.asarray(img2), CFG, H, W)
        res = matcher.match(f1.desc, f1.mask, f2.desc, f2.mask,
                            MatchingConfig())
        m = np.asarray(res.mask)
        assert m.sum() > 25, m.sum()
        # ground truth: which landmark does each keypoint sit on?
        proj1, _ = synthetic.project_w(K, poses[0], scene.xyz)
        proj2, _ = synthetic.project_w(K, poses[1], scene.xyz)
        uv1 = np.asarray(f1.uv)
        uv2 = np.asarray(f2.uv)
        lm1 = np.linalg.norm(uv1[:, None] - proj1[None], axis=2).argmin(1)
        lm2 = np.linalg.norm(uv2[:, None] - proj2[None], axis=2).argmin(1)
        idx2 = np.asarray(res.idx2)
        correct = (lm1[m] == lm2[idx2[m]]).mean()
        assert correct > 0.9, correct

    def test_cross_check_kills_asymmetric(self):
        rng = np.random.RandomState(2)
        d = jnp.asarray(rng.randint(0, 2 ** 32, (32, 8), dtype=np.uint32))
        mask = jnp.ones(32, bool)
        # identical sets: every kp matches itself with distance 0
        res = matcher.match(d, mask, d, mask, MatchingConfig(lowe_ratio=0.9))
        np.testing.assert_array_equal(np.asarray(res.idx2), np.arange(32))
        assert bool(res.mask.all())
        assert (np.asarray(res.distance) == 0).all()


class TestOrientation:
    def test_dense_map_matches_gather_oracle(self):
        """Dense (square-window) orientation tracks the gather-based
        intensity-centroid oracle at strong-gradient pixels."""
        from vslam_jax.frontend import descriptors
        rng = np.random.RandomState(3)
        img = jnp.asarray(np.cumsum(np.cumsum(
            rng.randn(H, W).astype(np.float32), 0), 1) / 50.0)
        uv = jnp.asarray(
            np.stack([rng.uniform(30, W - 30, 64),
                      rng.uniform(30, H - 30, 64)], 1).astype(np.float32))
        ref = np.asarray(descriptors.compute_orientations(img, uv, 15))
        got = np.asarray(descriptors.orientations_at(img, uv, 15))
        d = np.abs(np.angle(np.exp(1j * (got - ref))))
        # square vs circular window: allow a modest angular tolerance
        assert np.median(d) < np.deg2rad(15.0), np.rad2deg(np.median(d))

    def test_dense_map_90deg_equivariance(self):
        """Rotating the image by 90 deg rotates the dense orientation map by
        90 deg exactly (square window is symmetric under k*90)."""
        from vslam_jax.frontend import descriptors
        rng = np.random.RandomState(4)
        img = np.cumsum(np.cumsum(rng.randn(128, 128).astype(np.float32), 0), 1)
        a0 = np.asarray(descriptors.orientation_map(jnp.asarray(img), 15))
        # rot90(img): (y, x) <- img[x, H-1-y]  (numpy k=1: counter-clockwise)
        a1 = np.asarray(descriptors.orientation_map(
            jnp.asarray(np.rot90(img).copy()), 15))
        # orientation at rotated location should be a0 - 90deg (mod 2pi)
        inner = slice(20, 108)
        pred = np.rot90(a0)[inner, inner] - np.pi / 2
        d = np.abs(np.angle(np.exp(1j * (a1[inner, inner] - pred))))
        assert np.percentile(d, 90) < 1e-3, np.percentile(d, 90)


class TestTrackCarry:
    def test_detect_with_carry_recovers_and_dedupes(self):
        """features.detect_with_carry: carried predictions re-localize to a
        nearby corner with budget priority, duplicate fresh detections are
        dropped, and responseless predictions (background) don't produce
        keypoints."""
        import dataclasses
        from vslam_jax.config import small_config
        from vslam_jax.datasets import synthetic
        from vslam_jax.frontend import features

        cfg = small_config().frontend
        K = small_config().camera.K()
        W, H = 256, 192
        scene = synthetic.make_scene(num_points=200, seed=3,
                                     extent=(10, 5, 30), z_min=6.0)
        poses = synthetic.make_trajectory(1, seed=3)
        img = jnp.asarray(synthetic.render_frame(K, poses[0], scene, W, H))

        uv_f, sc_f, ok_f = features.detect(img, cfg, H, W)
        uv_f, ok_f = np.asarray(uv_f), np.asarray(ok_f)
        n_carry = 40
        carry = np.zeros((cfg.max_keypoints, 2), np.float32)
        cmask = np.zeros((cfg.max_keypoints,), bool)
        # predictions 1 px off real detections (motion-model error shape)
        carry[:n_carry] = uv_f[:n_carry] + np.array([1.0, 0.5], np.float32)
        cmask[:n_carry] = ok_f[:n_carry]
        # one LIVE prediction on pure background: the response/quality
        # gates (not the mask) must reject it
        carry[n_carry] = [5.0 + cfg.border, 5.0 + cfg.border]
        cmask[n_carry] = True
        uv, sc, ok = features.detect_with_carry(
            img, cfg, H, W, jnp.asarray(carry), jnp.asarray(cmask))
        uv, ok = np.asarray(uv), np.asarray(ok)

        # every carried corner survives: a keypoint within 2 px of each
        for i in range(n_carry):
            if not cmask[i]:
                continue
            d = np.linalg.norm(uv[ok] - uv_f[i], axis=1).min()
            assert d < 2.0, (i, d)
        # the background prediction produced no keypoint anywhere near it
        d_bg = np.linalg.norm(uv[ok] - carry[n_carry], axis=1).min()
        assert d_bg > 3.0, d_bg
        # dedupe: no two valid keypoints within the NMS radius
        d2 = ((uv[ok][:, None] - uv[ok][None, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, 1e9)
        assert (d2 >= cfg.nms_radius ** 2).all() or \
            (np.sqrt(d2[d2 < cfg.nms_radius ** 2]).min() > 1.0)

    def test_tracker_runs_with_carry_enabled(self):
        """track_step with track_carry on: tracks a short sequence."""
        import dataclasses
        from vslam_jax.config import small_config
        from vslam_jax.datasets import synthetic
        from vslam_jax.pipeline import tracker

        cfg = small_config()
        cfg = cfg.replace(frontend=dataclasses.replace(
            cfg.frontend, track_carry=True))
        K = cfg.camera.K()
        W, H = cfg.camera.width, cfg.camera.height
        scene = synthetic.make_scene(num_points=600, seed=0,
                                     extent=(14, 6, 40), z_min=6.0)
        poses = synthetic.make_trajectory(5, step=0.6, seed=0)
        frames = synthetic.render_sequence(K, poses, scene, W, H)
        st = tracker.bootstrap(jnp.asarray(frames[0]), cfg)
        for i in range(1, 5):
            st, out = tracker.track_step(st, jnp.asarray(frames[i]), cfg)
            assert bool(out.success), i
        assert int(out.map_size) > 10
