"""Native C++ component tests — randomized property tests against brute-force
oracles, the same strategy as the reference's only test file
(reference tests/test_kdtree.cpp:47-146), extended to the queries the
reference never implemented (k-nearest) and to the native image pipeline."""
import io
import os

import numpy as np
import pytest

try:
    from vslam_jax.utils import native
    native.load()
    HAVE_NATIVE = True
except Exception:   # pragma: no cover - toolchain-less environments
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE, reason="native lib unavailable")


def _cloud(rng, n):
    return (rng.rand(n, 2) * 100).astype(np.float32)


class TestKDTree:
    def test_nearest_vs_bruteforce(self):
        rng = np.random.RandomState(0)
        for trial in range(50):
            pts = _cloud(rng, rng.randint(50, 3000))
            idx = native.SpatialIndex(pts)
            q = rng.rand(2) * 100
            i, d2 = idx.nearest(q)
            dists = ((pts - q) ** 2).sum(1)
            assert np.isclose(d2, dists.min(), rtol=1e-4), trial
            assert np.isclose(dists[i], dists.min(), rtol=1e-4)

    def test_radius_vs_bruteforce(self):
        rng = np.random.RandomState(1)
        for trial in range(50):
            pts = _cloud(rng, rng.randint(50, 2500))
            idx = native.SpatialIndex(pts)
            q = rng.rand(2) * 100
            r = rng.uniform(5, 40)
            got = set(idx.radius(q, r, cap=4096).tolist())
            want = set(np.where(((pts - q) ** 2).sum(1) <= r * r)[0].tolist())
            assert got == want, trial

    def test_knearest_vs_bruteforce(self):
        rng = np.random.RandomState(2)
        for trial in range(30):
            pts = _cloud(rng, rng.randint(50, 1500))
            idx = native.SpatialIndex(pts)
            q = rng.rand(2) * 100
            k = rng.randint(1, 12)
            got_i, got_d2 = idx.k_nearest(q, k)
            dists = ((pts - q) ** 2).sum(1)
            want = np.sort(dists)[:k]
            assert len(got_i) == min(k, len(pts))
            np.testing.assert_allclose(np.sort(got_d2), want, rtol=1e-4)

    def test_grid_radius_matches_kdtree(self):
        rng = np.random.RandomState(3)
        pts = _cloud(rng, 2000)
        kd = native.SpatialIndex(pts, backend="kdtree")
        gr = native.SpatialIndex(pts, backend="grid", cell_size=10.0)
        for _ in range(20):
            q = rng.rand(2) * 100
            r = rng.uniform(3, 30)
            assert set(kd.radius(q, r, cap=4096).tolist()) == \
                set(gr.radius(q, r, cap=4096).tolist())


class TestPngAndPrefetcher:
    def _write_pngs(self, tmpdir, n=6, w=64, h=48):
        from PIL import Image
        rng = np.random.RandomState(0)
        paths, arrays = [], []
        for i in range(n):
            arr = (rng.rand(h, w) * 255).astype(np.uint8)
            p = os.path.join(tmpdir, f"f{i:03d}.png")
            Image.fromarray(arr, mode="L").save(p)
            paths.append(p)
            arrays.append(arr)
        return paths, arrays

    def test_png_decode_matches_pil(self, tmp_path):
        paths, arrays = self._write_pngs(str(tmp_path))
        data = open(paths[0], "rb").read()
        out = native.decode_png_gray(data, 64, 48)
        np.testing.assert_allclose(out, arrays[0] / 255.0, atol=1e-6)

    def test_png_rgb_luminance(self, tmp_path):
        from PIL import Image
        rng = np.random.RandomState(1)
        arr = (rng.rand(32, 40, 3) * 255).astype(np.uint8)
        p = str(tmp_path / "rgb.png")
        Image.fromarray(arr, mode="RGB").save(p)
        out = native.decode_png_gray(open(p, "rb").read(), 40, 32)
        want = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                + 0.114 * arr[..., 2]) / 255.0
        np.testing.assert_allclose(out, want, atol=2e-3)

    def test_prefetcher_streams_in_order(self, tmp_path):
        paths, arrays = self._write_pngs(str(tmp_path), n=10)
        pf = native.ImagePrefetcher(paths, 64, 48, workers=3, lookahead=4)
        assert len(pf) == 10
        for i, frame in pf:
            np.testing.assert_allclose(frame, arrays[i] / 255.0, atol=1e-6)
        pf.close()

    def test_prefetcher_missing_file_errors(self, tmp_path):
        paths, _ = self._write_pngs(str(tmp_path), n=2)
        paths.append(str(tmp_path / "nope.png"))
        pf = native.ImagePrefetcher(paths, 64, 48)
        pf.get(0)
        with pytest.raises(IOError):
            pf.get(2)
        pf.close()
