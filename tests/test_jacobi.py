"""Jacobi eigensolver vs jnp.linalg oracles."""
import numpy as np
import jax.numpy as jnp

from vslam_jax.ops import jacobi


def _rand_sym(rng, b, n):
    A = rng.randn(b, n, n).astype(np.float32)
    return (A + A.transpose(0, 2, 1)) / 2


class TestJacobi:
    def test_eigh_matches_numpy(self):
        rng = np.random.RandomState(0)
        for n in (3, 4, 9):
            A = _rand_sym(rng, 64, n)
            w, V = jacobi.jacobi_eigh(jnp.asarray(A))
            w_np = np.linalg.eigvalsh(A)
            np.testing.assert_allclose(np.asarray(w), w_np, atol=2e-4)
            # eigen equation A v = w v
            Av = np.einsum("bij,bjk->bik", A, np.asarray(V))
            Vw = np.asarray(V) * np.asarray(w)[:, None, :]
            np.testing.assert_allclose(Av, Vw, atol=5e-4)

    def test_psd_normal_matrices(self):
        # the actual workload shape: AtA from 8x9 constraint matrices
        rng = np.random.RandomState(1)
        A8 = rng.randn(128, 8, 9).astype(np.float32)
        AtA = np.einsum("bij,bik->bjk", A8, A8)
        w, V = jacobi.jacobi_eigh(jnp.asarray(AtA))
        w_np = np.linalg.eigvalsh(AtA)
        np.testing.assert_allclose(np.asarray(w), w_np, rtol=1e-3, atol=1e-3)

    def test_rank2_project(self):
        rng = np.random.RandomState(2)
        F = rng.randn(32, 3, 3).astype(np.float32)
        F2 = np.asarray(jacobi.rank2_project(jnp.asarray(F)))
        # oracle: zero the smallest singular value
        U, S, Vt = np.linalg.svd(F)
        S[:, 2] = 0
        want = np.einsum("bij,bj,bjk->bik", U, S, Vt)
        np.testing.assert_allclose(F2, want, atol=1e-4)
        s2 = np.linalg.svd(F2, compute_uv=False)
        assert (s2[:, 2] < 1e-4).all()

    def test_svd3_reconstructs(self):
        rng = np.random.RandomState(3)
        E = rng.randn(32, 3, 3).astype(np.float32)
        U, S, Vt = jacobi.svd3(jnp.asarray(E))
        rec = np.einsum("bij,bj,bjk->bik", np.asarray(U), np.asarray(S),
                        np.asarray(Vt))
        np.testing.assert_allclose(rec, E, atol=2e-4)
        s_np = np.linalg.svd(E, compute_uv=False)
        np.testing.assert_allclose(np.asarray(S), s_np, atol=2e-4)
