"""Hamming kernels and the matcher's kernel dispatch."""
import numpy as np
import jax.numpy as jnp
import pytest

from vslam_jax.config import MatchingConfig
from vslam_jax.matching import hamming, matcher


@pytest.mark.parametrize("n1,n2", [(3072, 3072), (100, 300)])
def test_hamming_matmul_matches_popcount(n1, n2):
    """The int8 bit-plane matmul is exact: int32 accumulation of 0/1
    products, so it equals the popcount oracle bit for bit, at the full
    keypoint budget and at a shape that is no multiple of anything."""
    rng = np.random.RandomState(n1 + n2)
    d1 = jnp.asarray(rng.randint(0, 2 ** 32, (n1, 8), dtype=np.uint64)
                     .astype(np.uint32))
    d2 = jnp.asarray(rng.randint(0, 2 ** 32, (n2, 8), dtype=np.uint64)
                     .astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(hamming.hamming_matmul(d1, d2)),
                                  np.asarray(hamming.hamming_popcount(d1, d2)))


def test_matcher_kernel_dispatch_agrees():
    """MatchingConfig.kernel selects equivalent kernels."""
    rng = np.random.RandomState(2)
    n = 256
    d1 = jnp.asarray(rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint32))
    d2 = jnp.asarray(rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint32))
    m = jnp.asarray(rng.rand(n) > 0.1)
    results = {
        k: matcher.match(d1, m, d2, m, MatchingConfig(kernel=k))
        for k in ("matmul", "popcount")
    }
    base, other = results["matmul"], results["popcount"]
    np.testing.assert_array_equal(np.asarray(other.idx2),
                                  np.asarray(base.idx2))
    np.testing.assert_array_equal(np.asarray(other.mask),
                                  np.asarray(base.mask))
    np.testing.assert_array_equal(np.asarray(other.distance),
                                  np.asarray(base.distance))
