"""Hamming distance between packed 256-bit descriptors.

Replaces the reference's O(N^2) CPU brute-force BFMatcher NORM_HAMMING
(reference src/Frame.cpp:83-85 — hot loop #1 in SURVEY.md §3.1) with two
batched formulations:

  * ``hamming_matmul`` — unpack bits to {0,1} int8 planes; then
    popcount(xor(a, b)) == sum_a + sum_b - 2 * a·b, so the full (N1, N2)
    distance matrix is one int8 matmul with int32 accumulation, which XLA
    can hand to the int8 tensor cores. This is the default.
  * ``hamming_popcount`` — ``lax.population_count`` on the packed uint32
    words. The oracle for testing the matmul path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..frontend.descriptors import unpack_bits


def hamming_popcount(desc1, desc2):
    """(N1,8) x (N2,8) packed uint32 -> (N1,N2) int32 Hamming distances."""
    x = jnp.bitwise_xor(desc1[:, None, :], desc2[None, :, :])  # (N1,N2,8)
    return jax.lax.population_count(x).sum(axis=-1).astype(jnp.int32)


def hamming_matmul(desc1, desc2):
    """Bit-plane matmul formulation: d(a,b) = |a| + |b| - 2 a·b over {0,1} bits.

    (N1,8) x (N2,8) packed uint32 -> (N1,N2) int32. The N1 x N2 x 256 inner
    product takes int8 inputs with int32 accumulation, so it is exact.
    """
    a = unpack_bits(desc1)  # (N1, 256) int8
    b = unpack_bits(desc2)
    ab = jax.lax.dot_general(
        a,
        b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # (N1, N2)
    sa = jnp.sum(a.astype(jnp.int32), axis=1)
    sb = jnp.sum(b.astype(jnp.int32), axis=1)
    return sa[:, None] + sb[None, :] - 2 * ab


def hamming_pairwise(desc1, desc2):
    """Row-wise Hamming between aligned arrays: (N,8),(N,8) -> (N,) int32."""
    x = jnp.bitwise_xor(desc1, desc2)
    return jax.lax.population_count(x).sum(axis=-1).astype(jnp.int32)
