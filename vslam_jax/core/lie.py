"""SO(3)/SE(3) Lie-group operations in pure jax.numpy.

The reference manipulates 4x4 ``cv::Mat`` poses directly with matrix products
(reference: src/vslam.cpp:80-88). A batched bundle adjuster needs proper
exp/log maps for minimal 6-dof updates, so this module provides them. All
functions are batched-friendly (vmap over leading axes) and numerically safe
near the identity (Taylor-series branches selected with ``jnp.where``, which
XLA compiles without data-dependent control flow).
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(w):
    """so(3) hat operator: (…,3) -> (…,3,3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W):
    """Inverse of hat: (…,3,3) -> (…,3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(w):
    """Rodrigues formula with small-angle Taylor branch. (…,3) -> (…,3,3)."""
    theta_sq = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta_sq + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks
    small = theta_sq < 1e-8
    A = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / (theta_sq + _EPS))
    I = jnp.eye(3, dtype=w.dtype)
    return I + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R):
    """(…,3,3) -> (…,3). Safe near identity and near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    # w = theta / (2 sin(theta)) * vee(R - R^T); Taylor for small theta
    sin_theta = jnp.sin(theta)
    small = jnp.abs(sin_theta) < 1e-6
    scale = jnp.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * jnp.where(small, 1.0, sin_theta)),
    )
    w = scale[..., None] * vee(R - jnp.swapaxes(R, -1, -2))
    return w


def _so3_left_jacobian(w):
    """V such that se3_exp translation = V @ rho."""
    theta_sq = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta_sq + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta_sq < 1e-8
    B = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / (theta_sq + _EPS))
    C = jnp.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (theta - jnp.sin(theta)) / (theta_sq * theta + _EPS)
    )
    I = jnp.eye(3, dtype=w.dtype)
    return I + B[..., None, None] * W + C[..., None, None] * W2


def se3_exp(xi):
    """se(3) exp: (…,6) [rho, w] -> (…,4,4) homogeneous transform."""
    rho, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return make_T(R, t)


def se3_log(T):
    """(…,4,4) -> (…,6) [rho, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    V = _so3_left_jacobian(w)
    rho = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([rho, w], axis=-1)


def make_T(R, t):
    """Assemble (…,4,4) from (…,3,3) and (…,3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )
    return jnp.concatenate([top, bottom[..., None, :]], axis=-2)


def inv_T(T):
    """Inverse of a rigid transform, exploiting structure (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def orthonormalize_T(T, iters: int = 2):
    """Project the rotation block of a (…, 4, 4) transform back onto SO(3)
    by Newton iteration (R <- R (3I - R^T R) / 2), leaving translation
    untouched.

    WHY THIS EXISTS: the tracked pose is a product chain — every frame
    composes ~a dozen 4x4 float32 products (pose chain, PnP GN exp-updates,
    inversions), and the accumulated non-orthogonality is MULTIPLICATIVE:
    measured on the corridor with dense PnP commits, the live pose's
    rotation singular values inflated 1.0 -> 1.07 within 30 frames
    (||R^T R - I|| 1e-6 -> 0.23), which scales every subsequent chained
    step and ran the committed scale to 24x. One Newton sweep per frame
    pins the drift at machine precision (the iteration is quadratically
    convergent near SO(3), so iters=2 is far below f32 eps for any
    per-frame drift).
    """
    R = T[..., :3, :3]
    I = jnp.eye(3, dtype=T.dtype)
    for _ in range(iters):
        R = R @ (1.5 * I - 0.5 * jnp.swapaxes(R, -1, -2) @ R)
    return T.at[..., :3, :3].set(R)


def transform_points(T, X):
    """Apply (…,4,4) to points (…,N,3) -> (…,N,3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
