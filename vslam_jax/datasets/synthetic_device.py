"""On-device synthetic frame rendering (JAX), for device-resident runs.

The host renderer (datasets/synthetic.py render_frame) is a Python loop of
patch splats — fine for tests, but far slower than the tracker, so a long
device run fed by it measures the renderer and the upload, not the SLAM
system. This module renders the SAME scene model entirely on device:
project all landmarks, bilinear-resample each landmark's patch by its
subpixel offset (the same 4-tap scheme as the host renderer), and scatter
the patches into the frame.

Overlap handling matches the host renderer's painter's algorithm via a
two-pass z-buffer: scatter-min per-pixel depth, then each patch writes only
the pixels it owns (its depth equals the buffer's). XLA scatter-min/max are
well-defined under colliding indices, unlike scatter-set — an additive
composite was tried first and measurably broke tracking: overlapping
patches near the vanishing point summed into saturated high-contrast blobs
that the detector locked onto as stable pseudo-corners with corrupted
identities, collapsing the monocular scale 1.0 -> 0.05 over 400 frames on
the same corridor the host renderer tracks at ATE 0.35.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("num_points", "patch_size"))
def make_corridor_scene_device(key, poses, num_points: int,
                               lateral: float = 14.0, vertical: float = 5.0,
                               ahead_min: float = 4.0, ahead_max: float = 45.0,
                               patch_size: int = 9):
    """Generate a corridor scene ON the device (no host upload).

    Device-side generation reduces the transfer to the (F, 4, 4) pose
    array. Mirrors the host
    generator's design (datasets/synthetic.py make_corridor_scene +
    _make_patches: landmarks anchored along the trajectory; smoothed
    high-contrast binary identity texture + X-junction center) with JAX
    RNG — the scene is statistically equivalent, not bit-identical.

    Returns (xyz (P, 3), patches (P, ps, ps)).
    """
    kk = jax.random.split(key, 6)
    F = poses.shape[0]
    idx = jax.random.randint(kk[0], (num_points,), 0, F)
    T = poses[idx]                                        # (P, 4, 4)
    right, up, fwd = T[:, :3, 0], T[:, :3, 1], T[:, :3, 2]
    pos = T[:, :3, 3]
    xyz = (
        pos
        + fwd * jax.random.uniform(kk[1], (num_points, 1),
                                   minval=ahead_min, maxval=ahead_max)
        + right * (jax.random.normal(kk[2], (num_points, 1)) * lateral)
        + up * (jax.random.normal(kk[3], (num_points, 1)) * vertical)
    )

    ps = patch_size
    patches = jnp.where(
        jax.random.uniform(kk[4], (num_points, ps, ps)) > 0.5, 0.85, 0.15)
    # 3x3 box smooth, edge-padded (same as synthetic._box3)
    pp = jnp.pad(patches, ((0, 0), (1, 1), (1, 1)), mode="edge")
    sm = jnp.zeros_like(patches)
    for dy in range(3):
        for dx in range(3):
            sm = sm + pp[:, dy:dy + ps, dx:dx + ps]
    patches = sm / 9.0
    c = ps // 2
    q = 2
    hi = jax.random.uniform(kk[5], (num_points, 1, 1), minval=0.9, maxval=1.0)
    lo = 1.0 - hi
    patches = patches.at[:, c - q:c, c - q:c].set(
        jnp.broadcast_to(hi, (num_points, q, q)))
    patches = patches.at[:, c:c + q, c:c + q].set(
        jnp.broadcast_to(hi, (num_points, q, q)))
    patches = patches.at[:, c - q:c, c:c + q].set(
        jnp.broadcast_to(lo, (num_points, q, q)))
    patches = patches.at[:, c:c + q, c - q:c].set(
        jnp.broadcast_to(lo, (num_points, q, q)))
    return xyz.astype(jnp.float32), patches.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("width", "height"))
def render_frame_device(xyz, patches, K, T_wc, width: int, height: int,
                        background: float = 0.35):
    """Render one grayscale frame on device.

    Args:
      xyz: (P, 3) world landmarks.
      patches: (P, ps, ps) per-landmark texture in [0, 1].
      K: (3, 3) intrinsics; T_wc: (4, 4) camera-to-world pose.
    Returns: (H, W) float32 image in [0, 1].
    """
    P, ps, _ = patches.shape
    r = ps // 2
    T_cw = jnp.linalg.inv(T_wc)
    Xc = xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = Xc[:, 2]
    uvw = Xc @ K.T
    uv = uvw[:, :2] / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)[:, None]

    vis = (
        (z > 0.2)
        & (uv[:, 0] >= r + 1) & (uv[:, 0] < width - r - 1)
        & (uv[:, 1] >= r + 1) & (uv[:, 1] < height - r - 1)
    )
    xi = jnp.floor(uv[:, 0]).astype(jnp.int32)
    yi = jnp.floor(uv[:, 1]).astype(jnp.int32)
    fx = (uv[:, 0] - xi)[:, None, None]
    fy = (uv[:, 1] - yi)[:, None, None]

    # subpixel placement: same bilinear 4-tap resample as the host renderer
    pp = jnp.pad(patches, ((0, 0), (1, 1), (1, 1)), mode="edge")
    shifted = (
        (1 - fy) * (1 - fx) * pp[:, 1:-1, 1:-1]
        + (1 - fy) * fx * pp[:, 1:-1, :-2]
        + fy * (1 - fx) * pp[:, :-2, 1:-1]
        + fy * fx * pp[:, :-2, :-2]
    )                                                     # (P, ps, ps)

    dy = jnp.arange(-r, r + 1)
    yy = yi[:, None, None] + dy[None, :, None]            # (P, ps, 1)
    xx = xi[:, None, None] + dy[None, None, :]            # (P, 1, ps)
    yy = jnp.broadcast_to(yy, (P, ps, ps))
    xx = jnp.broadcast_to(xx, (P, ps, ps))
    # invisible landmarks scatter out of bounds -> dropped
    yy = jnp.where(vis[:, None, None], yy, height)

    # pass 1: per-pixel nearest depth (scatter-min is duplicate-safe)
    zpix = jnp.broadcast_to(z[:, None, None], (P, ps, ps))
    zbuf = jnp.full((height, width), jnp.inf, jnp.float32)
    zbuf = zbuf.at[yy, xx].min(zpix, mode="drop")
    # pass 2: each patch writes only pixels it owns (depth ties can only be
    # the same landmark; distinct-landmark f32 depth ties are measure-zero)
    own = zpix == zbuf[jnp.clip(yy, 0, height - 1), jnp.clip(xx, 0, width - 1)]
    val = jnp.where(own, shifted, -jnp.inf)
    img = jnp.full((height, width), -jnp.inf, jnp.float32)
    img = img.at[yy, xx].max(val, mode="drop")
    return jnp.where(jnp.isfinite(img), img, background)
