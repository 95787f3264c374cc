"""Oriented binary (rBRIEF/ORB-style) descriptors as batched gather kernels.

The reference calls OpenCV's ORB::compute for 256-bit descriptors at fixed
keypoint size (reference src/Frame.cpp:57,66-68). Rebuilt as batched
array kernels:

  * orientation by the ORB intensity-centroid method, computed for all N
    keypoints at once from gathered patches;
  * a fixed pseudo-random 256-pair sampling pattern (generated once,
    seeded — our own pattern, *not* OpenCV's learned table; matching only
    requires internal consistency);
  * pattern steering by the keypoint angle, bilinear sampling of the blurred
    image at all N x 256 x 2 locations in one gather, comparison -> bits;
  * bit-packing into (N, 8) uint32 words so the Hamming stage can use either
    `lax.population_count` or the int8 bit-plane matmul (matching/hamming.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FrontendConfig
from .features import _sep_filter, gaussian_blur

_PATTERN_SEED = 42


@functools.lru_cache(maxsize=None)
def brief_pattern(bits: int = 256, patch_radius: int = 15):
    """(bits, 4) float32 [x1, y1, x2, y2] sampling offsets, Gaussian-distributed
    (BRIEF G-II), clipped inside the patch. Fixed at import by seed.

    Returns numpy (NOT jnp): cached device arrays created inside a jit trace
    would leak tracers into later traces."""
    rng = np.random.RandomState(_PATTERN_SEED)
    sigma = patch_radius / 2.5
    pts = rng.randn(bits, 4) * sigma
    pts = np.clip(pts, -(patch_radius - 1), patch_radius - 1)
    return pts.astype(np.float32)


def _gather_nearest(img, y, x):
    """Nearest-neighbor sample img (H,W) at float coords; clamps to borders.

    One gather per sample instead of bilinear's four.
    ORB itself rounds the steered pattern to integer offsets, so nearest
    sampling matches the reference descriptor's semantics
    (cv::ORB, reference src/Frame.cpp:57).
    """
    H, W = img.shape
    yi = jnp.clip(jnp.round(y), 0, H - 1).astype(jnp.int32)
    xi = jnp.clip(jnp.round(x), 0, W - 1).astype(jnp.int32)
    return img.reshape(-1)[yi * W + xi]


def _gather_bilinear(img, y, x):
    """Bilinear sample img (H,W) at float coords; clamps to borders.
    y, x: any broadcastable shape."""
    H, W = img.shape
    y0 = jnp.clip(jnp.floor(y), 0, H - 2)
    x0 = jnp.clip(jnp.floor(x), 0, W - 2)
    wy = y - y0
    wx = x - x0
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)
    flat = img.reshape(-1)

    def at(yy, xx):
        return flat[yy * W + xx]

    v00 = at(y0i, x0i)
    v01 = at(y0i, x0i + 1)
    v10 = at(y0i + 1, x0i)
    v11 = at(y0i + 1, x0i + 1)
    return (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )


@functools.lru_cache(maxsize=None)
def _centroid_grids(radius: int):
    """Numpy grids (see brief_pattern for why not jnp)."""
    ys = np.arange(-radius, radius + 1, dtype=np.float32)
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    mask = (gx ** 2 + gy ** 2) <= radius ** 2  # circular patch like ORB
    return gy, gx, mask.astype(np.float32)


def compute_orientations(img, uv, patch_radius: int):
    """ORB intensity-centroid orientation: theta = atan2(m01, m10) over a
    circular patch. uv: (N, 2). Returns (N,) radians.

    Gather formulation (N x (2r+1)^2 random samples) — kept as the oracle;
    the pipeline uses ``orientation_map`` + one small gather, which avoids
    the N x (2r+1)^2 random gathers."""
    gy, gx, circ = _centroid_grids(patch_radius)
    # (N, d, d) absolute sample coordinates
    y = uv[:, 1][:, None, None] + gy[None]
    x = uv[:, 0][:, None, None] + gx[None]
    vals = _gather_nearest(img, y, x) * circ[None]
    m01 = jnp.sum(vals * gy[None], axis=(1, 2))
    m10 = jnp.sum(vals * gx[None], axis=(1, 2))
    return jnp.arctan2(m01, m10)


def orientation_map(img, patch_radius: int):
    """Dense intensity-centroid orientation, one angle per pixel.

    Dense formulation: over a SQUARE (2r+1)^2 patch the centroid moments are
    separable correlations — m10 = box_y(ramp_x(I)), m01 = box_x(ramp_y(I)) —
    four 1D shift-MAC passes over the image (elementwise, fuses) instead of
    N x (2r+1)^2 random gathers. The square window (vs ORB's circular disc)
    costs a few degrees of rotation equivariance at 45 deg; it is exactly
    equivariant at multiples of 90 deg. Descriptor matching only needs
    frame-to-frame consistency, which a fixed window provides.
    """
    r = patch_radius
    ramp = np.arange(-r, r + 1, dtype=np.float32)
    box = np.ones(2 * r + 1, dtype=np.float32)
    m10 = _sep_filter(_sep_filter(img, ramp, r, axis=1), box, r, axis=0)
    m01 = _sep_filter(_sep_filter(img, ramp, r, axis=0), box, r, axis=1)
    return jnp.arctan2(m01, m10)


def orientations_at(img, uv, patch_radius: int):
    """Per-keypoint orientation via the dense map + one (N,) gather."""
    H, W = img.shape
    amap = orientation_map(img, patch_radius)
    xi = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, H - 1)
    return amap[yi, xi]


def pack_bits(bits):
    """(N, 256) bool -> (N, 8) uint32, little-endian within each word."""
    n, nbits = bits.shape
    words = bits.reshape(n, nbits // 32, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    return jnp.sum(words << shifts, axis=2, dtype=jnp.uint32)


def unpack_bits(packed, nbits: int = 256):
    """(N, 8) uint32 -> (N, 256) int8 in {0,1}."""
    n = packed.shape[0]
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = (packed[:, :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(n, nbits).astype(jnp.int8)


@functools.lru_cache(maxsize=None)
def _int_pattern(bits: int, patch_radius: int):
    """Integer-rounded BRIEF offsets for the dense (upright) path. Numpy."""
    pat = brief_pattern(bits, patch_radius)
    return np.round(pat).astype(np.int32)


def describe_dense_upright(img_blurred, uv, cfg: FrontendConfig):
    """Gather-free upright BRIEF — the default descriptor path.

    Instead of sampling 2*256 offsets per keypoint (N x 512 bilinear
    gathers), compute every pixel's descriptor densely: each of the 256
    pairs is one comparison between two *shifted copies of the whole image*
    (elementwise work), the bits are packed
    into an (H, W, 8) uint32 bit-plane image, and the N keypoints just gather
    their 8 words. Rotation invariance is dropped (fine for forward-motion
    video; the oriented gather path remains available via cfg-driven
    dispatch in frame.py).
    """
    H, W = img_blurred.shape
    pat = _int_pattern(cfg.descriptor_bits, cfg.patch_radius)  # (B, 4) np
    r = cfg.patch_radius
    padded = jnp.pad(img_blurred, r, mode="edge")

    def shifted(dx, dy):
        # value at (y, x) = img[y + dy, x + dx]
        return jax.lax.dynamic_slice(padded, (r + dy, r + dx), (H, W))

    words = []
    for w in range(cfg.descriptor_bits // 32):
        acc = jnp.zeros((H, W), jnp.uint32)
        for b in range(32):
            x1, y1, x2, y2 = pat[w * 32 + b]
            bit = (shifted(int(x1), int(y1)) < shifted(int(x2), int(y2)))
            acc = acc | (bit.astype(jnp.uint32) << np.uint32(b))
        words.append(acc)
    planes = jnp.stack(words, axis=-1)            # (H, W, 8) uint32
    xi = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, H - 1)
    return planes[yi, xi]                          # (N, 8)


@functools.partial(jax.jit, static_argnames=("cfg",))
def describe(img_blurred, uv, angle, cfg: FrontendConfig):
    """Steered-BRIEF descriptors.

    Args:
      img_blurred: (H, W) pre-smoothed grayscale image.
      uv: (N, 2) keypoint pixel coords.
      angle: (N,) orientation in radians.
    Returns:
      (N, 8) uint32 packed 256-bit descriptors.
    """
    pat = brief_pattern(cfg.descriptor_bits, cfg.patch_radius)  # (B, 4)
    c = jnp.cos(angle)[:, None]  # (N, 1)
    s = jnp.sin(angle)[:, None]

    def rot(px, py):
        # (N, B) rotated offsets
        return c * px[None, :] - s * py[None, :], s * px[None, :] + c * py[None, :]

    x1, y1 = rot(pat[:, 0], pat[:, 1])
    x2, y2 = rot(pat[:, 2], pat[:, 3])
    ax1 = uv[:, 0:1] + x1
    ay1 = uv[:, 1:2] + y1
    ax2 = uv[:, 0:1] + x2
    ay2 = uv[:, 1:2] + y2
    i1 = _gather_nearest(img_blurred, ay1, ax1)  # (N, B)
    i2 = _gather_nearest(img_blurred, ay2, ax2)
    bits = i1 < i2
    return pack_bits(bits)


def describe_from_image(img, uv, cfg: FrontendConfig):
    """Convenience: blur + orient + describe. Returns (desc, angle)."""
    blurred = gaussian_blur(img, cfg.blur_sigma)
    angle = compute_orientations(blurred, uv, cfg.patch_radius)
    desc = describe(blurred, uv, angle, cfg)
    return desc, angle
