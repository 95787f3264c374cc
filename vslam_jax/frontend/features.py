"""Corner detection as batched convolutions + tiled top-k.

Rebuild of the reference's feature front-end:
  * the active Shi-Tomasi path (`cv::goodFeaturesToTrack`, reference
    src/Frame.cpp:61: 3000 corners, quality 0.01, min distance 3) becomes a
    structure-tensor min-eigenvalue response computed with depthwise
    convolutions, non-max suppression by max-pooling, and a top-k selection;
  * the dormant 5x5 grid-tiled ORB path (reference src/Frame.cpp:16-51)
    becomes the *default* selection strategy: top-k per image tile, which
    yields the spatial distribution ORB-SLAM-style systems want and maps to
    a single reshaped top-k.

Everything returns fixed-size padded arrays (capacity = config max_keypoints)
with validity masks — XLA static shapes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FrontendConfig


def _shift(img, dy: int, dx: int):
    """img shifted so out[y,x] = img[y+dy, x+dx], edge-padded. Static offsets."""
    H, W = img.shape
    r = max(abs(dy), abs(dx))
    if r == 0:
        return img
    p = jnp.pad(img, r, mode="edge")
    return jax.lax.dynamic_slice(p, (r + dy, r + dx), (H, W))


def _sep_filter(img, k, radius: int, axis: int):
    """1D correlation along axis via static shifts + multiply-adds.

    Unrolled shift-MACs are elementwise adds and fuse into one kernel,
    where a single-channel 2D convolution may lower to a generic sliding
    window (chosen on the earlier accelerator; re-race on the H100
    pending).
    """
    out = jnp.zeros_like(img)
    for i in range(2 * radius + 1):
        o = i - radius
        s = _shift(img, o, 0) if axis == 0 else _shift(img, 0, o)
        out = out + float(k[i]) * s
    return out


def sobel_gradients(img):
    """Ix, Iy via separable Sobel ([1,2,1] smooth ⊗ [-1,0,1] diff), shift-add."""
    smooth = np.array([1.0, 2.0, 1.0]) / 4.0
    diff = np.array([-1.0, 0.0, 1.0]) / 2.0
    ix = _sep_filter(_sep_filter(img, smooth, 1, axis=0), diff, 1, axis=1)
    iy = _sep_filter(_sep_filter(img, smooth, 1, axis=1), diff, 1, axis=0)
    return ix, iy


def _box_filter(img, radius: int):
    k = np.ones(2 * radius + 1) / float(2 * radius + 1)
    return _sep_filter(_sep_filter(img, k, radius, axis=0), k, radius, axis=1)


def gaussian_kernel_1d(sigma: float, radius: int):
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img, sigma: float, radius: int | None = None):
    """Separable Gaussian blur (shift-add stencil)."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    k = gaussian_kernel_1d(sigma, radius)
    img = _sep_filter(img, k, radius, axis=1)
    img = _sep_filter(img, k, radius, axis=0)
    return img


def corner_response(img, score: str = "shi_tomasi", harris_k: float = 0.04,
                    window_radius: int = 2):
    """Structure-tensor corner response map.

    shi_tomasi: min eigenvalue of the structure tensor (what
    goodFeaturesToTrack computes, reference src/Frame.cpp:61).
    harris: det - k trace^2 (what the reference's grid-ORB used via
    cv::ORB HARRIS_SCORE, src/Frame.cpp:22).
    """
    ix, iy = sobel_gradients(img)
    sxx = _box_filter(ix * ix, window_radius)
    syy = _box_filter(iy * iy, window_radius)
    sxy = _box_filter(ix * iy, window_radius)
    if score == "harris":
        det = sxx * syy - sxy * sxy
        tr = sxx + syy
        return det - harris_k * tr * tr
    # min-eigenvalue (Shi-Tomasi)
    half_tr = 0.5 * (sxx + syy)
    disc = jnp.sqrt(jnp.maximum(0.25 * (sxx - syy) ** 2 + sxy * sxy, 0.0))
    return half_tr - disc


def nms(response, radius: int):
    """Non-max suppression: keep pixels equal to their window max
    (the functional equivalent of goodFeaturesToTrack's min-distance,
    reference src/Frame.cpp:61).

    Square-window max is separable: shift-max along rows then columns —
    element-wise maxes instead of a generic reduce_window lowering.
    """
    pooled = response
    for axis in (0, 1):
        acc = pooled
        for o in range(1, radius + 1):
            if axis == 0:
                acc = jnp.maximum(acc, _shift(pooled, o, 0))
                acc = jnp.maximum(acc, _shift(pooled, -o, 0))
            else:
                acc = jnp.maximum(acc, _shift(pooled, 0, o))
                acc = jnp.maximum(acc, _shift(pooled, 0, -o))
        pooled = acc
    return response >= pooled


def _subpixel_offsets(response, ys, xs):
    """Quadratic 3-point sub-pixel refinement along each axis."""
    H, W = response.shape

    def sample(dy, dx):
        yy = jnp.clip(ys + dy, 0, H - 1)
        xx = jnp.clip(xs + dx, 0, W - 1)
        return response[yy, xx]

    c = sample(0, 0)
    def axis_offset(m, p):
        denom = m - 2.0 * c + p
        off = 0.5 * (m - p) / jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom)
        return jnp.clip(off, -0.5, 0.5)

    dx = axis_offset(sample(0, -1), sample(0, 1))
    dy = axis_offset(sample(-1, 0), sample(1, 0))
    return dy, dx


def refine_tracked(resp, prev_uv, prev_mask, border: int,
                   height: int, width: int, radius: int = 3):
    """Re-localize carried keypoints at the local response maximum around
    their PREDICTED positions.

    The per-tile top-k selection is repeatable only for strong corners:
    marginal ones pop in and out of a tile's top-k frame to frame, and a
    missed detection kills the feature track (and with it the landmark's
    map-id chain). Measured on the synthetic corridor: 33% of mapped
    keypoints lost their match each frame, 77% of those because no
    keypoint was detected within 3 px of the landmark's projection. A
    tracked corner that still has response near its predicted position
    should survive REGARDLESS of global budget competition — the KLT
    insight, batched: one (N, (2r+1)^2) gather +
    argmax per carried keypoint. The caller supplies prediction
    (pipeline/tracker.py projects each mapped keypoint's landmark through
    the constant-velocity pose, so the search radius only has to cover
    motion-model error, not optical flow).

    Returns (uv (N, 2), score (N,), ok (N,)).
    """
    n = prev_uv.shape[0]
    xi = jnp.clip(jnp.round(prev_uv[:, 0]).astype(jnp.int32), 0, width - 1)
    yi = jnp.clip(jnp.round(prev_uv[:, 1]).astype(jnp.int32), 0, height - 1)
    d = jnp.arange(-radius, radius + 1)
    wy = jnp.clip(yi[:, None, None] + d[None, :, None], 0, height - 1)
    wx = jnp.clip(xi[:, None, None] + d[None, None, :], 0, width - 1)
    win = resp[wy, wx].reshape(n, -1)                   # (N, (2r+1)^2)
    flat = jnp.argmax(win, axis=1)
    score = jnp.max(win, axis=1)
    w = 2 * radius + 1
    by = flat // w - radius
    bx = flat % w - radius
    ys = jnp.clip(yi + by, 0, height - 1)
    xs = jnp.clip(xi + bx, 0, width - 1)
    dy, dx = _subpixel_offsets(resp, ys, xs)
    uv = jnp.stack([xs.astype(jnp.float32) + dx,
                    ys.astype(jnp.float32) + dy], axis=1)
    ok = (prev_mask & (xs >= border) & (xs < width - border)
          & (ys >= border) & (ys < height - border) & (score > 0.0))
    return uv, score, ok


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width"))
def detect(img, cfg: FrontendConfig, height: int, width: int):
    """Detect corners on a (height, width) grayscale image.

    Returns (uv (N,2) f32, score (N,) f32, mask (N,) bool), N = cfg.max_keypoints.

    Selection: the image is split into cfg.grid_rows x cfg.grid_cols tiles and
    the strongest k-per-tile responses are kept (idiomatic form of the
    reference's per-cell cap, src/Frame.cpp:27-42). Quality gating mirrors
    goodFeaturesToTrack: response >= quality_level * max response.
    """
    resp = corner_response(img, cfg.score, cfg.harris_k)
    return _select(resp, cfg, height, width)


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width"))
def detect_with_carry(img, cfg: FrontendConfig, height: int, width: int,
                      carry_uv, carry_mask):
    """detect() + carried-keypoint survival (refine_tracked).

    Carried keypoints (re-localized at the response maximum around their
    predicted positions) take PRIORITY over fresh detections in the
    budget, and fresh detections within nms_radius of a surviving carried
    keypoint are dropped (they are the same corner — keeping both would
    make the ratio test reject the pair's matches as ambiguous). Carried
    keypoints that converge onto the same corner dedupe among themselves
    the same way.
    """
    n = cfg.max_keypoints
    resp = corner_response(img, cfg.score, cfg.harris_k)
    uv_f, sc_f, ok_f = _select(resp, cfg, height, width)
    uv_t, sc_t, ok_t = refine_tracked(resp, carry_uv, carry_mask,
                                      cfg.border, height, width)
    # carried corners still satisfy the detector's quality gate
    ok_t = ok_t & (sc_t > cfg.quality_level * jnp.max(resp))
    # tracked-tracked dedupe: keep the lowest-index claimant of a corner,
    # with the SAME Chebyshev metric as the detector's square-window NMS
    # (ADVICE r04: a Euclidean circle misses diagonal offsets inside the
    # NMS square, letting the ratio-test-fatal duplicate pair survive).
    # One-pass suppression by index priority: in a chain a~b~c (a not
    # near c), b — itself killed by a — still kills c. Accepted as an
    # approximation: chains need 3+ carried keypoints converging within
    # one NMS window, which refine_tracked's shared-argmax already makes
    # rare, and the cost is one lost carry (the corner re-enters as a
    # fresh detection next frame), not a wrong measurement.
    r_cheb = float(cfg.nms_radius)
    d_tt = jnp.max(jnp.abs(uv_t[:, None] - uv_t[None, :]), axis=-1)
    i = jnp.arange(uv_t.shape[0])
    clash = (d_tt <= r_cheb) & ok_t[None, :] & (i[None, :] < i[:, None])
    ok_t = ok_t & ~clash.any(axis=1)
    # fresh detections duplicating a surviving carried corner are dropped
    d_ft = jnp.max(jnp.abs(uv_f[:, None] - uv_t[None, :]), axis=-1)
    ok_f = ok_f & ~((d_ft <= r_cheb) & ok_t[None, :]).any(axis=1)

    uv = jnp.concatenate([uv_t, uv_f], axis=0)
    sc = jnp.concatenate([sc_t, sc_f], axis=0)
    ok = jnp.concatenate([ok_t, ok_f], axis=0)
    pri = jnp.concatenate([sc_t + 1e9, sc_f], axis=0)   # carried outrank
    order = jnp.argsort(jnp.where(ok, -pri, jnp.inf))[:n]
    return uv[order], jnp.where(ok, sc, 0.0)[order], ok[order]


def _select(resp, cfg: FrontendConfig, height: int, width: int):
    keep = nms(resp, cfg.nms_radius)

    H, W = height, width
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    b = cfg.border
    in_border = (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)

    masked = jnp.where(keep & in_border, resp, -jnp.inf)

    n = cfg.max_keypoints
    gr, gc = cfg.grid_rows, cfg.grid_cols
    if gr > 0 and gc > 0 and H % gr == 0 and W % gc == 0 and n % (gr * gc) == 0:
        th, tw = H // gr, W // gc
        k_tile = n // (gr * gc)
        tiles = masked.reshape(gr, th, gc, tw).transpose(0, 2, 1, 3).reshape(
            gr * gc, th * tw
        )
        vals, idx = jax.lax.top_k(tiles, k_tile)  # (T, k)
        ty = idx // tw
        tx = idx % tw
        tile_row = jax.lax.broadcasted_iota(jnp.int32, (gr * gc, k_tile), 0) // gc
        tile_col = jax.lax.broadcasted_iota(jnp.int32, (gr * gc, k_tile), 0) % gc
        ys = (tile_row * th + ty).reshape(-1)
        xs = (tile_col * tw + tx).reshape(-1)
        scores = vals.reshape(-1)
    else:
        vals, idx = jax.lax.top_k(masked.reshape(-1), n)
        ys = idx // W
        xs = idx % W
        scores = vals

    max_resp = jnp.max(resp)
    valid = (scores > cfg.quality_level * max_resp) & jnp.isfinite(scores)

    dy, dx = _subpixel_offsets(resp, ys, xs)
    uv = jnp.stack(
        [xs.astype(jnp.float32) + dx, ys.astype(jnp.float32) + dy], axis=1
    )
    # Re-sort globally by score so truncation (if any) keeps the best, and
    # padded/invalid entries sink to the end.
    order = jnp.argsort(jnp.where(valid, -scores, jnp.inf))
    order = order[:n]
    return uv[order], jnp.where(valid, scores, 0.0)[order], valid[order]
