"""Per-frame feature extraction: the jitted analogue of the reference's
``extract_features(Frame&)`` (reference src/Frame.cpp:53-80).

One call turns a grayscale image into a fixed-capacity FrameFeatures pytree:
detect -> orient -> describe, all fused under a single jit. The KD-tree the
reference builds per frame (src/Frame.cpp:76) has no equivalent here: spatial
queries are batched distance computations (matching/projection.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import FrontendConfig
from ..core.types import FrameFeatures
from . import descriptors, features


@functools.partial(jax.jit, static_argnames=("cfg", "height", "width"))
def extract_features(img, cfg: FrontendConfig, height: int, width: int,
                     carry_uv=None, carry_mask=None) -> FrameFeatures:
    """img: (height, width) float32 grayscale in [0, 1].

    ``carry_uv``/``carry_mask``: optional predicted positions of carried
    keypoints (mapped-track survival, features.detect_with_carry); None
    selects the plain detector.

    Descriptor path is config-selected: oriented steered-BRIEF (gathers,
    rotation-invariant) or dense upright BRIEF (shifted-image bit planes,
    the default) — the two-strategy structure mirrors the reference's
    pair of extractors (src/Frame.cpp:16-51 vs :53-80).
    """
    if carry_uv is not None:
        uv, score, mask = features.detect_with_carry(
            img, cfg, height, width, carry_uv, carry_mask)
    else:
        uv, score, mask = features.detect(img, cfg, height, width)
    blurred = features.gaussian_blur(img, cfg.blur_sigma)
    if cfg.oriented:
        angle = descriptors.orientations_at(blurred, uv, cfg.patch_radius)
        desc = descriptors.describe(blurred, uv, angle, cfg)
    else:
        angle = jnp.zeros_like(score)
        desc = descriptors.describe_dense_upright(blurred, uv, cfg)
    # Zero descriptors of invalid slots so padded rows can't accidentally match.
    desc = jnp.where(mask[:, None], desc, 0)
    return FrameFeatures(uv=uv, desc=desc, score=score, mask=mask, angle=angle)
