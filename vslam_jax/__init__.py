"""vslam_jax — a monocular feature-based SLAM framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
rahulaggarwal965/vslam (C++/OpenCV/Pangolin), built from batched,
static-shape array programs:

  * feature detection / description as batched convolution + top-k kernels
    (frontend/),
  * descriptor matching as int8 bit-plane matmuls instead of brute-force
    CPU Hamming + KD-trees (matching/),
  * two-view geometry as massively parallel hypothesize-and-verify RANSAC —
    the completed form of the reference's unfinished ransac.cu (geometry/),
  * a functional fixed-capacity world map (mapping/),
  * Schur-complement Gauss-Newton/LM bundle adjustment — the completed form
    of the reference's optimzer.cpp stub (optimizer/),
  * multi-chip execution via jax.sharding meshes (parallel/).
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry (8-point, triangulation, BA) needs true f32 accumulation; a GPU
# runs float32 products as TF32 (about three decimal digits) unless the
# precision is raised, which breaks pose estimation. Hot kernels that can
# tolerate lower precision (descriptor matmuls are int8; image convs) opt in
# locally via jax.default_matmul_precision context or explicit `precision=`.
_jax.config.update("jax_default_matmul_precision", "highest")

from .config import VSLAMConfig, small_config  # noqa: F401
