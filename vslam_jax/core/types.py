"""Core pytree state containers.

Functional equivalents of the reference's mutable structs:
  * FrameFeatures  ≈ struct Frame        (reference include/Frame.h:11-27)
  * MapState       ≈ struct PointMap     (reference include/PointMap.h:10-21)
  * TwoViewResult  ≈ the locals of main's per-frame block (src/vslam.cpp:70-290)

Everything is a fixed-capacity padded array + validity mask so the whole SLAM
step compiles to a single static-shape XLA program.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree, every field a leaf.

    Instances pass through ``jit``/``lax.scan`` like any pytree; ``replace``
    returns a copy with the given fields swapped (``dataclasses.replace``).
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(
        cls, data_fields=names, meta_fields=[])


@pytree_dataclass
class FrameFeatures:
    """Per-frame detection output (fixed capacity N = config.frontend.max_keypoints).

    Replaces Frame.points / Frame.descriptors / Frame.map_point_ids
    (reference include/Frame.h:20-23). The KD-tree member (Frame.h:24) has no
    equivalent: spatial queries are batched distance computations on the
    device (see mapping/point_map.py).
    """
    uv: jnp.ndarray          # (N, 2) f32 pixel coords
    desc: jnp.ndarray        # (N, 8) uint32 packed 256-bit descriptors
    score: jnp.ndarray       # (N,) f32 detector response
    mask: jnp.ndarray        # (N,) bool — valid keypoint
    angle: jnp.ndarray       # (N,) f32 orientation (radians)

    @property
    def capacity(self) -> int:
        return self.uv.shape[-2]


@pytree_dataclass
class TwoViewResult:
    """Output of the two-view tracker (match → RANSAC → E → R,t)."""
    matches: jnp.ndarray       # (M, 2) i32 indices (idx in frame1, idx in frame2)
    match_mask: jnp.ndarray    # (M,) bool — survived ratio test + RANSAC
    F: jnp.ndarray             # (3, 3) fundamental matrix
    E: jnp.ndarray             # (3, 3) essential matrix
    R: jnp.ndarray             # (3, 3) relative rotation (cam1 -> cam2 coords)
    t: jnp.ndarray             # (3,) unit-norm relative translation
    num_inliers: jnp.ndarray   # () i32
    success: jnp.ndarray       # () bool


# Column layout of MapState.pt — the packed per-point f32 payload. All the
# f32 per-landmark state lives in ONE (C, PT_COLS) array so map mutation is
# ONE row scatter per op instead of six (the layout was chosen on the
# earlier accelerator, whose scatters serialized per update row; re-race
# on the H100 pending).
# xyz|conf are adjacent so the
# landmark-refine write (tracker 8b / BA write-back) is a single
# column-sliced scatter.
PT_XYZ = slice(0, 3)         # world position
PT_CONF = 3                  # maturity confidence (ray-span parallax, rad)
PT_COLOR = slice(4, 7)       # RGB in [0, 1]
PT_FIRST_UV = slice(7, 9)    # founding-observation pixel
PT_FIRST_C = slice(9, 12)    # founding camera center (world)
PT_FIRST_P = slice(12, 24)   # founding projection matrix, row-major (3, 4)
PT_COLS = 24


@pytree_dataclass
class MapState:
    """Persistent world map (functional version of reference PointMap).

    * pt — packed per-point f32 payload (see PT_* column layout above);
      exposed through the ``xyz``/``color``/``conf``/``first_*`` property
      views. Readers use the views (XLA fuses the column slice into the
      consuming gather); writers scatter packed rows.
        - xyz/color ≈ the reference point arrays (PointMap.h:13-17).
        - first_uv/first_P/first_C — the map-held track memory: when a
          broken track re-binds to its landmark via association, the
          tracker restores its pending record from these, so parallax
          maturity (and provisional promotion) accumulates across detector
          misses instead of resetting per unbroken match segment
          (tracker step 9). first_P is stored flat (12 columns); the
          property reshapes to (C, 3, 4).
        - conf — maturity confidence: the ray-span parallax (radians) of
          the landmark's last geometric estimate. PnP weights anchors by
          conf^2/(conf^2+conf0^2) — inverse depth-variance weighting
          (sigma_z ~ noise/parallax), so freshly promoted minimal-span
          anchors inform the pose without dominating it.
    * desc/desc_count — rolling archive of observation descriptors per point;
      supports the min-over-observations Hamming cost ``orb_distance``
      (reference src/PointMap.cpp:36-46) as a masked min-reduction. Stored
      point-major FLAT — row p * K + k is slot k of point p — so the
      observe/insert scatters are plain row scatters on a 2D row-major
      array (the (C, K, 8) form made XLA pick a capacity-minor layout and
      pay two ~0.4 ms layout-flip copies per frame around every scatter).
    * size — insert cursor (functional version of PointMap::size with doubling
      growth, reference src/PointMap.cpp:5-15 — here capacity is static).
    """
    pt: jnp.ndarray          # (C, PT_COLS) f32 packed payload (layout above)
    desc: jnp.ndarray        # (C * K, 8) uint32 observation descriptor archive
    desc_count: jnp.ndarray  # (C,) i32 observations recorded (may exceed K)
    alive: jnp.ndarray       # (C,) bool
    last_seen: jnp.ndarray   # (C,) i32 frame index of latest observation
    prov: jnp.ndarray        # (C,) bool — PROVISIONAL landmark: inserted
                             # below the full parallax-maturity gate so its
                             # depth is not yet trustworthy. Participates in
                             # association (track identity persists across
                             # detector misses) and in BA (which re-solves
                             # its position), but is excluded from PnP
                             # anchoring and from the scale-ratio estimate
                             # until promoted (tracker step 8b) at full
                             # parallax. Thickens the anchor supply without
                             # the depth-bias compounding that a globally
                             # lowered insertion gate reintroduces
                             # (tracker step 8 measurement note).
    size: jnp.ndarray        # () i32 insert cursor

    @property
    def capacity(self) -> int:
        return self.pt.shape[-2]

    @property
    def obs_slots(self) -> int:
        return self.desc.shape[-2] // self.pt.shape[-2]

    # ---- packed-column views (read-only; writers scatter into pt) --------
    @property
    def xyz(self) -> jnp.ndarray:
        return self.pt[..., PT_XYZ]

    @property
    def color(self) -> jnp.ndarray:
        return self.pt[..., PT_COLOR]

    @property
    def conf(self) -> jnp.ndarray:
        return self.pt[..., PT_CONF]

    @property
    def first_uv(self) -> jnp.ndarray:
        return self.pt[..., PT_FIRST_UV]

    @property
    def first_C(self) -> jnp.ndarray:
        return self.pt[..., PT_FIRST_C]

    @property
    def first_P(self) -> jnp.ndarray:
        return self.pt[..., PT_FIRST_P].reshape(
            self.pt.shape[:-1] + (3, 4))


def pack_pt_rows(xyz, conf, color, first_uv, first_C, first_P):
    """Assemble (B, PT_COLS) packed payload rows from per-field arrays.
    first_P may be (B, 3, 4) or (B, 12)."""
    B = xyz.shape[0]
    return jnp.concatenate([
        xyz,
        conf.reshape(B, 1),
        color,
        first_uv,
        first_C,
        first_P.reshape(B, 12),
    ], axis=1)


def empty_map(capacity: int, obs_slots: int) -> MapState:
    return MapState(
        pt=jnp.zeros((capacity, PT_COLS), jnp.float32),
        desc=jnp.zeros((capacity * obs_slots, 8), jnp.uint32),
        desc_count=jnp.zeros((capacity,), jnp.int32),
        alive=jnp.zeros((capacity,), bool),
        last_seen=jnp.zeros((capacity,), jnp.int32),
        prov=jnp.zeros((capacity,), bool),
        size=jnp.zeros((), jnp.int32),
    )


def empty_features(capacity: int) -> FrameFeatures:
    return FrameFeatures(
        uv=jnp.zeros((capacity, 2), jnp.float32),
        desc=jnp.zeros((capacity, 8), jnp.uint32),
        score=jnp.zeros((capacity,), jnp.float32),
        mask=jnp.zeros((capacity,), bool),
        angle=jnp.zeros((capacity,), jnp.float32),
    )
