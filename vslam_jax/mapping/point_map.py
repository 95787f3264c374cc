"""Functional persistent world map.

Rebuild of the reference's PointMap (reference
include/PointMap.h:10-24, src/PointMap.cpp):

  * ``insert_points``    ≈ add_reprojection_inliers (src/PointMap.cpp:3-34) —
    masked scatter at an insert cursor instead of realloc-and-copy growth.
  * descriptor archive   ≈ the per-point observation lists frame_ids /
    frame_point_ids (PointMap.h:15-16). We store a rolling window of K
    observation descriptors per point, so the min-over-observations Hamming
    cost ``orb_distance`` (src/PointMap.cpp:36-46) becomes a masked min over
    the K axis.
  * ``associate``        ≈ the search-by-projection block inlined in main
    (src/vslam.cpp:129-161): project -> frustum test -> radius search ->
    min-Hamming gate. The KD-tree radius query (src/vslam.cpp:149,
    KDTree.cpp:145-171) becomes a dense masked distance reduction, scanned
    over fixed-size map blocks to bound memory; per block the descriptor
    distances are int8 bit-plane matmuls.

Association here is argmin-per-keypoint, which is strictly better than the
reference's first-candidate-wins loop (and immune to its `> 0` vs `>= 0`
map-id bug, src/vslam.cpp:114,239).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MapConfig, MatchingConfig
from ..core import types
from ..core.types import MapState
from ..frontend.descriptors import unpack_bits

# associate(): packed (hamming << 18 | row) selection key sentinel — larger
# than any real key (max ham 256 -> 256·2^18 + row < 2^27)
_NO_KEY = 1 << 30


def insert_points(m: MapState, xyz, color, desc, valid, frame_idx=0,
                  provisional=None, first_uv=None, first_P=None,
                  first_C=None, conf=None) -> MapState:
    """Append masked rows at the insert cursor.

    Args:
      xyz: (B, 3) world points; color: (B, 3); desc: (B, 8) uint32 packed
      descriptor of the founding observation; valid: (B,) bool;
      provisional: optional (B,) bool — rows inserted below the full
      parallax-maturity gate (MapState.prov semantics); None = all full;
      first_uv/first_P/first_C: optional founding-observation record
      ((B, 2), (B, 3, 4), (B, 3)) — the map-held track memory
      (MapState.first_*); None = zeros.
    Rows beyond capacity are dropped (cursor saturates); the tracker counts
    them (TrackOutput.num_dropped_inserts) and the pipeline reclaims slots
    via ``evict_lru`` + ``compact`` before the cursor gets there.
    """
    C = m.capacity
    K = m.obs_slots
    B = valid.shape[0]
    if provisional is None:
        provisional = jnp.zeros_like(valid)
    if first_uv is None:
        first_uv = jnp.zeros((B, 2), jnp.float32)
    if first_P is None:
        first_P = jnp.zeros((B, 3, 4), jnp.float32)
    if first_C is None:
        first_C = jnp.zeros((B, 3), jnp.float32)
    if conf is None:
        conf = jnp.zeros((B,), jnp.float32)
    offs = jnp.cumsum(valid.astype(jnp.int32)) - 1          # (B,)
    pos = jnp.where(valid, m.size + offs, C)                # C = out-of-range -> drop
    pos = jnp.where(pos < C, pos, C)
    payload = types.pack_pt_rows(xyz, conf, color, first_uv, first_C, first_P)
    m2 = MapState(
        pt=m.pt.at[pos].set(payload, mode="drop"),
        desc=m.desc.at[pos * K].set(desc, mode="drop"),   # founding = slot 0
        desc_count=m.desc_count.at[pos].set(1, mode="drop"),
        alive=m.alive.at[pos].set(True, mode="drop"),
        last_seen=m.last_seen.at[pos].set(
            jnp.asarray(frame_idx, jnp.int32), mode="drop"),
        prov=m.prov.at[pos].set(provisional, mode="drop"),
        size=jnp.minimum(m.size + valid.sum().astype(jnp.int32), C),
    )
    return m2


def add_observations(m: MapState, point_ids, desc, valid, frame_idx=0) -> MapState:
    """Record a new observation descriptor for existing map points.

    point_ids: (N,) i32 (-1 or invalid rows dropped); desc: (N, 8) uint32.
    Descriptors go into a rolling slot (desc_count % K), the functional
    version of the reference pushing onto frame_ids/frame_point_ids
    (src/vslam.cpp:116-117,154-156).
    """
    K = m.obs_slots
    ok = valid & (point_ids >= 0)
    pid = jnp.where(ok, point_ids, m.capacity)  # drop via out-of-range
    slot = jnp.where(ok, m.desc_count[jnp.clip(point_ids, 0, m.capacity - 1)] % K, 0)
    return m.replace(
        desc=m.desc.at[pid * K + slot].set(desc, mode="drop"),
        desc_count=m.desc_count.at[pid].add(ok.astype(jnp.int32), mode="drop"),
        last_seen=m.last_seen.at[pid].set(
            jnp.asarray(frame_idx, jnp.int32), mode="drop"),
    )


def cull_stale(m: MapState, current_frame, min_obs: int = 2,
               max_age: int = 30) -> MapState:
    """Retire landmarks that were created but never corroborated.

    A point with fewer than ``min_obs`` recorded observations that has not
    been seen for ``max_age`` frames is marked dead: it stops participating
    in association and is dropped from snapshots. (The reference's map only
    ever grows and every spurious triangulation stays forever —
    SURVEY.md §5 'long-context'.) Culling only marks slots dead (cursor
    monotonicity keeps ids stable for the observation graph between
    maintenance points); ``compact`` reclaims the slots and hands back the
    id remap for every id holder to apply.
    """
    in_cursor = jnp.arange(m.capacity) < m.size
    stale = (
        in_cursor
        & m.alive
        & (m.desc_count < min_obs)
        & (current_frame - m.last_seen > max_age)
    )
    return m.replace(alive=m.alive & ~stale)


def evict_lru(m: MapState, min_free: int) -> MapState:
    """Mark the oldest-seen alive landmarks dead until at least ``min_free``
    slots would be free after compaction.

    Bounded-memory mapping policy: when the map approaches capacity even
    after culling (well-observed landmarks never go stale), the points the
    camera has not seen for longest are the ones least likely to be
    re-associated; evicting them keeps insert bandwidth for the live frontier.
    Exact-count eviction (ties broken by slot index) via one argsort over the
    capacity axis — static shapes, jit-safe.
    """
    C = m.capacity
    in_cursor = jnp.arange(C) < m.size
    alive = m.alive & in_cursor
    n_alive = alive.sum().astype(jnp.int32)
    n_evict = jnp.maximum(n_alive - (C - min_free), 0)
    ls = jnp.where(alive, m.last_seen, jnp.iinfo(jnp.int32).max)
    order = jnp.argsort(ls)                                  # oldest first
    evict_idx = jnp.where(jnp.arange(C) < n_evict, order, C)
    return m.replace(alive=m.alive.at[evict_idx].set(False, mode="drop"))


def compact(m: MapState):
    """Pack alive landmarks to the front of the arrays, freeing dead slots.

    Returns (compacted_map, remap) where ``remap`` is (C,) i32 mapping old
    slot id -> new slot id, -1 for retired slots. Every holder of map point
    ids (tracker ``prev_map_id``, keyframe ``obs_pid``) must be passed
    through ``remap_ids`` afterwards. This is the functional replacement for
    the reference's never-shrinking realloc map (src/PointMap.cpp:5-15).
    """
    C = m.capacity
    K = m.obs_slots
    in_cursor = jnp.arange(C) < m.size
    keep = m.alive & in_cursor
    new_pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    remap = jnp.where(keep, new_pos, -1)
    dst = jnp.where(keep, new_pos, C)                        # C -> drop
    # archive rows move with their point: flat row p*K+k -> new_pos*K+k
    ddst = (dst[:, None] * K + jnp.arange(K, dtype=dst.dtype)[None, :]
            ).reshape(-1)                                    # >= C*K -> drop
    m2 = MapState(
        pt=jnp.zeros_like(m.pt).at[dst].set(m.pt, mode="drop"),
        desc=jnp.zeros_like(m.desc).at[ddst].set(m.desc, mode="drop"),
        desc_count=jnp.zeros_like(m.desc_count).at[dst].set(
            m.desc_count, mode="drop"),
        alive=jnp.zeros_like(m.alive).at[dst].set(keep, mode="drop"),
        last_seen=jnp.zeros_like(m.last_seen).at[dst].set(
            m.last_seen, mode="drop"),
        prov=jnp.zeros_like(m.prov).at[dst].set(m.prov, mode="drop"),
        size=keep.sum().astype(jnp.int32),
    )
    return m2, remap


def remap_ids(ids, remap):
    """Apply a ``compact`` remap to an array of map point ids (-1 passes
    through; retired ids become -1)."""
    C = remap.shape[0]
    looked = remap[jnp.clip(ids, 0, C - 1)]
    return jnp.where(ids >= 0, looked, -1)


class AssociationResult(NamedTuple):
    point_id: jnp.ndarray   # (N,) i32 best map point per keypoint, -1 if none
    distance: jnp.ndarray   # (N,) i32 Hamming distance of the association


@functools.partial(jax.jit, static_argnames=("map_cfg", "match_cfg", "width", "height"))
def associate(
    m: MapState,
    P,                      # (3, 4) projection matrix of the current frame
    kp_uv,                  # (N, 2) keypoint pixels
    kp_desc,                # (N, 8) packed descriptors
    kp_free,                # (N,) bool — keypoint valid AND not yet associated
    map_cfg: MapConfig,
    match_cfg: MatchingConfig,
    width: int,
    height: int,
    frame_idx=None,         # () i32 current frame (enables the reacq tier)
) -> AssociationResult:
    """Search-by-projection over the whole map, scanned in blocks.

    For every free keypoint: the alive map point that (a) projects within
    ``match_cfg.search_radius`` pixels of it, (b) is in front of the camera
    and inside the image, and (c) minimizes the min-over-archive Hamming
    distance, accepted if that distance < ``match_cfg.hamming_max``
    (reference gate at src/vslam.cpp:152-153, DISTANCE_THRESHOLD=64).

    RE-ACQUISITION tier (``match_cfg.reacq_*``, active when ``frame_idx``
    is given): a map point seen within the last ``reacq_max_age`` frames
    additionally accepts the looser ``reacq_hamming_max`` descriptor gate,
    but only within the tighter ``reacq_radius`` pixel window. This is how
    a track broken by a detector miss re-binds to its landmark when the
    corner re-enters as a fresh detection: its descriptor lands in the
    64-96 band vs the archive, which the strict gate
    rejects. Selection stays the single lexicographic (hamming, id) min
    over the union of both tiers' candidates, so a strict-gate candidate
    at lower distance always outranks a reacq one.
    """
    use_reacq = frame_idx is not None and match_cfg.reacq_max_age > 0
    # packed-key selection stores the row index in the low 18 bits; a
    # capacity past 2^18 would overflow into the distance bits and decode
    # WRONG landmark ids with no error
    assert m.capacity <= (1 << 18), \
        f"map capacity {m.capacity} exceeds the 2^18 packed-key bound"

    C = m.capacity
    B = map_cfg.block_size
    assert C % B == 0
    N = kp_uv.shape[0]
    K = m.obs_slots
    r_sq = match_cfg.search_radius ** 2
    reacq_r_sq = match_cfg.reacq_radius ** 2

    kp_bits = unpack_bits(kp_desc)                    # (N, 256) int8
    kp_x = kp_uv[:, 0]
    kp_y = kp_uv[:, 1]

    def _block_work(carry, start):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, B, axis=0)
        # xyz = the first 3 packed columns; slice only those (types.PT_XYZ)
        xyz = jax.lax.dynamic_slice(m.pt, (start, 0), (B, 3))   # (B, 3)
        alive = sl(m.alive)
        desc = jax.lax.dynamic_slice_in_dim(
            m.desc, start * K, B * K, 0).reshape(B, K, 8)
        dcount = sl(m.desc_count)

        Xh = jnp.concatenate([xyz, jnp.ones_like(xyz[:, :1])], axis=1)
        proj = Xh @ P.T                               # (B, 3)
        z = proj[:, 2]
        safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = proj[:, 0] / safe
        v = proj[:, 1] / safe
        vis = alive & (z > 0.1) & (u >= 0) & (u < width) & (v >= 0) & (v < height)

        # pixel gate: (B, N)
        du = u[:, None] - kp_x[None, :]
        dv = v[:, None] - kp_y[None, :]
        d2 = du * du + dv * dv
        near = vis[:, None] & (d2 <= r_sq)
        if use_reacq:
            # recently-seen points get the tighter window at the looser
            # descriptor gate; the pixel subset (reacq_radius < radius)
            # means `near` still covers every candidate pair, so the
            # block-skip gate below needs no change. age >= 1 targets
            # exactly BROKEN tracks: a landmark already observed this
            # frame (via match propagation, observe runs before associate
            # in the step) must not grab a second keypoint through the
            # loose gate.
            age = frame_idx - sl(m.last_seen)
            recent = vis & (age >= 1) & (age <= match_cfg.reacq_max_age)
            near_rq = recent[:, None] & (d2 <= reacq_r_sq)
        else:
            near_rq = None

        def _gated(args):
            near, near_rq, desc, dcount = args
            # Hamming: min over the K archive slots, one int8 matmul per
            # occupied slot. Slot 0 always exists for live points; slots k>0
            # run only when some point in the block has a k+1'th observation
            # (on a typical map most blocks don't — ~K x fewer matmuls).
            ham = jnp.full((B, N), 1 << 14, jnp.int32)
            kp_pop = jnp.sum(kp_bits.astype(jnp.int32), 1)[None, :]

            def _slot(ham, k):
                slot_valid = (dcount > k)[:, None]    # (B, 1)
                bits = unpack_bits(desc[:, k, :])     # (B, 256) int8
                ab = jax.lax.dot_general(
                    bits, kp_bits,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=jnp.int32,
                )
                d_k = (jnp.sum(bits.astype(jnp.int32), 1)[:, None]
                       + kp_pop - 2 * ab)
                return jnp.where(slot_valid, jnp.minimum(ham, d_k), ham)

            ham = _slot(ham, 0)
            for k in range(1, K):
                ham = jax.lax.cond(
                    jnp.any(dcount > k),
                    lambda h, kk=k: _slot(h, kk),
                    lambda h: h,
                    ham,
                )

            ok = near & (ham < match_cfg.hamming_max)
            if near_rq is not None:
                ok = ok | (near_rq & (ham < match_cfg.reacq_hamming_max))
            ok = ok & kp_free[None, :]
            # Pack (distance, global row) into ONE int32 key so the whole
            # epilogue is a single fused min-reduce over the block axis —
            # the separate min + argmin + improved/where passes were each
            # another (B, N) device-memory sweep. ham ≤ 256 and row < 2^18
            # ≥ any capacity in use, so
            # ham·2^18 + row < 2^31; lexicographic (ham, row) min matches
            # the old argmin tie-break (lowest id among equal distances)
            # and the sharded combine (parallel/sharded_map.py).
            row = start + jnp.arange(B, dtype=jnp.int32)
            key = jnp.where(ok, ham * (1 << 18) + row[:, None], _NO_KEY)
            return jnp.min(key, axis=0)                   # (N,)

        def _trivial(args):
            return jnp.full((N,), _NO_KEY, jnp.int32)

        # A block contributes only if some candidate pair passes the
        # frustum+radius gate — for a moving camera most stale blocks don't,
        # so their K matmuls are skipped entirely.
        blk_key = jax.lax.cond(
            jnp.any(near) & jnp.any(kp_free), _gated, _trivial,
            (near, near_rq, desc, dcount),
        )
        return jnp.minimum(carry, blk_key)

    init = jnp.full((N,), _NO_KEY, jnp.int32)
    # Loop only over blocks the insert cursor has reached — a young map
    # costs O(size), not O(capacity), per frame (a dynamic-bound fori_loop
    # instead of a static scan over capacity with a per-block size-cond).
    nblk = jnp.minimum((m.size + B - 1) // B, C // B)

    def body(i, carry):
        return _block_work(carry, i * jnp.int32(B))

    best_key = jax.lax.fori_loop(0, nblk, body, init)
    best_d = jnp.where(best_key < _NO_KEY, best_key >> 18, 1 << 14)
    best_id = best_key & ((1 << 18) - 1)
    # acceptance was gated per-tier inside the scan (a reacq winner may
    # carry a distance in [hamming_max, reacq_hamming_max))
    found = best_key < _NO_KEY
    return AssociationResult(
        point_id=jnp.where(found, best_id, -1),
        distance=best_d.astype(jnp.int32),
    )
