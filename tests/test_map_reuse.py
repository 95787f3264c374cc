"""Round-5 map re-use machinery: re-acquisition association tier,
provisional landmarks, founding-record restore, supply-adaptive promotion.

These are the components that took the flagship corridor from median 0
associations / 3 anchors per frame (r04) to 32 / 12;
each gate's semantics are pinned here at the unit level so the endurance
artifacts guard only the emergent behavior.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vslam_jax.config import small_config
from vslam_jax.core import camera as cam
from vslam_jax.core.types import empty_map
from vslam_jax.mapping import point_map

pytestmark = pytest.mark.quick

CFG = small_config()
W, H = CFG.camera.width, CFG.camera.height
K = jnp.asarray(CFG.camera.K())


def _flip_bits(desc, n_bits):
    """Flip the n lowest bits of the first words of a (N, 8) u32 descriptor
    array — Hamming distance exactly n_bits from the original."""
    d = np.asarray(desc).copy()
    for b in range(n_bits):
        w, off = divmod(b, 32)
        d[:, w] ^= np.uint32(1) << np.uint32(off)
    return jnp.asarray(d)


def _map_with_landmark(frame_seen, xyz_w=(0.0, 0.0, 10.0), seed=1):
    m = empty_map(CFG.map.capacity, CFG.map.obs_per_point)
    desc = jax.random.bits(jax.random.PRNGKey(seed), (1, 8), jnp.uint32)
    m = point_map.insert_points(
        m, jnp.asarray([xyz_w], jnp.float32), jnp.zeros((1, 3)),
        desc, jnp.ones(1, bool), frame_idx=frame_seen)
    return m, desc


class TestReacquisitionTier:
    """associate()'s second tier: recently-seen landmarks accept the looser
    Hamming gate inside the tighter pixel window (point_map.associate)."""

    def _associate(self, m, kp_uv, kp_desc, frame_idx):
        P = cam.projection_matrix(K, jnp.eye(4))
        free = jnp.zeros(kp_uv.shape[0], bool).at[0].set(True)
        return point_map.associate(
            m, P, kp_uv, kp_desc, free, CFG.map, CFG.matching, W, H,
            frame_idx=jnp.asarray(frame_idx, jnp.int32))

    def _kp_at_projection(self, m, offset_px=0.0):
        X = np.asarray(m.xyz[0])
        uv = np.asarray(cam.projection_matrix(K, jnp.eye(4)) @
                        np.append(X, 1.0))
        uv = uv[:2] / uv[2] + np.asarray([offset_px, 0.0])
        kp_uv = jnp.zeros((16, 2), jnp.float32).at[0].set(
            jnp.asarray(uv, jnp.float32))
        return kp_uv

    def test_recent_landmark_rebinds_in_the_64_96_band(self):
        # descriptor at Hamming 80 vs the archive: above the strict gate
        # (64), below the reacq gate (96); landmark seen 2 frames ago
        m, desc = _map_with_landmark(frame_seen=8)
        kp_uv = self._kp_at_projection(m, offset_px=2.0)
        kp_desc = jnp.tile(_flip_bits(desc, 80), (16, 1))
        res = self._associate(m, kp_uv, kp_desc, frame_idx=10)
        assert int(res.point_id[0]) == 0, "reacq tier must re-bind"

    def test_stale_landmark_does_not_get_the_loose_gate(self):
        age = CFG.matching.reacq_max_age + 5
        m, desc = _map_with_landmark(frame_seen=10)
        kp_uv = self._kp_at_projection(m, offset_px=2.0)
        kp_desc = jnp.tile(_flip_bits(desc, 80), (16, 1))
        res = self._associate(m, kp_uv, kp_desc, frame_idx=10 + age)
        assert int(res.point_id[0]) == -1

    def test_loose_gate_only_inside_the_tight_window(self):
        # within the 12 px strict radius but OUTSIDE the 6 px reacq radius
        m, desc = _map_with_landmark(frame_seen=8)
        off = (CFG.matching.reacq_radius + CFG.matching.search_radius) / 2
        kp_uv = self._kp_at_projection(m, offset_px=off)
        kp_desc = jnp.tile(_flip_bits(desc, 80), (16, 1))
        res = self._associate(m, kp_uv, kp_desc, frame_idx=10)
        assert int(res.point_id[0]) == -1
        # ...while a strict-gate descriptor still binds there
        kp_desc2 = jnp.tile(_flip_bits(desc, 30), (16, 1))
        res2 = self._associate(m, kp_uv, kp_desc2, frame_idx=10)
        assert int(res2.point_id[0]) == 0

    def test_beyond_reacq_hamming_never_binds(self):
        m, desc = _map_with_landmark(frame_seen=9)
        kp_uv = self._kp_at_projection(m, offset_px=1.0)
        kp_desc = jnp.tile(
            _flip_bits(desc, CFG.matching.reacq_hamming_max + 8), (16, 1))
        res = self._associate(m, kp_uv, kp_desc, frame_idx=10)
        assert int(res.point_id[0]) == -1

    def test_strict_candidate_outranks_reacq_candidate(self):
        # two landmarks projecting near the keypoint: a strict-gate hit at
        # Hamming 40 must win over a reacq hit at 70 (lexicographic min)
        m = empty_map(CFG.map.capacity, CFG.map.obs_per_point)
        key = jax.random.PRNGKey(3)
        desc = jax.random.bits(key, (1, 8), jnp.uint32)
        xyz = jnp.asarray([[0.0, 0.0, 10.0], [0.02, 0.0, 10.0]], jnp.float32)
        descs = jnp.concatenate([_flip_bits(desc, 70 - 0),
                                 _flip_bits(desc, 40)], axis=0)
        m = point_map.insert_points(m, xyz, jnp.zeros((2, 3)), descs,
                                    jnp.ones(2, bool), frame_idx=9)
        kp_uv = self._kp_at_projection(m)
        kp_desc = jnp.tile(desc, (16, 1))
        res = self._associate(m, kp_uv, kp_desc, frame_idx=10)
        assert int(res.point_id[0]) == 1   # the Hamming-40 strict hit

    def test_associate_matches_brute_force_on_both_tiers(self):
        # random map (a second archive slot on some landmarks, dead rows,
        # mixed ages) + keypoints near projections with 0-110 flipped bits:
        # the blocked XLA scan must pick the same (id, distance) as the
        # numpy brute force, with hits in the re-acquisition band
        import chip_smoke
        chip_smoke.check_associate(CFG, n_landmarks=3000, n_kp=96)


class TestProvisionalMachinery:
    def test_provisional_excluded_from_full_problem_until_promoted(self):
        m = empty_map(256, 2)
        desc = jax.random.bits(jax.random.PRNGKey(0), (4, 8), jnp.uint32)
        prov = jnp.asarray([True, True, False, False])
        m = point_map.insert_points(
            m, jnp.ones((4, 3), jnp.float32), jnp.zeros((4, 3)), desc,
            jnp.ones(4, bool), provisional=prov)
        assert np.array_equal(np.asarray(m.prov[:4]), np.asarray(prov))
        # compact preserves the flag and the founding records
        m2 = m.replace(alive=m.alive.at[2].set(False))
        m3, remap = point_map.compact(m2)
        r = np.asarray(remap[:4])
        assert np.asarray(m3.prov)[r[0]] and np.asarray(m3.prov)[r[1]]
        assert not np.asarray(m3.prov)[r[3]]

    def test_supply_adaptive_bar_governs_promotion(self):
        """Integration probe on the tracker: with a rich anchor supply the
        high bar governs (a 6-deg track must NOT promote); with a starved
        supply the low bar governs (the same track promotes)."""
        from vslam_jax.pipeline import tracker

        lo = CFG.triangulation.promote_parallax_lo_deg
        hi = CFG.triangulation.promote_parallax_deg
        mid = 0.5 * (lo + hi)
        bar_starved = jnp.where(
            jnp.asarray(0) < CFG.triangulation.anchor_target,
            jnp.deg2rad(lo), jnp.deg2rad(hi))
        bar_rich = jnp.where(
            jnp.asarray(CFG.triangulation.anchor_target + 10)
            < CFG.triangulation.anchor_target,
            jnp.deg2rad(lo), jnp.deg2rad(hi))
        par = jnp.deg2rad(mid)
        assert bool(par > bar_starved)
        assert not bool(par > bar_rich)
