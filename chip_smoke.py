"""Chip smoke: the full-width SLAM path on one GPU, checked against references.

    python chip_smoke.py           # one GPU: parity phases, then end to end
    python chip_smoke.py --four    # four GPUs: only the multi-device paths

Every phase raises on failure; nothing is caught. The last line of a passing
run is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
a failing run (or one where JAX finds no GPU) exits non-zero and never
prints it. Compiled programs go to JAX's persistent cache
(``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``), so a
second run reports lower compile seconds.

Precision: the package sets ``jax_default_matmul_precision="highest"`` at
import, so float32 products run in full float32, not TF32. Each check states
its tolerance beside the comparison.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import re
import time

import numpy as np

import jax
import jax.numpy as jnp

from vslam_jax.ops.bench_kernels import device_ms
from vslam_jax.utils import runtime

# Names every informational line with the card it was taken on.
CARD = "?"


def say(msg: str) -> None:
    print(msg, flush=True)


def info(msg: str) -> None:
    say(f"[{CARD}] {msg}")


class CompileClock:
    """Sums JAX's backend-compile seconds per program name (a persistent
    cache hit records its much shorter retrieval instead)."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.by_fun = collections.Counter()
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kw):
        if event == self.EVENT:
            self.by_fun[str(kw.get("fun_name", "?"))] += duration

    def report(self, phase: str) -> float:
        """Print and clear the seconds accumulated since the last report."""
        total = sum(self.by_fun.values())
        top = ", ".join(f"{k}={v:.2f}s" for k, v in self.by_fun.most_common(6))
        info(f"compile {phase}: {total:.2f}s over {len(self.by_fun)} "
             f"programs ({top})")
        self.by_fun.clear()
        return total


# ---------------------------------------------------------------------------
# Parity phases: one kernel path against a plain reference, at real widths
# ---------------------------------------------------------------------------

def check_hamming(n: int = 3072) -> None:
    """int8 bit-plane matmul Hamming vs population_count. Tolerance: none —
    int8 products accumulate in int32, so the two must agree bit for bit."""
    from vslam_jax.matching import hamming

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    d1 = jax.random.bits(k1, (n, 8), jnp.uint32)
    d2 = jax.random.bits(k2, (n, 8), jnp.uint32)
    mm = jax.jit(hamming.hamming_matmul)
    pc = jax.jit(hamming.hamming_popcount)
    a, b = np.asarray(mm(d1, d2)), np.asarray(pc(d1, d2))
    if not np.array_equal(a, b):
        raise AssertionError(
            f"hamming_matmul != hamming_popcount at {n}x{n}: "
            f"{int((a != b).sum())} entries differ")
    # which kernel XLA chose for the int8 dot (tensor cores or an upcast)
    hlo = mm.lower(d1, d2).compile().as_text()
    targets = sorted({ln.split('custom_call_target="')[1].split('"')[0]
                      for ln in hlo.splitlines()
                      if 'custom_call_target="' in ln})
    dots = sorted({m.group(1) for m in re.finditer(
        r"= (\S+|\([^)]*\)) (?:dot|custom-call)\(", hlo)})
    info(f"hamming {n}x{n}: matmul == popcount bit for bit; int8 dot "
         f"lowered to custom calls {targets or 'none'}, result types {dots}")
    t_mm = device_ms(lambda: mm(d1, d2))
    t_pc = device_ms(lambda: pc(d1, d2))
    info(f"hamming {n}x{n} time per call: matmul {t_mm:.4f} ms, "
         f"popcount {t_pc:.4f} ms")


def _flip_bits(desc: np.ndarray, counts: np.ndarray, rng) -> np.ndarray:
    """Flip ``counts[i]`` distinct bits of row i of (N, 8) uint32 ``desc``."""
    bits = np.unpackbits(desc.view(np.uint8), axis=1)          # (N, 256)
    for i, c in enumerate(counts):
        bits[i, rng.choice(256, int(c), replace=False)] ^= 1
    return np.packbits(bits, axis=1).view(np.uint32)


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1)


def associate_oracle(xyz, alive, last_seen, archive, count, P, kp_uv,
                     kp_desc, width, height, mcfg, frame_idx):
    """Brute-force search-by-projection in numpy: every keypoint against
    every landmark, both gate tiers, lexicographic (distance, row) winner.
    Returns (point_id (N,), distance (N,)) like point_map.associate."""
    Xh = np.concatenate([xyz, np.ones_like(xyz[:, :1])], 1).astype(np.float32)
    proj = Xh @ P.T.astype(np.float32)
    z = proj[:, 2]
    safe = np.where(np.abs(z) < 1e-9, np.float32(1e-9), z)
    u, v = proj[:, 0] / safe, proj[:, 1] / safe
    vis = alive & (z > 0.1) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    age = frame_idx - last_seen
    recent = vis & (age >= 1) & (age <= mcfg.reacq_max_age)
    K = archive.shape[1]
    ids = np.full(len(kp_uv), -1, np.int64)
    dist = np.full(len(kp_uv), 1 << 14, np.int64)
    for i, (kx, ky) in enumerate(kp_uv):
        d2 = (u - kx) * (u - kx) + (v - ky) * (v - ky)
        cand = np.nonzero(vis & (d2 <= np.float32(mcfg.search_radius ** 2)))[0]
        if cand.size == 0:
            continue
        ham = _popcount_rows(archive[cand] ^ kp_desc[i][None, None, :])
        ham = np.where(np.arange(K)[None, :] < count[cand][:, None], ham,
                       1 << 14).min(axis=1)
        ok = ham < mcfg.hamming_max
        ok |= (recent[cand] & (d2[cand] <= np.float32(mcfg.reacq_radius ** 2))
               & (ham < mcfg.reacq_hamming_max))
        if ok.any():
            j = np.lexsort((cand[ok], ham[ok]))[0]
            ids[i], dist[i] = cand[ok][j], ham[ok][j]
    return ids, dist


def check_associate(cfg, n_landmarks: int = 51200, n_kp: int = 384,
                    seed: int = 0) -> None:
    """point_map.associate (both tiers, frame_idx given) on the configured
    map capacity vs the numpy brute force. Tolerance: none — ids and
    distances must be identical."""
    from vslam_jax.core import camera as cam
    from vslam_jax.core.types import empty_map
    from vslam_jax.mapping import point_map

    mc, mt = cfg.map, cfg.matching
    W, H = cfg.camera.width, cfg.camera.height
    K = cfg.camera.K()
    rng = np.random.RandomState(seed)
    n = n_landmarks
    xyz = np.stack([rng.uniform(-25, 25, n), rng.uniform(-6, 6, n),
                    rng.uniform(-5, 60, n)], 1).astype(np.float32)
    desc = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    extra = rng.rand(n) < 0.1                  # a second archive slot
    desc2 = rng.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    frame_idx = 12
    last = rng.randint(0, frame_idx + 1, n).astype(np.int32)
    alive = rng.rand(n) > 0.05

    m = empty_map(mc.capacity, mc.obs_per_point)
    m = point_map.insert_points(m, jnp.asarray(xyz), jnp.zeros((n, 3)),
                                jnp.asarray(desc), jnp.ones(n, bool))
    m = point_map.add_observations(m, jnp.arange(n, dtype=jnp.int32),
                                   jnp.asarray(desc2), jnp.asarray(extra))
    m = m.replace(last_seen=m.last_seen.at[:n].set(jnp.asarray(last)),
                  alive=m.alive.at[:n].set(jnp.asarray(alive)))

    P = np.asarray(cam.projection_matrix(jnp.asarray(K), jnp.eye(4)))
    Xh = np.concatenate([xyz, np.ones((n, 1), np.float32)], 1)
    proj = Xh @ P.T
    uv = proj[:, :2] / proj[:, 2:3]
    inview = ((proj[:, 2] > 1) & alive & (uv[:, 0] > 10) & (uv[:, 0] < W - 10)
              & (uv[:, 1] > 10) & (uv[:, 1] < H - 10))
    sel = rng.choice(np.nonzero(inview)[0], n_kp, replace=False)
    kp_uv = (uv[sel] + rng.randn(n_kp, 2) * 3.0).astype(np.float32)
    kp_desc = _flip_bits(desc[sel], rng.randint(0, 110, n_kp), rng)

    got = point_map.associate(
        m, jnp.asarray(P), jnp.asarray(kp_uv), jnp.asarray(kp_desc),
        jnp.ones(n_kp, bool), mc, mt, W, H,
        frame_idx=jnp.asarray(frame_idx, jnp.int32))
    gid = np.asarray(got.point_id)
    gd = np.asarray(got.distance)

    archive = np.zeros((n, 2, 8), np.uint32)
    archive[:, 0], archive[:, 1] = desc, desc2
    count = 1 + extra.astype(np.int64)
    rid, rd = associate_oracle(xyz, alive, last, archive, count, P, kp_uv,
                               kp_desc, W, H, mt, frame_idx)
    if not (np.array_equal(gid, rid) and np.array_equal(gd, rd)):
        bad = np.nonzero((gid != rid) | (gd != rd))[0]
        raise AssertionError(
            f"associate disagrees with brute force on {bad.size}/{n_kp} "
            f"keypoints, e.g. kp {bad[:5]}: got {gid[bad[:5]]}/{gd[bad[:5]]} "
            f"want {rid[bad[:5]]}/{rd[bad[:5]]}")
    hit = rid >= 0
    n_reacq = int((rd[hit] >= mt.hamming_max).sum())
    if hit.sum() < n_kp // 3 or n_reacq == 0:
        raise AssertionError(f"scenario too easy: {int(hit.sum())} hits, "
                             f"{n_reacq} in the re-acquisition band")
    info(f"associate capacity {mc.capacity}, {n} landmarks, {n_kp} kp: "
         f"identical to brute force ({int(hit.sum())} hits, {n_reacq} via "
         f"the re-acquisition tier)")


def check_jacobi(batch: int = 1024, rel_tol: float = 1e-4) -> None:
    """ops.jacobi 9x9 eigendecomposition vs numpy.linalg.eigh (float64).
    Tolerance: eigenvalues and the residual |A V - V diag(w)| within
    ``rel_tol`` of each matrix's largest eigenvalue, at "highest" precision
    (float32 throughout, ~1e-7 unit roundoff)."""
    from vslam_jax.ops import jacobi

    rng = np.random.RandomState(3)
    A8 = rng.randn(batch, 8, 9).astype(np.float32)     # rank-8 like the
    A = np.einsum("bij,bik->bjk", A8, A8)              # 8-point system
    w, V = jax.jit(jacobi.jacobi_eigh)(jnp.asarray(A))
    w, V = np.asarray(w, np.float64), np.asarray(V, np.float64)
    w_ref = np.linalg.eigh(A.astype(np.float64))[0]
    scale = np.abs(w_ref).max(axis=1, keepdims=True)
    err_w = float((np.abs(np.sort(w, axis=1) - w_ref) / scale).max())
    resid = np.einsum("bij,bjk->bik", A.astype(np.float64), V) - V * w[:, None]
    err_r = float((np.abs(resid).max(axis=(1, 2)) / scale[:, 0]).max())
    if not (err_w <= rel_tol and err_r <= rel_tol):
        raise AssertionError(f"jacobi_eigh: eigenvalue err {err_w:.2e}, "
                             f"residual {err_r:.2e} > {rel_tol}")
    info(f"jacobi 9x9 batch {batch}: eigenvalue rel err {err_w:.2e}, "
         f"residual {err_r:.2e} (tol {rel_tol})")


def _angle_deg(a, b) -> float:
    c = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    return math.degrees(math.acos(max(-1.0, min(1.0, c))))


def check_two_view(num_hypotheses: int = 1024) -> None:
    """ransac_fundamental + E -> (R, t) on the synthetic two-view scene
    against its exact ground truth. Tolerance: R error < 0.5 deg, t
    direction error < 6 deg (0.4 px noise, 0.8 m baseline)."""
    from vslam_jax.datasets import synthetic
    from vslam_jax.geometry import epipolar, ransac

    K = np.array([[500., 0, 320], [0, 500., 240], [0, 0, 1]], np.float32)
    scene = synthetic.make_scene(num_points=800, seed=7)
    poses = synthetic.make_trajectory(2, step=0.8, seed=7)
    uv1, uv2, vis, _ = synthetic.correspondences(
        K, poses[0], poses[1], scene.xyz, 640, 480, noise_px=0.4)
    uv1, uv2, vis = map(jnp.asarray, (uv1, uv2, vis))
    res = jax.jit(ransac.ransac_fundamental,
                  static_argnames=("num_hypotheses",))(
        jax.random.PRNGKey(0), uv1, uv2, vis, num_hypotheses=num_hypotheses)
    Kj = jnp.asarray(K)
    E = epipolar.essential_from_fundamental(res.model, Kj)
    R, t, _ = epipolar.recover_pose(E, Kj, uv1, uv2, res.inliers)
    T21 = np.linalg.inv(poses[1]) @ poses[0]          # cam1 -> cam2
    dR = np.asarray(R, np.float64).T @ T21[:3, :3]
    r_err = math.degrees(math.acos(max(-1.0, min(1.0,
                                                 (np.trace(dR) - 1) / 2))))
    t_err = _angle_deg(np.asarray(t, np.float64), T21[:3, 3])
    if not (bool(res.success) and r_err < 0.5 and t_err < 6.0):
        raise AssertionError(f"two-view: success={bool(res.success)} "
                             f"R err {r_err:.3f} deg, t err {t_err:.2f} deg")
    info(f"two-view RANSAC ({num_hypotheses} hyp): R err {r_err:.3f} deg, "
         f"t dir err {t_err:.2f} deg, {int(res.num_inliers)} inliers")


def ba_problem(n_cams: int = 20, n_pts: int = 8192, k_obs: int = 16):
    from bench_ba import make_problem
    return make_problem(n_cams, n_pts, k_obs)


def compare_ba(a, sa, b, sb, what: str, cost_rtol: float = 1e-3,
               pose_atol: float = 1e-3) -> None:
    """Two LM solves of one problem agree. Tolerance: final cost within
    ``cost_rtol`` relative and every T_cw entry within ``pose_atol``:
    reduction order differs between devices and colliding scatter-adds
    run as atomics on the GPU, so the bits differ run to run."""
    ca, cb = float(sa.final_cost), float(sb.final_cost)
    dT = float(np.abs(np.asarray(a.T_cw) - np.asarray(b.T_cw)).max())
    if not (abs(ca - cb) <= cost_rtol * abs(cb) and dT <= pose_atol
            and ca < float(sa.initial_cost)):
        raise AssertionError(f"{what}: cost {ca:.4f} vs {cb:.4f} "
                             f"(initial {float(sa.initial_cost):.4f}), "
                             f"max |dT_cw| {dT:.2e}")
    info(f"{what}: final cost {ca:.4f} vs {cb:.4f} "
         f"(from {float(sa.initial_cost):.4f}), max |dT_cw| {dT:.2e}")


def check_ba(cfg) -> None:
    """Window-size BA (20 cams x 8,192 points) on the GPU vs the same solve
    on this process's CPU device."""
    from vslam_jax.optimizer import ba

    problem, K = ba_problem()
    gpu = ba.solve(problem, jnp.asarray(K), cfg.ba)
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = ba.solve(jax.device_put(problem, cpu_dev),
                       jax.device_put(jnp.asarray(K), cpu_dev), cfg.ba)
    compare_ba(*gpu, *cpu, f"window BA {problem.num_cams}x"
               f"{problem.points.shape[0]} gpu vs cpu")


# ---------------------------------------------------------------------------
# End to end through SLAMSystem, at the default (full) configuration
# ---------------------------------------------------------------------------

def make_sequence(cfg, n_frames: int, density: int, seed: int):
    """Device-rendered corridor: (poses (F, 4, 4) numpy, frames (F, H, W)
    device array). Frames never leave the device."""
    from vslam_jax.datasets import synthetic, synthetic_device

    W, H = cfg.camera.width, cfg.camera.height
    Kj = jnp.asarray(cfg.camera.K())
    poses = synthetic.make_trajectory(n_frames, step=1.0, seed=seed)
    poses_d = jnp.asarray(poses)
    xyz, patches = synthetic_device.make_corridor_scene_device(
        jax.random.PRNGKey(seed), poses_d, n_frames * density, lateral=20.0)

    @jax.jit
    def render_all(ps):
        def step(_, pose):
            return 0, synthetic_device.render_frame_device(
                xyz, patches, Kj, pose, W, H)
        return jax.lax.scan(step, 0, ps)[1]

    return poses, jax.block_until_ready(render_all(poses_d))


def assert_run(name: str, s, gt_poses) -> dict:
    """The endurance bounds: success 1.0, ATE < 2.0, finite poses, a
    window-BA event, no dropped insert."""
    from vslam_jax.utils import evaluate

    est = s.poses()
    rows = [r for r in s.metrics.records if r.get("kind") == "frame"
            and "success" in r]
    success = sum(r["success"] for r in rows) / max(len(rows), 1)
    finite = bool(np.isfinite(est).all())
    ate = (evaluate.ate_rmse(est, gt_poses[:len(est)].astype(np.float64))[0]
           if finite else float("inf"))
    ba_rows = [r for r in s.metrics.records if r.get("kind") == "ba"]
    out = {"frames": len(est), "success_rate": success, "ate_rmse": ate,
           "window_ba_events": len(ba_rows),
           "window_ba_accepted": sum(bool(r.get("ba_result_accepted"))
                                     for r in ba_rows),
           "dropped_inserts": s.dropped_inserts_total}
    info(f"{name}: {out}")
    if not (success == 1.0 and finite and ate < 2.0 and ba_rows
            and s.dropped_inserts_total == 0):
        raise AssertionError(f"{name} out of bounds: {out}")
    return out


def run_end_to_end(cfg, clock: CompileClock, n_frames: int = 201,
                   density: int = 150, live_frames: int = 61,
                   seed: int = 7) -> None:
    from vslam_jax.pipeline import slam

    chunk = cfg.pipeline.keyframe_every * cfg.pipeline.local_ba_every
    assert (n_frames - 1) % chunk == 0 and n_frames > 2 * chunk
    t0 = time.perf_counter()
    poses, frames = make_sequence(cfg, n_frames, density, seed)
    info(f"scene + {n_frames} frames rendered on device "
         f"({n_frames * density} landmarks, {cfg.camera.width}x"
         f"{cfg.camera.height}): {time.perf_counter() - t0:.2f}s")
    clock.report("scene render")

    # chunked driver: bootstrap + the first chunk compile, then steady chunks
    s = slam.SLAMSystem(cfg, seed=seed)
    t0 = time.perf_counter()
    s.process_chunk(frames[:chunk + 1])
    info(f"chunked driver first call ({chunk + 1} frames, incl. compile): "
         f"{time.perf_counter() - t0:.2f}s")
    clock.report("chunked driver")
    t0 = time.perf_counter()
    for s0 in range(chunk + 1, n_frames, chunk):
        s.process_chunk(frames[s0:s0 + chunk])
    wall = time.perf_counter() - t0
    info(f"chunked driver: {(n_frames - chunk - 1) / wall} frames/s "
         f"over {n_frames - chunk - 1} frames (window BA included)")
    clock.report("chunked steady (should be ~0)")
    assert_run("chunked driver", s, poses)

    t0 = time.perf_counter()
    s.run_global_ba()
    info(f"global BA over {s._kf_count} keyframes (incl. compile): "
         f"{time.perf_counter() - t0:.2f}s; coverage "
         f"{s.last_global_ba_coverage}")
    clock.report("global BA")
    cov = s.last_global_ba_coverage
    if not (cov["dropped_points"] == 0 and cov["dropped_obs"] == 0
            and np.isfinite(s.keyframe_poses()).all()):
        raise AssertionError(f"global BA truncated or diverged: {cov}")

    # live path: a fresh system, one frame per call
    live = slam.SLAMSystem(cfg, seed=seed)
    t0 = time.perf_counter()
    for i in range(2):
        live.process(frames[i])
    info(f"live driver first 2 frames (incl. compile): "
         f"{time.perf_counter() - t0:.2f}s")
    clock.report("live driver")
    t0 = time.perf_counter()
    for i in range(2, live_frames):
        live.process(frames[i])
    wall = time.perf_counter() - t0
    info(f"live driver: {(live_frames - 2) / wall} frames/s over "
         f"{live_frames - 2} frames (window BA included)")
    clock.report("live steady")
    assert_run("live driver", live, poses)
    stats = jax.devices()[0].memory_stats() or {}
    info(f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


# ---------------------------------------------------------------------------
# Four devices: the paths `cli run --mesh N` reaches
# ---------------------------------------------------------------------------

def run_four(cfg, n_frames: int = 31, seed: int = 7) -> None:
    import functools

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from vslam_jax.optimizer import ba
    from vslam_jax.parallel import mesh as mesh_mod
    from vslam_jax.parallel import sharded_ba, sharded_ransac
    from vslam_jax.pipeline import slam

    n_dev = 4
    if len(jax.devices()) < n_dev:
        raise SystemExit(f"--four needs {n_dev} GPUs, have {len(jax.devices())}")
    axis = cfg.mesh.axis_map
    mesh = mesh_mod.make_mesh(axis, n_dev)

    # sharded-map tracking vs the one-device trajectory on the same frames.
    # Tolerance: after Sim(3) alignment (monocular scale is free) the two
    # trajectories agree within 0.1 m RMSE over the ~30 m path — float32
    # reduction order and atomics differ between the sharded and unsharded
    # programs, and the difference compounds through pose chaining.
    poses, frames = make_sequence(cfg, n_frames, 150, seed)
    frames = np.asarray(frames)
    ref = slam.SLAMSystem(cfg, seed=seed)
    shd = slam.SLAMSystem(cfg, seed=seed, mesh=mesh)
    t0 = time.perf_counter()
    for f in frames:
        ref.process(f)
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    for f in frames:
        shd.process(f)
    t_shd = time.perf_counter() - t0
    info(f"{n_frames} frames incl. compile: 1 device {t_ref:.2f}s, "
         f"map over {n_dev} devices {t_shd:.2f}s")
    assert_run("sharded-map tracking (4 devices)", shd, poses)
    assert_run("one-device tracking", ref, poses)
    from vslam_jax.utils import evaluate
    dp = float(np.abs(shd.poses() - ref.poses()).max())
    rmse = evaluate.ate_rmse(shd.poses(), ref.poses().astype(np.float64))[0]
    info(f"sharded-map vs 1-device trajectory: aligned RMSE {rmse:.4f} m, "
         f"max raw |dpose| {dp:.4f}")
    if not rmse <= 0.1:
        raise AssertionError(f"sharded vs 1-device trajectory RMSE {rmse}")

    # landmark-sharded BA vs ba.solve
    problem, K = ba_problem()
    Kj = jnp.asarray(K)
    compare_ba(*sharded_ba.solve_sharded(mesh, axis, problem, Kj, cfg.ba),
               *ba.solve(problem, Kj, cfg.ba),
               f"BA {problem.num_cams}x{problem.points.shape[0]} sharded "
               f"over {n_dev} vs 1 device")

    # hypothesis-sharded pose RANSAC vs the unsharded program on the same
    # global sample batch. Tolerance: > 99% identical inlier decisions.
    from vslam_jax.datasets import synthetic
    from vslam_jax.geometry import ransac as ransac_mod
    Kc = np.array([[500., 0, 320], [0, 500., 240], [0, 0, 1]], np.float32)
    scene = synthetic.make_scene(num_points=3000, seed=7)
    tp = synthetic.make_trajectory(2, step=0.8, seed=7)
    uv1, uv2, vis, _ = synthetic.correspondences(
        Kc, tp[0], tp[1], scene.xyz, 640, 480, noise_px=0.4)
    uv1, uv2, vis = map(jnp.asarray, (uv1, uv2, vis))
    Kcj, key, H = jnp.asarray(Kc), jax.random.PRNGKey(3), \
        cfg.ransac.num_hypotheses
    want = ransac_mod.ransac_pose(key, uv1, uv2, vis, Kcj, num_hypotheses=H)

    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P(), P()),
                       out_specs=P(), check_vma=False)
    def run(a, b, c):
        return sharded_ransac.ransac_pose_hypsharded(
            axis, n_dev, key, a, b, c, Kcj, num_hypotheses=H)

    got = run(uv1, uv2, vis)
    agree = float((np.asarray(got.inliers) == np.asarray(want.inliers)).mean())
    if not (bool(got.success) and agree > 0.99):
        raise AssertionError(f"hypothesis-sharded RANSAC: success "
                             f"{bool(got.success)}, inlier agreement {agree}")
    info(f"hypothesis-sharded RANSAC ({H} hyp over {n_dev}): inlier "
         f"agreement {agree:.4f}")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device paths and their references")
    args = ap.parse_args(argv)

    cache = runtime.enable_compile_cache()
    devs = runtime.require_gpu()
    CARD = runtime.gpu_name_and_power_limit().replace("\n", " | ")
    say(CARD)
    d0 = devs[0]
    info(f"device_kind {d0.device_kind}; {len(devs)} device(s); jax "
         f"{jax.__version__}; bytes_limit "
         f"{(d0.memory_stats() or {}).get('bytes_limit')}; "
         f"compile cache {cache}")

    from vslam_jax.config import VSLAMConfig
    cfg = VSLAMConfig()
    clock = CompileClock()
    t_start = time.perf_counter()
    if args.four:
        run_four(cfg)
    else:
        for phase in (check_hamming, lambda: check_associate(cfg),
                      check_jacobi, check_two_view, lambda: check_ba(cfg)):
            phase()
        clock.report("parity phases")
        run_end_to_end(cfg, clock)
    info(f"total {time.perf_counter() - t_start:.2f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
