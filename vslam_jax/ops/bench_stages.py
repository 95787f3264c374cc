"""Per-stage device-time breakdown of the tracking step on a GPU.

    python -m vslam_jax.ops.bench_stages

Times each pipeline stage (feature extraction, matching, RANSAC pose,
triangulation, search-by-projection association, map insert) in isolation,
then the full fused ``track_step`` as a carried ``lax.scan``. Each timing is
the mean of several calls after a warm-up, ended by ``block_until_ready``
(ops/bench_kernels.device_ms). Refuses to run without a GPU.
"""
from __future__ import annotations

from .bench_kernels import device_ms


def main(map_size: int = 51200):
    import jax
    import jax.numpy as jnp

    from ..config import VSLAMConfig
    from ..core import camera as cam
    from ..core.types import empty_map
    from ..datasets import synthetic
    from ..frontend.frame import extract_features
    from ..geometry import pnp, ransac, triangulation
    from ..mapping import point_map
    from ..matching import matcher
    from ..pipeline import tracker

    cfg = VSLAMConfig()
    K = cfg.camera.K()
    Kj = jnp.asarray(K)
    W, H = cfg.camera.width, cfg.camera.height
    from ..utils import runtime
    runtime.enable_compile_cache()
    runtime.require_gpu()
    print(runtime.gpu_name_and_power_limit())
    print(f"device_kind={jax.devices()[0].device_kind} frame={W}x{H} "
          f"kp={cfg.frontend.max_keypoints} hyp={cfg.ransac.num_hypotheses} "
          f"map={map_size}")

    # ---- realistic inputs: a rendered synthetic pair + a populated map ----
    scene = synthetic.make_scene(num_points=8000, seed=0, extent=(60, 12, 120),
                                 z_min=5.0)
    poses = synthetic.make_trajectory(2, step=1.0, seed=0)
    f0, f1 = synthetic.render_sequence(K, poses, scene, W, H)
    img0 = jnp.asarray(f0)
    img1 = jnp.asarray(f1)
    feats0 = extract_features(img0, cfg.frontend, H, W)
    feats1 = extract_features(img1, cfg.frontend, H, W)
    mres = matcher.match(feats0.desc, feats0.mask, feats1.desc, feats1.mask,
                         cfg.matching)
    uv1, uv2 = feats0.uv, feats1.uv[mres.idx2]

    m = empty_map(cfg.map.capacity, cfg.map.obs_per_point)
    kk = jax.random.split(jax.random.PRNGKey(7), 2)
    xyz = jax.random.normal(kk[0], (map_size, 3)) * jnp.asarray([20., 8., 30.]) \
        + jnp.asarray([0., 0., 40.])
    desc = jax.random.bits(kk[1], (map_size, 8), jnp.uint32)
    m = point_map.insert_points(m, xyz, jnp.zeros((map_size, 3), jnp.float32),
                                desc, jnp.ones(map_size, bool))
    P1 = cam.projection_matrix(Kj, jnp.eye(4))
    T2 = jnp.asarray(poses[1])
    P2 = cam.projection_matrix(Kj, T2)
    key = jax.random.PRNGKey(0)
    xyz3, desc3 = xyz[:3072], desc[:3072]
    ids = jnp.arange(3072, dtype=jnp.int32) * 4

    # (name, jitted fn, args): arrays are arguments, never closed-over
    # constants, so the map is not baked into the programs
    stages = [
        ("features (Shi-Tomasi+NMS+BRIEF)",
         jax.jit(lambda im: extract_features(im, cfg.frontend, H, W).desc),
         (img1,)),
        ("match (hamming+ratio+crosscheck)",
         jax.jit(lambda a, am, b, bm: matcher.match(
             a, am, b, bm, cfg.matching).idx2),
         (feats0.desc, feats0.mask, feats1.desc, feats1.mask)),
        (f"ransac_pose ({cfg.ransac.num_hypotheses} hyp, 8-pt+E+cheirality)",
         jax.jit(lambda k, a, b, mk: ransac.ransac_pose(
             k, a, b, mk, Kj, num_hypotheses=cfg.ransac.num_hypotheses,
             inlier_threshold=cfg.ransac.inlier_threshold,
             min_inliers=cfg.ransac.min_inliers).R),
         (key, uv1, uv2, mres.mask)),
        ("triangulate_dlt (3072 pts)",
         jax.jit(lambda a, b: triangulation.triangulate_dlt(P1, P2, a, b)[0]),
         (uv1, uv2)),
        (f"associate (map={map_size})",
         jax.jit(lambda mm, uv, d, mk: point_map.associate(
             mm, P2, uv, d, mk, cfg.map, cfg.matching, W, H).point_id),
         (m, feats1.uv, feats1.desc, feats1.mask)),
        # sum the mutated arrays, not just .size — returning only the
        # cursor lets XLA dead-code-eliminate every scatter
        ("insert+cull (map ops)",
         jax.jit(lambda mm, x, d: (lambda m2: m2.xyz.sum() + m2.alive.sum()
                                   + m2.last_seen.sum())(
             point_map.cull_stale(
                 point_map.insert_points(mm, x, jnp.zeros((3072, 3)), d,
                                         jnp.ones(3072, bool)),
                 jnp.asarray(100, jnp.int32)))),
         (m, xyz3, desc3)),
        ("observe (archive scatter)",
         jax.jit(lambda mm, i, d, mk: point_map.add_observations(
             mm, i, d, mk, jnp.asarray(7, jnp.int32)).desc_count.sum()),
         (m, ids, feats1.desc, feats1.mask)),
        ("pnp refine (8 GN iters, 3072 pts)",
         jax.jit(lambda x, uv, mk: pnp.refine_pose(
             jnp.eye(4), x, uv, mk, Kj, iters=8).T_cw),
         (xyz3, feats1.uv, feats1.mask)),
    ]

    total = 0.0
    for name, fn, args in stages:
        ms = device_ms(lambda fn=fn, args=args: fn(*args))
        total += ms
        print(f"stage {name:45s} {ms:8.3f} ms")

    # ---- the fused full step, at the same live map size -------------------
    # Loop-CARRIED scan (state threads through, map mutates every step), the
    # same shape as the real pipeline. The FINAL STATE is a program output:
    # with only the inlier counts live, XLA dead-code-eliminates the whole
    # map pipeline (none of it feeds num_inliers).
    state = tracker.bootstrap(img0, cfg)
    state = state.replace(map=m)
    n = 8

    @jax.jit
    def run_seq(st, im):
        def body(s, _):
            s2, out = tracker.track_step(s, im, cfg)
            return s2, out.num_inliers
        st, inl = jax.lax.scan(body, st, None, length=n)
        return st, inl.sum()

    ms = device_ms(lambda: run_seq(state, img1), reps=3) / n
    print(f"stage {'sum of isolated stages':45s} {total:8.3f} ms")
    print(f"stage {'full fused track_step (carried scan)':45s} {ms:8.3f} ms  "
          f" ({1000.0 / ms:.1f} frames/s at map={map_size})")


if __name__ == "__main__":
    main()
