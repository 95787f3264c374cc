"""BA benchmark (BASELINE metric 3): LM iterations/sec on one GPU.

    python bench_ba.py [--skip-kitti-scale]

Measures, on the window-BA shape (20 cameras, 8192 landmarks, 16 obs
slots) and on a KITTI-00-scale global shape (256 cameras, 64k corridor
landmarks, 8 obs slots):
  * seconds per LM iteration of ``ba.solve`` for both Schur assemblies
    (one-hot matmul vs blocked scatter-add, optimizer/ba.py);
  * a per-stage breakdown of one LM iteration (GN+Schur assembly, dense
    camera solve, landmark back-substitution, cost evaluation).

Every timing is the mean of several calls after one warm-up (compile)
call, ended by ``jax.block_until_ready``. Prints one JSON line. Refuses to
run without a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def make_problem(n_cams=20, n_pts=8192, k_obs=16, noise_px=0.5, seed=0,
                 corridor=False):
    """``corridor=True`` anchors landmarks along the trajectory (KITTI-00
    shape: hundreds of cameras over a long path, each landmark visible
    from a local stretch) instead of a fixed box every camera sees."""
    import jax.numpy as jnp
    from vslam_jax.datasets import synthetic
    from vslam_jax.optimizer import ba

    rng = np.random.RandomState(seed)
    K = np.array([[718.856, 0, 607.19], [0, 718.856, 185.22], [0, 0, 1.0]],
                 np.float32)
    poses = synthetic.make_trajectory(n_cams, step=1.0, seed=seed)
    if corridor:
        scene = synthetic.make_corridor_scene(
            poses, num_points=n_pts, seed=seed, lateral=20.0, vertical=6.0,
            ahead=(4.0, 60.0))
    else:
        scene = synthetic.make_scene(num_points=n_pts, seed=seed,
                                     extent=(60, 15, 120), z_min=4.0)
    xyz = scene.xyz
    obs_cam = np.zeros((n_pts, k_obs), np.int32)
    obs_uv = np.zeros((n_pts, k_obs, 2), np.float32)
    obs_mask = np.zeros((n_pts, k_obs), bool)
    # vectorized visibility: project all points through all cameras
    for c in range(n_cams):
        T_cw = np.linalg.inv(poses[c])
        Xc = xyz @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = (Xc @ K.T)
        z = uv[:, 2]
        ok = z > 0.5
        uvp = uv[:, :2] / np.maximum(z[:, None], 1e-6)
        ok &= (uvp[:, 0] >= 0) & (uvp[:, 0] < 1248) \
            & (uvp[:, 1] >= 0) & (uvp[:, 1] < 384)
        slot = obs_mask.sum(1)
        can = ok & (slot < k_obs)
        idx = np.where(can)[0]
        obs_cam[idx, slot[idx]] = c
        obs_uv[idx, slot[idx]] = uvp[idx] + rng.randn(len(idx), 2) * noise_px
        obs_mask[idx, slot[idx]] = True

    cam_fixed = np.zeros(n_cams, bool)
    cam_fixed[0] = True
    T_cw_all = np.stack([np.linalg.inv(p) for p in poses]).astype(np.float32)
    # perturb initial state so LM has real work
    import jax.numpy as jnp
    from vslam_jax.core import lie
    xi = rng.randn(n_cams, 6).astype(np.float32) * 0.01
    xi[0] = 0
    T0 = np.asarray(lie.se3_exp(jnp.asarray(xi))) @ T_cw_all
    pts0 = xyz + rng.randn(*xyz.shape).astype(np.float32) * 0.05
    problem = ba.BAProblem(
        T_cw=jnp.asarray(T0),
        cam_fixed=jnp.asarray(cam_fixed),
        cam_mask=jnp.ones(n_cams, bool),
        points=jnp.asarray(pts0),
        point_mask=jnp.asarray(obs_mask.sum(1) >= 2),
        obs_cam=jnp.asarray(obs_cam),
        obs_uv=jnp.asarray(obs_uv),
        obs_mask=jnp.asarray(obs_mask),
    )
    return problem, K


def measure_iters_per_sec(problem, K, assembly, iters=10, reps=5):
    """Seconds per LM iteration of one ``iters``-iteration solve."""
    import jax.numpy as jnp
    from vslam_jax.config import BAConfig
    from vslam_jax.ops.bench_kernels import device_ms
    from vslam_jax.optimizer import ba

    Kj = jnp.asarray(K)
    cfg = BAConfig(iterations=iters, schur_assembly=assembly)
    ms = device_ms(lambda: ba.solve(problem, Kj, cfg), reps=reps)
    _, stats = ba.solve(problem, Kj, cfg)
    return ms / 1e3 / iters, stats


def measure_breakdown(problem, K, assembly):
    """Per-stage device ms of one LM iteration."""
    import jax
    import jax.numpy as jnp
    from vslam_jax.config import BAConfig
    from vslam_jax.ops.bench_kernels import device_ms
    from vslam_jax.optimizer import ba

    Kj = jnp.asarray(K)
    cfg = BAConfig(schur_assembly=assembly)
    lam = jnp.float32(1e-3)

    @jax.jit
    def gn_schur(p):
        r, w, J_c, J_p, _ = ba._gn_quantities(p.T_cw, p.points, p, Kj,
                                              cfg.huber_delta)
        return ba._schur_reduce(r, w, J_c, J_p, p, lam, assembly=assembly)

    S, b, Hpp_inv, b_p, W_blk = gn_schur(problem)
    C6 = S.shape[0]

    @jax.jit
    def dense_solve(S, b):
        L, low = jax.scipy.linalg.cho_factor(
            S + (1e-6 * jnp.trace(S) / C6) * jnp.eye(C6, dtype=S.dtype),
            lower=True)
        return jax.scipy.linalg.cho_solve((L, low), b)

    dx_cam = dense_solve(S, b)
    backsub = jax.jit(lambda dx, p: ba._backsub(dx, Hpp_inv, b_p, W_blk, p))
    cost = jax.jit(lambda p: ba.compute_cost(p, Kj, cfg.huber_delta))
    stages = [("gn+schur_assembly", lambda: gn_schur(problem)),
              ("dense_camera_solve", lambda: dense_solve(S, b)),
              ("landmark_backsub", lambda: backsub(dx_cam, problem)),
              ("cost_eval", lambda: cost(problem))]
    out = []
    for name, fn in stages:
        ms = device_ms(fn)
        out.append({"stage": name, "ms": ms})
        print(f"ba stage [{assembly}] {name:22s} {ms:8.3f} ms",
              file=sys.stderr)
    return out


def race_assemblies(problem, K, assemblies=("scatter", "onehot")):
    race = {}
    for assembly in assemblies:
        per_iter, stats = measure_iters_per_sec(problem, K, assembly)
        race[assembly] = {
            "sec_per_lm_iteration": per_iter,
            "lm_iterations_per_sec": 1.0 / per_iter,
            "initial_cost": float(stats.initial_cost),
            "final_cost": float(stats.final_cost),
            "accepted_steps": int(np.asarray(stats.accepted).sum()),
        }
        print(f"assembly={assembly}: {per_iter * 1e3:.3f} ms/LM-iter",
              file=sys.stderr)
    return race


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-kitti-scale", action="store_true")
    args = ap.parse_args()

    from vslam_jax.utils import runtime

    runtime.enable_compile_cache()
    devs = runtime.require_gpu()
    card = runtime.gpu_name_and_power_limit()
    print(card, file=sys.stderr)

    result = {"device": {"platform": devs[0].platform,
                         "kind": devs[0].device_kind, "count": len(devs),
                         "name_power_limit": card}}
    shapes = [("window", 20, 8192, 16, False)]
    if not args.skip_kitti_scale:
        # KITTI-00-scale global BA: hundreds of cameras, corridor landmarks
        shapes.append(("kitti00_scale", 256, 65536, 8, True))
    for name, c, p, k, corridor in shapes:
        problem, K = make_problem(c, p, k, corridor=corridor,
                                  seed=1 if corridor else 0)
        race = race_assemblies(problem, K)
        winner = min(race, key=lambda a: race[a]["sec_per_lm_iteration"])
        result[name] = {
            "problem": {"cams": c, "points": p, "obs_slots": k,
                        "live_landmarks": int(problem.point_mask.sum()),
                        "observations": int((problem.obs_mask
                                             & problem.point_mask[:, None])
                                            .sum())},
            "assembly_race": race,
            "breakdown": measure_breakdown(problem, K, winner),
        }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
