"""Map re-use experiment harness (round-5 task 1 iteration loop).

Runs the corridor exploration scenario (the endurance.py §1 shape, shortened)
on host CPU and reports the anchor-supply health metrics the round targets:
median num_tracked_map / num_associated / num_pnp_inliers per frame, window-BA
engagement, ATE vs the no-BA control. Fast inner loop for tuning the
re-acquisition association tier, PnP weighting, and insertion gates.

    python scripts/exp_mapreuse.py [--frames 150] [--seed 7] [--no-control]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(cfg, frames, poses, seed, enable_ba=True, label=""):
    import numpy as np
    from vslam_jax.pipeline import slam
    from vslam_jax.utils import evaluate

    s = slam.SLAMSystem(cfg, seed=seed, enable_ba=enable_ba)
    t0 = time.perf_counter()
    for f in frames:
        s.process(f)
    wall = time.perf_counter() - t0
    fr = [r for r in s.metrics.records
          if r.get("kind") == "frame" and "success" in r]
    ba = [r for r in s.metrics.records if r.get("kind") == "ba"]
    ate, _, _ = evaluate.ate_rmse(s.poses(), poses.astype(np.float64))

    med = lambda k: float(np.median([r[k] for r in fr]))
    mean = lambda k: float(np.mean([r[k] for r in fr]))
    rep = {
        "label": label,
        "frames": len(fr),
        "ate": round(float(ate), 4),
        "success_rate": sum(r["success"] for r in fr) / len(fr),
        "med_tracked_map": med("num_tracked_map"),
        "med_associated": med("num_associated"),
        "med_pnp_inliers": med("num_pnp_inliers"),
        "mean_associated": round(mean("num_associated"), 2),
        "mean_new_points": round(mean("num_new_points"), 2),
        "map_alive": fr[-1]["map_alive"],
        "ba_events": len(ba),
        "ba_accepted": sum(1 for r in ba if r.get("ba_result_accepted")),
        "ba_starved": sum(1 for r in ba if r.get("skipped")),
        "wall_s": round(wall, 1),
    }
    return rep, s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--capacity", type=int, default=1024)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from vslam_jax.utils import runtime
    runtime.enable_compile_cache()
    import numpy as np
    from vslam_jax.config import small_config
    from vslam_jax.datasets import synthetic

    cfg = small_config()
    cfg = cfg.replace(
        pipeline=dataclasses.replace(
            cfg.pipeline, keyframe_every=5, max_keyframes=256,
            local_ba_every=5),
        map=dataclasses.replace(cfg.map, capacity=args.capacity))

    K = cfg.camera.K()
    W, H = cfg.camera.width, cfg.camera.height
    # the cli --corridor path: step 0.6, corridor scene, 100 pts/frame
    poses = synthetic.make_trajectory(args.frames, step=0.6, seed=args.seed)
    scene = synthetic.make_corridor_scene(
        poses, num_points=args.frames * 100, seed=args.seed)
    frames = [synthetic.render_frame(K, poses[i], scene, W, H)
              for i in range(args.frames)]

    rep, _ = run_one(cfg, frames, poses, args.seed, enable_ba=True, label="ba")
    print(json.dumps(rep))
    if not args.no_control:
        rep_c, _ = run_one(cfg, frames, poses, args.seed, enable_ba=False,
                           label="no_ba")
        print(json.dumps(rep_c))


if __name__ == "__main__":
    main()
