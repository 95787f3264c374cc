"""Gate-constant sensitivity study (VERDICT r04 next #6).

One-factor-at-a-time sweep of the triangulation / association / promotion
gate constants around their defaults, on BOTH behavioral regimes (the
exploration corridor and the dense revisit box), reporting (ATE,
anchors/frame, associations/frame, map_alive) per point. Emits
``artifacts/sweeps_r05/gates.json`` — the measured justification for every
hand-set constant the round-4 verdict flagged as unjustified.

    python scripts/sweep_gates.py [--frames 150] [--out artifacts/sweeps_r05]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_case(cfg, scenes, seed=7):
    import jax
    import numpy as np
    from vslam_jax.pipeline import slam
    from vslam_jax.utils import evaluate

    # every case is a distinct static config -> a fresh set of compiled
    # programs; without clearing, ~20 cases of compile cache exhaust host
    # RAM (observed: LLVM 'Cannot allocate memory' mid-sweep)
    jax.clear_caches()
    out = {}
    for name, (frames, poses, pipe) in scenes.items():
        c = cfg.replace(pipeline=pipe)
        s = slam.SLAMSystem(c, seed=seed, enable_ba=True)
        for f in frames:
            s.process(f)
        fr = [r for r in s.metrics.records
              if r.get("kind") == "frame" and "success" in r]
        ate, _, _ = evaluate.ate_rmse(s.poses(), poses.astype(np.float64))
        out[name] = {
            "ate": round(float(ate), 4),
            "med_tracked_map": float(np.median(
                [r["num_tracked_map"] for r in fr])),
            "med_associated": float(np.median(
                [r["num_associated"] for r in fr])),
            "map_alive": fr[-1]["map_alive"],
            "success_rate": sum(r["success"] for r in fr) / len(fr),
        }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--out", default="artifacts/sweeps_r05")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from vslam_jax.utils import runtime
    runtime.enable_compile_cache()
    import numpy as np
    from vslam_jax.config import small_config
    from vslam_jax.datasets import synthetic

    os.makedirs(args.out, exist_ok=True)
    base = small_config()
    base = base.replace(map=dataclasses.replace(base.map, capacity=1024))
    K = base.camera.K()
    W, H = base.camera.width, base.camera.height

    # the two behavioral regimes (same shapes as scripts/endurance.py)
    poses_c = synthetic.make_trajectory(args.frames, step=0.6,
                                        seed=args.seed)
    scene_c = synthetic.make_corridor_scene(
        poses_c, num_points=args.frames * 100, seed=args.seed)
    frames_c = [synthetic.render_frame(K, poses_c[i], scene_c, W, H)
                for i in range(args.frames)]
    pipe_c = dataclasses.replace(base.pipeline, keyframe_every=5,
                                 max_keyframes=256, local_ba_every=5)
    poses_r = synthetic.make_trajectory(100, step=0.35, yaw_rate=0.002,
                                        seed=2)
    scene_r = synthetic.make_scene(num_points=900, seed=2,
                                   extent=(16, 6, 60), z_min=6.0)
    frames_r = [synthetic.render_frame(K, poses_r[i], scene_r, W, H)
                for i in range(100)]
    pipe_r = dataclasses.replace(base.pipeline, keyframe_every=2,
                                 max_keyframes=96, local_ba_every=5)
    scenes = {"corridor": (frames_c, poses_c, pipe_c),
              "revisit": (frames_r, poses_r, pipe_r)}

    # one-factor-at-a-time around the defaults
    axes = {
        "min_parallax_deg": ("triangulation", [1.0, 2.0, 3.0]),
        "track_id_hamming_max": ("triangulation", [40, 56, 72]),
        "promote_parallax_lo_deg": ("triangulation", [4.0, 5.0, 6.0]),
        "anchor_target": ("triangulation", [8, 12, 20]),
        "hamming_max": ("matching", [48, 64, 80]),
        "reacq_hamming_max": ("matching", [80, 96, 112]),
        "reacq_max_age": ("matching", [0, 4, 8]),
    }
    results = {"defaults": run_case(base, scenes, args.seed), "axes": {}}
    print("defaults:", json.dumps(results["defaults"]), flush=True)
    for field, (group, values) in axes.items():
        rows = []
        for v in values:
            g = getattr(base, group)
            cfg = base.replace(**{group: dataclasses.replace(g,
                                                             **{field: v})})
            r = run_case(cfg, scenes, args.seed)
            rows.append({"value": v, **r})
            print(f"{field}={v}:", json.dumps(r), flush=True)
        results["axes"][field] = rows

    with open(os.path.join(args.out, "gates.json"), "w") as f:
        json.dump(results, f, indent=2)
    print("SWEEP OK")


if __name__ == "__main__":
    main()
