"""Device-resident endurance on a GPU: a long run of the full pipeline.

    python scripts/endurance_device.py [--frames 500] [--full] [--chunk 25] \
        [--out out/endurance_device]

The synthetic corridor frames are rendered ON the device
(datasets/synthetic_device.py — only the pose array is uploaded), and the
full SLAMSystem semantics run against them: keyframe selection, map
maintenance (LRU evict + compact + remap), window-BA cadence with the
trust-region / gauge / starvation guards, and a full-coverage global BA at
the end. Refuses to run without a GPU.

What remains host-bound and is reported as such: the per-frame scalar
fetch (SLAMSystem.process device_get's the TrackOutput for metrics and
keyframe decisions) and BA-event orchestration — both independent of frame
content.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--out", default="out/endurance_device")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--full", action="store_true",
                    help="run at the DEFAULT (full) config — 1248x384, "
                         "3072 kp, 1024 hypotheses — instead of "
                         "small_config")
    ap.add_argument("--chunk", type=int, default=0,
                    help="device-resident chunked driver (pipeline/"
                         "scan_driver.py): track N frames per compiled "
                         "lax.scan with on-device keyframe decisions, "
                         "ring insertion, maintenance AND frame "
                         "rendering — one scalar fetch per chunk instead "
                         "of a full TrackOutput round trip per frame "
                         "(VERDICT r04 next #3). 0 = per-frame driver.")
    args = ap.parse_args()

    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vslam_jax.config import VSLAMConfig, small_config
    from vslam_jax.datasets import synthetic, synthetic_device
    from vslam_jax.pipeline import slam
    from vslam_jax.utils import evaluate, runtime

    runtime.enable_compile_cache()
    runtime.require_gpu()
    card = runtime.gpu_name_and_power_limit()
    print(card, flush=True)

    os.makedirs(args.out, exist_ok=True)
    # MetricsLogger appends; a fresh artifact must not inherit a prior
    # run's rows
    mpath = os.path.join(args.out, "metrics.jsonl")
    if os.path.exists(mpath):
        os.remove(mpath)
    cfg = VSLAMConfig() if args.full else small_config()
    cfg = cfg.replace(pipeline=dataclasses.replace(
        cfg.pipeline, keyframe_every=5, max_keyframes=256, local_ba_every=5))
    if not args.full:
        # capacity sized so the ~1.7 inserts/frame corridor rate crosses the
        # maintenance high-water mark mid-run — the lifecycle (LRU evict +
        # compact + remap) must be exercised on the device, not just on the
        # host-CPU artifact
        cfg = cfg.replace(map=dataclasses.replace(cfg.map, capacity=1024))
    with open(os.path.join(args.out, "config.json"), "w") as f:
        f.write(cfg.to_json())

    K = cfg.camera.K()
    W, H = cfg.camera.width, cfg.camera.height

    step = 1.0 if args.full else 0.6
    density = 150 if args.full else 100
    poses = synthetic.make_trajectory(args.frames, step=step, seed=args.seed)
    t0 = time.perf_counter()
    Kj = jnp.asarray(K)
    poses_d = jnp.asarray(poses)     # (F, 4, 4) — the only scene upload
    xyz, patches = synthetic_device.make_corridor_scene_device(
        jax.random.PRNGKey(args.seed), poses_d, args.frames * density,
        lateral=20.0 if args.full else 14.0)
    jax.block_until_ready(xyz)
    print(f"device scene gen ({args.frames * density} landmarks): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    s = slam.SLAMSystem(cfg, metrics_path=os.path.join(args.out,
                                                       "metrics.jsonl"),
                        seed=args.seed)
    t_start = time.perf_counter()
    n_succ = 0
    if args.chunk > 0:
        # Pre-render the whole sequence INTO DEVICE MEMORY (one scan; for
        # 500 frames at 256x192 that is ~98 MB) — the synthetic renderer
        # is the input generator, not a SLAM component, and folding it
        # into the tracked chunk would make the "system rate" a renderer
        # benchmark. Frames never leave the device; chunks consume slices.
        @jax.jit
        def render_all(ps):
            def step(_, pose):
                return 0, synthetic_device.render_frame_device(
                    xyz, patches, Kj, pose, W, H)
            _, imgs = jax.lax.scan(step, 0, ps)
            return imgs

        t_r = time.perf_counter()
        frames_dev = render_all(poses_d)
        frames_dev.block_until_ready()
        print(f"pre-render {args.frames} frames on device: "
              f"{time.perf_counter() - t_r:.1f}s", flush=True)

        # warm-up compile outside the timed region (the per-frame driver
        # amortizes its compile over the first frames; one scan program
        # compiles once) — run the first chunk, then time the rest.
        # Only FULL chunks run: a shorter tail would be a different scan
        # length and trigger a fresh compile for a handful of frames.
        s.process_chunk(frames_dev[: args.chunk + 1])
        t_start = time.perf_counter()
        n_frames_run = args.chunk + 1
        for s0 in range(args.chunk + 1, args.frames - args.chunk + 1,
                        args.chunk):
            info = s.process_chunk(frames_dev[s0:s0 + args.chunk])
            n_frames_run += args.chunk
            print(f"chunk @{s0}: {info['frames']} frames "
                  f"{time.perf_counter() - t_start:.1f}s elapsed",
                  flush=True)
        wall = time.perf_counter() - t_start
        frames_timed = n_frames_run - (args.chunk + 1)
        args.frames = n_frames_run
        fr_rows = [r for r in s.metrics.records
                   if r.get("kind") == "frame" and "success" in r]
        n_succ = sum(r["success"] for r in fr_rows) + 1
    else:
        for i in range(args.frames):
            img = synthetic_device.render_frame_device(
                xyz, patches, Kj, poses_d[i], W, H)
            info = s.process(img)
            n_succ += int(info.get("success", True))
            if i % 100 == 0:
                print(f"frame {i}: {info.get('map_size', 0)} map points, "
                      f"{time.perf_counter() - t_start:.1f}s elapsed",
                      flush=True)
        wall = time.perf_counter() - t_start
        frames_timed = args.frames

    est = s.poses()
    gt = poses[:len(est)].astype(np.float64)   # chunked mode runs full
    ate, _, _ = evaluate.ate_rmse(est, gt)     # chunks only
    rpe_t, rpe_r = evaluate.rpe(est, gt)

    t_gba = time.perf_counter()
    s.run_global_ba()
    gba_s = time.perf_counter() - t_gba
    kf = s.keyframe_poses()
    kf_frames = np.asarray(s.kf_store.kf_frame)
    kf_frames = np.sort(kf_frames[kf_frames >= 0])
    ate_kf, _, _ = evaluate.ate_rmse(kf, poses[kf_frames].astype(np.float64))

    rows = [json.loads(l) for l in open(os.path.join(args.out,
                                                     "metrics.jsonl"))]
    ba_ev = [r for r in rows if r.get("kind") == "ba"]
    # both drivers flag maintenance on the frame row (the per-frame one
    # additionally logs a map_maintenance row; counting the flag keeps
    # the two modes comparable)
    maint = [r for r in rows if r.get("ran_maintenance")]
    frames = [r for r in rows if r.get("kind") == "frame"
              and "num_dropped_inserts" in r]

    report = {
        "device": f"{jax.devices()[0].device_kind} ({card})",
        "frames": args.frames,
        "driver": f"chunked({args.chunk})" if args.chunk else "per-frame",
        "fps_end_to_end": frames_timed / wall,
        "wall_s": wall,
        "ate_rmse": float(ate),
        "ate_rmse_keyframes_after_global_ba": float(ate_kf),
        "rpe_trans": float(rpe_t),
        "rpe_rot_deg": float(rpe_r),
        "success_rate": n_succ / args.frames,
        "window_ba_events": len(ba_ev),
        "window_ba_accepted": sum(bool(r.get("ba_result_accepted", True))
                                  for r in ba_ev),
        "maintenance_runs": len(maint),
        "dropped_inserts_total": sum(r["num_dropped_inserts"]
                                     for r in frames),
        "global_ba_wall_s": gba_s,
        "global_ba_coverage": s.last_global_ba_coverage,
        "note": ("chunked driver: frames pre-rendered into device memory "
                 "(input generation, not a SLAM stage); per-chunk host "
                 "round trips only (one scalar fetch + one BA-gate "
                 "fetch per chunk)" if args.chunk else
                 "per-frame driver: per-frame scalar fetches + BA "
                 "orchestration are host round-trips"),
    }
    with open(os.path.join(args.out, "endurance.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))

    # ---- asserted bounds -------------------------------------------------
    assert report["success_rate"] == 1.0, report["success_rate"]
    assert math.isfinite(report["rpe_trans"])
    assert report["ate_rmse"] < 2.0, report["ate_rmse"]
    assert report["window_ba_events"] > 0
    assert report["dropped_inserts_total"] == 0
    if not args.full:
        assert report["maintenance_runs"] >= 1, "lifecycle not exercised"
    g = report["global_ba_coverage"]
    assert g["dropped_points"] == 0 and g["dropped_obs"] == 0, g
    print("DEVICE ENDURANCE OK")


if __name__ == "__main__":
    main()
