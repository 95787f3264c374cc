"""CLI configuration assembly (VERDICT weak #4: precedence bug)."""
import argparse

from vslam_jax.cli import _build_cfg
from vslam_jax.config import CameraConfig, VSLAMConfig


def _args(**kw):
    ns = argparse.Namespace(small=False, config=None, no_ba=False)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_dataset_camera_overrides_json_config(tmp_path):
    """--config JSON must not clobber dataset-derived calibration."""
    cfg_json = VSLAMConfig().replace(
        camera=CameraConfig(width=64, height=48, fx=1.0, fy=1.0, cx=1.0, cy=1.0)
    )
    p = tmp_path / "cfg.json"
    p.write_text(cfg_json.to_json())
    ds_cam = CameraConfig(width=1241, height=376, fx=718.0, fy=718.0,
                          cx=607.0, cy=185.0)
    cfg = _build_cfg(_args(config=str(p)), camera=ds_cam)
    assert cfg.camera == ds_cam                       # dataset wins
    assert cfg.frontend == cfg_json.frontend          # rest of JSON survives


def test_json_config_applies_without_dataset():
    cfg = _build_cfg(_args())
    assert cfg == VSLAMConfig()


def test_stream_viewer(tmp_path):
    """MapStream appends deltas; a reader replaying the JSONL reconstructs
    the final cloud; compaction triggers a reset record."""
    import json
    import numpy as np
    from vslam_jax.viz.stream import MapStream

    out = str(tmp_path)
    st = MapStream(out)
    snap1 = {"points": np.arange(12, dtype=np.float32).reshape(4, 3),
             "colors": np.full((4, 3), 0.5, np.float32),
             "poses": np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))}
    st.update(snap1, frame=1)
    snap2 = {"points": np.arange(21, dtype=np.float32).reshape(7, 3),
             "colors": np.full((7, 3), 0.5, np.float32),
             "poses": np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))}
    st.update(snap2, frame=2)
    # compaction: cloud shrinks -> reset
    snap3 = {"points": np.arange(6, dtype=np.float32).reshape(2, 3),
             "colors": np.full((2, 3), 0.5, np.float32),
             "poses": np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))}
    st.update(snap3, frame=3)

    pts, traj = [], []
    with open(out + "/stream.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("reset"):
                pts, traj = [], []
            pts.extend(rec.get("points", []))
            traj.extend(rec.get("traj", []))
    assert len(pts) == 2          # post-reset cloud
    assert any(json.loads(l).get("reset")
               for l in open(out + "/stream.jsonl"))
    assert (tmp_path / "live.html").exists()
    # delta framing: record 2 carried only the 3 new points
    recs = [json.loads(l) for l in open(out + "/stream.jsonl")]
    assert len(recs[0]["points"]) == 4
    assert len(recs[1]["points"]) == 3
