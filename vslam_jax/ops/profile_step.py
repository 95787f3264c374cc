"""Per-op device-time attribution of the fused tracking step via xprof.

Run on a GPU:  python -m vslam_jax.ops.profile_step [n_frames]

Captures a ``jax.profiler`` trace of the carried-scan tracking loop at the
bench.py steady-state workload (51k live map) into
``<checkout>/out/profile_step`` and aggregates device-plane op durations by
op name, printing the top cost centers. The isolated-stage harness
(ops/bench_stages.py) times whole stages; this tool names the ops *between*
them.

The installed xprof/tensorboard packages ship no ``xplane_pb2``, so the
trace file is parsed with a minimal protobuf wire-format reader
(``_parse_xspace``) covering exactly the fields we aggregate: plane name,
event-metadata names, line events (metadata id, duration).
"""
from __future__ import annotations

import collections
import glob
import os
import sys


# ---------------------------------------------------------------------------
# Minimal protobuf wire parsing (XSpace schema, tsl/profiler xplane.proto)
# ---------------------------------------------------------------------------

def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:                       # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 2:                     # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:                     # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        elif wt == 1:                     # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"wire type {wt}")
        yield field, wt, val


def _parse_event(buf):
    meta_id = 0
    dur_ps = 0
    for f, _, v in _fields(buf):
        if f == 1:
            meta_id = v
        elif f == 3:
            dur_ps = v
    return meta_id, dur_ps


def _parse_line(buf):
    name = b""
    events = []
    for f, wt, v in _fields(buf):
        if f == 2 and wt == 2:
            name = v
        elif f == 4 and wt == 2:
            events.append(_parse_event(v))
    return name.decode("utf-8", "replace"), events


def _parse_meta_entry(buf):
    """map<int64, XEventMetadata> entry -> (id, name)."""
    key = 0
    name = b""
    for f, wt, v in _fields(buf):
        if f == 1 and wt == 0:
            key = v
        elif f == 2 and wt == 2:
            # XEventMetadata { int64 id=1; string name=2; ... }
            for f2, wt2, v2 in _fields(v):
                if f2 == 2 and wt2 == 2:
                    name = v2
    return key, name.decode("utf-8", "replace")


def _parse_plane(buf):
    name = b""
    lines = []
    meta = {}
    for f, wt, v in _fields(buf):
        if f == 2 and wt == 2:
            name = v
        elif f == 3 and wt == 2:
            lines.append(_parse_line(v))
        elif f == 4 and wt == 2:
            k, nm = _parse_meta_entry(v)
            meta[k] = nm
    return name.decode("utf-8", "replace"), lines, meta


def _parse_xspace(path):
    with open(path, "rb") as f:
        buf = f.read()
    planes = []
    for f_, wt, v in _fields(buf):
        if f_ == 1 and wt == 2:
            planes.append(_parse_plane(v))
    return planes


def aggregate_device_ops(trace_dir):
    """Aggregate (op name -> total ms, count) over all device planes."""
    paths = glob.glob(
        os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    agg = collections.Counter()
    cnt = collections.Counter()
    n_dev_planes = 0
    for p in paths:
        for name, lines, meta in _parse_xspace(p):
            low = name.lower()
            if not ("gpu" in low or "device" in low) or "host" in low:
                continue
            n_dev_planes += 1
            for lname, events in lines:
                # XLA op lines carry per-op events; step/module lines would
                # double-count (a module event spans its ops)
                if "module" in lname.lower() or "step" in lname.lower():
                    continue
                for meta_id, dur_ps in events:
                    nm = meta.get(meta_id, f"#{meta_id}")
                    agg[nm] += dur_ps * 1e-9       # ps -> ms
                    cnt[nm] += 1
    return agg, cnt, n_dev_planes


_GROUPS = (
    ("fusion", "fusion"),
    ("convolution", "conv"),
    ("dot", "dot/matmul"),
    ("sort", "sort"),
    ("scatter", "scatter"),
    ("gather", "gather"),
    ("dynamic-slice", "dyn-slice"),
    ("dynamic-update-slice", "dyn-update"),
    ("reduce", "reduce"),
    ("copy", "copy"),
    ("while", "while"),
    ("select-and-scatter", "select-scatter"),
)


def classify(op):
    base = op.split(".")[0]
    for pat, label in _GROUPS:
        if base.startswith(pat):
            return label
    return base


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    import functools
    import numpy as np
    import jax
    import jax.numpy as jnp

    from ..config import VSLAMConfig
    from ..datasets import synthetic
    from ..mapping import point_map
    from ..pipeline import tracker

    cfg = VSLAMConfig()
    K = cfg.camera.K()
    W, H = cfg.camera.width, cfg.camera.height
    from ..utils import runtime
    runtime.enable_compile_cache()
    runtime.require_gpu()
    print(runtime.gpu_name_and_power_limit(), file=sys.stderr)
    print(f"device_kind={jax.devices()[0].device_kind} frames={n_frames} "
          f"map=51200", file=sys.stderr)

    scene = synthetic.make_scene(num_points=12000, seed=3,
                                 extent=(80, 15, 160), z_min=5.0)
    poses = synthetic.make_trajectory(n_frames + 1, step=1.0, seed=3)
    frames_np = synthetic.render_sequence(K, poses, scene, W, H)
    state = tracker.bootstrap(jnp.asarray(frames_np[0]), cfg)
    kk = jax.random.split(jax.random.PRNGKey(11), 2)
    n_pre = 51200
    xyz = jax.random.normal(kk[0], (n_pre, 3)) * jnp.asarray([20., 8., 60.])
    desc = jax.random.bits(kk[1], (n_pre, 8), jnp.uint32)
    m = point_map.insert_points(
        state.map, xyz, jnp.zeros((n_pre, 3), jnp.float32), desc,
        jnp.ones((n_pre,), bool), frame_idx=1 << 20)
    state = state.replace(map=m)
    stacked = jnp.asarray(np.stack(frames_np[1:]))
    np.asarray(state.map.size)

    @functools.partial(jax.jit, static_argnames=("n",))
    def run_n(st, fr, n):
        def body(s, i):
            s2, out = tracker.track_step(s, fr[i], cfg)
            return s2, out.num_inliers
        st, inl = jax.lax.scan(body, st, jnp.arange(n))
        return st, inl.sum()

    # compile + warm outside the trace
    jax.block_until_ready(run_n(state, stacked, n_frames))

    trace_dir = os.path.join(runtime.CHECKOUT, "out", "profile_step")
    import shutil
    shutil.rmtree(trace_dir, ignore_errors=True)
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(run_n(state, stacked, n_frames))

    agg, cnt, n_planes = aggregate_device_ops(trace_dir)
    total = sum(agg.values())
    print(f"device planes: {n_planes}; total device op time "
          f"{total:.3f} ms over {n_frames} frames "
          f"= {total / n_frames:.3f} ms/frame", file=sys.stderr)

    by_group = collections.Counter()
    for op, ms in agg.items():
        by_group[classify(op)] += ms
    print("\n== by op class (ms total | ms/frame | % ) ==")
    for g, ms in by_group.most_common():
        print(f"{g:20s} {ms:9.3f} {ms / n_frames:8.3f} {100 * ms / total:5.1f}%")

    print("\n== top 40 individual ops (ms total | count | ms/frame) ==")
    for op, ms in agg.most_common(40):
        print(f"{ms:9.3f} {cnt[op]:6d} {ms / n_frames:8.4f}  {op[:110]}")


if __name__ == "__main__":
    main()
