"""True multi-process distributed test (SURVEY.md §4 prescription).

Spawns 2 local OS processes that form a jax.distributed process group over
CPU devices (each contributes 2 virtual devices -> a 4-device global mesh)
and run the landmark-sharded BA solver across the group — the first real
execution of parallel/multihost.initialize's jax.distributed path, which the
single-process 8-device-mesh tests cannot exercise.

Process 0 also runs the identical problem single-device and asserts the
distributed camera solution matches (parity), then writes a sentinel the
pytest process checks.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_WORKER = textwrap.dedent("""
    import os, sys, json
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")

    from vslam_jax.parallel import multihost

    active = multihost.initialize()
    assert active, "multihost.initialize did not join the process group"
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 4, jax.device_count()   # 2 per process

    import jax.numpy as jnp
    from vslam_jax.config import BAConfig
    from vslam_jax.optimizer import ba
    from vslam_jax.parallel import sharded_ba
    from jax.sharding import Mesh

    sys.path.insert(0, os.environ["VSLAM_TEST_DIR"])
    from test_multiprocess import _make_problem
    problem, K = _make_problem()

    mesh = Mesh(np.array(jax.devices()), ("shard",))
    cfg = BAConfig(iterations=5)
    out, stats = sharded_ba.solve_sharded(mesh, "shard", problem,
                                          jnp.asarray(K), cfg)
    T = np.asarray(out.T_cw)          # replicated camera solution

    if jax.process_index() == 0:
        ref, ref_stats = ba.solve(problem, jnp.asarray(K), cfg)
        diff = float(np.abs(T - np.asarray(ref.T_cw)).max())
        result = {
            "diff": diff,
            "final_cost": float(stats.final_cost),
            "ref_cost": float(ref_stats.final_cost),
            "processes": jax.process_count(),
            "devices": jax.device_count(),
        }
        with open(os.environ["VSLAM_MP_OUT"], "w") as f:
            json.dump(result, f)
""")


def _make_problem(n_cams=4, n_pts=64, k_obs=4, seed=0):
    """Deterministic tiny BA problem every process builds identically."""
    import jax.numpy as jnp
    from vslam_jax.datasets import synthetic
    from vslam_jax.optimizer import ba

    rng = np.random.RandomState(seed)
    K = np.array([[200.0, 0, 64], [0, 200.0, 48], [0, 0, 1]], np.float32)
    poses = synthetic.make_trajectory(n_cams, step=0.5, seed=seed)
    scene = synthetic.make_scene(num_points=n_pts, seed=seed,
                                 extent=(8, 4, 20), z_min=4.0)
    xyz = scene.xyz
    obs_cam = np.zeros((n_pts, k_obs), np.int32)
    obs_uv = np.zeros((n_pts, k_obs, 2), np.float32)
    obs_mask = np.zeros((n_pts, k_obs), bool)
    for p in range(n_pts):
        s = 0
        for c in range(n_cams):
            if s >= k_obs:
                break
            T_cw = np.linalg.inv(poses[c])
            Xc = T_cw[:3, :3] @ xyz[p] + T_cw[:3, 3]
            if Xc[2] > 0.5:
                uv = (K @ Xc)[:2] / Xc[2]
                obs_cam[p, s] = c
                obs_uv[p, s] = uv + rng.randn(2) * 0.3
                obs_mask[p, s] = True
                s += 1
    cam_fixed = np.zeros(n_cams, bool)
    cam_fixed[:2] = True
    T_cw_all = np.stack([np.linalg.inv(p) for p in poses]).astype(np.float32)
    return ba.BAProblem(
        T_cw=jnp.asarray(T_cw_all),
        cam_fixed=jnp.asarray(cam_fixed),
        cam_mask=jnp.ones(n_cams, bool),
        points=jnp.asarray(
            xyz + rng.randn(*xyz.shape).astype(np.float32) * 0.03),
        point_mask=jnp.asarray(obs_mask.sum(1) >= 2),
        obs_cam=jnp.asarray(obs_cam),
        obs_uv=jnp.asarray(obs_uv),
        obs_mask=jnp.asarray(obs_mask),
    ), K


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_sharded_ba(tmp_path):
    port = _free_port()
    out_path = str(tmp_path / "mp_result.json")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
            "VSLAM_MP_OUT": out_path,
            "VSLAM_TEST_DIR": os.path.join(repo, "tests"),
            "PYTHONPATH": repo,
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env, cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out.decode()[-2000:], err.decode()[-2000:]))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"

    with open(out_path) as f:
        result = json.load(f)
    assert result["processes"] == 2
    assert result["devices"] == 4
    # distributed camera solution matches the single-device solve
    assert result["diff"] < 1e-3, result
    assert np.isfinite(result["final_cost"])
