"""Kernel microbenchmarks: race the alternative formulations on a GPU.

    python -m vslam_jax.ops.bench_kernels

Prints ms per call for:
  * Hamming (N1,N2) over 256-bit descriptors: int8 bit-plane matmul vs
    population_count (matching/hamming.py); both must agree bit for bit.
  * Search-by-projection association (mapping/point_map.associate) at
    several live map sizes — the map-scaling hot path (the analogue of
    reference src/vslam.cpp:129-161).
  * batched 9x9 symmetric eigendecomposition: fixed-sweep Jacobi
    (ops/jacobi.py) vs jnp.linalg.eigh.

Each timing is the mean of ``reps`` calls after one warm-up call, ended by
``jax.block_until_ready``. Refuses to run without a GPU.
"""
from __future__ import annotations

import time

import numpy as np


def device_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of ``fn()`` after one warm-up (compile) call."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1000.0


def _rand_desc(key, n):
    import jax
    import jax.numpy as jnp
    return jax.random.bits(key, (n, 8), jnp.uint32)


def bench_hamming(n1=3072, n2=3072):
    import jax
    from ..matching import hamming

    d1 = _rand_desc(jax.random.PRNGKey(0), n1)
    d2 = _rand_desc(jax.random.PRNGKey(1), n2)
    fns = {"matmul(int8)": jax.jit(hamming.hamming_matmul),
           "popcount": jax.jit(hamming.hamming_popcount)}
    outs = [np.asarray(f(d1, d2)) for f in fns.values()]
    assert (outs[0] == outs[1]).all(), "matmul disagrees with popcount"
    for name, f in fns.items():
        ms = device_ms(lambda f=f: f(d1, d2))
        print(f"hamming {n1}x{n2} {name:14s} {ms:8.4f} ms")


def bench_associate(map_sizes=(4096, 51200, 131072), n_kp=3072):
    """Search-by-projection cost vs live map size (the scaling hot path)."""
    import jax
    import jax.numpy as jnp
    from ..config import VSLAMConfig
    from ..core.types import empty_map
    from ..mapping import point_map

    cfg = VSLAMConfig()
    W, H = cfg.camera.width, cfg.camera.height
    K = cfg.camera.K()
    P = jnp.asarray(np.hstack([K, np.zeros((3, 1), np.float32)]))
    for ms_pts in map_sizes:
        m = empty_map(cfg.map.capacity, cfg.map.obs_per_point)
        k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(ms_pts), 4)
        xyz = jax.random.normal(k1, (ms_pts, 3)) * jnp.asarray([20., 8., 30.]) \
            + jnp.asarray([0., 0., 40.])
        desc = jax.random.bits(k2, (ms_pts, 8), jnp.uint32)
        m = point_map.insert_points(
            m, xyz, jnp.zeros((ms_pts, 3), jnp.float32), desc,
            jnp.ones(ms_pts, bool))
        uv = jnp.stack([jax.random.uniform(k3, (n_kp,)) * W,
                        jax.random.uniform(k3, (n_kp,)) * H], -1)
        kd = jax.random.bits(k4, (n_kp, 8), jnp.uint32)
        free = jnp.ones(n_kp, bool)
        t = device_ms(lambda: point_map.associate(
            m, P, uv, kd, free, cfg.map, cfg.matching, W, H))
        n_blocks = -(-ms_pts // cfg.map.block_size)
        print(f"associate map={ms_pts:7d} {t:8.3f} ms ({n_blocks} blocks "
              f"x K={cfg.map.obs_per_point})")


def bench_eigh(batch=2048):
    import jax
    import jax.numpy as jnp
    from . import jacobi

    A8 = jax.random.normal(jax.random.PRNGKey(3), (batch, 8, 9))
    AtA = jnp.einsum("bij,bik->bjk", A8, A8)
    for name, fn in [("jacobi(8 sweeps)",
                      jax.jit(lambda A: jacobi.jacobi_eigh(A, sweeps=8))),
                     ("jnp.linalg.eigh", jax.jit(jnp.linalg.eigh))]:
        ms = device_ms(lambda fn=fn: fn(AtA))
        print(f"eigh9x9 {name:22s} {ms:8.3f} ms  ({batch} batch)")


def main():
    import jax
    from ..utils import runtime

    runtime.enable_compile_cache()
    runtime.require_gpu()
    print(runtime.gpu_name_and_power_limit())
    print(f"device_kind={jax.devices()[0].device_kind} jax={jax.__version__}")
    bench_hamming()
    bench_associate()
    bench_eigh()


if __name__ == "__main__":
    main()
