"""Process set-up shared by the entry points (CLI, chip smoke, benchmarks).

Nothing here runs at package import: tests and library users keep JAX's
defaults. Entry points call these once, before their first device op.
"""
from __future__ import annotations

import os
import subprocess

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache`` (listed in .gitignore): the path is part of
    the cache key, so it never derives from a temp name, a pid or the time.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def select_platform(name: str) -> None:
    """Apply ``--platform``: ``cpu`` pins JAX to the host, ``gpu`` requires
    a GPU (no fallback), ``default`` leaves JAX's own choice."""
    import jax

    if name == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif name == "gpu":
        require_gpu()


def require_gpu():
    """Return ``jax.devices()`` if they are GPUs; raise SystemExit if JAX
    found none (a measurement never falls back to the CPU)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX found platform {devs[0].platform!r} "
            f"({devs[0].device_kind})")
    return devs


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of the cards as nvidia-smi reports them.
    Raises if nvidia-smi is missing or cannot name a card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi named no GPU")
    return out
