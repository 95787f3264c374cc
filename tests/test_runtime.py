"""Entry-point set-up: compile cache location, platform selection, and the
chip smoke's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import jax
import pytest

from vslam_jax.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env_var(monkeypatch, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert runtime.enable_compile_cache() == "/some/cache"
    assert jax.config.jax_compilation_cache_dir is None   # left to JAX


def test_compile_cache_defaults_to_fixed_checkout_path(monkeypatch,
                                                       restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert runtime.enable_compile_cache() == path           # stable
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cli_platform_gpu_fails_without_gpu(tmp_path):
    from vslam_jax import cli
    traj = tmp_path / "t.txt"
    traj.write_text("0 0 0 0 0 0 0 1\n1 1 0 0 0 0 0 1\n")
    with pytest.raises(SystemExit):
        cli.main(["eval", "--est", str(traj), "--gt", str(traj),
                  "--platform", "gpu"])


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """On a CPU-only host, and in a directory holding only the script, the
    smoke exits non-zero and never prints its result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
