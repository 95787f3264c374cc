"""Test harness: force an 8-device virtual CPU platform.

The tests run on the host CPU; all sharding/collective paths are validated
on a virtual host-platform mesh, mirroring the multi-process test strategy
recommended in SURVEY.md §4. The GPU run is ``python chip_smoke.py``.

Must run before jax initializes, hence the env mutation at import time.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force, even on a host with a GPU
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Two-tier suite (VERDICT r03 next #2): everything not marked ``slow``
    is ``quick``. ``pytest -m quick`` is the pre-commit tier — measured
    6-8.5 min wall on this machine's 8-device CPU mesh (the old '< 5 min'
    claim was never re-timed here; VERDICT r04 weak #4); the full suite
    adds the multi-minute sharded-tracking / multi-process / mesh-fan
    tests (~14 min more)."""
    for item in items:
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables at module boundaries. The full suite
    compiles hundreds of programs (several full track_step variants on an
    8-device mesh among them) into one process; a run was observed to
    segfault inside XLA:CPU late in the suite with ~100 modules' worth of
    live executables, and the same test passes in a fresh process. Bounding
    the live-program set is cheap (cross-module cache hits were already
    rare) and makes the suite robust."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)
