"""The pytree dataclass helper behind the state containers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vslam_jax.core.types import MapState, empty_map, pytree_dataclass


@pytree_dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray


def test_flatten_unflatten_roundtrip():
    m = empty_map(16, 2)
    leaves, treedef = jax.tree.flatten(m)
    assert len(leaves) == 7
    back = jax.tree.unflatten(treedef, leaves)
    assert isinstance(back, MapState)
    for x, y in zip(jax.tree.leaves(back), leaves):
        assert x is y
    # paths name the fields (the checkpoint keys are built from them)
    paths = [p[0].name for p, _ in jax.tree_util.tree_flatten_with_path(m)[0]]
    assert paths == ["pt", "desc", "desc_count", "alive", "last_seen",
                     "prov", "size"]


def test_replace_is_functional_and_frozen():
    p = _Pair(a=jnp.zeros(3), b=jnp.ones(2))
    q = p.replace(a=jnp.full(3, 2.0))
    assert float(p.a.sum()) == 0.0 and float(q.a.sum()) == 6.0
    assert q.b is p.b
    with pytest.raises(Exception):
        p.a = jnp.zeros(3)


def test_scan_carry_under_jit():
    @jax.jit
    def run(p, xs):
        def step(c, x):
            return c.replace(a=c.a + x, b=c.b * 2.0), c.a.sum()
        return jax.lax.scan(step, p, xs)

    p, ys = run(_Pair(a=jnp.zeros(2), b=jnp.ones(())), jnp.arange(4.0))
    assert isinstance(p, _Pair)
    np.testing.assert_allclose(np.asarray(p.a), [6.0, 6.0])
    assert float(p.b) == 16.0
    np.testing.assert_allclose(np.asarray(ys), [0.0, 0.0, 2.0, 6.0])
