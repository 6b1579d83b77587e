"""The in-repo pytree dataclass helper (core/struct.py)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from minigrid_dynamicprogramming_tpu.core import struct
from minigrid_dynamicprogramming_tpu.core.state import EnvParams, new_state


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    tag: str = struct.field(pytree_node=False, default="x")


def test_pytree_round_trip():
    p = _Pair(jnp.arange(3), jnp.ones((2, 2)), tag="t")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(q, _Pair) and q.tag == "t"
    np.testing.assert_array_equal(q.a, p.a)
    doubled = jax.jit(lambda x: jax.tree_util.tree_map(lambda y: 2 * y, x))(p)
    np.testing.assert_array_equal(doubled.b, 2 * np.ones((2, 2)))
    assert doubled.tag == "t"


def test_static_fields_stay_out_of_leaves():
    p = _Pair(jnp.zeros(1), jnp.zeros(2), tag="static")
    assert len(jax.tree_util.tree_leaves(p)) == 2
    assert "static" in str(jax.tree_util.tree_structure(p))
    assert jax.tree_util.tree_structure(p) != jax.tree_util.tree_structure(
        p.replace(tag="other")
    )


def test_replace_and_frozen():
    p = _Pair(jnp.zeros(1), jnp.zeros(2))
    q = p.replace(a=jnp.ones(1))
    assert float(q.a[0]) == 1.0 and float(p.a[0]) == 0.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.ones(1)
    s = new_state(4, 5, rng=jax.random.PRNGKey(0))
    assert s.replace(step_count=jnp.int32(3)).step_count == 3


def test_env_params_hashable_static_arg():
    p1 = EnvParams(width=5, height=5).with_extra(k=1)
    p2 = EnvParams(width=5, height=5).with_extra(k=1)
    assert p1 == p2 and hash(p1) == hash(p2)
    assert jax.tree_util.tree_leaves(p1) == []

    area = jax.jit(
        lambda x, params: x * params.width * params.height, static_argnums=1
    )
    assert int(area(jnp.int32(2), p1)) == 50
    assert int(area(jnp.int32(2), p2.replace(width=6))) == 60
