"""Tool-layer tests: ASCII printer, state digest, benchmark CLI, manual
control, checkpointing — mirroring the reference's ``tests/test_scripts.py``
plus digest/checkpoint coverage the reference lacks."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.core.constants import ACT_FORWARD
from minigrid_dynamicprogramming_tpu.utils.debug import pprint_state, state_hash
from minigrid_dynamicprogramming_tpu.utils.parity import state_from_reference

from .oracle import make_reference_env


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-LavaGapS7-v0"])
def test_pprint_matches_reference(env_id):
    ref_env, _ = make_reference_env(env_id, seed=3)
    state = state_from_reference(ref_env)
    assert pprint_state(state) == ref_env.unwrapped.pprint_grid()
    ref_env.close()


def test_state_hash_matches_reference():
    ref_env, _ = make_reference_env("MiniGrid-Empty-8x8-v0", seed=7)
    state = state_from_reference(ref_env)
    assert state_hash(state) == ref_env.unwrapped.hash()
    ref_env.close()


def test_state_hash_sensitivity():
    env = mgtpu.make("MiniGrid-Empty-5x5-v0")
    _, state = jax.jit(env.reset)(jax.random.PRNGKey(0))
    h0 = state_hash(state)
    _, moved, *_ = jax.jit(env.step)(
        jax.random.PRNGKey(1), state, jnp.asarray(ACT_FORWARD)
    )
    assert state_hash(moved) != h0
    assert state_hash(state) == h0  # pure function, state untouched


def test_benchmark_smoke():
    from minigrid_dynamicprogramming_tpu.benchmark import benchmark

    res = benchmark(
        "MiniGrid-Empty-5x5-v0",
        num_resets=3,
        num_frames=3,
        tile_size=8,
        batch=8,
        horizon=4,
    )
    assert res["reset_ms"] > 0
    assert res["batched_env_steps_per_s"] > 0


def test_manual_control_scripted():
    """Drive ManualControl with fake key events (reference
    tests/test_scripts.py:18-49 drives pygame with a mock)."""
    from minigrid_dynamicprogramming_tpu.manual_control import ManualControl

    mc = ManualControl(mgtpu.make("MiniGrid-Empty-5x5-v0"), seed=0)
    mc.reset()
    before = mc.describe()
    assert "mission" in before and ">>" in before or "<<" in before or "^^" in before or "VV" in before
    out = mc.handle_key("up")
    assert out is not None and isinstance(out[0], float)
    assert mc.handle_key("x") is None  # unbound key ignored
    mc.handle_key("r")  # reset binding
    with pytest.raises(SystemExit):
        mc.handle_key("q")


def test_checkpoint_roundtrip(tmp_path):
    from minigrid_dynamicprogramming_tpu.utils import checkpoint as ckpt

    env = mgtpu.make("MiniGrid-DoorKey-5x5-v0")
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    batch = jax.jit(jax.vmap(env.generate, in_axes=(0, None)), static_argnums=1)(
        keys, env.params
    )
    tree = {"env_state": batch, "counter": jnp.asarray(5)}
    meta = ckpt.save(str(tmp_path / "ck"), tree, env_state=batch)
    assert len(meta["env_digests"]) == 4

    target = jax.tree_util.tree_map(np.zeros_like, jax.device_get(tree))
    restored = ckpt.restore(
        str(tmp_path / "ck"), target, env_state_of=lambda t: t["env_state"]
    )
    np.testing.assert_array_equal(
        np.asarray(restored["env_state"].grid_obj), np.asarray(batch.grid_obj)
    )
    assert int(restored["counter"]) == 5


def test_checkpoint_integrity_check(tmp_path):
    from minigrid_dynamicprogramming_tpu.utils import checkpoint as ckpt

    env = mgtpu.make("MiniGrid-Empty-5x5-v0")
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    batch = jax.jit(jax.vmap(env.generate, in_axes=(0, None)), static_argnums=1)(
        keys, env.params
    )
    ckpt.save(str(tmp_path / "ck"), {"env_state": batch}, env_state=batch)

    # Tamper with the metadata digests: restore must fail the check.
    import json, os

    meta_path = os.path.join(str(tmp_path / "ck"), "framework_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["env_digests"][0] = "deadbeefdeadbeef"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    target = jax.device_get({"env_state": batch})
    with pytest.raises(ValueError):
        ckpt.restore(
            str(tmp_path / "ck"), target, env_state_of=lambda t: t["env_state"]
        )


def test_compile_cache_dir(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code;
    otherwise the cache is the fixed .jax_cache at the checkout root."""
    import pathlib

    from minigrid_dynamicprogramming_tpu.utils import compile_cache

    root = pathlib.Path(mgtpu.__file__).resolve().parent.parent
    assert compile_cache.CACHE_DIR == str(root / ".jax_cache")

    calls = []
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: calls.append((name, value))
    )
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert compile_cache.enable_compile_cache() == compile_cache.CACHE_DIR
    assert ("jax_compilation_cache_dir", compile_cache.CACHE_DIR) in calls
