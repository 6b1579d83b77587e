"""Guard rails: checkify invariants, debug mode, telemetry, profiling.

Covers SURVEY §5 "race detection / sanitizers" (checkify NaN/OOB guards +
``jax_debug_nans`` test mode), "metrics / observability" (generation
acceptance-rate telemetry), and "tracing / profiling" (jax.profiler traces,
per-kernel counters)."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.utils.guards import (
    check_state,
    checked_reset,
    checked_step,
    debug_mode,
)
from minigrid_dynamicprogramming_tpu.utils.profiling import KernelTimer, trace
from minigrid_dynamicprogramming_tpu.utils.telemetry import (
    generation_acceptance,
)


def test_checked_step_clean_episode():
    env = mgtpu.make("MiniGrid-DoorKey-8x8-v0")
    _, state = jax.jit(env.reset)(jax.random.PRNGKey(0))
    step = jax.jit(checked_step(env))
    key = jax.random.PRNGKey(1)
    for t in range(20):
        key, k1, k2 = jax.random.split(key, 3)
        a = jax.random.randint(k1, (), 0, 7)
        err, (obs, state, r, term, trunc, _) = step(k2, state, a)
        err.throw()  # no invariant violated on the healthy path


def test_checked_step_catches_corrupted_state():
    env = mgtpu.make("MiniGrid-Empty-8x8-v0")
    _, state = jax.jit(env.reset)(jax.random.PRNGKey(0))
    bad = state.replace(agent_pos=jnp.asarray([99, 1], jnp.int32))
    step = jax.jit(checked_step(env))
    err, _ = step(jax.random.PRNGKey(1), bad, jnp.asarray(0))
    with pytest.raises(Exception, match="out of bounds"):
        err.throw()

    bad2 = state.replace(
        grid_obj=state.grid_obj.at[2, 2].set(jnp.uint8(200))
    )
    err, _ = step(jax.random.PRNGKey(1), bad2, jnp.asarray(0))
    with pytest.raises(Exception, match="object code"):
        err.throw()


def test_checked_reset_all_flagship_envs():
    for env_id in [
        "MiniGrid-DoorKey-8x8-v0",
        "MiniGrid-Dynamic-Obstacles-8x8-v0",
        "BabyAI-GoToDoor-v0",
    ]:
        env = mgtpu.make(env_id)
        err, _ = jax.jit(checked_reset(env))(jax.random.PRNGKey(0))
        err.throw()


def test_debug_mode_trips_on_nan():
    with debug_mode():
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(
                jax.jit(lambda x: x / x)(jnp.asarray(0.0))
            )
    # restored after the block
    assert not jax.config.jax_debug_nans
    jax.block_until_ready(jax.jit(lambda x: x / x)(jnp.asarray(0.0)))


def test_generation_acceptance_loop_mode():
    """BabyAI levels expose the regenerate-loop outcome."""
    rep = generation_acceptance(mgtpu.make("BabyAI-GoToDoor-v0"), n=512)
    assert rep["mode"] == "loop"
    assert rep["accept_rate"] == 1.0  # this level never exhausts its bound
    assert 1.0 <= rep["mean_tries"] <= rep["max_tries"]
    assert 0.0 < rep["first_try_rate"] <= 1.0


def test_generation_acceptance_multiroom():
    rep = generation_acceptance(mgtpu.make("MiniGrid-MultiRoom-N6-v0"), n=512)
    assert rep["mode"] == "loop"
    # N6 chains must reach 6 rooms essentially always — a drop here is the
    # silent-truncation bias the telemetry exists to expose.
    assert rep["accept_rate"] >= 0.99


def test_generation_acceptance_structural_fallback():
    rep = generation_acceptance(mgtpu.make("MiniGrid-Empty-8x8-v0"), n=256)
    assert rep["mode"] == "structural"
    assert rep["accept_rate"] == 1.0


def test_profiler_trace_writes_events(tmp_path):
    env = mgtpu.make("MiniGrid-Empty-8x8-v0")
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        _, state = jax.jit(env.reset)(jax.random.PRNGKey(0))
        jax.block_until_ready(state.grid_obj)
    files = glob.glob(os.path.join(logdir, "**", "*"), recursive=True)
    assert any(os.path.isfile(f) for f in files), "no trace artifacts written"


def test_kernel_timer_report():
    env = mgtpu.make("MiniGrid-Empty-8x8-v0")
    timer = KernelTimer()
    reset_fn = jax.jit(env.reset)
    step_fn = jax.jit(env.step)
    _, state = timer.run("reset", reset_fn, jax.random.PRNGKey(0), units=1)
    for i in range(5):
        out = timer.run(
            "step", step_fn, jax.random.PRNGKey(i), state, jnp.asarray(2),
            units=1,
        )
        state = out[1]
    rep = timer.report()
    assert rep["reset"]["calls"] == 1
    assert rep["step"]["calls"] == 5
    assert rep["step"]["seconds"] > 0
    assert rep["step"]["per_s"] > 0


def test_device_audit():
    """The integer-lowering probe battery (utils/device_audit.py) must pass
    on the test backend (CPU); on an accelerator it documents which
    scatter lowerings are broken — run `benchmark --audit` there (batched
    sub-32-bit scatters miscompiled on an earlier accelerator backend)."""
    from minigrid_dynamicprogramming_tpu.utils.device_audit import audit_device

    rep = audit_device(batch=256)
    assert rep["ok"], rep
