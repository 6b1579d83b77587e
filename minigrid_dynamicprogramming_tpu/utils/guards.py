"""NaN/OOB guard rails (SURVEY §5 "race detection / sanitizers").

The reference has no sanitizer layer (single-threaded Python; invariants are
implicit in ``Grid.set`` bounds asserts, /root/reference/minigrid/core/
grid.py:105-111).  On the device data path the equivalent is functional:
``checkify`` assertions over the state pytree that compile into the step
program in test/debug mode and disappear entirely in production mode, plus a
``debug_mode`` switch for ``jax_debug_nans``/``jax_debug_infs``.

Usage::

    step = checked_step(env)                 # checkified step fn
    err, (obs, state, r, term, trunc, _) = jax.jit(step)(key, state, action)
    err.throw()                              # raises on any violated invariant

    with debug_mode():                       # NaN/Inf tripwires for a block
        train_step(...)
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from minigrid_dynamicprogramming_tpu.core.constants import NUM_COLORS, NUM_OBJECTS
from minigrid_dynamicprogramming_tpu.core.state import EnvParams, EnvState

__all__ = ["check_state", "checked_step", "checked_reset", "debug_mode"]


def check_state(params: EnvParams, state: EnvState) -> None:
    """checkify assertions for every EnvState invariant the reference's
    Python layer enforces implicitly (bounds asserts in grid.py:105-111,
    dir/pos validity in minigrid_env.py:431-437)."""
    w, h = params.width, params.height
    checkify.check(
        (state.agent_pos[0] >= 0)
        & (state.agent_pos[0] < w)
        & (state.agent_pos[1] >= 0)
        & (state.agent_pos[1] < h),
        "agent position out of bounds",
    )
    checkify.check(
        (state.agent_dir >= 0) & (state.agent_dir < 4),
        "agent direction outside [0, 4)",
    )
    checkify.check(
        jnp.all(state.grid_obj < NUM_OBJECTS),
        "grid object code outside the encoding table",
    )
    checkify.check(
        jnp.all(state.grid_color < NUM_COLORS),
        "grid color code outside the encoding table",
    )
    checkify.check(
        jnp.all(state.grid_state < 3),
        "door state outside {open, closed, locked}",
    )
    checkify.check(
        (state.step_count >= 0) & (state.step_count <= params.max_steps),
        "step_count outside [0, max_steps]",
    )
    checkify.check(
        state.carrying_obj < NUM_OBJECTS,
        "carried object code outside the encoding table",
    )


def checked_step(env):
    """A checkified ``env.step``: returns ``(err, outputs)``; ``err.throw()``
    raises with the first violated invariant.  Also guards the reward for
    NaN/Inf and range (env.reward_range, minigrid_env.py:54)."""
    lo, hi = env.reward_range

    def _step(key, state, action):
        out = env.step(key, state, action)
        _, new_state, reward, _, _, _ = out
        check_state(env.params, new_state)
        checkify.check(jnp.isfinite(reward), "non-finite reward")
        checkify.check(
            (reward >= lo) & (reward <= hi),
            "reward outside the declared reward_range",
        )
        return out

    return checkify.checkify(_step, errors=checkify.user_checks)


def checked_reset(env):
    """A checkified ``env.reset``: state invariants hold post-generation."""

    def _reset(key):
        obs, state = env.reset(key)
        check_state(env.params, state)
        return obs, state

    return checkify.checkify(_reset, errors=checkify.user_checks)


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True):
    """Scoped ``jax_debug_nans``/``jax_debug_infs`` — the SURVEY §5 test
    mode.  Any jitted computation producing NaN/Inf inside the block re-runs
    un-jitted and raises at the producing primitive."""
    prev_nans = jax.config.jax_debug_nans
    prev_infs = jax.config.jax_debug_infs
    try:
        jax.config.update("jax_debug_nans", nans)
        jax.config.update("jax_debug_infs", infs)
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nans)
        jax.config.update("jax_debug_infs", prev_infs)
