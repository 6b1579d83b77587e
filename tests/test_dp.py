"""Exactness tests for the batched DP solvers (dp/tabular.py and the
key-domain kernel in dp/pallas_vi.py).

Optimality oracle: breadth-first search for the minimum number of steps to
a reward-positive termination, either over the *reference* environment
(deep-copied per expansion) or over this package's own ``env.step`` (the
whole frontier stepped in one batched call).  The VI distance must equal
it exactly, and the greedy VI policy rolled through our env must realize
it.
"""

from __future__ import annotations

from copy import deepcopy
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.dp.tabular import (
    TabularLayout,
    extract_layout,
    env_return,
    greedy_action,
    state_value,
    steps_to_go,
    value_iteration,
)
from minigrid_dynamicprogramming_tpu.utils.parity import state_from_reference

from .oracle import make_reference_env

GAMMA = 0.995
# DP actions exclude drop (never optimal; see dp/tabular.py docstring).
BFS_ACTIONS = (0, 1, 2, 3, 5)


def _ref_key(env):
    e = env.unwrapped
    return (
        e.grid.encode().tobytes(),
        tuple(int(x) for x in e.agent_pos),
        int(e.agent_dir),
        None if e.carrying is None else (e.carrying.type, e.carrying.color),
    )


def _bfs(root, root_key, expand, max_depth):
    """Fewest steps from ``root`` to a reward-positive termination.

    ``expand(frontier)`` yields ``(child, key, reward, terminated,
    truncated)`` for every action from every node of the frontier."""
    frontier, seen = [root], {root_key}
    for depth in range(1, max_depth + 1):
        nxt = []
        for child, key, r, term, trunc in expand(frontier):
            if term and r > 0:
                return depth
            if term or trunc or key in seen:
                continue
            seen.add(key)
            nxt.append(child)
        frontier = nxt
        if not frontier:
            return np.inf
    return np.inf


def bfs_optimal_steps(ref_env, max_depth=80):
    """Min steps to a reward > 0 termination in the reference env."""

    def expand(frontier):
        for env in frontier:
            for a in BFS_ACTIONS:
                child = deepcopy(env)
                _, r, term, trunc, _ = child.step(a)
                yield child, _ref_key(child), r, term, trunc

    return _bfs(deepcopy(ref_env), _ref_key(ref_env), expand, max_depth)


_KEY_FIELDS = (
    "grid_obj", "grid_color", "grid_state", "contains_obj",
    "contains_color", "agent_pos", "agent_dir", "carrying_obj",
    "carrying_color",
)


def _state_key(state):
    return b"".join(
        np.asarray(getattr(state, f)).tobytes() for f in _KEY_FIELDS
    )


def env_bfs_optimal_steps(env, state, actions=BFS_ACTIONS, max_depth=80):
    """Min steps to a reward > 0 termination through this package's own
    ``env.step`` from one (unbatched) ``state``, on the default device.
    Each depth steps the whole frontier times ``actions`` in one call,
    padded to a power of two (at least 1024) so the step compiles a few
    times only."""
    step = jax.jit(jax.vmap(env.step))
    acts = np.asarray(actions, np.int32)

    def expand(frontier):
        n = len(frontier) * len(acts)
        size = max(1024, 1 << (n - 1).bit_length())
        batch = jax.tree_util.tree_map(
            lambda *xs: np.resize(np.repeat(np.stack(xs), len(acts), 0),
                                  (size,) + xs[0].shape),
            *frontier,
        )
        a = np.resize(np.tile(acts, len(frontier)), size)
        keys = jax.random.split(jax.random.PRNGKey(0), size)
        _, nxt, r, term, trunc, _ = jax.device_get(step(keys, batch, a))
        for i in range(n):
            child = jax.tree_util.tree_map(lambda x: x[i], nxt)
            yield child, _state_key(child), r[i], term[i], trunc[i]

    root = jax.device_get(state)
    return _bfs(root, _state_key(root), expand, max_depth)


@pytest.mark.parametrize(
    "env_id,seed",
    [
        ("MiniGrid-Empty-5x5-v0", 0),
        ("MiniGrid-Empty-Random-5x5-v0", 3),
        ("MiniGrid-DoorKey-5x5-v0", 0),
        ("MiniGrid-DoorKey-5x5-v0", 7),
        ("MiniGrid-LavaGapS5-v0", 1),
        ("MiniGrid-SimpleCrossingS9N1-v0", 2),
    ],
)
def test_vi_matches_bfs(env_id, seed):
    ref_env, _ = make_reference_env(env_id, seed)
    want = bfs_optimal_steps(ref_env)

    state = state_from_reference(ref_env)
    layout = extract_layout(state, max_doors=1)
    v, _ = value_iteration(layout, gamma=GAMMA, n_sweeps=128)
    got = float(steps_to_go(state_value(v, layout, state), GAMMA))
    assert got == want, f"{env_id} seed={seed}: VI={got} BFS={want}"
    ref_env.close()


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-6x6-v0", "MiniGrid-Empty-8x8-v0"])
def test_greedy_rollout_is_optimal(env_id):
    """Greedy policy reaches the goal in exactly steps_to_go steps with the
    closed-form env return."""
    env = mgtpu.make(env_id)
    B = 8
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    _, states = jax.jit(jax.vmap(env.reset))(keys)
    layouts = jax.jit(jax.vmap(partial(extract_layout, max_doors=1)))(states)
    vi = jax.jit(jax.vmap(partial(value_iteration, gamma=GAMMA, n_sweeps=128)))
    v, pol = vi(layouts)

    vals = jax.vmap(state_value)(v, layouts, states)
    dists = np.asarray(steps_to_go(vals, GAMMA))
    assert np.isfinite(dists).all()

    step = jax.jit(jax.vmap(env.step))
    ga = jax.jit(jax.vmap(greedy_action))
    st = states
    done = np.zeros(B, bool)
    steps = np.zeros(B, int)
    rew = np.zeros(B)
    k = jax.random.PRNGKey(1)
    for t in range(int(dists.max()) + 1):
        acts = ga(pol, layouts, st)
        k, k2 = jax.random.split(k)
        _, st, r, term, _, _ = step(jax.random.split(k2, B), st, acts)
        newly = np.asarray(term) & ~done
        rew[newly] = np.asarray(r)[newly]
        steps[newly] = t + 1
        done |= np.asarray(term)
    assert done.all()
    np.testing.assert_array_equal(steps, dists)
    want_r = np.asarray(env_return(vals, GAMMA, 0, env.params.max_steps))
    np.testing.assert_allclose(rew, want_r, atol=1e-5)


def test_unreachable_goal_has_zero_value():
    """Wall off the goal: every state's value drops to exactly 0."""
    from minigrid_dynamicprogramming_tpu.core.constants import OBJ_WALL

    env = mgtpu.make("MiniGrid-Empty-5x5-v0")
    _, state = env.reset(jax.random.PRNGKey(0))
    layout = extract_layout(state, max_doors=1)
    v, _ = value_iteration(layout, gamma=GAMMA, n_sweeps=128)
    assert float(state_value(v, layout, state)) > 0

    # Goal sits at (3, 3); walls at (2, 3) and (3, 2) seal its corner.
    sealed = state.replace(
        grid_obj=state.grid_obj.at[3, 2].set(OBJ_WALL).at[2, 3].set(OBJ_WALL)
    )
    layout2 = extract_layout(sealed, max_doors=1)
    v2, _ = value_iteration(layout2, gamma=GAMMA, n_sweeps=128)
    walk = np.asarray(layout2.base_walk)
    v2_np = np.asarray(v2)
    # No walkable non-goal cell can reach the goal any more.
    goal = np.asarray(layout2.goal)
    reachable_cells = walk & ~goal
    assert (v2_np[..., reachable_cells] == 0).all()


@pytest.mark.parametrize(
    "env_id,batch,n_sweeps",
    [("MiniGrid-DoorKey-8x8-v0", 3, 48), ("MiniGrid-DoorKey-5x5-v0", 2, 25)],
)
def test_pallas_key_vi_matches_xla(env_id, batch, n_sweeps):
    """The fused key-domain kernel, run in the Pallas interpreter, equals
    key_value_iteration.  DoorKey-5x5's 25-cell raster is padded to 32
    cells inside the kernel, and an odd sweep count ends in the second
    ping-pong buffer."""
    from minigrid_dynamicprogramming_tpu.dp.pallas_vi import (
        pallas_key_value_iteration,
    )
    from minigrid_dynamicprogramming_tpu.dp.tabular_key import (
        extract_key_layout,
        key_value_iteration,
    )

    env = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(2), batch)
    _, states = jax.jit(jax.vmap(env.reset))(keys)
    layouts = jax.jit(jax.vmap(partial(extract_key_layout, max_doors=1)))(
        states
    )
    v_ref, _ = jax.jit(
        jax.vmap(partial(key_value_iteration, gamma=GAMMA, n_sweeps=n_sweeps))
    )(layouts)
    v_pl = pallas_key_value_iteration(
        layouts, gamma=GAMMA, n_sweeps=n_sweeps, interpret=True
    )
    np.testing.assert_allclose(
        np.asarray(v_pl), np.asarray(v_ref), atol=1e-6
    )


def test_pallas_key_vi_target_and_two_doors():
    """Pickup-target objective with two door slots (four configs) on a
    35-cell raster, through the interpreter."""
    from minigrid_dynamicprogramming_tpu.dp.pallas_vi import (
        pallas_key_value_iteration,
    )
    from minigrid_dynamicprogramming_tpu.dp.tabular_key import (
        extract_key_layout,
        key_value_iteration,
    )

    def extract(state):
        ball = jnp.argmax((state.grid_obj == 6).ravel())  # OBJ_BALL
        color = state.grid_color.ravel()[ball].astype(jnp.int32)
        return extract_key_layout(
            state, max_doors=2, target_type=6, target_color=color
        )

    env = mgtpu.make("MiniGrid-KeyCorridorS3R2-v0")
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    _, states = jax.jit(jax.vmap(env.reset))(keys)
    layouts = jax.jit(jax.vmap(extract))(states)
    v_ref, _ = jax.jit(
        jax.vmap(partial(key_value_iteration, gamma=GAMMA, n_sweeps=30))
    )(layouts)
    assert (np.asarray(v_ref) > 0).any()
    v_pl = pallas_key_value_iteration(
        layouts, gamma=GAMMA, n_sweeps=30, interpret=True
    )
    np.testing.assert_allclose(
        np.asarray(v_pl), np.asarray(v_ref), atol=1e-6
    )


@pytest.mark.parametrize(
    "env_id,seed",
    [
        ("MiniGrid-DoorKey-5x5-v0", 0),
        ("MiniGrid-DoorKey-5x5-v0", 7),
        ("MiniGrid-DoorKey-6x6-v0", 3),
        ("MiniGrid-Empty-Random-5x5-v0", 3),
        ("MiniGrid-LavaGapS5-v0", 1),
    ],
)
def test_vi_matches_env_bfs(env_id, seed):
    """VI steps-to-go equals a breadth-first search through our own env
    step (no reference needed)."""
    env = mgtpu.make(env_id)
    _, state = jax.jit(env.reset)(jax.random.PRNGKey(seed))
    layout = extract_layout(state, max_doors=1)
    v, _ = value_iteration(layout, gamma=GAMMA, n_sweeps=128)
    got = float(steps_to_go(state_value(v, layout, state), GAMMA))
    want = env_bfs_optimal_steps(env, state)
    assert np.isfinite(want)
    assert got == want, f"{env_id} seed={seed}: VI={got} BFS={want}"
