"""Batched exact dynamic programming over Minigrid layouts.

The reference repo is named *Minigrid_DynamicProgramming* but contains no DP
code (see SURVEY.md §0); this module realizes the namesake capability as a
first-class batched component: exact value iteration over the tabular state
space

    (door-config, carrying, dir, y, x)

of one layout, vmapped over thousands of layouts.

Design: instead of a flat ``V[T[a, s]]`` gather (irregular memory
access), the value tensor keeps its factored shape ``(C, 4, H, W)`` and every
action's backup is a *structured* operation —

* left/right   -> roll along the dir axis,
* forward      -> spatial shift per dir + walkability select,
* pickup       -> index flip along the carry bit of the config axis,
* toggle       -> small config-axis gather driven by a (C, D+1) table,

so one sweep is ~20 shifted selects + a max — elementwise work with
perfectly regular memory access, which XLA vectorizes across the layout
batch.

Model (exact for the reference MDP restricted to non-drop actions; dropping
the key is never optimal because reward decays with step count,
minigrid_env.py:235-240):

* actions: left/right (minigrid_env.py:536-543), forward (:546-553), pickup
  of the single key (:556-561), toggle of doors incl. unlock-with-key
  (world_object.py:185-195), drop/done as no-ops;
* every action costs one step (discount gamma); reaching the goal pays 1 and
  terminates; stepping into lava terminates with 0 (:548-553);
* V*[s] = gamma^(d(s) - 1) where d is the optimal step count, so optimal
  distances and the reference's ``1 - 0.9 * t / max_steps`` return fall out
  of V in closed form (:func:`steps_to_go`, :func:`env_return`).

Scope: layouts whose interactive objects are doors (any number up to
``max_doors``, 3-state) plus at most one key; balls/boxes are treated as
static blockers.  This covers Empty/FourRooms/Crossing/DistShift/LavaGap/
DoorKey/Unlock/LockedRoom-style worlds exactly.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.constants import (
    DIR_TO_VEC_ARR,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_FLOOR,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    OBJ_WALL,
    STATE_LOCKED,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu.core.state import EnvState

__all__ = [
    "TabularLayout",
    "extract_layout",
    "assert_dp_scope",
    "value_iteration",
    "greedy_action",
    "steps_to_go",
    "env_return",
    "solve",
]


def assert_dp_scope(state: EnvState, max_doors: int) -> None:
    """Host-side scope check for this module.

    Raises if the layout violates the solver's domain assumptions (doors
    beyond the slot budget that are not already open, or more than one
    key).  ``extract_layout`` silently freezes overflow doors as walls —
    sound for open doors only — so an un-slotted closed door would make
    the solver quietly wrong.  Call this (eagerly, on
    concrete states) before trusting values on a new env family; the
    key-position domain lives in dp/tabular_key.py.
    """
    import numpy as np

    obj = np.asarray(state.grid_obj)
    st = np.asarray(state.grid_state)
    # Slots go to doors in raster order; any NON-OPEN door past the budget
    # is frozen as a wall by extract_layout — unsound.
    door_states = st.ravel()[(obj == OBJ_DOOR).ravel()]  # raster order
    overflow = door_states[max_doors:]
    if (overflow != STATE_OPEN).any():
        raise ValueError(
            f"layout has {door_states.size} doors but the DP budget is "
            f"max_doors={max_doors}, and {(overflow != STATE_OPEN).sum()} "
            "overflow door(s) are not open; they would be frozen as walls "
            "and values would be wrong"
        )
    n_keys = int((obj == OBJ_KEY).sum()) + int(
        np.asarray(state.carrying_obj) == OBJ_KEY
    )
    if n_keys > 1:
        raise ValueError(
            f"layout has {n_keys} keys; the tabular domain models one"
        )


class TabularLayout(NamedTuple):
    """Static per-layout data for DP (all fixed-shape; vmap over layouts).

    The config axis enumerates ``carry in {0, 1}`` (fast bit) x the door
    states ``sigma_k in {open, closed, locked}`` (mixed radix 3^k).
    """

    base_walk: jnp.ndarray  # (H, W) bool — walkable ignoring doors/key
    goal: jnp.ndarray  # (H, W) bool
    lava: jnp.ndarray  # (H, W) bool
    door_pos: jnp.ndarray  # (D, 2) int32 (x, y); (-1, -1) = unused slot
    door_id: jnp.ndarray  # (H, W) int32 — door slot at cell, -1 if none
    door_unlockable: jnp.ndarray  # (D,) bool — key color matches door color
    key_pos: jnp.ndarray  # (2,) int32 (x, y); (-1, -1) = no key on grid
    init_cfg: jnp.ndarray  # () int32 — config encoding the layout's t=0 doors/carry

    @property
    def n_doors(self) -> int:
        # Static door-slot count, derived from shape so the pytree stays
        # vmap-safe (no non-array leaves).
        return self.door_pos.shape[-2]


def _num_cfg(n_doors: int) -> int:
    return 2 * (3**n_doors)


def extract_layout(state: EnvState, max_doors: int = 2) -> TabularLayout:
    """Derive the DP layout from an :class:`EnvState` on device.

    Doors are assigned slots in raster order; layouts with more than
    ``max_doors`` doors get the excess treated as walls (sound for
    reachability only if the excess doors are open — callers pick
    ``max_doors`` to cover their env family).
    """
    obj = state.grid_obj
    h, w = obj.shape

    is_door = obj == OBJ_DOOR
    # The key cell is walkable once the key is picked up; the carry == 0
    # block is applied per-config in _cfg_tables.
    base_walk = (
        (obj == OBJ_EMPTY)
        | (obj == OBJ_FLOOR)
        | (obj == OBJ_GOAL)
        | (obj == OBJ_LAVA)
        | (obj == OBJ_KEY)
        | is_door
    )

    # Door slots in raster order: rank cells by (not-door, raster index).
    flat = jnp.arange(h * w, dtype=jnp.int32)
    door_rank = jnp.where(is_door.ravel(), flat, h * w)
    order = jnp.argsort(door_rank)  # first D entries are the doors
    slots = order[:max_doors]
    slot_valid = is_door.ravel()[slots]
    dx = (slots % w).astype(jnp.int32)
    dy = (slots // w).astype(jnp.int32)
    door_pos = jnp.stack(
        [jnp.where(slot_valid, dx, -1), jnp.where(slot_valid, dy, -1)], axis=-1
    )
    # One-hot writes, not a dynamic scatter: batched scatters miscompiled
    # on an earlier accelerator backend; ``audit_device`` checks the live
    # one (ops/grid.py:cell_set).
    door_id = jnp.full((h * w,), -1, dtype=jnp.int32)
    for i in range(max_doors):
        door_id = jnp.where(
            (flat == slots[i]) & slot_valid[i], jnp.int32(i), door_id
        )
    door_id = door_id.reshape(h, w)
    # Doors beyond the slot budget: walkable only if open at t=0, frozen.
    overflow = is_door & (door_id < 0)
    base_walk = base_walk & ~(overflow & (state.grid_state != STATE_OPEN))

    # The single key: first key cell in raster order (or carried).
    is_key = obj == OBJ_KEY
    key_rank = jnp.where(is_key.ravel(), flat, h * w)
    kidx = jnp.argmin(key_rank)
    has_key_cell = is_key.ravel()[kidx]
    key_pos = jnp.where(
        has_key_cell,
        jnp.stack([kidx % w, kidx // w]).astype(jnp.int32),
        jnp.array([-1, -1], dtype=jnp.int32),
    )
    key_color = jnp.where(
        has_key_cell,
        state.grid_color.ravel()[kidx],
        state.carrying_color.astype(jnp.int32),
    )
    door_color = state.grid_color[
        jnp.clip(door_pos[:, 1], 0, h - 1), jnp.clip(door_pos[:, 0], 0, w - 1)
    ]
    door_unlockable = slot_valid & (door_color == key_color)

    # t=0 config: door states from the grid + current carry bit.
    sigma = state.grid_state[
        jnp.clip(door_pos[:, 1], 0, h - 1), jnp.clip(door_pos[:, 0], 0, w - 1)
    ].astype(jnp.int32)
    sigma = jnp.where(slot_valid, sigma, 0)
    pow3 = 3 ** jnp.arange(max_doors, dtype=jnp.int32)
    carry0 = (state.carrying_obj == OBJ_KEY).astype(jnp.int32)
    init_cfg = carry0 + 2 * jnp.sum(sigma * pow3)

    return TabularLayout(
        base_walk=base_walk,
        goal=obj == OBJ_GOAL,
        lava=obj == OBJ_LAVA,
        door_pos=door_pos,
        door_id=door_id,
        door_unlockable=door_unlockable,
        key_pos=key_pos,
        init_cfg=init_cfg.astype(jnp.int32),
    )


def _cfg_tables(layout: TabularLayout):
    """Per-config decodes and the toggle-transition table.

    Returns (walk: (C, H, W) bool, toggle_cfg: (C, D) int32, carry: (C,)).
    """
    D = layout.n_doors
    C = _num_cfg(D)
    cfg = jnp.arange(C, dtype=jnp.int32)
    carry = cfg % 2
    code = cfg // 2
    pow3 = 3 ** jnp.arange(D, dtype=jnp.int32)
    sigma = (code[:, None] // pow3[None, :]) % 3  # (C, D)

    # Walkability per config: base minus closed/locked doors minus the key
    # cell while the key is still on the grid (carry == 0).
    h, w = layout.base_walk.shape
    door_sigma_map = jnp.zeros((C, h, w), dtype=jnp.int32)
    did = layout.door_id  # (H, W)
    safe = jnp.clip(did, 0, D - 1)
    cell_sigma = jnp.where(did >= 0, sigma[:, safe.ravel()].reshape(C, h, w), 0)
    door_block = (did >= 0)[None] & (cell_sigma != STATE_OPEN)

    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    key_cell = (xs == layout.key_pos[0]) & (ys == layout.key_pos[1])
    key_block = key_cell[None] & (carry[:, None, None] == 0)

    walk = layout.base_walk[None] & ~door_block & ~key_block

    # Toggle table: new config when toggling door k from config c
    # (Door.toggle, world_object.py:185-195): open->closed, closed->open,
    # locked->open iff carrying a matching key.
    unlockable = layout.door_unlockable[None, :] & (carry[:, None] == 1)
    new_sigma = jnp.where(
        sigma == STATE_OPEN,
        1,  # open -> closed
        jnp.where(
            sigma == STATE_LOCKED,
            jnp.where(unlockable, STATE_OPEN, STATE_LOCKED),
            STATE_OPEN,  # closed -> open
        ),
    )
    delta = (new_sigma - sigma) * pow3[None, :]  # (C, D)
    toggle_cfg = cfg[:, None] + 2 * delta
    return walk, toggle_cfg, carry


def _shift_from(v: jnp.ndarray, dxy) -> jnp.ndarray:
    """out(y, x) = v(y + dy, x + dx), zero beyond the border.

    v has shape (..., H, W); dxy is a static (dx, dy) pair.
    """
    dx, dy = dxy
    zero = jnp.zeros((), dtype=v.dtype)
    if dy:
        v = jnp.roll(v, -dy, axis=-2)
        if dy > 0:
            v = v.at[..., -dy:, :].set(zero)
        else:
            v = v.at[..., :-dy, :].set(zero)
    if dx:
        v = jnp.roll(v, -dx, axis=-1)
        if dx > 0:
            v = v.at[..., :, -dx:].set(zero)
        else:
            v = v.at[..., :, :-dx].set(zero)
    return v


_DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))  # DIR_TO_VEC (constants.py:49-58)


def _backup(v: jnp.ndarray, layout: TabularLayout, gamma: float):
    """One Bellman backup.  v: (C, 4, H, W) -> (q: (A, C, 4, H, W))."""
    walk, toggle_cfg, carry = _cfg_tables(layout)
    C = v.shape[0]
    h, w = layout.base_walk.shape

    # left / right: dir rolls (minigrid_env.py:536-543).
    q_left = gamma * jnp.roll(v, 1, axis=1)  # dir' = dir - 1
    q_right = gamma * jnp.roll(v, -1, axis=1)

    # forward per dir: value at the front cell, gated by walkability and
    # the goal/lava terminals (minigrid_env.py:546-553).
    q_fwd = []
    for d, dxy in enumerate(_DIRS):
        vn = _shift_from(v[:, d], dxy)  # (C, H, W) value at front cell
        walk_n = _shift_from(walk, dxy)  # front walkable per config
        goal_n = _shift_from(layout.goal.astype(v.dtype), dxy)
        lava_n = _shift_from(layout.lava.astype(v.dtype), dxy)
        moved = jnp.where(walk_n, vn, v[:, d])
        qd = gamma * moved
        qd = jnp.where(lava_n > 0, 0.0, qd)  # lava: terminal, no reward
        qd = jnp.where(goal_n > 0, 1.0, qd)  # goal: terminal, reward 1
        q_fwd.append(qd)
    q_fwd = jnp.stack(q_fwd, axis=1)  # (C, 4, H, W)

    # pickup: carry bit 0 -> 1 when facing the key (minigrid_env.py:556-561).
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    v_flip = v.reshape(C // 2, 2, 4, h, w)[:, ::-1].reshape(C, 4, h, w)
    q_pick = []
    for d, dxy in enumerate(_DIRS):
        dx, dy = dxy
        key_front = (xs + dx == layout.key_pos[0]) & (ys + dy == layout.key_pos[1])
        can = key_front[None] & (carry[:, None, None] == 0)
        q_pick.append(gamma * jnp.where(can, v_flip[:, d], v[:, d]))
    q_pick = jnp.stack(q_pick, axis=1)

    # toggle: config jump when facing a door (world_object.py:185-195).
    did = layout.door_id
    safe_did = jnp.clip(did, 0, layout.n_doors - 1)
    q_tog = []
    for d, dxy in enumerate(_DIRS):
        front_did = _shift_from(did + 1, dxy) - 1  # -1 where no door / OOB
        safe_front = jnp.clip(front_did, 0, layout.n_doors - 1)
        # new config per (c, cell): toggle_cfg[c, door_at_front(cell)]
        new_cfg = toggle_cfg[:, safe_front.ravel()].reshape(C, h, w)
        new_cfg = jnp.where((front_did >= 0)[None], new_cfg, jnp.arange(C)[:, None, None])
        # gather along the (small) config axis via one-hot contraction —
        # regular compute instead of irregular memory access.
        onehot = jax.nn.one_hot(new_cfg, C, dtype=v.dtype, axis=0)  # (C', C, H, W)
        q_tog.append(gamma * jnp.einsum("kchw,khw->chw", onehot, v[:, d]))
    q_tog = jnp.stack(q_tog, axis=1)

    q_stay = gamma * v  # drop (no-op here) / done

    # Action order matches Actions: left, right, forward, pickup, drop,
    # toggle, done (core/actions.py analog).
    return jnp.stack([q_left, q_right, q_fwd, q_pick, q_stay, q_tog, q_stay])


@partial(jax.jit, static_argnames=("gamma", "n_sweeps"))
def value_iteration(
    layout: TabularLayout,
    gamma: float = 0.995,
    n_sweeps: int = 256,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact VI: returns (V: (C, 4, H, W) f32, policy: (C, 4, H, W) int8).

    ``n_sweeps`` bounds the solvable distance: states further than n_sweeps
    steps from the goal keep V = 0.  vmap over a batch of layouts.
    """
    h, w = layout.base_walk.shape
    C = _num_cfg(layout.n_doors)
    v0 = jnp.zeros((C, 4, h, w), dtype=jnp.float32)

    def sweep(v, _):
        q = _backup(v, layout, gamma)
        return jnp.max(q, axis=0), None

    v, _ = jax.lax.scan(sweep, v0, None, length=n_sweeps)
    policy = jnp.argmax(_backup(v, layout, gamma), axis=0).astype(jnp.int8)
    return v, policy


def steps_to_go(v: jnp.ndarray, gamma: float) -> jnp.ndarray:
    """d(s) = 1 + log_gamma V(s); inf where unreachable (V = 0)."""
    d = 1.0 + jnp.log(jnp.maximum(v, 1e-30)) / math.log(gamma)
    return jnp.where(v > 0, jnp.round(d), jnp.inf)


def env_return(
    v: jnp.ndarray, gamma: float, step_count, max_steps: int
) -> jnp.ndarray:
    """The reference's success reward 1 - 0.9 * t_goal / max_steps
    (minigrid_env.py:235-240) reached by following the optimal policy from a
    state with ``step_count`` steps already taken; 0 if out of budget."""
    d = steps_to_go(v, gamma)
    t_goal = step_count + d
    r = 1.0 - 0.9 * (t_goal / max_steps)
    return jnp.where(t_goal <= max_steps, r, 0.0)


def _state_index(layout: TabularLayout, state: EnvState):
    """Current (cfg, dir, y, x) of an env state under this layout."""
    D = layout.n_doors
    h, w = layout.base_walk.shape  # noqa: shapes are static under jit
    sigma = state.grid_state[
        jnp.clip(layout.door_pos[:, 1], 0, h - 1),
        jnp.clip(layout.door_pos[:, 0], 0, w - 1),
    ].astype(jnp.int32)
    sigma = jnp.where(layout.door_pos[:, 0] >= 0, sigma, 0)
    pow3 = 3 ** jnp.arange(D, dtype=jnp.int32)
    carry = (state.carrying_obj == OBJ_KEY).astype(jnp.int32)
    cfg = carry + 2 * jnp.sum(sigma * pow3)
    return cfg, state.agent_dir, state.agent_pos[1], state.agent_pos[0]


def greedy_action(
    policy: jnp.ndarray, layout: TabularLayout, state: EnvState
) -> jnp.ndarray:
    """Optimal action for the env's current state (for policy rollouts)."""
    c, d, y, x = _state_index(layout, state)
    return policy[c, d, y, x].astype(jnp.int32)


def state_value(v: jnp.ndarray, layout: TabularLayout, state: EnvState):
    c, d, y, x = _state_index(layout, state)
    return v[c, d, y, x]


def solve(
    env,
    keys: jnp.ndarray,
    gamma: float = 0.995,
    n_sweeps: int = 256,
    max_doors: int = 2,
):
    """Generate a batch of layouts from PRNG keys and solve them exactly.

    Returns (states, layouts, V, policy), each with a leading batch axis.
    """
    reset = jax.vmap(env.reset)
    _, states = reset(keys)
    layouts = jax.vmap(partial(extract_layout, max_doors=max_doors))(states)
    vi = jax.vmap(partial(value_iteration, gamma=gamma, n_sweeps=n_sweeps))
    v, policy = vi(layouts)
    return states, layouts, v, policy
