"""Exact DP over the key-tracking tabular domain.

``dp/tabular.py`` solves the goal-reaching family (DoorKey/Crossing/...)
over ``(door-config, carry-bit, dir, y, x)``; that domain cannot express
tasks where the agent must *drop* the key to free its hands — KeyCorridor
(/root/reference/minigrid/envs/keycorridor.py:129-137) and the
ObstructedMaze family (obstructedmaze.py:95-106) terminate on picking up a
target object, and pickup requires empty hands (minigrid_env.py:556-561),
so optimal play is: pick key -> unlock -> drop key -> pick target.  The
dropped key lands on a real cell and blocks it, so exactness requires the
key's *position* in the state.

This module widens the state space to

    (key-loc, door-config, dir, y, x),   key-loc in {cell 0..H*W-1, CARRIED}

with doors as a binary config axis (bit = "opened"): toggling a door open
strictly dominates closing it (an extra open door only adds walkable
cells), so open->closed transitions are modeled as value-neutral self-loops
and each door needs one bit over its initial state instead of a 3-state
digit.  V keeps the factored shape ``(K, Cd, 4, H, W)`` and every backup is
a structured shift/select/take_along_axis — no irregular scatter — so XLA
vectorizes it across a layout batch, same design as dp/tabular.py.

Objectives: reach a goal cell (``target_pos = (-1, -1)``) or pick up a
target object (terminal reward 1 on the pickup action facing it with empty
hands).  Scope: any number of doors up to ``max_doors``, one key, one
target; other balls/boxes are static blockers.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.constants import (
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_FLOOR,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    STATE_LOCKED,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu.core.state import EnvState

__all__ = [
    "KeyTabularLayout",
    "extract_key_layout",
    "key_value_iteration",
    "key_state_index",
    "key_greedy_action",
    "key_steps_to_go",
]

_DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))  # DIR_TO_VEC (constants.py:49-58)


class KeyTabularLayout(NamedTuple):
    """Static per-layout data; vmap over layouts.

    ``K = H*W + 1`` key locations (raster cell index, or ``H*W`` = carried);
    ``Cd = 2^D`` door configs (bit k = door k has been opened)."""

    base_walk: jnp.ndarray  # (H, W) bool — walkable ignoring doors/key
    base_empty: jnp.ndarray  # (H, W) bool — cells the key may be dropped on
    goal: jnp.ndarray  # (H, W) bool
    lava: jnp.ndarray  # (H, W) bool
    target_pos: jnp.ndarray  # (2,) int32 (x, y); (-1,-1) = goal objective
    door_pos: jnp.ndarray  # (D, 2) int32; (-1,-1) = unused slot
    door_id: jnp.ndarray  # (H, W) int32; -1 where no door
    door_init: jnp.ndarray  # (D,) int32 — grid door state at t=0
    door_unlockable: jnp.ndarray  # (D,) bool
    key0: jnp.ndarray  # () int32 — initial key loc (H*W if carried, -1 none)

    @property
    def n_doors(self) -> int:
        return self.door_pos.shape[-2]


def extract_key_layout(
    state: EnvState,
    max_doors: int = 7,
    target_type: jnp.ndarray | int = -1,
    target_color: jnp.ndarray | int = -1,
) -> KeyTabularLayout:
    """Derive the key-tracking DP layout from an :class:`EnvState`.

    ``target_type``/``target_color`` select the pickup-terminal object
    (e.g. from ``state.aux`` for KeyCorridor); pass -1/-1 for goal-reaching
    tasks.  The target's own cell is excluded from walkability (balls/boxes
    block movement) and the key's cell is handled per key-loc config.
    """
    obj = state.grid_obj
    h, w = obj.shape
    flat = jnp.arange(h * w, dtype=jnp.int32)

    is_door = obj == OBJ_DOOR
    is_key = obj == OBJ_KEY
    base_walk = (
        (obj == OBJ_EMPTY)
        | (obj == OBJ_FLOOR)
        | (obj == OBJ_GOAL)
        | (obj == OBJ_LAVA)
        | is_key  # key blocking is per-config (key-loc axis)
        | is_door
    )
    # Cells where a carried key may be dropped: reference drop requires a
    # literally empty front cell (minigrid_env.py:564-568).
    base_empty = (obj == OBJ_EMPTY) | is_key

    # Door slots in raster order (same scheme as tabular.extract_layout).
    door_rank = jnp.where(is_door.ravel(), flat, h * w)
    order = jnp.argsort(door_rank)
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
    overflow = is_door & (door_id < 0)
    base_walk = base_walk & ~(overflow & (state.grid_state != STATE_OPEN))

    door_init = state.grid_state[
        jnp.clip(door_pos[:, 1], 0, h - 1), jnp.clip(door_pos[:, 0], 0, w - 1)
    ].astype(jnp.int32)
    door_init = jnp.where(slot_valid, door_init, STATE_OPEN)

    # The single key: first key cell in raster order, or carried.
    key_rank = jnp.where(is_key.ravel(), flat, h * w)
    kidx = jnp.argmin(key_rank).astype(jnp.int32)
    has_key_cell = is_key.ravel()[kidx]
    carrying_key = state.carrying_obj == OBJ_KEY
    key0 = jnp.where(
        has_key_cell, kidx, jnp.where(carrying_key, h * w, -1)
    ).astype(jnp.int32)
    key_color = jnp.where(
        has_key_cell,
        state.grid_color.ravel()[kidx].astype(jnp.int32),
        state.carrying_color.astype(jnp.int32),
    )
    door_color = state.grid_color[
        jnp.clip(door_pos[:, 1], 0, h - 1), jnp.clip(door_pos[:, 0], 0, w - 1)
    ].astype(jnp.int32)
    door_unlockable = slot_valid & (door_color == key_color)

    # Target object: first cell matching (type, color); its cell blocks.
    t_type = jnp.asarray(target_type, jnp.int32)
    t_color = jnp.asarray(target_color, jnp.int32)
    is_target = (
        (obj.astype(jnp.int32) == t_type)
        & (state.grid_color.astype(jnp.int32) == t_color)
        & (t_type >= 0)
    )
    t_rank = jnp.where(is_target.ravel(), flat, h * w)
    tidx = jnp.argmin(t_rank)
    has_target = is_target.ravel()[tidx]
    target_pos = jnp.where(
        has_target,
        jnp.stack([tidx % w, tidx // w]).astype(jnp.int32),
        jnp.array([-1, -1], dtype=jnp.int32),
    )
    ys = jnp.arange(h, dtype=jnp.int32)[:, None]
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    target_cell = (xs == target_pos[0]) & (ys == target_pos[1])
    base_walk = base_walk & ~target_cell

    return KeyTabularLayout(
        base_walk=base_walk,
        base_empty=base_empty,
        goal=obj == OBJ_GOAL,
        lava=obj == OBJ_LAVA,
        target_pos=target_pos,
        door_pos=door_pos,
        door_id=door_id,
        door_init=door_init,
        door_unlockable=door_unlockable,
        key0=key0,
    )


def _shift_from(v: jnp.ndarray, dxy) -> jnp.ndarray:
    """out(.., y, x) = v(.., y+dy, x+dx), zero-padded (same as tabular.py)."""
    dx, dy = dxy
    zero = jnp.zeros((), dtype=v.dtype)
    if dy:
        v = jnp.roll(v, -dy, axis=-2)
        v = v.at[..., -dy:, :].set(zero) if dy > 0 else v.at[..., :-dy, :].set(zero)
    if dx:
        v = jnp.roll(v, -dx, axis=-1)
        v = v.at[..., :, -dx:].set(zero) if dx > 0 else v.at[..., :, :-dx].set(zero)
    return v


def _front_index(h: int, w: int, dxy) -> jnp.ndarray:
    """(H, W) raster index of the front cell per agent cell; -1 if OOB."""
    dx, dy = dxy
    ys = jnp.arange(h)[:, None] + dy
    xs = jnp.arange(w)[None, :] + dx
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    return jnp.where(ok, ys * w + xs, -1).astype(jnp.int32)


def _door_tables(layout: KeyTabularLayout):
    """Per-(config, cell) door openness and toggle data.

    Returns (open_cell: (Cd, H, W) bool — door cell currently open,
    door_block: (Cd, H, W) bool, bitmask: (H, W) int32,
    locked_cell: (Cd, H, W) bool, closed_cell: (Cd, H, W) bool)."""
    D = layout.n_doors
    Cd = 1 << D
    cfg = jnp.arange(Cd, dtype=jnp.int32)
    h, w = layout.base_walk.shape

    did = layout.door_id
    safe = jnp.clip(did, 0, D - 1)
    opened_bit = (cfg[:, None] >> safe.ravel()[None, :]) & 1  # (Cd, HW)
    opened_bit = opened_bit.reshape(Cd, h, w)
    init_cell = layout.door_init[safe]  # (H, W)
    is_door_cell = did >= 0

    open_cell = is_door_cell[None] & (
        (opened_bit == 1) | (init_cell == STATE_OPEN)[None]
    )
    locked_cell = (
        is_door_cell[None]
        & (opened_bit == 0)
        & (init_cell == STATE_LOCKED)[None]
    )
    closed_cell = is_door_cell[None] & ~open_cell & ~locked_cell
    door_block = is_door_cell[None] & ~open_cell
    bitmask = jnp.where(is_door_cell, 1 << safe, 0)
    return open_cell, door_block, bitmask, locked_cell, closed_cell


def _backup(v: jnp.ndarray, layout: KeyTabularLayout, gamma: float):
    """One Bellman backup over V: (K, Cd, 4, H, W) -> q: (A, K, Cd, 4, H, W).

    Action order = the reference Actions enum (left, right, forward,
    pickup, drop, toggle, done)."""
    K, Cd, _, h, w = v.shape
    CARRIED = h * w
    kloc = jnp.arange(K, dtype=jnp.int32)  # key-loc axis labels

    _, door_block, bitmask, locked_cell, closed_cell = _door_tables(layout)

    ys = jnp.arange(h, dtype=jnp.int32)[:, None]
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    cell_idx = (ys * w + xs).astype(jnp.int32)

    # Walkability per (k, cfg): base minus closed/locked doors minus the
    # key's current cell.
    key_block = kloc[:, None, None] == cell_idx[None]  # (K, H, W)
    walk = (
        layout.base_walk[None, None]
        & ~door_block[None]
        & ~key_block[:, None]
    )  # (K, Cd, H, W)

    q_left = gamma * jnp.roll(v, 1, axis=2)
    q_right = gamma * jnp.roll(v, -1, axis=2)

    target_cell = (xs == layout.target_pos[0]) & (ys == layout.target_pos[1])

    q_fwd, q_pick, q_drop, q_tog = [], [], [], []
    for d, dxy in enumerate(_DIRS):
        vd = v[:, :, d]  # (K, Cd, H, W)
        fidx = _front_index(h, w, dxy)  # (H, W)

        # forward (minigrid_env.py:546-553)
        vn = _shift_from(vd, dxy)
        walk_n = _shift_from(walk, dxy)
        goal_n = _shift_from(layout.goal.astype(v.dtype), dxy)
        lava_n = _shift_from(layout.lava.astype(v.dtype), dxy)
        qd = gamma * jnp.where(walk_n, vn, vd)
        qd = jnp.where(lava_n > 0, 0.0, qd)
        qd = jnp.where(goal_n > 0, 1.0, qd)
        q_fwd.append(qd)

        # pickup (minigrid_env.py:556-561): key -> carried, or target ->
        # terminal reward 1; both need empty hands (k != CARRIED).
        key_front = (kloc[:, None, None] == fidx[None]) & (fidx >= 0)[None]
        v_carried = vd[CARRIED][None]  # (1, Cd, H, W)
        qp = jnp.where(key_front[:, None], gamma * v_carried, gamma * vd)
        target_front = _shift_from(
            target_cell.astype(jnp.int32), dxy
        ).astype(bool)
        can_target = target_front[None, None] & (
            kloc[:, None, None, None] != CARRIED
        )
        qp = jnp.where(can_target, 1.0, qp)
        q_pick.append(qp)

        # drop (minigrid_env.py:564-568): only the carried slice changes;
        # the key lands on the front cell (which must be empty and not a
        # door cell), i.e. key-loc jumps CARRIED -> front index.
        droppable = (
            _shift_from(layout.base_empty, dxy)
            & (fidx >= 0)
            & ~_shift_from(layout.door_id >= 0, dxy)
        )  # (H, W)
        idx = jnp.clip(fidx, 0, K - 1)[None, None]  # (1, 1, H, W)
        v_at_drop = jnp.take_along_axis(
            vd, jnp.broadcast_to(idx, (1, Cd, h, w)), axis=0
        )[0]  # (Cd, H, W)
        q_carried = gamma * jnp.where(droppable[None], v_at_drop, vd[CARRIED])
        qdrop = gamma * vd
        qdrop = qdrop.at[CARRIED].set(q_carried)
        q_drop.append(qdrop)

        # toggle (world_object.py:185-195): closed -> open always; locked ->
        # open iff carrying the matching key; open -> value-neutral
        # self-loop (closing never helps; see module docstring).
        unlock_cell = locked_cell & layout.door_unlockable[
            jnp.clip(layout.door_id, 0, layout.n_doors - 1)
        ][None]
        closed_n = _shift_from(closed_cell, dxy)  # (Cd, H, W)
        unlock_n = _shift_from(unlock_cell, dxy)
        bit_n = _shift_from(bitmask, dxy)  # (H, W)
        allowed = closed_n[None] | (
            unlock_n[None] & (kloc[:, None, None, None] == CARRIED)
        )  # (K, Cd, H, W)
        cfg = jnp.arange(Cd, dtype=jnp.int32)
        new_cfg = cfg[:, None, None] | bit_n[None]  # (Cd, H, W)
        v_open = jnp.take_along_axis(
            vd,
            jnp.broadcast_to(new_cfg[None], (K, Cd, h, w)),
            axis=1,
        )
        q_tog.append(gamma * jnp.where(allowed, v_open, vd))

    q_fwd = jnp.stack(q_fwd, axis=2)
    q_pick = jnp.stack(q_pick, axis=2)
    q_drop = jnp.stack(q_drop, axis=2)
    q_tog = jnp.stack(q_tog, axis=2)
    q_stay = gamma * v

    return jnp.stack([q_left, q_right, q_fwd, q_pick, q_drop, q_tog, q_stay])


@partial(jax.jit, static_argnames=("gamma", "n_sweeps"))
def key_value_iteration(
    layout: KeyTabularLayout,
    gamma: float = 0.995,
    n_sweeps: int = 256,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact VI over the key-tracking domain.

    Returns (V: (K, Cd, 4, H, W) f32, policy: same shape int8); vmap over a
    layout batch."""
    h, w = layout.base_walk.shape
    K = h * w + 1
    Cd = 1 << layout.n_doors
    v0 = jnp.zeros((K, Cd, 4, h, w), dtype=jnp.float32)

    def sweep(v, _):
        return jnp.max(_backup(v, layout, gamma), axis=0), None

    v, _ = jax.lax.scan(sweep, v0, None, length=n_sweeps)
    policy = jnp.argmax(_backup(v, layout, gamma), axis=0).astype(jnp.int8)
    return v, policy


def key_state_index(layout: KeyTabularLayout, state: EnvState):
    """(k, cfg, dir, y, x) of an env state under this layout."""
    h, w = layout.base_walk.shape
    D = layout.n_doors
    obj = state.grid_obj
    is_key = (obj == OBJ_KEY).ravel()
    flat = jnp.arange(h * w, dtype=jnp.int32)
    kidx = jnp.argmin(jnp.where(is_key, flat, h * w)).astype(jnp.int32)
    k = jnp.where(is_key[kidx], kidx, h * w)  # carried otherwise

    sigma = state.grid_state[
        jnp.clip(layout.door_pos[:, 1], 0, h - 1),
        jnp.clip(layout.door_pos[:, 0], 0, w - 1),
    ].astype(jnp.int32)
    opened = (sigma == STATE_OPEN) & (layout.door_init != STATE_OPEN)
    opened = opened & (layout.door_pos[:, 0] >= 0)
    cfg = jnp.sum(opened.astype(jnp.int32) << jnp.arange(D, dtype=jnp.int32))
    return k, cfg, state.agent_dir, state.agent_pos[1], state.agent_pos[0]


def key_greedy_action(
    policy: jnp.ndarray, layout: KeyTabularLayout, state: EnvState
) -> jnp.ndarray:
    k, c, d, y, x = key_state_index(layout, state)
    return policy[k, c, d, y, x].astype(jnp.int32)


def key_state_value(v: jnp.ndarray, layout: KeyTabularLayout, state: EnvState):
    k, c, d, y, x = key_state_index(layout, state)
    return v[k, c, d, y, x]


def key_steps_to_go(v: jnp.ndarray, gamma: float) -> jnp.ndarray:
    d = 1.0 + jnp.log(jnp.maximum(v, 1e-30)) / math.log(gamma)
    return jnp.where(v > 0, jnp.round(d), jnp.inf)
