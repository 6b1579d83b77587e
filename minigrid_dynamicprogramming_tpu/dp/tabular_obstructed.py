"""Exact DP over the obstructed domain: box-hidden keys + one movable ball.

``dp/tabular_key.py`` tracks the key's position, which covers
pick-unlock-drop-pick tasks (KeyCorridor, ObstructedMaze-1Dl).  Two
reference sub-families still fall outside that domain:

* **Keys hidden in boxes** — ObstructedMaze ``h`` variants put the key
  inside a grey box (`/root/reference/minigrid/envs/obstructedmaze.py:230-245`:
  ``box.contains = key``); toggling the box replaces it with the key
  (`/root/reference/minigrid/core/world_object.py:291-294`), so "in the
  box" is one more key location.
* **Movable blocking balls** — ObstructedMaze ``b`` variants and
  BlockedUnlockPickup place a ball directly in front of the locked door
  (`/root/reference/minigrid/envs/blockedunlockpickup.py:99-104`); the
  agent must pick it up and drop it elsewhere, so the ball's position is
  part of the state.

This module widens the state space to

    (ball-loc, key-loc, door-config, dir, y, x)

with ``ball-loc in {cell 0..HW-1, CARRIED, ABSENT}`` and
``key-loc in {cell 0..HW-1, CARRIED, IN_BOX}`` (the box never moves: its
cell is static; when the key leaves the box the cell becomes empty).  The
single carry slot is shared — pickup requires empty hands
(`/root/reference/minigrid/minigrid_env.py:556-561`), so states with both
objects carried are unreachable and no reachable state transitions into
them.  V keeps the factored shape ``(B, K, Cd, 4, H, W)`` and every backup
is a structured shift/select/take_along_axis, same design as
dp/tabular_key.py, so XLA vectorizes it across a layout batch.

Scope: one key (bare or box-hidden), one movable ball, any number of
doors up to ``max_doors``, one pickup-terminal target (or a goal cell);
other objects are static blockers.  Deliberately NOT modeled (each would
only ever cost the reference agent extra actions in this family, so the
restriction never changes the optimum — BFS-verified in
tests/test_dp_obstructed.py): picking up the key-box itself (carrying it
teleports the key but costs an extra pickup+drop over toggling in place),
and re-closing doors.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.constants import (
    OBJ_BALL,
    OBJ_BOX,
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
from minigrid_dynamicprogramming_tpu.dp.tabular_key import (
    _DIRS,
    _front_index,
    _shift_from,
)

__all__ = [
    "ObstructedLayout",
    "extract_obstructed_layout",
    "obstructed_value_iteration",
    "obstructed_state_index",
    "obstructed_greedy_action",
    "obstructed_steps_to_go",
]


class ObstructedLayout(NamedTuple):
    """Static per-layout data; vmap over layouts.

    ``K = H*W + 2`` key locations (cell, CARRIED=H*W, IN_BOX=H*W+1);
    ``B = H*W + 2`` ball locations (cell, CARRIED=H*W, ABSENT=H*W+1);
    ``Cd = 2^D`` door configs (bit k = door k has been opened)."""

    base_walk: jnp.ndarray  # (H, W) bool — walkable ignoring doors/key/ball
    base_empty: jnp.ndarray  # (H, W) bool — may become a drop target
    goal: jnp.ndarray  # (H, W) bool
    lava: jnp.ndarray  # (H, W) bool
    target_pos: jnp.ndarray  # (2,) int32 (x, y); (-1,-1) = goal objective
    door_pos: jnp.ndarray  # (D, 2) int32; (-1,-1) = unused slot
    door_id: jnp.ndarray  # (H, W) int32; -1 where no door
    door_init: jnp.ndarray  # (D,) int32 — grid door state at t=0
    door_unlockable: jnp.ndarray  # (D,) bool
    box_idx: jnp.ndarray  # () int32 — key-box raster cell, -1 if none
    key0: jnp.ndarray  # () int32 — initial key loc (incl. IN_BOX), -1 none
    ball0: jnp.ndarray  # () int32 — initial movable-ball loc (incl. ABSENT)

    @property
    def n_doors(self) -> int:
        return self.door_pos.shape[-2]


def extract_obstructed_layout(
    state: EnvState,
    max_doors: int = 7,
    target_type: jnp.ndarray | int = -1,
    target_color: jnp.ndarray | int = -1,
) -> ObstructedLayout:
    """Derive the obstructed-domain DP layout from an :class:`EnvState`.

    The key is found bare on the grid, carried, or inside the first box
    whose ``contains_obj`` is a key.  The movable ball is the first ball
    that is not the target object; any other balls are static blockers.
    """
    obj = state.grid_obj
    h, w = obj.shape
    hw = h * w
    flat = jnp.arange(hw, dtype=jnp.int32)
    t_type = jnp.asarray(target_type, jnp.int32)
    t_color = jnp.asarray(target_color, jnp.int32)

    is_target = (
        (obj.astype(jnp.int32) == t_type)
        & (state.grid_color.astype(jnp.int32) == t_color)
        & (t_type >= 0)
    )
    t_rank = jnp.where(is_target.ravel(), flat, hw)
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

    is_door = obj == OBJ_DOOR
    is_key = obj == OBJ_KEY
    is_keybox = (obj == OBJ_BOX) & (state.contains_obj == OBJ_KEY)
    is_movable_ball = (obj == OBJ_BALL) & ~target_cell

    # Walkable modulo the dynamic occupants (doors/key/box/ball handled
    # per-config on their own axes).
    base_walk = (
        (obj == OBJ_EMPTY)
        | (obj == OBJ_FLOOR)
        | (obj == OBJ_GOAL)
        | (obj == OBJ_LAVA)
        | is_key
        | is_keybox
        | is_movable_ball
        | is_door
    ) & ~target_cell
    # Cells a carried object may be dropped on once vacated: reference drop
    # requires a literally empty front cell (minigrid_env.py:564-568).
    base_empty = (obj == OBJ_EMPTY) | is_key | is_keybox | is_movable_ball

    # Door slots in raster order (same scheme as tabular_key).
    door_rank = jnp.where(is_door.ravel(), flat, hw)
    order = jnp.argsort(door_rank)
    slots = order[:max_doors]
    slot_valid = is_door.ravel()[slots]
    dx = (slots % w).astype(jnp.int32)
    dy = (slots // w).astype(jnp.int32)
    door_pos = jnp.stack(
        [jnp.where(slot_valid, dx, -1), jnp.where(slot_valid, dy, -1)], axis=-1
    )
    # One-hot writes, not dynamic scatters: batched scatters miscompiled on
    # an earlier accelerator backend; ``audit_device`` checks the live one
    # (ops/grid.py:cell_set).
    door_id = jnp.full((hw,), -1, dtype=jnp.int32)
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

    # Key-box cell (first in raster order).
    bx_rank = jnp.where(is_keybox.ravel(), flat, hw)
    bxidx = jnp.argmin(bx_rank).astype(jnp.int32)
    has_box = is_keybox.ravel()[bxidx]
    box_idx = jnp.where(has_box, bxidx, -1).astype(jnp.int32)

    # Key location: bare cell > in-box > carried.
    key_rank = jnp.where(is_key.ravel(), flat, hw)
    kidx = jnp.argmin(key_rank).astype(jnp.int32)
    has_key_cell = is_key.ravel()[kidx]
    carrying_key = state.carrying_obj == OBJ_KEY
    key0 = jnp.where(
        has_key_cell,
        kidx,
        jnp.where(has_box, hw + 1, jnp.where(carrying_key, hw, -1)),
    ).astype(jnp.int32)
    key_color = jnp.where(
        has_key_cell,
        state.grid_color.ravel()[kidx].astype(jnp.int32),
        jnp.where(
            has_box,
            state.contains_color.ravel()[bxidx].astype(jnp.int32),
            state.carrying_color.astype(jnp.int32),
        ),
    )
    door_color = state.grid_color[
        jnp.clip(door_pos[:, 1], 0, h - 1), jnp.clip(door_pos[:, 0], 0, w - 1)
    ].astype(jnp.int32)
    door_unlockable = slot_valid & (door_color == key_color)

    # Movable ball (first non-target ball in raster order).
    bl_rank = jnp.where(is_movable_ball.ravel(), flat, hw)
    blidx = jnp.argmin(bl_rank).astype(jnp.int32)
    has_ball = is_movable_ball.ravel()[blidx]
    carrying_ball = state.carrying_obj == OBJ_BALL
    ball0 = jnp.where(
        has_ball, blidx, jnp.where(carrying_ball, hw, hw + 1)
    ).astype(jnp.int32)

    return ObstructedLayout(
        base_walk=base_walk,
        base_empty=base_empty,
        goal=obj == OBJ_GOAL,
        lava=obj == OBJ_LAVA,
        target_pos=target_pos,
        door_pos=door_pos,
        door_id=door_id,
        door_init=door_init,
        door_unlockable=door_unlockable,
        box_idx=box_idx,
        key0=key0,
        ball0=ball0,
    )


def _door_tables(layout: ObstructedLayout):
    """Per-(config, cell) door tables — same contract as tabular_key."""
    D = layout.n_doors
    Cd = 1 << D
    cfg = jnp.arange(Cd, dtype=jnp.int32)
    h, w = layout.base_walk.shape

    did = layout.door_id
    safe = jnp.clip(did, 0, D - 1)
    opened_bit = (cfg[:, None] >> safe.ravel()[None, :]) & 1
    opened_bit = opened_bit.reshape(Cd, h, w)
    init_cell = layout.door_init[safe]
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
    return door_block, bitmask, locked_cell, closed_cell


def _backup(v: jnp.ndarray, layout: ObstructedLayout, gamma: float):
    """One Bellman backup: (B, K, Cd, 4, H, W) -> q: (A, B, K, Cd, 4, H, W).

    Action order = the reference Actions enum (left, right, forward,
    pickup, drop, toggle, done)."""
    B, K, Cd, _, h, w = v.shape
    hw = h * w
    CARRIED = hw  # same sentinel on both axes
    IN_BOX = hw + 1
    kloc = jnp.arange(K, dtype=jnp.int32)
    bloc = jnp.arange(B, dtype=jnp.int32)

    door_block, bitmask, locked_cell, closed_cell = _door_tables(layout)

    ys = jnp.arange(h, dtype=jnp.int32)[:, None]
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    cell_idx = (ys * w + xs).astype(jnp.int32)
    box_cell = cell_idx == layout.box_idx  # (H, W); all-False if no box

    # Occupancy by the tracked objects, per axis value.
    key_block = (kloc[:, None, None] == cell_idx[None]) | (
        (kloc == IN_BOX)[:, None, None] & box_cell[None]
    )  # (K, H, W)
    ball_block = bloc[:, None, None] == cell_idx[None]  # (B, H, W)

    # walk: (B, K, Cd, H, W)
    walk = (
        layout.base_walk[None, None, None]
        & ~door_block[None, None]
        & ~key_block[None, :, None]
        & ~ball_block[:, None, None]
    )

    q_left = gamma * jnp.roll(v, 1, axis=3)
    q_right = gamma * jnp.roll(v, -1, axis=3)

    target_cell = (xs == layout.target_pos[0]) & (ys == layout.target_pos[1])
    empty_hands = (bloc != CARRIED)[:, None] & (kloc != CARRIED)[None]  # (B,K)

    unlock_cell = locked_cell & layout.door_unlockable[
        jnp.clip(layout.door_id, 0, layout.n_doors - 1)
    ][None]

    q_fwd, q_pick, q_drop, q_tog = [], [], [], []
    for d, dxy in enumerate(_DIRS):
        vd = v[:, :, :, d]  # (B, K, Cd, H, W)
        fidx = _front_index(h, w, dxy)  # (H, W), -1 if OOB

        # forward (minigrid_env.py:546-553)
        vn = _shift_from(vd, dxy)
        walk_n = _shift_from(walk, dxy)
        goal_n = _shift_from(layout.goal.astype(v.dtype), dxy)
        lava_n = _shift_from(layout.lava.astype(v.dtype), dxy)
        qd = gamma * jnp.where(walk_n, vn, vd)
        qd = jnp.where(lava_n > 0, 0.0, qd)
        qd = jnp.where(goal_n > 0, 1.0, qd)
        q_fwd.append(qd)

        # pickup (minigrid_env.py:556-561): needs empty hands; the front
        # cell holds at most one of {key, ball, target} in reachable states.
        key_front = (kloc[:, None, None] == fidx[None]) & (fidx >= 0)[None]
        ball_front = (bloc[:, None, None] == fidx[None]) & (fidx >= 0)[None]
        eh = empty_hands[:, :, None, None, None]  # (B, K, 1, 1, 1)
        # key -> CARRIED: value at k = CARRIED for the same b.
        v_k_carried = vd[:, CARRIED][:, None]  # (B, 1, Cd, H, W)
        qp = jnp.where(
            key_front[None, :, None] & eh, gamma * v_k_carried, gamma * vd
        )
        # ball -> CARRIED: value at b = CARRIED for the same k.
        v_b_carried = vd[CARRIED][None]  # (1, K, Cd, H, W)
        qp = jnp.where(
            ball_front[:, None, None] & eh, gamma * v_b_carried, qp
        )
        target_front = _shift_from(target_cell.astype(jnp.int32), dxy).astype(
            bool
        )
        qp = jnp.where(target_front[None, None, None] & eh, 1.0, qp)
        q_pick.append(qp)

        # drop (minigrid_env.py:564-568): front cell must be empty in the
        # current (b, k) state; only the carried slices change.
        front_ok = _shift_from(layout.base_empty, dxy) & (fidx >= 0)
        key_at_f = (kloc[:, None, None] == fidx[None]) | (
            (kloc == IN_BOX)[:, None, None]
            & (fidx == layout.box_idx)[None]
            & (layout.box_idx >= 0)
        )  # (K, H, W)
        ball_at_f = bloc[:, None, None] == fidx[None]  # (B, H, W)
        droppable = (
            front_ok[None, None, None]
            & ~key_at_f[None, :, None]
            & ~ball_at_f[:, None, None]
        )  # (B, K, Cd=1, H, W) broadcast over Cd
        idx = jnp.clip(fidx, 0, hw - 1)
        # carried key -> k = front index (same b).
        v_k_drop = jnp.take_along_axis(
            vd,
            jnp.broadcast_to(idx[None, None, None], (B, 1, Cd, h, w)),
            axis=1,
        )  # (B, 1, Cd, H, W)
        k_is_carried = (kloc == CARRIED)[None, :, None, None, None]
        qdrop = jnp.where(
            k_is_carried & droppable, gamma * v_k_drop, gamma * vd
        )
        # carried ball -> b = front index (same k); key axis untouched.
        v_b_drop = jnp.take_along_axis(
            vd,
            jnp.broadcast_to(idx[None, None, None], (1, K, Cd, h, w)),
            axis=0,
        )  # (1, K, Cd, H, W)
        b_is_carried = (bloc == CARRIED)[:, None, None, None, None]
        qdrop = jnp.where(
            b_is_carried & ~k_is_carried & droppable, gamma * v_b_drop, qdrop
        )
        q_drop.append(qdrop)

        # toggle (world_object.py:185-195, :291-294): doors and the key-box.
        closed_n = _shift_from(closed_cell, dxy)  # (Cd, H, W)
        unlock_n = _shift_from(unlock_cell, dxy)
        bit_n = _shift_from(bitmask, dxy)  # (H, W)
        allowed = closed_n[None] | (
            unlock_n[None] & (kloc == CARRIED)[:, None, None, None]
        )  # (K, Cd, H, W)
        cfg = jnp.arange(Cd, dtype=jnp.int32)
        new_cfg = cfg[:, None, None] | bit_n[None]  # (Cd, H, W)
        v_open = jnp.take_along_axis(
            vd, jnp.broadcast_to(new_cfg[None, None], (B, K, Cd, h, w)), axis=2
        )
        qt = gamma * jnp.where(allowed[None], v_open, vd)
        # box toggle: facing the box while the key is inside reveals the key
        # at the box cell (works with full hands — toggle has no empty-hand
        # precondition in the reference).
        box_front = (fidx == layout.box_idx) & (layout.box_idx >= 0)  # (H, W)
        v_k_revealed = jnp.take_along_axis(
            vd,
            jnp.broadcast_to(
                jnp.clip(layout.box_idx, 0, hw - 1)[None, None, None, None, None],
                (B, 1, Cd, h, w),
            ),
            axis=1,
        )  # (B, 1, Cd, H, W)
        k_in_box = (kloc == IN_BOX)[None, :, None, None, None]
        qt = jnp.where(
            k_in_box & box_front[None, None, None],
            gamma * v_k_revealed,
            qt,
        )
        q_tog.append(qt)

    q_fwd = jnp.stack(q_fwd, axis=3)
    q_pick = jnp.stack(q_pick, axis=3)
    q_drop = jnp.stack(q_drop, axis=3)
    q_tog = jnp.stack(q_tog, axis=3)
    q_stay = gamma * v

    return jnp.stack([q_left, q_right, q_fwd, q_pick, q_drop, q_tog, q_stay])


@partial(jax.jit, static_argnames=("gamma", "n_sweeps"))
def obstructed_value_iteration(
    layout: ObstructedLayout,
    gamma: float = 0.995,
    n_sweeps: int = 256,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact VI over the obstructed domain.

    Returns (V: (B, K, Cd, 4, H, W) f32, policy: same shape int8); vmap
    over a layout batch."""
    h, w = layout.base_walk.shape
    K = h * w + 2
    B = h * w + 2
    Cd = 1 << layout.n_doors
    v0 = jnp.zeros((B, K, Cd, 4, h, w), dtype=jnp.float32)

    def sweep(v, _):
        return jnp.max(_backup(v, layout, gamma), axis=0), None

    v, _ = jax.lax.scan(sweep, v0, None, length=n_sweeps)
    policy = jnp.argmax(_backup(v, layout, gamma), axis=0).astype(jnp.int8)
    return v, policy


def obstructed_state_index(layout: ObstructedLayout, state: EnvState):
    """(b, k, cfg, dir, y, x) of an env state under this layout."""
    h, w = layout.base_walk.shape
    hw = h * w
    D = layout.n_doors
    obj = state.grid_obj
    flat = jnp.arange(hw, dtype=jnp.int32)

    is_key = (obj == OBJ_KEY).ravel()
    kidx = jnp.argmin(jnp.where(is_key, flat, hw)).astype(jnp.int32)
    is_keybox = ((obj == OBJ_BOX) & (state.contains_obj == OBJ_KEY)).ravel()
    has_box_now = is_keybox.any()
    carrying_key = state.carrying_obj == OBJ_KEY
    k = jnp.where(
        is_key[kidx],
        kidx,
        jnp.where(has_box_now, hw + 1, jnp.where(carrying_key, hw, -1)),
    )

    ys = jnp.arange(h, dtype=jnp.int32)[:, None]
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    target_cell = (xs == layout.target_pos[0]) & (ys == layout.target_pos[1])
    is_ball = ((obj == OBJ_BALL) & ~target_cell).ravel()
    blidx = jnp.argmin(jnp.where(is_ball, flat, hw)).astype(jnp.int32)
    carrying_ball = state.carrying_obj == OBJ_BALL
    b = jnp.where(
        is_ball[blidx], blidx, jnp.where(carrying_ball, hw, hw + 1)
    )

    sigma = state.grid_state[
        jnp.clip(layout.door_pos[:, 1], 0, h - 1),
        jnp.clip(layout.door_pos[:, 0], 0, w - 1),
    ].astype(jnp.int32)
    opened = (sigma == STATE_OPEN) & (layout.door_init != STATE_OPEN)
    opened = opened & (layout.door_pos[:, 0] >= 0)
    cfg = jnp.sum(opened.astype(jnp.int32) << jnp.arange(D, dtype=jnp.int32))
    return b, k, cfg, state.agent_dir, state.agent_pos[1], state.agent_pos[0]


def obstructed_greedy_action(
    policy: jnp.ndarray, layout: ObstructedLayout, state: EnvState
) -> jnp.ndarray:
    b, k, c, d, y, x = obstructed_state_index(layout, state)
    return policy[b, k, c, d, y, x].astype(jnp.int32)


def obstructed_state_value(
    v: jnp.ndarray, layout: ObstructedLayout, state: EnvState
):
    b, k, c, d, y, x = obstructed_state_index(layout, state)
    return v[b, k, c, d, y, x]


def obstructed_steps_to_go(v: jnp.ndarray, gamma: float) -> jnp.ndarray:
    d = 1.0 + jnp.log(jnp.maximum(v, 1e-30)) / math.log(gamma)
    return jnp.where(v > 0, jnp.round(d), jnp.inf)
