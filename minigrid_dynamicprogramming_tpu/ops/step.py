"""Branchless transition kernel.

Batched re-derivation of ``MiniGridEnv.step``
(/root/reference/minigrid/minigrid_env.py:520-590) plus the object toggle
callbacks (``Door.toggle`` /root/reference/minigrid/core/world_object.py:185-195,
``Box.toggle`` world_object.py:291-294).

The reference dispatches on the action with Python ``if``s and mutates a graph
of objects.  Here all seven action outcomes are computed as masks over the SoA
state and combined with ``jnp.where`` — one straight-line program, identical
for every environment in the batch, so ``vmap`` turns it into a handful of
fused vector ops per env batch.
"""

from __future__ import annotations

import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.constants import (
    ACT_DROP,
    ACT_FORWARD,
    ACT_LEFT,
    ACT_PICKUP,
    ACT_RIGHT,
    ACT_TOGGLE,
    CAN_OVERLAP_LUT,
    CAN_PICKUP_LUT,
    DIR_TO_VEC_ARR,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    STATE_CLOSED,
    STATE_LOCKED,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu.core.state import EnvParams, EnvState
from minigrid_dynamicprogramming_tpu.ops import grid as G


def success_reward(step_count: jnp.ndarray, max_steps: int) -> jnp.ndarray:
    """Reward on reaching the goal: ``1 - 0.9 * step_count / max_steps``
    (reference minigrid_env.py:235-240)."""
    return 1.0 - 0.9 * (step_count.astype(jnp.float32) / max_steps)


def base_step(params: EnvParams, state: EnvState, action: jnp.ndarray):
    """One transition of the core MDP.

    Returns ``(new_state, reward, terminated)``; truncation is applied by the
    caller (env wrapper) so per-env ``step`` overrides can adjust
    reward/termination first, matching the subclass-override structure of the
    reference.
    """
    action = action.astype(jnp.int32)
    step_count = state.step_count + 1

    dvec = DIR_TO_VEC_ARR[state.agent_dir]  # (2,) int32
    fwd = state.agent_pos + dvec
    fx, fy = fwd[0], fwd[1]
    # All reference layouts are wall-enclosed so fwd stays in-bounds whenever
    # it matters; clip anyway and treat OOB like a wall so the kernel is total.
    in_bounds = (
        (fx >= 0) & (fx < params.width) & (fy >= 0) & (fy < params.height)
    )
    cx = jnp.clip(fx, 0, params.width - 1)
    cy = jnp.clip(fy, 0, params.height - 1)

    fwd_obj = jnp.where(in_bounds, state.grid_obj[cy, cx], jnp.uint8(2))
    fwd_color = jnp.where(in_bounds, state.grid_color[cy, cx], jnp.uint8(0))
    fwd_state = jnp.where(in_bounds, state.grid_state[cy, cx], jnp.uint8(0))
    fwd_contains = jnp.where(
        in_bounds, state.contains_obj[cy, cx], jnp.uint8(OBJ_EMPTY)
    )
    fwd_contains_color = jnp.where(
        in_bounds, state.contains_color[cy, cx], jnp.uint8(0)
    )

    is_left = action == ACT_LEFT
    is_right = action == ACT_RIGHT
    is_forward = action == ACT_FORWARD
    is_pickup = action == ACT_PICKUP
    is_drop = action == ACT_DROP
    is_toggle = action == ACT_TOGGLE

    # --- turns (minigrid_env.py:536-543) ---
    new_dir = jnp.where(
        is_left,
        (state.agent_dir + 3) % 4,
        jnp.where(is_right, (state.agent_dir + 1) % 4, state.agent_dir),
    )

    # --- forward (minigrid_env.py:546-553) ---
    fwd_is_empty = fwd_obj == OBJ_EMPTY
    fwd_open_door = (fwd_obj == OBJ_DOOR) & (fwd_state == STATE_OPEN)
    can_enter = CAN_OVERLAP_LUT[fwd_obj] | fwd_open_door
    moved = is_forward & can_enter & in_bounds
    new_pos = jnp.where(moved, fwd, state.agent_pos)
    hit_goal = is_forward & (fwd_obj == OBJ_GOAL)
    hit_lava = is_forward & (fwd_obj == OBJ_LAVA)
    terminated = hit_goal | hit_lava
    reward = jnp.where(hit_goal, success_reward(step_count, params.max_steps), 0.0)

    # --- pickup (minigrid_env.py:556-561) ---
    not_carrying = state.carrying_obj == OBJ_EMPTY
    do_pickup = is_pickup & CAN_PICKUP_LUT[fwd_obj] & not_carrying & in_bounds

    # --- drop (minigrid_env.py:564-568) ---
    do_drop = is_drop & fwd_is_empty & (~not_carrying) & in_bounds

    # --- toggle (minigrid_env.py:571-573) ---
    fwd_is_door = fwd_obj == OBJ_DOOR
    key_matches = (state.carrying_obj == OBJ_KEY) & (
        state.carrying_color == fwd_color
    )
    do_unlock = (
        is_toggle & fwd_is_door & (fwd_state == STATE_LOCKED) & key_matches
    )
    do_flip = is_toggle & fwd_is_door & (fwd_state != STATE_LOCKED)
    new_door_state = jnp.where(
        do_unlock,
        jnp.uint8(STATE_OPEN),
        jnp.where(
            do_flip,
            jnp.where(
                fwd_state == STATE_OPEN,
                jnp.uint8(STATE_CLOSED),
                jnp.uint8(STATE_OPEN),
            ),
            fwd_state,
        ),
    )
    do_open_box = is_toggle & (fwd_obj == 7) & in_bounds  # OBJ_BOX

    # --- forward-cell updates, one where-cascade per plane ---
    cell_obj = jnp.where(
        do_pickup,
        jnp.uint8(OBJ_EMPTY),
        jnp.where(
            do_drop,
            state.carrying_obj,
            jnp.where(do_open_box, fwd_contains, fwd_obj),
        ),
    )
    cell_color = jnp.where(
        do_pickup,
        jnp.uint8(0),
        jnp.where(
            do_drop,
            state.carrying_color,
            jnp.where(do_open_box, fwd_contains_color, fwd_color),
        ),
    )
    cell_state = jnp.where(
        do_pickup | do_drop | do_open_box, jnp.uint8(0), new_door_state
    )
    cell_contains = jnp.where(
        do_pickup | do_open_box,
        jnp.uint8(OBJ_EMPTY),
        jnp.where(do_drop, state.carrying_contains_obj, fwd_contains),
    )
    cell_contains_color = jnp.where(
        do_pickup | do_open_box,
        jnp.uint8(0),
        jnp.where(do_drop, state.carrying_contains_color, fwd_contains_color),
    )

    # cell_set_dense (one-hot where), NOT .at[].set: batched sub-32-bit
    # scatters miscompiled on an earlier accelerator backend
    # (``audit_device`` checks the live one), and this runs inside the
    # rollout scan (ops/grid.py:cell_set).
    grid_obj = G.cell_set_dense(
        state.grid_obj, cy, cx,
        jnp.where(in_bounds, cell_obj, state.grid_obj[cy, cx]),
    )
    grid_color = G.cell_set_dense(
        state.grid_color, cy, cx,
        jnp.where(in_bounds, cell_color, state.grid_color[cy, cx]),
    )
    grid_state = G.cell_set_dense(
        state.grid_state, cy, cx,
        jnp.where(in_bounds, cell_state, state.grid_state[cy, cx]),
    )
    contains_obj = G.cell_set_dense(
        state.contains_obj, cy, cx,
        jnp.where(in_bounds, cell_contains, state.contains_obj[cy, cx]),
    )
    contains_color = G.cell_set_dense(
        state.contains_color, cy, cx,
        jnp.where(
            in_bounds, cell_contains_color, state.contains_color[cy, cx]
        ),
    )

    # --- identity-mark maintenance (BabyAI verifier object tracking) ---
    # Marks follow the object: pickup lifts the cell's bits into
    # carrying_marks, drop puts them back, opening a box destroys the box
    # object (its contents were never tracked, world_object.py:291-294).
    zero_m = jnp.zeros((), dtype=state.marks.dtype)
    fwd_marks = jnp.where(in_bounds, state.marks[cy, cx], zero_m)
    cell_marks = jnp.where(
        do_pickup | do_open_box,
        zero_m,
        jnp.where(do_drop, state.carrying_marks, fwd_marks),
    )
    marks = G.cell_set_dense(
        state.marks, cy, cx,
        jnp.where(in_bounds, cell_marks, state.marks[cy, cx]),
    )
    new_carrying_marks = jnp.where(
        do_pickup,
        fwd_marks,
        jnp.where(do_drop, zero_m, state.carrying_marks),
    )

    # --- carried-object updates ---
    new_carrying_obj = jnp.where(
        do_pickup, fwd_obj, jnp.where(do_drop, jnp.uint8(OBJ_EMPTY), state.carrying_obj)
    )
    new_carrying_color = jnp.where(
        do_pickup,
        fwd_color,
        jnp.where(do_drop, jnp.uint8(0), state.carrying_color),
    )
    new_carrying_contains = jnp.where(
        do_pickup,
        fwd_contains,
        jnp.where(do_drop, jnp.uint8(OBJ_EMPTY), state.carrying_contains_obj),
    )
    new_carrying_contains_color = jnp.where(
        do_pickup,
        fwd_contains_color,
        jnp.where(do_drop, jnp.uint8(0), state.carrying_contains_color),
    )

    new_state_ = state.replace(
        grid_obj=grid_obj,
        grid_color=grid_color,
        grid_state=grid_state,
        contains_obj=contains_obj,
        contains_color=contains_color,
        marks=marks,
        agent_pos=new_pos,
        agent_dir=new_dir,
        carrying_obj=new_carrying_obj,
        carrying_color=new_carrying_color,
        carrying_contains_obj=new_carrying_contains,
        carrying_contains_color=new_carrying_contains_color,
        carrying_marks=new_carrying_marks,
        step_count=step_count,
        terminated=terminated,
    )
    return new_state_, reward, terminated


def apply_truncation(params: EnvParams, state: EnvState) -> EnvState:
    """``truncated = step_count >= max_steps`` (minigrid_env.py:582-583).

    BabyAI levels compute max_steps per episode from the sampled instruction
    (roomgrid_level.py:76-83); those params carry
    ``dynamic_max_steps_slot = <aux index>`` and the threshold is read from
    the episode state instead of the static param.
    """
    slot = params.opt("dynamic_max_steps_slot")
    if slot is None:
        limit = params.max_steps
    else:
        limit = state.aux[slot]
    return state.replace(truncated=state.step_count >= limit)
