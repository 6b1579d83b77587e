"""Egocentric partial-observation encoder.

Batched re-derivation of ``MiniGridEnv.gen_obs_grid``/``gen_obs``
(/root/reference/minigrid/minigrid_env.py:592-645): the reference slices a
sub-grid (OOB cells become ``Wall``), rotates it ``agent_dir + 1`` times,
runs the sequential shadow-casting sweep ``Grid.process_vis``
(/root/reference/minigrid/core/grid.py:291-328), overlays the carried object
at the agent cell and encodes to a (view, view, 3) uint8 image.

Here the slice+rotate collapses into ONE gather: the inverse of
``get_view_coords`` (minigrid_env.py:421-446) gives

    world(vx, vy) = agent_pos + dir_vec * (view - 1 - vy) + right_vec * (vx - hs)

so the rotated egocentric view is a single vectorized index computation.  The
visibility sweep is reproduced *exactly* (not approximated by generic
shadow-casting): each row pass is a monotone left/right OR-cascade, computed
as ``view-1`` shift-or steps, which XLA fuses into one kernel across the
whole env batch.
"""

from __future__ import annotations

import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.constants import (
    COLOR_GREY,
    DIR_TO_VEC_ARR,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_UNSEEN,
    OBJ_WALL,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu.core.state import EnvParams, EnvState


def _shift_right(x: jnp.ndarray) -> jnp.ndarray:
    """[a, b, c] -> [0, a, b] along the last axis."""
    return jnp.concatenate([jnp.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)


def _shift_left(x: jnp.ndarray) -> jnp.ndarray:
    """[a, b, c] -> [b, c, 0] along the last axis."""
    return jnp.concatenate([x[..., 1:], jnp.zeros_like(x[..., :1])], axis=-1)


def process_vis(see: jnp.ndarray, view: int) -> jnp.ndarray:
    """Exact port of the reference's sequential visibility sweep
    (grid.py:291-328) over a (view, view) boolean ``see``-through map indexed
    ``[vy, vx]`` with the agent at ``(vx=view // 2, vy=view - 1)``.

    The reference iterates rows bottom-to-top; per row it runs a rightward
    then a leftward propagation pass, each also seeding diagonal visibility
    into the row above.  Both passes are monotone OR-cascades along the row,
    so each is computed as ``view - 1`` shift-or steps — fully unrolled at
    trace time (view is static and small).
    """
    hs = view // 2
    mask = jnp.zeros((view, view), dtype=bool)
    mask = mask.at[view - 1, hs].set(True)

    # Rows bottom-to-top, mirroring ``for j in reversed(range(height))``.
    for j in reversed(range(view)):
        row = mask[j]
        see_row = see[j]

        # Pass 1 (grid.py:297-308): for i in 0..view-2, mask[i] & see[i]
        # propagates to i+1 (same row, cascading) and diagonally to row j-1.
        for _ in range(view - 1):
            row = row | _shift_right(row & see_row)
        cond1 = row & see_row
        cond1 = cond1.at[view - 1].set(False)  # loop excludes i = view-1

        # Pass 2 (grid.py:310-321): for i in view-1..1 descending.
        for _ in range(view - 1):
            row = row | _shift_left(row & see_row)
        cond2 = row & see_row
        cond2 = cond2.at[0].set(False)  # loop excludes i = 0

        mask = mask.at[j].set(row)
        if j > 0:
            up = mask[j - 1]
            up = up | cond1 | _shift_right(cond1)  # mask[i, j-1], mask[i+1, j-1]
            up = up | cond2 | _shift_left(cond2)  # mask[i, j-1], mask[i-1, j-1]
            mask = mask.at[j - 1].set(up)

    return mask


def gen_obs_planes(params: EnvParams, state: EnvState):
    """Egocentric view planes + visibility mask, all indexed ``[vy, vx]``.

    Returns ``(obj, color, obj_state, vis)`` where the agent sits at
    ``vy = view - 1, vx = view // 2`` facing up (decreasing vy), matching the
    post-rotation frame of the reference (minigrid_env.py:606-607).
    """
    view = params.agent_view_size
    hs = view // 2

    d = DIR_TO_VEC_ARR[state.agent_dir]  # forward (dx, dy)
    r = jnp.stack([-d[1], d[0]])  # right vec (minigrid_env.py:404-411)

    vy = jnp.arange(view, dtype=jnp.int32)[:, None]  # (view, 1)
    vx = jnp.arange(view, dtype=jnp.int32)[None, :]  # (1, view)
    wx = state.agent_pos[0] + d[0] * (view - 1 - vy) + r[0] * (vx - hs)
    wy = state.agent_pos[1] + d[1] * (view - 1 - vy) + r[1] * (vx - hs)

    oob = (wx < 0) | (wx >= params.width) | (wy < 0) | (wy >= params.height)
    cxx = jnp.clip(wx, 0, params.width - 1)
    cyy = jnp.clip(wy, 0, params.height - 1)

    # Out-of-bounds cells become Wall() (grid.py:136-139): (WALL, grey, 0).
    obj = jnp.where(oob, jnp.uint8(OBJ_WALL), state.grid_obj[cyy, cxx])
    color = jnp.where(oob, jnp.uint8(COLOR_GREY), state.grid_color[cyy, cxx])
    obj_state = jnp.where(oob, jnp.uint8(0), state.grid_state[cyy, cxx])

    if params.see_through_walls:
        vis = jnp.ones((view, view), dtype=bool)
    else:
        # see_behind() is False for Wall and for non-open Door
        # (world_object.py:165-166, 182-183).
        blocked = (obj == OBJ_WALL) | (
            (obj == OBJ_DOOR) & (obj_state != STATE_OPEN)
        )
        vis = process_vis(~blocked, view)

    # Carried-object overlay at the agent cell (minigrid_env.py:618-625):
    # the cell under the agent shows what it carries, or empty.
    obj = obj.at[view - 1, hs].set(state.carrying_obj)
    color = color.at[view - 1, hs].set(
        jnp.where(
            state.carrying_obj == OBJ_EMPTY, jnp.uint8(0), state.carrying_color
        )
    )
    obj_state = obj_state.at[view - 1, hs].set(jnp.uint8(0))

    return obj, color, obj_state, vis


def gen_obs_image(params: EnvParams, state: EnvState) -> jnp.ndarray:
    """(view, view, 3) uint8 image in the reference's ``[x, y]`` layout
    (``Grid.encode`` writes ``array[i, j]`` with i = x, grid.py:252-266);
    cells outside the visibility mask encode as zeros ("unseen")."""
    obj, color, obj_state, vis = gen_obs_planes(params, state)
    img = jnp.stack([obj, color, obj_state], axis=-1)  # [vy, vx, 3]
    img = jnp.where(vis[..., None], img, jnp.uint8(0))
    return jnp.transpose(img, (1, 0, 2))  # -> [vx, vy, 3]


def agent_view_visible_mask(params: EnvParams, state: EnvState) -> jnp.ndarray:
    """Visibility mask in ``[vx, vy]`` layout (reference orientation)."""
    _, _, _, vis = gen_obs_planes(params, state)
    return jnp.transpose(vis)


def get_view_coords(params: EnvParams, state: EnvState, x, y):
    """World grid coords -> agent-view coords ``(vx, vy)``; may be negative
    or >= view (exact analog of ``MiniGridEnv.get_view_coords``,
    /root/reference/minigrid/minigrid_env.py:421-446).  Jittable; ``x``/``y``
    may be traced scalars or arrays."""
    sz = params.agent_view_size
    hs = sz // 2
    d = DIR_TO_VEC_ARR[state.agent_dir]
    rx, ry = -d[1], d[0]  # right_vec (minigrid_env.py:404-411)
    tx = state.agent_pos[0] + d[0] * (sz - 1) - rx * hs
    ty = state.agent_pos[1] + d[1] * (sz - 1) - ry * hs
    lx = x - tx
    ly = y - ty
    vx = rx * lx + ry * ly
    vy = -(d[0] * lx + d[1] * ly)
    return vx, vy


def in_view(params: EnvParams, state: EnvState, x, y) -> jnp.ndarray:
    """Whether world cell ``(x, y)`` lies inside the agent's view rectangle
    (``MiniGridEnv.in_view``/``relative_coords``, minigrid_env.py:481-500).
    Note: view-rect membership only — occlusion is :func:`agent_sees`."""
    vx, vy = get_view_coords(params, state, x, y)
    sz = params.agent_view_size
    return (vx >= 0) & (vy >= 0) & (vx < sz) & (vy < sz)


def agent_sees(params: EnvParams, state: EnvState, x, y) -> jnp.ndarray:
    """Whether the (non-empty) world cell ``(x, y)`` is visible to the agent
    through the encoded observation — view-rect membership AND the occlusion
    mask AND type agreement with the decoded obs cell, exactly as
    ``MiniGridEnv.agent_sees`` computes it by decoding ``gen_obs()``
    (minigrid_env.py:502-518).  The reference asserts the world cell is
    non-None; here empty world cells simply return False (the decoded obs
    cell for an empty type is None there)."""
    vx, vy = get_view_coords(params, state, x, y)
    sz = params.agent_view_size
    inb = (vx >= 0) & (vy >= 0) & (vx < sz) & (vy < sz)
    img = gen_obs_image(params, state)  # [vx, vy, 3], unseen encoded as 0
    obs_type = img[jnp.clip(vx, 0, sz - 1), jnp.clip(vy, 0, sz - 1), 0]
    world_type = state.grid_obj[
        jnp.clip(y, 0, params.height - 1), jnp.clip(x, 0, params.width - 1)
    ]
    # Grid.decode returns None for "unseen"/"empty" (world_object.py:80-85);
    # the reference then requires obs_cell.type == world_cell.type.
    obs_nonempty = (obs_type != OBJ_UNSEEN) & (obs_type != OBJ_EMPTY)
    return inb & obs_nonempty & (obs_type == world_type)
