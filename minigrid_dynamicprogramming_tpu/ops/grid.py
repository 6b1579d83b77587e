"""Functional grid-construction ops.

Functional counterparts of the reference's imperative builders:
``Grid.horz_wall``/``vert_wall``/``wall_rect``
(/root/reference/minigrid/core/grid.py:80-108), ``MiniGridEnv.put_obj``
(/root/reference/minigrid/minigrid_env.py:369-376) and the rejection-sampling
placers ``place_obj``/``place_agent`` (minigrid_env.py:308-390).

Design note on ``place_obj``: the reference loops, proposing uniform positions
until one is empty/un-rejected.  Rejection sampling of a uniform proposal is
*exactly* a uniform draw over the valid set, so here placement is ONE
categorical draw over a validity mask — no data-dependent loop, no trace-time
divergence, and the layout distribution is identical.  (The reference's
``RecursionError`` guard at minigrid_env.py:334-338 becomes an ``ok`` flag:
sampling a fully-invalid mask returns ok=False.)
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.constants import (
    COLOR_GREY,
    OBJ_EMPTY,
    OBJ_WALL,
)
from minigrid_dynamicprogramming_tpu.core.state import EnvState


def cell_set(plane: jnp.ndarray, y, x, val) -> jnp.ndarray:
    """``plane[y, x] = val`` for traced scalar indices, WITHOUT a scatter.

    Batched dynamic-index scatters miscompiled on an earlier accelerator
    backend at large batch: bit-identical on CPU, silently wrong cells on
    the device.  ``utils/device_audit.py`` probes the live backend (run
    ``benchmark --audit`` after any backend upgrade).  The one-hot
    ``where`` is pure elementwise compare+select — the same class as the
    audit's oracle — so it cannot hit that bug by construction, and XLA
    fuses consecutive writes into one pass over the plane, where vmapped
    ``dynamic_update_slice`` chains do not fuse.  Whether a scatter is both
    correct and faster on a given card is for the audit and a timing to
    decide.

    OOB indices write nothing (the reference's builders never write OOB;
    callers gate conditional writes with ``where`` on the value).
    """
    return cell_set_dense(plane, y, x, val)


def elem_set(arr: jnp.ndarray, i, val) -> jnp.ndarray:
    """``arr[i] = val`` (1-D), scatter-free: see :func:`cell_set`.

    OOB indices write nothing (no clamping, unlike dynamic_update_slice).
    """
    hit = jnp.arange(arr.shape[0], dtype=jnp.int32) == i
    return jnp.where(hit, jnp.asarray(val, arr.dtype), arr)


def row_set(arr: jnp.ndarray, i, row) -> jnp.ndarray:
    """``arr[i, :] = row`` (2-D), scatter-free: see :func:`cell_set`.

    OOB indices write nothing (no clamping, unlike dynamic_update_slice).
    """
    hit = jnp.arange(arr.shape[0], dtype=jnp.int32)[:, None] == i
    return jnp.where(hit, jnp.asarray(row, arr.dtype)[None, :], arr)


def cell_set_dense(plane: jnp.ndarray, y, x, val) -> jnp.ndarray:
    """One-hot ``where`` variant of :func:`cell_set` for writes inside the
    rollout scan (see cell_set's docstring).  OOB indices write nothing."""
    ys = jnp.arange(plane.shape[0], dtype=jnp.int32)[:, None]
    xs = jnp.arange(plane.shape[1], dtype=jnp.int32)[None, :]
    hit = (ys == y) & (xs == x)
    return jnp.where(hit, jnp.asarray(val, plane.dtype), plane)


def put_obj(
    state: EnvState,
    x,
    y,
    obj: int,
    color: int,
    obj_state: int = 0,
    contains_obj: int = OBJ_EMPTY,
    contains_color: int = 0,
) -> EnvState:
    """Write one cell; coordinates may be traced scalars."""
    return state.replace(
        grid_obj=cell_set(state.grid_obj, y, x, obj),
        grid_color=cell_set(state.grid_color, y, x, color),
        grid_state=cell_set(state.grid_state, y, x, obj_state),
        contains_obj=cell_set(state.contains_obj, y, x, contains_obj),
        contains_color=cell_set(state.contains_color, y, x, contains_color),
    )


def clear_cell(state: EnvState, x, y) -> EnvState:
    return put_obj(state, x, y, OBJ_EMPTY, 0, 0)


def coord_grids(height: int, width: int):
    """(ys, xs) int32 index planes of shape (H, W)."""
    ys = jnp.arange(height, dtype=jnp.int32)[:, None]
    xs = jnp.arange(width, dtype=jnp.int32)[None, :]
    return jnp.broadcast_to(ys, (height, width)), jnp.broadcast_to(
        xs, (height, width)
    )


def paint(
    state: EnvState,
    mask: jnp.ndarray,
    obj: int,
    color: int,
    obj_state: int = 0,
) -> EnvState:
    """Set every cell where ``mask`` is True to (obj, color, obj_state)."""
    return state.replace(
        grid_obj=jnp.where(mask, jnp.uint8(obj), state.grid_obj),
        grid_color=jnp.where(mask, jnp.uint8(color), state.grid_color),
        grid_state=jnp.where(mask, jnp.uint8(obj_state), state.grid_state),
        contains_obj=jnp.where(mask, jnp.uint8(OBJ_EMPTY), state.contains_obj),
        contains_color=jnp.where(mask, jnp.uint8(0), state.contains_color),
    )


def horz_wall_mask(height: int, width: int, x, y, length) -> jnp.ndarray:
    ys, xs = coord_grids(height, width)
    return (ys == y) & (xs >= x) & (xs < x + length)


def vert_wall_mask(height: int, width: int, x, y, length) -> jnp.ndarray:
    ys, xs = coord_grids(height, width)
    return (xs == x) & (ys >= y) & (ys < y + length)


def horz_wall(
    state: EnvState, x, y, length=None, obj: int = OBJ_WALL, color: int = COLOR_GREY
) -> EnvState:
    h, w = state.grid_obj.shape
    if length is None:
        length = w - x
    return paint(state, horz_wall_mask(h, w, x, y, length), obj, color)


def vert_wall(
    state: EnvState, x, y, length=None, obj: int = OBJ_WALL, color: int = COLOR_GREY
) -> EnvState:
    h, w = state.grid_obj.shape
    if length is None:
        length = h - y
    return paint(state, vert_wall_mask(h, w, x, y, length), obj, color)


def wall_rect(state: EnvState, x, y, w, h) -> EnvState:
    """Perimeter walls of the (w, h) rectangle at (x, y) (grid.py:104-108)."""
    hh, ww = state.grid_obj.shape
    ys, xs = coord_grids(hh, ww)
    inside = (xs >= x) & (xs < x + w) & (ys >= y) & (ys < y + h)
    border = inside & (
        (xs == x) | (xs == x + w - 1) | (ys == y) | (ys == y + h - 1)
    )
    return paint(state, border, OBJ_WALL, COLOR_GREY)


def rect_mask(height: int, width: int, top, size) -> jnp.ndarray:
    """Cells in the half-open rectangle [top, top + size) — the proposal
    region of ``place_obj`` (minigrid_env.py:324-345), clipped to the grid."""
    ys, xs = coord_grids(height, width)
    tx = jnp.maximum(top[0], 0)
    ty = jnp.maximum(top[1], 0)
    return (xs >= tx) & (xs < tx + size[0]) & (ys >= ty) & (ys < ty + size[1])


def sample_mask_pos(
    key: jax.Array, mask: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Uniform draw over True cells of ``mask``. Returns (x, y, ok)."""
    h, w = mask.shape
    flat = mask.reshape(-1)
    logits = jnp.where(flat, 0.0, -jnp.inf)
    idx = jax.random.categorical(key, logits)
    ok = jnp.any(flat)
    idx = jnp.where(ok, idx, 0)
    return (idx % w).astype(jnp.int32), (idx // w).astype(jnp.int32), ok


def free_cell_mask(state: EnvState) -> jnp.ndarray:
    """Cells where place_obj may land: empty and not the agent's cell
    (minigrid_env.py:347-353)."""
    h, w = state.grid_obj.shape
    ys, xs = coord_grids(h, w)
    not_agent = ~((xs == state.agent_pos[0]) & (ys == state.agent_pos[1]))
    return (state.grid_obj == OBJ_EMPTY) & not_agent


def place_obj(
    key: jax.Array,
    state: EnvState,
    obj: int,
    color: int,
    obj_state: int = 0,
    top=(0, 0),
    size=None,
    reject_mask: Optional[jnp.ndarray] = None,
    contains_obj: int = OBJ_EMPTY,
    contains_color: int = 0,
):
    """Place ``obj`` uniformly over valid cells. Returns (state, (x, y), ok).

    ``reject_mask`` marks *disallowed* cells (the vectorized form of the
    reference's ``reject_fn`` callbacks, minigrid_env.py:356-357).
    """
    h, w = state.grid_obj.shape
    valid = free_cell_mask(state)
    if top is None:
        top = (0, 0)
    if size is not None or top != (0, 0):
        if size is None:
            size = (w, h)
        valid = valid & rect_mask(h, w, top, size)
    if reject_mask is not None:
        valid = valid & (~reject_mask)
    x, y, ok = sample_mask_pos(key, valid)
    placed = put_obj(
        state, x, y, obj, color, obj_state, contains_obj, contains_color
    )
    # On ok=False keep the grid unchanged (sampled fallback cell is junk).
    state = jax.tree_util.tree_map(
        lambda a, b: jnp.where(ok, a, b), placed, state
    )
    return state, (x, y), ok


def place_agent(
    key: jax.Array,
    state: EnvState,
    top=(0, 0),
    size=None,
    rand_dir: bool = True,
    reject_mask: Optional[jnp.ndarray] = None,
):
    """Sample an empty cell for the agent (minigrid_env.py:378-390).
    Returns (state, ok)."""
    kpos, kdir = jax.random.split(key)
    h, w = state.grid_obj.shape
    valid = free_cell_mask(state)
    if size is not None or top != (0, 0):
        if size is None:
            size = (w, h)
        valid = valid & rect_mask(h, w, top, size)
    if reject_mask is not None:
        valid = valid & (~reject_mask)
    x, y, ok = sample_mask_pos(kpos, valid)
    new_dir = (
        jax.random.randint(kdir, (), 0, 4)
        if rand_dir
        else state.agent_dir
    )
    return (
        state.replace(
            agent_pos=jnp.where(
                ok, jnp.stack([x, y]), state.agent_pos
            ),
            agent_dir=jnp.where(ok, new_dir, state.agent_dir),
        ),
        ok,
    )
