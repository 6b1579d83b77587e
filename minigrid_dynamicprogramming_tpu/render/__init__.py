"""Device-side RGB frame rendering.

The reference composes frames tile-by-tile in Python with an LRU tile cache
(/root/reference/minigrid/core/grid.py:200-242, ``get_frame``
minigrid_env.py:711-734).  On device the whole frame is ONE gather: each
cell's (obj, color, state, agent, highlight) tuple indexes a pre-rasterized
tile LUT (:mod:`.tiles`), and the gathered (H, W, ts, ts, 3) block is
reshaped to the (H*ts, W*ts, 3) frame.  This vmaps over the env batch and
runs on device, so video generation for thousands of envs is a single
XLA program.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from minigrid_dynamicprogramming_tpu.core.constants import DIR_TO_VEC_ARR
from minigrid_dynamicprogramming_tpu.core.state import EnvParams, EnvState
from minigrid_dynamicprogramming_tpu.ops.obs import gen_obs_planes
from minigrid_dynamicprogramming_tpu.render.tiles import (
    N_AGENT,
    N_HL,
    N_STATE,
    TILE_PIXELS,
    tile_lut,
)

__all__ = ["render_frame", "render_pov", "view_highlight_mask", "TILE_PIXELS"]


def _compose(lut, obj, color, st, agent_code, hl, tile_size):
    """Gather tiles by key and stitch the frame."""
    idx = (
        ((obj.astype(jnp.int32) * 6 + color) * N_STATE + st) * N_AGENT + agent_code
    ) * N_HL + hl
    h, w = obj.shape
    tiles = lut[idx]  # (h, w, ts, ts, 3)
    frame = jnp.transpose(tiles, (0, 2, 1, 3, 4))
    return frame.reshape(h * tile_size, w * tile_size, 3)


def view_highlight_mask(params: EnvParams, state: EnvState) -> jnp.ndarray:
    """(H, W) bool — world cells inside the agent's visible view cone,
    replicating the vis-mask projection of ``get_full_render``
    (minigrid_env.py:663-699)."""
    view = params.agent_view_size
    hs = view // 2
    _, _, _, vis = gen_obs_planes(params, state)  # [vy, vx]

    d = DIR_TO_VEC_ARR[state.agent_dir]
    r = jnp.stack([-d[1], d[0]])
    vy = jnp.arange(view, dtype=jnp.int32)[:, None]
    vx = jnp.arange(view, dtype=jnp.int32)[None, :]
    wx = state.agent_pos[0] + d[0] * (view - 1 - vy) + r[0] * (vx - hs)
    wy = state.agent_pos[1] + d[1] * (view - 1 - vy) + r[1] * (vx - hs)

    inb = (wx >= 0) & (wx < params.width) & (wy >= 0) & (wy < params.height)
    ok = vis & inb
    # One-hot OR of visible view cells into world coords — not a scatter
    # (batched sub-32-bit scatters miscompiled on an earlier accelerator
    # backend; ``audit_device`` checks the live one, ops/grid.py).
    # V*V * H*W comparisons; rendering is cold.
    ys = jnp.arange(params.height)[:, None, None]
    xs = jnp.arange(params.width)[None, :, None]
    hit = (ys == wy.ravel()) & (xs == wx.ravel()) & ok.ravel()
    return hit.any(axis=-1)


def render_frame(
    params: EnvParams,
    state: EnvState,
    tile_size: int = TILE_PIXELS,
    highlight: bool = True,
) -> jnp.ndarray:
    """Full-grid RGB frame, equivalent to ``get_full_render``
    (minigrid_env.py:663-709).  Returns (H*ts, W*ts, 3) uint8."""
    lut = jnp.asarray(tile_lut(tile_size))
    h, w = params.height, params.width
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    agent_here = (xs == state.agent_pos[0]) & (ys == state.agent_pos[1])
    agent_code = jnp.where(agent_here, state.agent_dir + 1, 0)
    if highlight:
        hl = view_highlight_mask(params, state).astype(jnp.int32)
    else:
        hl = jnp.zeros((h, w), dtype=jnp.int32)
    return _compose(
        lut, state.grid_obj, state.grid_color, state.grid_state,
        agent_code, hl, tile_size,
    )


def render_pov(
    params: EnvParams,
    state: EnvState,
    tile_size: int = TILE_PIXELS,
) -> jnp.ndarray:
    """Agent's POV RGB frame, equivalent to ``get_pov_render``
    (minigrid_env.py:647-661): the egocentric view grid rendered with the
    agent drawn at (view//2, view-1) facing up (dir=3) and the visibility
    mask as the highlight."""
    lut = jnp.asarray(tile_lut(tile_size))
    view = params.agent_view_size
    obj, color, st, vis = gen_obs_planes(params, state)  # [vy, vx]
    if not params.see_through_walls:
        # process_vis blanks invisible cells to None in the sliced grid
        # (grid.py:323-326), so they render as empty tiles.
        obj = jnp.where(vis, obj, jnp.uint8(1))
        color = jnp.where(vis, color, jnp.uint8(0))
        st = jnp.where(vis, st, jnp.uint8(0))
    vy = jnp.arange(view)[:, None]
    vx = jnp.arange(view)[None, :]
    agent_here = (vx == view // 2) & (vy == view - 1)
    # The carried-object overlay also replaces the agent cell in the POV
    # grid (gen_obs_grid, minigrid_env.py:618-625) — gen_obs_planes did it.
    agent_code = jnp.where(agent_here, 3 + 1, 0)
    return _compose(lut, obj, color, st, agent_code, vis.astype(jnp.int32), tile_size)


def render_frame_np(env, state, tile_size: int = TILE_PIXELS, highlight=True):
    """Host convenience: numpy frame for a single (unbatched) state."""
    return np.asarray(render_frame(env.params, state, tile_size, highlight))
