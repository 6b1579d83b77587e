"""Layout-polymorphic hook toolkit.

Env-family hooks (``pre_step``/``post_step``, the reference's per-subclass
``step`` overrides, e.g. /root/reference/minigrid/envs/dynamicobstacles.py:136-167,
fetch.py:162-176, roomgrid_level.py:86-103) are written ONCE against this
module and run in either batching layout:

* **batch-first** (:class:`~..core.state.EnvState` under ``vmap``): grid
  planes are ``(H, W)`` per env, scalars are 0-d, and the whole hook is
  vmapped over the leading batch axis.
* **lane-major** (:class:`~..parallel.lanes.LaneState`): grid planes are
  ``(H*W, B)`` with envs on the trailing axis, scalars are ``(B,)``, and the
  hook IS the batched program.

Most hook logic is elementwise (`jnp.where` cascades over per-env scalars)
and is automatically layout-agnostic.  The operations whose indexing scheme
differs per layout — cell reads/writes, whole-grid masks, per-env uniform
placement draws, state-tree selects — live here behind one dispatch point.

Lane-side draws are produced with ``jax.vmap`` over per-env keys, so they are
bit-identical to the batch-first path under the same keys (JAX PRNG is
counter-based and vmap-invariant); lane-vs-vmapped parity therefore holds
exactly even for stochastic hooks.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.constants import OBJ_EMPTY
from minigrid_dynamicprogramming_tpu.core.state import EnvParams, EnvState
from minigrid_dynamicprogramming_tpu.ops import grid as G
from minigrid_dynamicprogramming_tpu.parallel.lanes import (
    LaneState,
    _cell_onehot,
    _read,
    _select_lanes,
    _write,
)


def is_lanes(state) -> bool:
    return isinstance(state, LaneState)


def dir_vec(agent_dir: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``DIR_TO_VEC`` (constants.py:49-58) as elementwise compare-selects —
    works for 0-d and ``(B,)`` directions alike (shape-polymorphic gathers
    complicate lane hooks)."""
    one = jnp.ones((), jnp.int32)
    dx = jnp.where(agent_dir == 0, one, jnp.where(agent_dir == 2, -one, 0))
    dy = jnp.where(agent_dir == 1, one, jnp.where(agent_dir == 3, -one, 0))
    return dx, dy


def read_cell(params: EnvParams, state, field: str, x, y):
    """``plane[y, x]`` for one named plane; per-env (x, y) in lane layout."""
    plane = getattr(state, field)
    if is_lanes(state):
        hw = params.height * params.width
        idx = y * params.width + x
        return _read(plane, _cell_onehot(hw, idx))
    return plane[y, x]


_GATED_PLANES = {
    "no_boxes": ("contains_obj", "contains_color"),
    "no_marks": ("marks", "vmarks"),
}


def write_cell(params: EnvParams, state, x, y, do, **values):
    """Conditionally write named planes at per-env (x, y).

    ``values`` maps plane field name -> new value (scalar constant or
    per-env array); ``do`` is the per-env write-enable mask.

    Planes gated off for the env family (registry plane gates — the family
    can never place a Box / a verifier mark, so the plane is statically
    constant) are dropped from the write set: the write would be an
    identity, and eliding it keeps the plane a pass-through carry in
    rollouts.
    """
    for flag, fields in _GATED_PLANES.items():
        if params.opt(flag, False):
            values = {k: v for k, v in values.items() if k not in fields}
    if is_lanes(state):
        hw = params.height * params.width
        oh = _cell_onehot(hw, y * params.width + x)
        do = jnp.broadcast_to(do, oh.shape[1:])
        upd = {}
        for name, val in values.items():
            plane = getattr(state, name)
            val = jnp.broadcast_to(
                jnp.asarray(val, plane.dtype), plane.shape[1:]
            )
            upd[name] = _write(plane, oh, do, val)
        return state.replace(**upd)
    upd = {}
    for name, val in values.items():
        plane = getattr(state, name)
        val = jnp.asarray(val, plane.dtype)
        # cell_set_dense (one-hot where), NOT .at[].set: batched sub-32-bit
        # scatters miscompiled on an earlier accelerator backend
        # (``audit_device`` checks the live one), and hooks run inside the
        # rollout scan (ops/grid.py:cell_set).
        upd[name] = G.cell_set_dense(plane, y, x, jnp.where(do, val, plane[y, x]))
    return state.replace(**upd)


def put_obj(params, state, x, y, obj, color, obj_state=0, do=True):
    """Layout-polymorphic ``G.put_obj`` (minigrid_env.py:369-376)."""
    return write_cell(
        params,
        state,
        x,
        y,
        do,
        grid_obj=obj,
        grid_color=color,
        grid_state=obj_state,
        contains_obj=OBJ_EMPTY,
        contains_color=0,
    )


def clear_cell(params, state, x, y, do=True):
    return put_obj(params, state, x, y, OBJ_EMPTY, 0, 0, do=do)


def cell_coords(params: EnvParams, state):
    """Per-cell (xs, ys) int32 index arrays in the state's plane shape:
    ``(H, W)`` batch-first, ``(HW, 1)`` lane-major (broadcasts over lanes)."""
    h, w = params.height, params.width
    if is_lanes(state):
        flat = jnp.arange(h * w, dtype=jnp.int32)[:, None]
        return flat % w, flat // w
    ys = jnp.arange(h, dtype=jnp.int32)[:, None]
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    return (
        jnp.broadcast_to(xs, (h, w)),
        jnp.broadcast_to(ys, (h, w)),
    )


def free_cell_mask(params: EnvParams, state):
    """Cells where ``place_obj`` may land (minigrid_env.py:347-353):
    empty and not the agent's cell."""
    xs, ys = cell_coords(params, state)
    if is_lanes(state):
        ax, ay = state.agent_x, state.agent_y
    else:
        ax, ay = state.agent_pos[0], state.agent_pos[1]
    not_agent = ~((xs == ax) & (ys == ay))
    return (state.grid_obj == OBJ_EMPTY) & not_agent


def rect_mask(params: EnvParams, state, top, size):
    """Cells in the clipped half-open rect [top, top + size) — the proposal
    region of ``place_obj`` (minigrid_env.py:324-345).  ``top`` entries may
    be per-env arrays."""
    xs, ys = cell_coords(params, state)
    tx = jnp.maximum(top[0], 0)
    ty = jnp.maximum(top[1], 0)
    return (xs >= tx) & (xs < tx + size[0]) & (ys >= ty) & (ys < ty + size[1])


def sample_mask_pos(params: EnvParams, key, state, mask):
    """Uniform draw over True cells of ``mask`` per env; returns (x, y, ok).

    Lane layout: ``key`` is per-env ``(B, 2)`` and the draw is
    ``vmap``-of-the-scalar-sampler, so results are bit-identical to the
    batch-first path under the same per-env keys (one small bool transpose
    of the mask per draw).
    """
    if is_lanes(state):
        per_env = mask.T  # (B, HW)
        w = params.width

        def one(k, m):
            return G.sample_mask_pos(k, m.reshape(-1, w))

        return jax.vmap(one)(key, per_env)
    return G.sample_mask_pos(key, mask)


def split_key(key, n: int):
    """``jax.random.split`` that also handles per-env ``(B, 2)`` key arrays,
    returning a list of n keys (each ``(2,)`` or ``(B, 2)``)."""
    if key.ndim == 2:
        ks = jax.vmap(lambda k: jax.random.split(k, n))(key)  # (B, n, 2)
        return [ks[:, i] for i in range(n)]
    ks = jax.random.split(key, n)
    return [ks[i] for i in range(n)]


def select_state(cond, a, b):
    """Per-env ``where(cond, a, b)`` over two states of the same layout."""
    if is_lanes(a):
        return _select_lanes(cond, a, b)
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(
            cond.reshape(cond.shape + (1,) * (x.ndim - cond.ndim)), x, y
        ),
        a,
        b,
    )


def reduce_any_cells(params: EnvParams, state, mask) -> jnp.ndarray:
    """``jnp.any`` over the cell axes only (per-env result)."""
    if is_lanes(state):
        return jnp.any(mask, axis=0)
    return jnp.any(mask)


def reduce_sum_cells(params: EnvParams, state, x) -> jnp.ndarray:
    if is_lanes(state):
        return jnp.sum(x, axis=0)
    return jnp.sum(x)


def shift_cells(params: EnvParams, state, mask, dx: int, dy: int):
    """Shift a per-cell mask by a static (dx, dy), zero-filling — i.e.
    ``out[y, x] = mask[y - dy, x - dx]``.  Used for 4-adjacency tests
    (verifier.py:409-433)."""
    h, w = params.height, params.width
    if is_lanes(state):
        b = mask.shape[-1]
        m = mask.reshape(h, w, b)
        if dy > 0:
            m = jnp.pad(m[:-dy], ((dy, 0), (0, 0), (0, 0)))
        elif dy < 0:
            m = jnp.pad(m[-dy:], ((0, -dy), (0, 0), (0, 0)))
        if dx > 0:
            m = jnp.pad(m[:, :-dx], ((0, 0), (dx, 0), (0, 0)))
        elif dx < 0:
            m = jnp.pad(m[:, -dx:], ((0, 0), (0, -dx), (0, 0)))
        return m.reshape(h * w, b)
    m = mask
    if dy > 0:
        m = jnp.pad(m[:-dy], ((dy, 0), (0, 0)))
    elif dy < 0:
        m = jnp.pad(m[-dy:], ((0, -dy), (0, 0)))
    if dx > 0:
        m = jnp.pad(m[:, :-dx], ((0, 0), (dx, 0)))
    elif dx < 0:
        m = jnp.pad(m[:, -dx:], ((0, 0), (0, -dx)))
    return m


def agent_xy(state):
    if is_lanes(state):
        return state.agent_x, state.agent_y
    return state.agent_pos[0], state.agent_pos[1]
