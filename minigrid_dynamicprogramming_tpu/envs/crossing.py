"""Lava/Simple Crossing (reference /root/reference/minigrid/envs/crossing.py:13-184).

``num_crossings`` rivers (vertical or horizontal obstacle lines on even
rows/columns) are sampled as a uniform k-subset of the candidate lines, then a
guaranteed zig-zag path is opened: a shuffled sequence of horizontal/vertical
room-to-room crossings, each opening one random cell in the next river.

The reference's ``shuffle + take-k`` subset draw becomes a permutation-prefix;
its sequential room walk (crossing.py:139-178) is replicated step-for-step
with traced room counters (``num_crossings`` is static and small, so the walk
unrolls at trace time).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.constants import (
    COLOR_GREEN,
    COLOR_GREY,
    COLOR_RED,
    OBJ_GOAL,
    OBJ_LAVA,
    OBJ_WALL,
)
from minigrid_dynamicprogramming_tpu.core.env import Environment
from minigrid_dynamicprogramming_tpu.core.state import EnvParams, new_state
from minigrid_dynamicprogramming_tpu.ops import grid as G

MISSION_LAVA = "avoid the lava and get to the green goal square"
MISSION_WALL = "find the opening and get to the green goal square"


def make_crossing(
    env_id: str,
    size: int = 9,
    num_crossings: int = 1,
    obstacle: str = "lava",
) -> Environment:
    assert size % 2 == 1
    params = EnvParams(
        width=size,
        height=size,
        max_steps=4 * size * size,
        see_through_walls=False,
    )
    obj, col = (
        (OBJ_LAVA, COLOR_RED) if obstacle == "lava" else (OBJ_WALL, COLOR_GREY)
    )
    mission = MISSION_LAVA if obstacle == "lava" else MISSION_WALL

    # Candidate river lines (crossing.py:139-141): vertical rivers at even x,
    # horizontal rivers at even y, both in [2, size-2).
    cand_v = list(range(2, size - 2, 2))
    cand_h = list(range(2, size - 2, 2))
    ncv, nch = len(cand_v), len(cand_h)
    ncand = ncv + nch
    k = num_crossings

    def generate(key: jax.Array, p: EnvParams):
        keys = jax.random.split(key, 3 + 2 * k)
        state = new_state(p.height, p.width, rng=keys[-1])
        state = G.wall_rect(state, 0, 0, p.width, p.height)
        state = state.replace(
            agent_pos=jnp.asarray((1, 1), dtype=jnp.int32),
            agent_dir=jnp.asarray(0, dtype=jnp.int32),
        )
        state = G.put_obj(state, p.width - 2, p.height - 2, OBJ_GOAL, COLOR_GREEN)

        # Uniform k-subset of candidate rivers = first k of a permutation.
        perm = jax.random.permutation(keys[0], ncand)
        # one-hot reduce, NOT a bool scatter: batched sub-32-bit scatters
        # miscompiled on an earlier accelerator backend; ``audit_device``
        # checks the live one (ops/grid.py:cell_set)
        sel = (jnp.arange(ncand)[None, :] == perm[:k, None]).any(axis=0)
        sel_v, sel_h = sel[:ncv], sel[ncv:]
        pos_v = jnp.asarray(cand_v, dtype=jnp.int32)
        pos_h = jnp.asarray(cand_h, dtype=jnp.int32)
        nv = sel_v.sum()

        # Paint rivers: vertical river x spans y in [1, size-1); horizontal
        # river y spans x in [1, size-1) (crossing.py:143-148).
        ys, xs = G.coord_grids(p.height, p.width)
        interior_y = (ys >= 1) & (ys < p.height - 1)
        interior_x = (xs >= 1) & (xs < p.width - 1)
        river_mask = jnp.zeros_like(ys, dtype=bool)
        for i in range(ncv):
            river_mask |= sel_v[i] & (xs == pos_v[i]) & interior_y
        for i in range(nch):
            river_mask |= sel_h[i] & (ys == pos_h[i]) & interior_x
        state = G.paint(state, river_mask, obj, col)

        # Room-boundary arrays: limits_v = [0, sorted selected v positions,
        # size-1 padding] (crossing.py:150-152).  Unselected slots sort to the
        # sentinel size-1.
        sorted_v = jnp.sort(jnp.where(sel_v, pos_v, p.width - 1))
        sorted_h = jnp.sort(jnp.where(sel_h, pos_h, p.height - 1))
        limits_v = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), sorted_v, jnp.asarray([p.width - 1])]
        )
        limits_h = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), sorted_h, jnp.asarray([p.height - 1])]
        )

        # Shuffled crossing order: nv horizontal-direction crossings (over the
        # vertical rivers) and k-nv vertical ones (crossing.py:154-156).
        order = jax.random.permutation(keys[1], k)
        path_is_h = (
            (jnp.arange(k)[None, :] == order[:, None])
            & (jnp.arange(k) < nv)[:, None]
        ).any(axis=0)

        # Sequential room walk opening one cell per crossing
        # (crossing.py:158-177).
        room_i = jnp.asarray(0, jnp.int32)
        room_j = jnp.asarray(0, jnp.int32)
        for t in range(k):
            is_h = path_is_h[t]
            y_rand = jax.random.randint(
                keys[2 + 2 * t], (), limits_h[room_j] + 1, limits_h[room_j + 1]
            )
            x_rand = jax.random.randint(
                keys[3 + 2 * t], (), limits_v[room_i] + 1, limits_v[room_i + 1]
            )
            open_x = jnp.where(is_h, limits_v[room_i + 1], x_rand)
            open_y = jnp.where(is_h, y_rand, limits_h[room_j + 1])
            state = G.clear_cell(state, open_x, open_y)
            room_i = room_i + is_h.astype(jnp.int32)
            room_j = room_j + (1 - is_h.astype(jnp.int32))
        return state

    return Environment(env_id, params, generate, mission_text=lambda c: mission)
