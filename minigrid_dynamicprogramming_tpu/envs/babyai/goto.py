"""BabyAI GoTo levels (reference /root/reference/minigrid/envs/babyai/goto.py).

Each level is a pure ``gen_mission(key, params, state, ctx)`` plugged into
:func:`..level.make_level`; rejection-sampling loops become ``ok`` flags and
categorical draws over validity masks (distribution-identical conditioned on
acceptance).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.constants import (
    COLOR_GREY,
    OBJ_BALL,
    OBJ_DOOR,
)
from minigrid_dynamicprogramming_tpu.core.env import Environment
from minigrid_dynamicprogramming_tpu.envs.babyai import core as B
from minigrid_dynamicprogramming_tpu.envs.babyai.level import (
    make_level,
    objs_reachable,
    open_all_doors,
)
from minigrid_dynamicprogramming_tpu.ops import grid as G
from minigrid_dynamicprogramming_tpu.ops import roomgrid as rg

COLOR_RED, COLOR_BLUE = 0, 2


def _goto_codes(kind, color):
    """GoToInstr(ObjDesc(type, color)) as mission codes."""
    return B.instr_codes(
        B.COMB_SINGLE, B.clause(B.KIND_GOTO, d1=(kind, color, B.LOC_NONE))
    )


def make_goto_red_ball_grey(
    env_id: str, room_size: int = 8, num_dists: int = 7
) -> Environment:
    """goto.py:12-77 — red ball + all-grey distractors, single room."""

    def gen(key, p, state, ctx):
        k_agent, k_ball, k_dist = jax.random.split(key, 3)
        state = rg.place_agent(k_agent, state, room_size)
        state, ctx, _, _ = rg.place_in_room(
            k_ball, state, ctx, room_size, 0, 0, OBJ_BALL, COLOR_RED
        )
        state, ctx, _, _, poss = rg.add_distractors(
            k_dist, state, ctx, room_size, 1, 1, 0, 0,
            num_distractors=num_dists, all_unique=False,
        )
        # All distractors repainted grey (goto.py:71-72), scatter-free:
        # batched sub-32-bit scatters miscompiled on an earlier accelerator
        # backend; ``audit_device`` checks the live one (ops/grid.py).
        grid_color = state.grid_color
        for t in range(num_dists):
            grid_color = G.cell_set(
                grid_color, poss[t, 1], poss[t, 0], COLOR_GREY
            )
        state = state.replace(grid_color=grid_color)
        ok = objs_reachable(state)
        return state, _goto_codes(OBJ_BALL, COLOR_RED), ok

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=B.single_profile("goto"))


def make_goto_red_ball(
    env_id: str, room_size: int = 8, num_dists: int = 7
) -> Environment:
    """goto.py:80-140 (and :143-192 for the no-distractor variant)."""

    def gen(key, p, state, ctx):
        k_agent, k_ball, k_dist = jax.random.split(key, 3)
        state = rg.place_agent(k_agent, state, room_size)
        state, ctx, _, _ = rg.place_in_room(
            k_ball, state, ctx, room_size, 0, 0, OBJ_BALL, COLOR_RED
        )
        state, ctx, _, _, _ = rg.add_distractors(
            k_dist, state, ctx, room_size, 1, 1, 0, 0,
            num_distractors=num_dists, all_unique=False,
        )
        ok = objs_reachable(state)
        return state, _goto_codes(OBJ_BALL, COLOR_RED), ok

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=B.single_profile("goto"))


def make_goto_obj(env_id: str, room_size: int = 8) -> Environment:
    """goto.py:195-259 — one object, no distractors."""

    def gen(key, p, state, ctx):
        k_agent, k_dist = jax.random.split(key)
        state = rg.place_agent(k_agent, state, room_size)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            k_dist, state, ctx, room_size, 1, 1, 0, 0,
            num_distractors=1, all_unique=True,
        )
        return state, _goto_codes(kinds[0], colors[0]), jnp.asarray(True)

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=B.single_profile("goto"))


def make_goto_local(
    env_id: str, room_size: int = 8, num_dists: int = 8
) -> Environment:
    """goto.py:262-337 — go to a random distractor, single room."""

    def gen(key, p, state, ctx):
        k_agent, k_dist, k_pick = jax.random.split(key, 3)
        state = rg.place_agent(k_agent, state, room_size)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            k_dist, state, ctx, room_size, 1, 1, 0, 0,
            num_distractors=num_dists, all_unique=False,
        )
        ok = objs_reachable(state)
        n = jax.random.randint(k_pick, (), 0, num_dists)
        return state, _goto_codes(kinds[n], colors[n]), ok

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=B.single_profile("goto"))


def make_goto(
    env_id: str,
    room_size: int = 8,
    num_rows: int = 3,
    num_cols: int = 3,
    num_dists: int = 18,
    doors_open: bool = False,
) -> Environment:
    """goto.py:340-425 — maze of rooms, many distractors."""

    def gen(key, p, state, ctx):
        k_agent, k_conn, k_dist, k_pick = jax.random.split(key, 4)
        state = rg.place_agent(
            k_agent, state, room_size, rows=num_rows, cols=num_cols
        )
        state, ctx = rg.connect_all(k_conn, state, ctx, room_size)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            k_dist, state, ctx, room_size, num_rows, num_cols,
            num_distractors=num_dists, all_unique=False,
        )
        ok = objs_reachable(state)
        n = jax.random.randint(k_pick, (), 0, num_dists)
        codes = _goto_codes(kinds[n], colors[n])
        if doors_open:
            state = open_all_doors(state)
        return state, codes, ok

    return make_level(env_id, gen, room_size, num_rows, num_cols, instr_profile=B.single_profile("goto"))


def make_goto_imp_unlock(
    env_id: str, room_size: int = 8, num_rows: int = 3, num_cols: int = 3
) -> Environment:
    """goto.py:428-524 — target object inside a locked room; the key sits in
    another room and unlocking is implicit."""

    def gen(key, p, state, ctx):
        (k_room, k_door, k_keyroom, k_key, k_conn, k_dists,
         k_agentroom, k_agent, k_obj) = jax.random.split(key, 9)
        # Locked door on a random room (goto.py:485-488).
        id_ = jax.random.randint(k_room, (), 0, num_cols)
        jd = jax.random.randint(jax.random.fold_in(k_room, 1), (), 0, num_rows)
        state, ctx, _, door_color, _ = rg.add_door(
            k_door, state, ctx, id_, jd, locked=True
        )
        # Key in a different room (goto.py:491-497): uniform over rooms
        # != (id, jd) — the retry loop's acceptance distribution.
        rooms = jnp.arange(num_rows * num_cols)
        ri = rooms % num_cols
        rj = rooms // num_cols
        valid = ~((ri == id_) & (rj == jd))
        pick = jax.random.categorical(
            k_keyroom, jnp.where(valid, 0.0, -jnp.inf)
        )
        from minigrid_dynamicprogramming_tpu.core.constants import OBJ_KEY

        state, ctx, _, _ = rg.place_in_room(
            k_key, state, ctx, room_size, ri[pick], rj[pick], OBJ_KEY, door_color
        )
        state, ctx = rg.connect_all(k_conn, state, ctx, room_size)
        # Two distractors in every unlocked room (goto.py:505-508); one scan
        # over rooms keeps the trace flat.
        dk = jax.random.split(k_dists, num_rows * num_cols)
        room_is = jnp.arange(num_rows * num_cols) % num_cols
        room_js = jnp.arange(num_rows * num_cols) // num_cols
        Place = rg.place_in_room

        def per_room(carry, inp):
            state, ctx = carry
            k, i, j = inp
            k1, k2 = jax.random.split(k)
            sub, sub_ctx = state, ctx
            for kk in (k1, k2):
                kkk, kkc, kkp = jax.random.split(kk, 3)
                kind = rg.OBJ_KINDS[jax.random.randint(kkk, (), 0, 3)]
                color = jax.random.randint(kkc, (), 0, 6)
                sub, sub_ctx, _, _ = Place(
                    kkp, sub, sub_ctx, room_size, i, j, kind, color
                )
            skip = (i == id_) & (j == jd)
            state = jax.tree_util.tree_map(
                lambda a, b: jnp.where(skip, b, a), sub, state
            )
            ctx = jax.tree_util.tree_map(
                lambda a, b: jnp.where(skip, b, a), sub_ctx, ctx
            )
            return (state, ctx), None

        (state, ctx), _ = jax.lax.scan(
            per_room, (state, ctx), (dk, room_is, room_js)
        )
        # Agent anywhere but the locked room (goto.py:511-517).
        apick = jax.random.categorical(
            k_agentroom, jnp.where(valid, 0.0, -jnp.inf)
        )
        state = rg.place_agent(
            k_agent, state, room_size, i=ri[apick], j=rj[apick],
            rows=num_rows, cols=num_cols,
        )
        ok = objs_reachable(state)
        # One object inside the locked room; go to it (goto.py:521-524).
        state, ctx, kinds, colors, _ = rg.add_distractors(
            k_obj, state, ctx, room_size, num_rows, num_cols, id_, jd,
            num_distractors=1, all_unique=False,
        )
        return state, _goto_codes(kinds[0], colors[0]), ok

    return make_level(env_id, gen, room_size, num_rows, num_cols, instr_profile=B.single_profile("goto"))


def make_goto_red_blue_ball(
    env_id: str, room_size: int = 8, num_dists: int = 7
) -> Environment:
    """goto.py:603-676 — exactly one red-or-blue ball among distractors."""

    def gen(key, p, state, ctx):
        k_agent, k_dist, k_color, k_ball = jax.random.split(key, 4)
        state = rg.place_agent(k_agent, state, room_size)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            k_dist, state, ctx, room_size, 1, 1, 0, 0,
            num_distractors=num_dists, all_unique=False,
        )
        # Reject red/blue ball distractors (goto.py:666-668).
        bad = jnp.any(
            (kinds == OBJ_BALL) & ((colors == COLOR_RED) | (colors == COLOR_BLUE))
        )
        color = jnp.where(
            jax.random.randint(k_color, (), 0, 2) == 0, COLOR_RED, COLOR_BLUE
        )
        state, ctx, _, _ = rg.place_in_room(
            k_ball, state, ctx, room_size, 0, 0, OBJ_BALL, color
        )
        ok = (~bad) & objs_reachable(state)
        return state, _goto_codes(OBJ_BALL, color), ok

    return make_level(env_id, gen, room_size, 1, 1, instr_profile=B.single_profile("goto"))


def make_goto_door(env_id: str, room_size: int = 7) -> Environment:
    """goto.py:679-743 — four doors on the center room, go to one."""

    def gen(key, p, state, ctx):
        k_doors, k_agent, k_pick = jax.random.split(key, 3)
        dk = jax.random.split(k_doors, 4)
        door_colors = jnp.zeros((4,), jnp.int32)
        for n in range(4):
            state, ctx, _, c, _ = rg.add_door(dk[n], state, ctx, 1, 1)
            door_colors = door_colors.at[n].set(c)
        state = rg.place_agent(k_agent, state, room_size, i=1, j=1, rows=3, cols=3)
        n = jax.random.randint(k_pick, (), 0, 4)
        codes = _goto_codes(OBJ_DOOR, door_colors[n])
        return state, codes, jnp.asarray(True)

    return make_level(env_id, gen, room_size, 3, 3, instr_profile=B.single_profile("goto"))


def make_goto_obj_door(env_id: str, room_size: int = 8) -> Environment:
    """goto.py:746-814 — go to one of 8 distractors or 4 doors in the
    center room."""

    def gen(key, p, state, ctx):
        k_agent, k_dist, k_doors, k_pick = jax.random.split(key, 4)
        state = rg.place_agent(k_agent, state, room_size, i=1, j=1, rows=3, cols=3)
        state, ctx, kinds, colors, _ = rg.add_distractors(
            k_dist, state, ctx, room_size, 3, 3, 1, 1,
            num_distractors=8, all_unique=False,
        )
        dk = jax.random.split(k_doors, 4)
        all_kinds = jnp.concatenate([kinds, jnp.full((4,), OBJ_DOOR)])
        all_colors = jnp.concatenate([colors, jnp.zeros((4,), jnp.int32)])
        for n in range(4):
            state, ctx, _, c, _ = rg.add_door(dk[n], state, ctx, 1, 1)
            all_colors = all_colors.at[8 + n].set(c)
        ok = objs_reachable(state)
        n = jax.random.randint(k_pick, (), 0, 12)
        return state, _goto_codes(all_kinds[n], all_colors[n]), ok

    return make_level(env_id, gen, room_size, 3, 3, instr_profile=B.single_profile("goto"))
