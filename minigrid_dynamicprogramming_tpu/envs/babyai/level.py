"""RoomGridLevel machinery: masked regeneration + reachability validation.

Batched form of ``RoomGridLevel._gen_grid``'s regenerate-on-reject loop
(/root/reference/minigrid/envs/babyai/core/roomgrid_level.py:118-139): each
level's ``gen_mission`` is a pure function returning an ``ok`` flag instead
of raising ``RejectSampling``, and a bounded ``lax.while_loop`` redraws the
whole episode until valid — the same distribution as the reference's loop
(conditioned on acceptance), without exceptions under jit.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.constants import (
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_WALL,
)
from minigrid_dynamicprogramming_tpu.core.env import Environment
from minigrid_dynamicprogramming_tpu.core.state import EnvParams, EnvState, new_state
from minigrid_dynamicprogramming_tpu.envs.babyai import core as B
from minigrid_dynamicprogramming_tpu.ops import roomgrid as rg

# gen_mission(key, params, state, ctx) -> (state, codes, ok)
GenMissionFn = Callable


def objs_reachable(state: EnvState) -> jnp.ndarray:
    """Device flood-fill of ``check_objs_reachable``
    (roomgrid_level.py:249-301): flood from the agent through empty/door
    cells; every object cell (anything but wall) must be visited."""
    obj = state.grid_obj
    h, w = obj.shape
    passable = (obj == OBJ_EMPTY) | (obj == OBJ_DOOR)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    reach0 = (xs == state.agent_pos[0]) & (ys == state.agent_pos[1])

    def grow(reach):
        src = reach & passable
        grown = reach
        grown = grown | jnp.pad(src[1:], ((0, 1), (0, 0)))
        grown = grown | jnp.pad(src[:-1], ((1, 0), (0, 0)))
        grown = grown | jnp.pad(src[:, 1:], ((0, 0), (0, 1)))
        grown = grown | jnp.pad(src[:, :-1], ((0, 0), (1, 0)))
        return grown

    # Grow to the monotone fixed point: identical result to the worst-case
    # (h*w)//2+2 unrolled sweeps, but stops at the flood diameter (typically
    # ~1/3 of the bound) — this runs inside the generation retry loop, so
    # the iteration count is a first-order cost.
    def cond(c):
        reach, changed, it = c
        return changed & (it < (h * w) // 2 + 2)

    def body(c):
        reach, _, it = c
        grown = grow(reach)
        return grown, jnp.any(grown != reach), it + 1

    reach, _, _ = jax.lax.while_loop(
        cond, body, (reach0, jnp.asarray(True), jnp.asarray(0, jnp.int32))
    )
    is_obj = (obj != OBJ_EMPTY) & (obj != OBJ_WALL)
    return jnp.all(~is_obj | reach)


def open_all_doors(state: EnvState) -> EnvState:
    """roomgrid_level.py:237-247."""
    is_door = state.grid_obj == OBJ_DOOR
    return state.replace(
        grid_state=jnp.where(is_door, jnp.uint8(0), state.grid_state)
    )


def make_level(
    env_id: str,
    gen_mission: GenMissionFn,
    room_size: int = 8,
    num_rows: int = 3,
    num_cols: int = 3,
    max_steps: Optional[int] = None,
    max_tries: int = 24,
    agent_view_size: int = 7,
    instr_profile=None,
) -> Environment:
    """Build an :class:`Environment` for one BabyAI level.

    ``instr_profile`` is the level's static instruction shape (see
    ``core.GENERIC_PROFILE``); it lets ``verify_step`` trace only the leaf
    slots/kinds this level can emit."""
    width = (room_size - 1) * num_cols + 1
    height = (room_size - 1) * num_rows + 1
    params = EnvParams(
        width=width,
        height=height,
        # Static cap used only when fixed; the live per-episode limit sits in
        # aux[AUX_MAX_STEPS] (roomgrid_level.py:76-83).
        max_steps=max_steps if max_steps is not None else 8 * room_size**2,
        see_through_walls=False,
        agent_view_size=agent_view_size,
    ).with_extra(
        room_size=room_size,
        num_rows=num_rows,
        num_cols=num_cols,
        fixed_max_steps=max_steps is not None,
        dynamic_max_steps_slot=B.AUX_MAX_STEPS,
        # BABYAI_DONE_ACTIONS env flag (verifier.py:25): read at factory
        # time; static in params so jit specializes each mode.
        done_actions=bool(os.environ.get("BABYAI_DONE_ACTIONS", False)),
        instr_profile=instr_profile,
    )

    def attempt(key: jax.Array, p: EnvParams):
        k_state, k_init, k_mission = jax.random.split(key, 3)
        state = new_state(p.height, p.width, rng=k_state)
        state, ctx = rg.init(k_init, state, room_size, num_rows, num_cols)
        state, codes, ok = gen_mission(k_mission, p, state, ctx)
        # Validation directly on descriptor match masks (mark-plane
        # materialization — init_instr — is hoisted out of the retry loop):
        # every active descriptor must match at least one object (the
        # reference asserts this in ObjDesc.surface, verifier.py:78), and
        # PutNext leaves must not start already satisfied or with
        # intersecting sets (roomgrid_level.py:159-176).  Only the
        # profile's possible slots are traced.
        profile = p.opt("instr_profile") or B.GENERIC_PROFILE
        leaf_kinds = profile[1:]
        for c in range(2):
            for l in range(2):
                kinds = leaf_kinds[c * 2 + l]
                if not kinds:
                    continue
                m = {}
                n_desc = 2 if "putnext" in kinds else 1
                for d in range(n_desc):
                    dtype, dcolor, dloc = B.desc_fields(codes, c, l, d)
                    m[d] = B.desc_match_mask(p, state, dtype, dcolor, dloc)
                    active = B.desc_active(codes, c, l, d)
                    ok = ok & (jnp.any(m[d]) | ~active)
                if "putnext" not in kinds:
                    continue
                is_put = B.leaf_kind(codes, c, l) == B.KIND_PUTNEXT
                move, fixed = m[0], m[1]
                up = jnp.pad(fixed[1:], ((0, 1), (0, 0)))
                down = jnp.pad(fixed[:-1], ((1, 0), (0, 0)))
                left = jnp.pad(fixed[:, 1:], ((0, 0), (0, 1)))
                right = jnp.pad(fixed[:, :-1], ((0, 0), (1, 0)))
                bad = jnp.any(move & (up | down | left | right)) | jnp.any(
                    move & fixed
                )
                ok = ok & (~is_put | ~bad)
        return state, codes, ok

    def generate_stats(key: jax.Array, p: EnvParams):
        """``generate`` plus acceptance telemetry: (state, GenStats).

        GenStats.tries is the number of whole-episode redraws consumed
        (reference analog: iterations of the regenerate-on-RejectSampling
        loop, roomgrid_level.py:118-139); GenStats.ok is False iff all
        ``max_tries`` draws were rejected — the silent-truncation case the
        telemetry exists to expose."""
        from minigrid_dynamicprogramming_tpu.utils.telemetry import GenStats

        # The attempt body is traced exactly once (inside the loop); the
        # init value is a zeros pytree of the right structure.
        shapes = jax.eval_shape(lambda k: attempt(k, p)[:2], key)
        zeros0 = jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), shapes
        )

        def cond(c):
            _, _, ok, _, it = c
            return (~ok) & (it < max_tries)

        def body(c):
            _, _, _, key, it = c
            key, k = jax.random.split(key)
            state, codes, ok = attempt(k, p)
            return state, codes, ok, key, it + 1

        state, codes, ok, _, it = jax.lax.while_loop(
            cond,
            body,
            (*zeros0, jnp.asarray(False), key, jnp.asarray(0, jnp.int32)),
        )
        # Mark-plane materialization + verifier aux init once, on the
        # accepted layout only (hoisted out of the rejection loop).
        state = B.init_instr(p, state, codes)
        return state, GenStats(tries=it, ok=ok)

    def generate(key: jax.Array, p: EnvParams) -> EnvState:
        return generate_stats(key, p)[0]

    def generate_batch(key: jax.Array, p: EnvParams, n: int) -> EnvState:
        """Pooled oversample-and-compact generation (core/env.py contract).

        Draws M = ceil(margin * n) iid attempts in one vmapped pass and
        keeps the first n accepted — iid samples from the same
        acceptance-conditioned law the reference's regenerate loop induces
        (roomgrid_level.py:118-139), so the layout distribution is
        unchanged.  ``vmap(generate)`` instead pays the BATCH-MAX retry
        count through the lockstep while_loop (measured on BossLevel at
        16k envs: tries_max 7 vs tries_mean 1.15 — a ~6x overdraw), and
        runs the mark materialization M times rather than n.  In the
        astronomically rare shortfall (fewer than n of M accepted; margin
        is sized >= 10 sigma above the mean for registered levels)
        accepted layouts are reused cyclically rather than shipping a
        rejected one.
        """
        import math as _math

        margin = p.opt("gen_oversample") or 1.5
        M = max(n + 8, int(_math.ceil(n * margin)))
        keys = jax.random.split(key, M)
        states, codes, ok = jax.vmap(attempt, in_axes=(0, None))(keys, p)
        order = jnp.argsort(~ok)  # stable: accepted first, in draw order
        acc = jnp.sum(ok)
        idx = jnp.arange(n)
        sel = order[jnp.where(idx < acc, idx, idx % jnp.maximum(acc, 1))]
        states = jax.tree_util.tree_map(lambda x: x[sel], states)
        codes = codes[sel]
        return jax.vmap(B.init_instr, in_axes=(None, 0, 0))(p, states, codes)

    return Environment(
        env_id,
        params,
        generate,
        post_step=B.verify_step,
        post_step_lanes=B.verify_step,  # layout-polymorphic via AG helpers
        mission_text=B.surface_text,
        generate_stats=generate_stats,
        generate_batch=generate_batch,
        hook_rng=False,  # the verifier consumes no randomness
    )
