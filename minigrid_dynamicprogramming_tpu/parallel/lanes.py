"""Lane-major (batch-last) fast path for batched stepping.

Why this exists: the straightforward ``vmap``-over-leading-axis layout puts
each env's tiny ``(H, W)`` / ``(view, view)`` planes into the array's minor
two dimensions, where a layout that tiles or pads them wastes most of the
bandwidth of every observation intermediate.

Here the batch lives in the LAST dimension instead: grid planes are
``(H*W, B)``, view planes ``(view*view, B)``, per-env scalars ``(B,)``.
Every op is dense over the env batch, per-env dynamic cell access becomes a
one-hot compare + reduce over the cell axis, and the sequential visibility
sweep becomes static shifts, with identical semantics (parity-tested
against the vmapped path in tests/test_lanes.py).  Whether this layout
beats the vmapped one on a given card is measured, not assumed.

Semantics are a port of the same reference code paths as ops/step.py and
ops/obs.py (/root/reference/minigrid/minigrid_env.py:520-645,
/root/reference/minigrid/core/grid.py:244-328); see those modules for the
line-by-line derivation.  This module only re-lays-out the math.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core import struct
from minigrid_dynamicprogramming_tpu.core.constants import (
    ACT_DROP,
    ACT_FORWARD,
    ACT_LEFT,
    ACT_PICKUP,
    ACT_RIGHT,
    ACT_TOGGLE,
    COLOR_GREY,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    OBJ_WALL,
    STATE_CLOSED,
    STATE_LOCKED,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu.core.env import Environment
from minigrid_dynamicprogramming_tpu.core.state import EnvParams, EnvState
from minigrid_dynamicprogramming_tpu.ops.step import success_reward

def _dir_vec(agent_dir: jnp.ndarray):
    """DIR_TO_VEC as compare-selects (no 4-entry gather)."""
    one = jnp.ones((), jnp.int32)
    dx = jnp.where(agent_dir == 0, one, jnp.where(agent_dir == 2, -one, 0))
    dy = jnp.where(agent_dir == 1, one, jnp.where(agent_dir == 3, -one, 0))
    return dx, dy


@struct.dataclass
class LaneState:
    """Batch-last mirror of a vmapped :class:`EnvState`.

    Planes are ``(H*W, B)`` (row-major cells first, envs last);
    per-env scalars are ``(B,)``; vectors put their own axis first.
    """

    grid_obj: jnp.ndarray  # (HW, B) u8
    grid_color: jnp.ndarray  # (HW, B) u8
    grid_state: jnp.ndarray  # (HW, B) u8
    contains_obj: jnp.ndarray  # (HW, B) u8
    contains_color: jnp.ndarray  # (HW, B) u8
    marks: jnp.ndarray  # (HW, B) u16
    vmarks: jnp.ndarray  # (HW, B) u16

    agent_x: jnp.ndarray  # (B,) i32
    agent_y: jnp.ndarray  # (B,) i32
    agent_dir: jnp.ndarray  # (B,) i32
    carrying_obj: jnp.ndarray  # (B,) u8
    carrying_color: jnp.ndarray  # (B,) u8
    carrying_contains_obj: jnp.ndarray  # (B,) u8
    carrying_contains_color: jnp.ndarray  # (B,) u8
    carrying_marks: jnp.ndarray  # (B,) u16

    step_count: jnp.ndarray  # (B,) i32
    terminated: jnp.ndarray  # (B,) bool
    truncated: jnp.ndarray  # (B,) bool

    aux: jnp.ndarray  # (AUX, B) i32
    mission: jnp.ndarray  # (MS, B) i32
    rng: jnp.ndarray  # (B, 2) u32

    @property
    def agent_pos(self) -> jnp.ndarray:
        """(2, B) stack so layout-agnostic hooks can write
        ``state.agent_pos[0]`` and get the per-env x vector in both layouts
        (EnvState stores (2,) per env)."""
        return jnp.stack([self.agent_x, self.agent_y])


def to_lanes(state: EnvState) -> LaneState:
    """Vmapped (batch-first) state -> lane-major state."""
    b, h, w = state.grid_obj.shape

    def plane(x):
        return x.reshape(b, h * w).T

    return LaneState(
        grid_obj=plane(state.grid_obj),
        grid_color=plane(state.grid_color),
        grid_state=plane(state.grid_state),
        contains_obj=plane(state.contains_obj),
        contains_color=plane(state.contains_color),
        marks=plane(state.marks),
        vmarks=plane(state.vmarks),
        agent_x=state.agent_pos[:, 0],
        agent_y=state.agent_pos[:, 1],
        agent_dir=state.agent_dir,
        carrying_obj=state.carrying_obj,
        carrying_color=state.carrying_color,
        carrying_contains_obj=state.carrying_contains_obj,
        carrying_contains_color=state.carrying_contains_color,
        carrying_marks=state.carrying_marks,
        step_count=state.step_count,
        terminated=state.terminated,
        truncated=state.truncated,
        aux=state.aux.T,
        mission=state.mission.T,
        rng=state.rng,
    )


def from_lanes(params: EnvParams, ls: LaneState) -> EnvState:
    """Lane-major state -> vmapped (batch-first) state."""
    h, w = params.height, params.width

    def plane(x):
        return x.T.reshape(-1, h, w)

    return EnvState(
        grid_obj=plane(ls.grid_obj),
        grid_color=plane(ls.grid_color),
        grid_state=plane(ls.grid_state),
        contains_obj=plane(ls.contains_obj),
        contains_color=plane(ls.contains_color),
        marks=plane(ls.marks),
        vmarks=plane(ls.vmarks),
        agent_pos=jnp.stack([ls.agent_x, ls.agent_y], axis=-1),
        agent_dir=ls.agent_dir,
        carrying_obj=ls.carrying_obj,
        carrying_color=ls.carrying_color,
        carrying_contains_obj=ls.carrying_contains_obj,
        carrying_contains_color=ls.carrying_contains_color,
        carrying_marks=ls.carrying_marks,
        step_count=ls.step_count,
        terminated=ls.terminated,
        truncated=ls.truncated,
        aux=ls.aux.T,
        mission=ls.mission.T,
        rng=ls.rng,
    )


def _cell_onehot(hw: int, idx: jnp.ndarray) -> jnp.ndarray:
    """(HW, B) bool one-hot of per-env flat cell index ``idx`` (B,)."""
    iota = jnp.arange(hw, dtype=jnp.int32)[:, None]
    return iota == idx[None, :]


def _read(plane: jnp.ndarray, onehot: jnp.ndarray) -> jnp.ndarray:
    """Per-lane read ``plane[idx]`` via masked max (exactly one hit/lane)."""
    zero = jnp.zeros((), dtype=plane.dtype)
    return jnp.where(onehot, plane, zero).max(axis=0)


def _write(plane, onehot, do, val):
    """Per-lane conditional write ``plane[idx] = val where do``."""
    return jnp.where(onehot & do[None, :], val[None, :], plane)


def step_lanes(
    params: EnvParams, ls: LaneState, action: jnp.ndarray
) -> Tuple[LaneState, jnp.ndarray, jnp.ndarray]:
    """Lane-major port of ``ops.step.base_step`` + truncation.

    Core MDP only (no per-family pre/post hooks); gate with
    :func:`supports_lanes`.  Returns ``(new_state, reward, terminated)``.
    """
    w, h = params.width, params.height
    hw = h * w
    action = action.astype(jnp.int32)
    step_count = ls.step_count + 1
    # Static plane gates (registry._reg): families that can never hold a Box
    # (or a BabyAI mark) skip those planes entirely — reads become constants,
    # writes are elided, and the untouched planes ride the rollout carry for
    # free instead of costing a read+write pass per step.
    no_boxes = bool(params.opt("no_boxes", False))
    no_marks = bool(params.opt("no_marks", False))

    dx, dy = _dir_vec(ls.agent_dir)
    fx = ls.agent_x + dx
    fy = ls.agent_y + dy
    in_bounds = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    fwd_idx = jnp.clip(fy, 0, h - 1) * w + jnp.clip(fx, 0, w - 1)
    oh = _cell_onehot(hw, fwd_idx)

    u8 = jnp.uint8
    fwd_obj = jnp.where(in_bounds, _read(ls.grid_obj, oh), u8(OBJ_WALL))
    fwd_color = jnp.where(in_bounds, _read(ls.grid_color, oh), u8(0))
    fwd_state = jnp.where(in_bounds, _read(ls.grid_state, oh), u8(0))
    if no_boxes:
        fwd_contains = u8(OBJ_EMPTY)
        fwd_contains_color = u8(0)
    else:
        fwd_contains = jnp.where(
            in_bounds, _read(ls.contains_obj, oh), u8(OBJ_EMPTY)
        )
        fwd_contains_color = jnp.where(
            in_bounds, _read(ls.contains_color, oh), u8(0)
        )
    if no_marks:
        fwd_marks = jnp.zeros((), ls.marks.dtype)
    else:
        fwd_marks = jnp.where(
            in_bounds, _read(ls.marks, oh), jnp.zeros((), ls.marks.dtype)
        )

    is_left = action == ACT_LEFT
    is_right = action == ACT_RIGHT
    is_forward = action == ACT_FORWARD
    is_pickup = action == ACT_PICKUP
    is_drop = action == ACT_DROP
    is_toggle = action == ACT_TOGGLE

    new_dir = jnp.where(
        is_left,
        (ls.agent_dir + 3) % 4,
        jnp.where(is_right, (ls.agent_dir + 1) % 4, ls.agent_dir),
    )

    fwd_is_empty = fwd_obj == OBJ_EMPTY
    fwd_open_door = (fwd_obj == OBJ_DOOR) & (fwd_state == STATE_OPEN)
    # CAN_OVERLAP as compare-selects (constants.py _CAN_OVERLAP): empty,
    # floor, goal, lava overlap-able.
    can_overlap = (
        fwd_is_empty
        | (fwd_obj == 3)  # OBJ_FLOOR
        | (fwd_obj == OBJ_GOAL)
        | (fwd_obj == OBJ_LAVA)
    )
    can_enter = can_overlap | fwd_open_door
    moved = is_forward & can_enter & in_bounds
    new_x = jnp.where(moved, fx, ls.agent_x)
    new_y = jnp.where(moved, fy, ls.agent_y)
    hit_goal = is_forward & (fwd_obj == OBJ_GOAL)
    hit_lava = is_forward & (fwd_obj == OBJ_LAVA)
    terminated = hit_goal | hit_lava
    reward = jnp.where(
        hit_goal, success_reward(step_count, params.max_steps), 0.0
    )

    not_carrying = ls.carrying_obj == OBJ_EMPTY
    can_pickup = (
        (fwd_obj == OBJ_KEY) | (fwd_obj == 6) | (fwd_obj == OBJ_BOX)
    )  # key, ball, box (constants.py _CAN_PICKUP)
    do_pickup = is_pickup & can_pickup & not_carrying & in_bounds
    do_drop = is_drop & fwd_is_empty & (~not_carrying) & in_bounds

    fwd_is_door = fwd_obj == OBJ_DOOR
    key_matches = (ls.carrying_obj == OBJ_KEY) & (
        ls.carrying_color == fwd_color
    )
    do_unlock = is_toggle & fwd_is_door & (fwd_state == STATE_LOCKED) & key_matches
    do_flip = is_toggle & fwd_is_door & (fwd_state != STATE_LOCKED)
    new_door_state = jnp.where(
        do_unlock,
        u8(STATE_OPEN),
        jnp.where(
            do_flip,
            jnp.where(
                fwd_state == STATE_OPEN, u8(STATE_CLOSED), u8(STATE_OPEN)
            ),
            fwd_state,
        ),
    )
    do_open_box = is_toggle & (fwd_obj == OBJ_BOX) & in_bounds

    cell_obj = jnp.where(
        do_pickup,
        u8(OBJ_EMPTY),
        jnp.where(
            do_drop,
            ls.carrying_obj,
            jnp.where(do_open_box, fwd_contains, fwd_obj),
        ),
    )
    cell_color = jnp.where(
        do_pickup,
        u8(0),
        jnp.where(
            do_drop,
            ls.carrying_color,
            jnp.where(do_open_box, fwd_contains_color, fwd_color),
        ),
    )
    cell_state = jnp.where(
        do_pickup | do_drop | do_open_box, u8(0), new_door_state
    )
    cell_contains = jnp.where(
        do_pickup | do_open_box,
        u8(OBJ_EMPTY),
        jnp.where(do_drop, ls.carrying_contains_obj, fwd_contains),
    )
    cell_contains_color = jnp.where(
        do_pickup | do_open_box,
        u8(0),
        jnp.where(do_drop, ls.carrying_contains_color, fwd_contains_color),
    )
    zero_m = jnp.zeros((), dtype=ls.marks.dtype)
    cell_marks = jnp.where(
        do_pickup | do_open_box,
        zero_m,
        jnp.where(do_drop, ls.carrying_marks, fwd_marks),
    )

    touched = in_bounds  # the write is a no-op when the value is unchanged
    grid_obj = _write(ls.grid_obj, oh, touched, cell_obj)
    grid_color = _write(ls.grid_color, oh, touched, cell_color)
    grid_state = _write(ls.grid_state, oh, touched, cell_state)
    if no_boxes:
        contains_obj = ls.contains_obj
        contains_color = ls.contains_color
    else:
        contains_obj = _write(ls.contains_obj, oh, touched, cell_contains)
        contains_color = _write(
            ls.contains_color, oh, touched, cell_contains_color
        )
    marks = ls.marks if no_marks else _write(ls.marks, oh, touched, cell_marks)

    new_carrying_marks = jnp.where(
        do_pickup, fwd_marks, jnp.where(do_drop, zero_m, ls.carrying_marks)
    )
    new_carrying_obj = jnp.where(
        do_pickup,
        fwd_obj,
        jnp.where(do_drop, u8(OBJ_EMPTY), ls.carrying_obj),
    )
    new_carrying_color = jnp.where(
        do_pickup, fwd_color, jnp.where(do_drop, u8(0), ls.carrying_color)
    )
    new_carrying_contains = jnp.where(
        do_pickup,
        fwd_contains,
        jnp.where(do_drop, u8(OBJ_EMPTY), ls.carrying_contains_obj),
    )
    new_carrying_contains_color = jnp.where(
        do_pickup,
        fwd_contains_color,
        jnp.where(do_drop, u8(0), ls.carrying_contains_color),
    )

    # Truncation (minigrid_env.py:582-583); dynamic per-episode limits read
    # from an aux slot (BabyAI, roomgrid_level.py:76-83).
    slot = params.opt("dynamic_max_steps_slot")
    limit = params.max_steps if slot is None else ls.aux[slot]
    truncated = step_count >= limit

    new_ls = ls.replace(
        grid_obj=grid_obj,
        grid_color=grid_color,
        grid_state=grid_state,
        contains_obj=contains_obj,
        contains_color=contains_color,
        marks=marks,
        agent_x=new_x,
        agent_y=new_y,
        agent_dir=new_dir,
        carrying_obj=new_carrying_obj,
        carrying_color=new_carrying_color,
        carrying_contains_obj=new_carrying_contains,
        carrying_contains_color=new_carrying_contains_color,
        carrying_marks=new_carrying_marks,
        step_count=step_count,
        terminated=terminated,
        truncated=truncated,
    )
    return new_ls, reward, terminated


def obs_lanes(params: EnvParams, ls: LaneState):
    """Lane-major port of ``ops.obs.gen_obs_planes``: egocentric view planes
    ``(obj, color, state, vis)`` each ``(view*view, B)`` indexed
    ``vy * view + vx`` (agent at ``vy = view-1, vx = view//2`` facing up).

    The slice+rotate gather is computed SEPARABLY: because every direction's
    view maps one egocentric axis to world rows and the other to world
    columns, the 49-cell window is two chained one-hot selections (7 row
    picks over H, then 7 column picks over W) instead of 49 picks over all
    H*W cells — ~18x less work.  With ``u`` the egocentric axis indexing
    world rows and ``t`` the axis indexing world columns:

        wy(u) = ay + py*u + qy      wx(t) = ax + px*t + qx
        view[vy, vx] = grid[wy(u), wx(t)],  (u, t) = (vx, vy) for horizontal
        facing (dir 0/2), (vy, vx) for vertical facing (dir 1/3).

    The gather itself is BIT-SLICED: each cell compresses to a 7-bit code
    (door states fold into the object nibble — obj 0..10, door-open/closed/
    locked as 11/12/13 — plus 3 color bits), world rows pack 4 cells per
    uint32 word with a static (v-1)-cell wall extension on both sides (the
    OOB fill), and the per-env column window becomes ONE per-lane funnel
    shift of the selected row words instead of a W-deep compare-select
    cascade per view cell.  Direction-dependent column reversal is resolved
    at unpack time from static bit positions.  Everything runs on (B,)
    uint32 vectors, so the packing is free parallelism.
    """
    w, h = params.width, params.height
    v = params.agent_view_size
    hs = v // 2
    u8 = jnp.uint8
    u32 = jnp.uint32

    d = ls.agent_dir  # (B,)
    horiz = d % 2 == 0  # facing +x / -x
    one = jnp.ones((), jnp.int32)
    sgn = jnp.where((d == 0) | (d == 1), one, -one)  # dir 0/1: +, dir 2/3: -
    # wy(u): dir0: ay+(u-hs) | dir1: ay+(v-1-u) | dir2: ay-(u-hs) | dir3: ay-(v-1-u)
    py = jnp.where(horiz, sgn, -sgn)
    qy = ls.agent_y + jnp.where(horiz, -sgn * hs, sgn * (v - 1))
    # wx(t): dir0: ax+(v-1-t) | dir1: ax-(t-hs) | dir2: ax-(v-1-t) | dir3: ax+(t-hs)
    px = -sgn
    qx = ls.agent_x + sgn * jnp.where(horiz, v - 1, hs)

    CPW = 4  # 7-bit cells per uint32 word
    ext = v - 1  # static wall padding on both row ends (the OOB fill)
    we = w + 2 * ext  # extended row length in cells
    nwords = -(-we // CPW)
    WALL7 = OBJ_WALL | (COLOR_GREY << 4)  # Wall is grey (grid.py:136-139)
    DOOR7 = 11  # door codes 11+state (open=11, closed=12, locked=13)
    wall_word = 0
    for i in range(CPW):
        wall_word |= WALL7 << (7 * i)

    # 1. 7-bit cell codes.
    obj32 = ls.grid_obj.astype(u32)
    code = jnp.where(
        obj32 == OBJ_DOOR, DOOR7 + ls.grid_state.astype(u32), obj32
    ) | (ls.grid_color.astype(u32) << 4)
    code3 = code.reshape(h, w, -1)  # (H, W, B)

    # 2. pack extended rows: rows[r][k] (B,) u32, ext cell j = world col j-ext.
    zero_w = jnp.zeros_like(code[0])
    rows = []
    for r in range(h):
        words = []
        for k in range(nwords):
            acc = None
            const_bits = 0
            for i in range(CPW):
                j = k * CPW + i
                if j >= we:
                    const_bits |= WALL7 << (7 * i)  # pad tail as wall too
                    continue
                c = j - ext
                if 0 <= c < w:
                    term = code3[r, c] << (7 * i)
                    acc = term if acc is None else acc | term
                else:
                    const_bits |= WALL7 << (7 * i)
            if acc is None:
                words.append(zero_w + u32(const_bits))
            elif const_bits:
                words.append(acc | u32(const_bits))
            else:
                words.append(acc)
        rows.append(words)

    # 3. stage 1: select the v world rows (OOB rows -> all-wall words).
    sel = []  # sel[u][k] : (B,) u32
    for u in range(v):
        wy = py * u + qy  # (B,)
        accs = [zero_w + u32(wall_word) for _ in range(nwords)]
        for r in range(h):
            hit = wy == r
            accs = [jnp.where(hit, rows[r][k], a) for k, a in enumerate(accs)]
        sel.append(accs)

    # 4. stage 2: funnel-shift the v-cell column window out of each row.
    # Window world cols are qx+px*t; in ext-cell coordinates the FORWARD
    # (ascending-col) window starts at s = qx + (0 if px<0 else ext), and a
    # px<0 view reads it reversed (resolved at unpack).  s in [0, w+ext-1].
    rev = px < 0
    s = qx + jnp.where(rev, 0, ext)  # (B,) i32
    k0 = s // CPW
    bsh = ((s % CPW) * 7).astype(u32)  # (B,) u32 bit shift within word
    csh = u32(7 * CPW) - bsh  # complement shift (<=28 < 32: no UB)
    nout = -(-v // CPW)  # output words per window
    MASK28 = u32((1 << (7 * CPW)) - 1)
    window = []  # window[u][j] : (B,) u32, cells 4j..4j+3 of the window
    for u in range(v):
        padded = sel[u] + [zero_w, zero_w]  # k0+j+1 may run past the row
        # gather padded[k0+j] for j in 0..nout by one cascade over k0
        gs = []
        for j in range(nout + 1):
            g = padded[j]
            for kk in range(1, nwords):
                if kk + j < len(padded):
                    g = jnp.where(k0 == kk, padded[kk + j], g)
            gs.append(g)
        outs = []
        for j in range(nout):
            outj = ((gs[j] >> bsh) | (gs[j + 1] << csh)) & MASK28
            outs.append(outj)
        window.append(outs)

    # 5. orientation-aware unpack: cell (vy,vx) reads window[u] at the
    # static bit of t or (v-1-t) depending on the reversal lane bit.
    def _extract(u, t):
        return (window[u][t // CPW] >> (7 * (t % CPW))) & 0x7F

    cells = []
    for vy in range(v):
        for vx in range(v):
            eh = jnp.where(rev, _extract(vx, v - 1 - vy), _extract(vx, vy))
            ev = jnp.where(rev, _extract(vy, v - 1 - vx), _extract(vy, vx))
            cells.append(jnp.where(horiz, eh, ev))
    view = jnp.stack(cells)  # (VV, B) u32 of 7-bit codes

    # 6. decode codes back to the wire-format planes.
    c4 = view & 0xF
    is_door = c4 >= DOOR7
    obj = jnp.where(is_door, u32(OBJ_DOOR), c4).astype(u8)
    obj_state = jnp.where(is_door, c4 - DOOR7, u32(0)).astype(u8)
    color = (view >> 4).astype(u8)

    if params.see_through_walls:
        vis = jnp.ones(obj.shape, dtype=bool)
    else:
        # not-see iff wall, or closed/locked door (codes 12, 13).
        blocked = (c4 == OBJ_WALL) | (c4 >= DOOR7 + STATE_CLOSED)
        vis = _process_vis_lanes(~blocked, v)

    # Carried-object overlay at the agent cell (minigrid_env.py:618-625).
    agent_cell = (v - 1) * v + hs
    obj = obj.at[agent_cell].set(ls.carrying_obj)
    color = color.at[agent_cell].set(
        jnp.where(ls.carrying_obj == OBJ_EMPTY, u8(0), ls.carrying_color)
    )
    obj_state = obj_state.at[agent_cell].set(u8(0))
    return obj, color, obj_state, vis


def _process_vis_lanes(see: jnp.ndarray, v: int) -> jnp.ndarray:
    """Lane-major port of the reference's sequential visibility sweep
    (grid.py:291-328); see ops.obs.process_vis for the derivation.  ``see``
    is ``(v*v, B)`` bool; the result is the same shape.

    Each view ROW is packed into v bits of one (B,) uint32 bitboard, so the
    left/right OR-cascades are per-env bit shifts instead of cell-axis
    concatenates (which cost a relayout each) — the whole sweep runs on
    v uint32 vectors of B lanes."""
    assert v <= 16, "row bitboard packs 2 rows of <=16 bits per uint32 word"
    u32 = jnp.uint32
    row_mask = u32((1 << v) - 1)

    # Pack: sees[j] bit i = see[j*v + i].
    sees = [
        jnp.zeros_like(see[0], dtype=u32)
        for _ in range(v)
    ]
    for j in range(v):
        acc = see[j * v].astype(u32)
        for i in range(1, v):
            acc = acc | (see[j * v + i].astype(u32) << i)
        sees[j] = acc

    rows = [jnp.zeros_like(sees[0]) for _ in range(v)]
    rows[v - 1] = jnp.full_like(sees[0], u32(1 << (v // 2)))

    not_last = u32(row_mask ^ (1 << (v - 1)))
    not_first = u32(row_mask ^ 1)
    for j in reversed(range(v)):
        row, see_row = rows[j], sees[j]
        for _ in range(v - 1):
            row = row | (((row & see_row) << 1) & row_mask)
        cond1 = row & see_row & not_last
        for _ in range(v - 1):
            row = row | ((row & see_row) >> 1)
        cond2 = row & see_row & not_first
        rows[j] = row
        if j > 0:
            rows[j - 1] = (
                rows[j - 1]
                | cond1
                | ((cond1 << 1) & row_mask)
                | cond2
                | (cond2 >> 1)
            )

    # Unpack back to (v*v, B) bool.
    bits = [
        ((rows[j] >> i) & 1).astype(bool) for j in range(v) for i in range(v)
    ]
    return jnp.stack(bits)


def obs_image_lanes(params: EnvParams, ls: LaneState) -> jnp.ndarray:
    """(B, view, view, 3) uint8 batch in the reference's ``[x, y]`` layout —
    bitwise-identical to ``vmap(gen_obs_image)`` on the equivalent state."""
    v = params.agent_view_size
    obj, color, obj_state, vis = obs_lanes(params, ls)
    img = jnp.stack([obj, color, obj_state], axis=1)  # (VV, 3, B)
    img = jnp.where(vis[:, None, :], img, jnp.uint8(0))
    img = img.reshape(v, v, 3, -1)  # [vy, vx, 3, B]
    return jnp.transpose(img, (3, 1, 0, 2))  # [B, vx, vy, 3]


def supports_lanes(env: Environment) -> bool:
    """True when the env's semantics are fully covered by the lane kernels:
    core MDP plus lane-capable hooks (``pre_step_lanes``/``post_step_lanes``
    — layout-polymorphic hooks register the same function for both layouts;
    ``action_map`` is elementwise and always lane-safe)."""
    return (env.pre_step is None or env.pre_step_lanes is not None) and (
        env.post_step is None or env.post_step_lanes is not None
    )


def step_lanes_env(
    env: Environment,
    keys,
    ls: LaneState,
    action: jnp.ndarray,
) -> Tuple[LaneState, jnp.ndarray, jnp.ndarray]:
    """Lane-major mirror of :meth:`Environment.step` including the per-family
    hooks (the reference's per-subclass ``step`` overrides).

    ``keys`` is a per-env ``(B, 2)`` key array (or None for hook-free envs);
    it is split exactly like the vmapped path splits its per-env key, so the
    two paths are bit-identical under the same keys.  Returns
    ``(new_state, reward, terminated)``; ``truncated`` lives on the state.
    """
    params = env.params
    if env.action_map is not None:
        action = env.action_map(params, action)
    prev = ls
    if env.pre_step_lanes is not None or env.post_step_lanes is not None:
        if keys is None or not env.hook_rng:
            k_pre = k_post = None
        else:
            ks = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
            k_pre, k_post = ks[:, 0], ks[:, 1]
    if env.pre_step_lanes is not None:
        ls = env.pre_step_lanes(params, k_pre, ls, action)
    ls, reward, term = step_lanes(params, ls, action)
    if env.post_step_lanes is not None:
        ls, reward, term = env.post_step_lanes(
            params, k_post, prev, ls, action, reward, term
        )
        ls = ls.replace(terminated=term)
    return ls, reward, term


class LaneRolloutResult(NamedTuple):
    final_state: LaneState
    total_reward: jnp.ndarray  # () f32
    episodes: jnp.ndarray  # () i32
    steps: jnp.ndarray  # () i32
    obs_checksum: jnp.ndarray  # () u32 — wrap-around tag keeping the obs encoder live
    resets_per_env: jnp.ndarray  # (B,) i32 — episode resets per lane (for
    # per-device episode accounting in sharded runs)


# LaneState fields whose batch axis is FIRST instead of last.
_BATCH_FIRST_FIELDS = ("rng",)


def _bcast_done(done, leaf, batch_first: bool):
    if batch_first:
        return done.reshape(done.shape + (1,) * (leaf.ndim - 1))
    return done.reshape((1,) * (leaf.ndim - 1) + done.shape)


def _select_lanes(
    done, fresh: LaneState, cur: LaneState, skip: tuple = ()
) -> LaneState:
    """Per-lane ``where(done, fresh, cur)`` respecting each field's layout.

    Fields in ``skip`` pass the current value through untouched — used for
    planes that are statically constant for the env family (registry plane
    gates), where ``fresh == cur`` by invariant."""
    out = {}
    for name in fresh.__dataclass_fields__:
        a, b = getattr(fresh, name), getattr(cur, name)
        if name in skip:
            out[name] = b
            continue
        out[name] = jnp.where(
            _bcast_done(done, a, name in _BATCH_FIRST_FIELDS), a, b
        )
    return LaneState(**out)


def _select_pool(pool, r_idx: jnp.ndarray, rounds: int) -> LaneState:
    """Pick per-lane pool round: pool leaves are (R, ...field-shape...)."""
    out = {}
    for name in LaneState.__dataclass_fields__:
        leaf = getattr(pool, name)
        batch_first = name in _BATCH_FIRST_FIELDS
        picked = leaf[0]
        for r in range(1, rounds):
            sel = _bcast_done(r_idx == r, leaf[0], batch_first)
            picked = jnp.where(sel, leaf[r], picked)
        out[name] = picked
    return LaneState(**out)


def lane_sharding(mesh, field: str, ndim: int, extra_leading: int = 0):
    """NamedSharding for one LaneState field: envs (the LAST axis for planes
    and scalars, axis -2 for ``rng``) sharded over the mesh's ``env`` axis.

    ``extra_leading`` accounts for stacked leading axes (e.g. the pool's
    rounds axis)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    if field in _BATCH_FIRST_FIELDS:  # rng: (..., B, 2)
        spec = (None,) * (extra_leading + ndim - 2) + ("env", None)
    else:  # (..., B)
        spec = (None,) * (extra_leading + ndim - 1) + ("env",)
    return NamedSharding(mesh, P(*spec))


def shard_lanes(ls: LaneState, mesh, extra_leading: int = 0) -> LaneState:
    """Constrain every field of a lane-major state to env-axis sharding
    (usable both outside jit as device_put and inside as a constraint)."""
    out = {}
    for name in ls.__dataclass_fields__:
        leaf = getattr(ls, name)
        sh = lane_sharding(mesh, name, leaf.ndim - extra_leading, extra_leading)
        out[name] = jax.lax.with_sharding_constraint(leaf, sh)
    return LaneState(**out)


def lane_rollout(
    env: Environment,
    key: jax.Array,
    batch_size: int,
    horizon: int = 256,
    autoreset: str = "pool",
    pool_rounds: int = 4,
    mesh=None,
) -> LaneRolloutResult:
    """Random-policy rollout on the lane-major fast path.

    Auto-reset modes:

    * ``"pool"`` — pregenerate ``pool_rounds`` full layout batches; the k-th
      reset of a slot draws round ``k % pool_rounds``.  Fresh layouts per
      episode (pool_rounds * batch_size distinct layouts per rollout) at
      pure-select cost per step.
    * ``"cached"`` — each slot replays its initial layout.

    The observation encoder runs every step and is folded into
    ``obs_checksum`` so the compiler cannot dead-code-eliminate it — the
    reported steps/s includes obs generation, like the reference's ``step``.

    Generation and the scan compile as ONE program, so XLA may fuse and
    schedule the pool build with the first steps.
    """
    k_init, k_scan = jax.random.split(key)
    return _lane_run(
        env, k_init, k_scan, batch_size, horizon, autoreset, pool_rounds, mesh
    )


@partial(jax.jit, static_argnums=(0, 3, 4, 5, 6, 7))
def _lane_run(
    env: Environment,
    k_init: jax.Array,
    k_scan: jax.Array,
    batch_size: int,
    horizon: int,
    autoreset: str,
    pool_rounds: int,
    mesh=None,
) -> LaneRolloutResult:
    pool = _lane_pool(env, k_init, batch_size, autoreset, pool_rounds, mesh)
    return _lane_scan(
        env, k_scan, pool, batch_size, horizon, autoreset, pool_rounds, mesh
    )


def _lane_pool(
    env: Environment,
    k_init: jax.Array,
    batch_size: int,
    autoreset: str,
    pool_rounds: int,
    mesh=None,
):
    assert supports_lanes(env), env.env_id
    rounds = pool_rounds if autoreset == "pool" else 1
    if env.generate_batch is not None:
        # Oversample-and-compact pooled generation (core/env.py): avoids
        # paying the batch-max whole-episode retry count that vmap's
        # lockstep while_loop imposes on rejection-heavy generators.
        pool_b = env.generate_batch(k_init, env.params, rounds * batch_size)
    else:
        init_keys = jax.random.split(k_init, rounds * batch_size)
        pool_b = jax.vmap(env.generate, in_axes=(0, None))(
            init_keys, env.params
        )
    pool = jax.tree_util.tree_map(
        lambda x: x.reshape((rounds,) + (batch_size,) + x.shape[1:]),
        pool_b,
    )
    pool = jax.vmap(to_lanes)(pool)  # leaves: (R, ..., B)
    if mesh is not None:
        # Env axis sharded over the mesh; generation/stepping then runs
        # fully parallel with zero cross-device communication (envs are
        # independent) and collectives appear only in the final reductions.
        pool = shard_lanes(pool, mesh, extra_leading=1)
    return pool


def _lane_scan(
    env: Environment,
    k_scan: jax.Array,
    pool,
    batch_size: int,
    horizon: int,
    autoreset: str,
    pool_rounds: int,
    mesh=None,
) -> LaneRolloutResult:
    rounds = pool_rounds if autoreset == "pool" else 1
    init_ls = jax.tree_util.tree_map(lambda x: x[0], pool)

    hooked = (
        env.pre_step_lanes is not None or env.post_step_lanes is not None
    ) and env.hook_rng

    skip = ()
    if env.params.opt("no_boxes", False):
        skip += ("contains_obj", "contains_color")
    if env.params.opt("no_marks", False):
        skip += ("marks", "vmarks")
    if env.params.opt("fixed_mission", False):
        skip += ("mission",)
    if env.params.opt("fixed_aux", False):
        skip += ("aux",)

    def body(carry, key_t):
        ls, reset_count = carry
        k_act, k_env = jax.random.split(key_t)
        actions = jax.random.randint(
            k_act, (batch_size,), 0, env.action_dim
        )
        keys = (
            jax.random.split(k_env, batch_size) if hooked else None
        )
        ls, reward, term = step_lanes_env(env, keys, ls, actions)
        done = term | ls.truncated
        reset_count = reset_count + done.astype(jnp.int32)
        if autoreset == "pool":
            fresh = _select_pool(pool, reset_count % rounds, rounds)
        elif autoreset == "cached":
            fresh = init_ls
        else:
            raise ValueError(f"unknown autoreset mode {autoreset!r}")
        ls = _select_lanes(done, fresh, ls, skip)
        # Full observation encode every step, checksummed in lane layout so
        # nothing is dead-code-eliminated and nothing transposes batch-first.
        obj, color, obj_state, vis = obs_lanes(env.params, ls)
        visu = vis.astype(jnp.uint8)
        # uint32 wrap-around tag (not a stable checksum): its only job is to
        # keep the obs encoder live against DCE; wrapping is by design.
        checksum = (
            (obj * visu).astype(jnp.uint32)
            + (color * visu).astype(jnp.uint32)
            + (obj_state * visu).astype(jnp.uint32)
        ).sum(dtype=jnp.uint32)
        return (ls, reset_count), (reward.sum(), done.sum(), checksum)

    (final_ls, reset_count), (rewards, dones, checksums) = jax.lax.scan(
        body,
        (init_ls, jnp.zeros((batch_size,), jnp.int32)),
        jax.random.split(k_scan, horizon),
    )
    return LaneRolloutResult(
        final_state=final_ls,
        total_reward=rewards.sum(),
        episodes=dones.sum().astype(jnp.int32),
        steps=jnp.asarray(batch_size * horizon, dtype=jnp.int32),
        obs_checksum=checksums.sum(dtype=jnp.uint32),
        resets_per_env=reset_count,
    )
