"""BabyAI language core: flattened instructions + device-side verifier.

Batched re-derivation of the reference BabyAI stack
(/root/reference/minigrid/envs/babyai/core/verifier.py,
roomgrid_level.py).  The reference builds a tree of ``Instr`` objects whose
``verify(action)`` walks Python object identity sets each step; here the
instruction is a flat 48-int code vector stored in ``state.mission`` and the
per-step verification is one branchless kernel fused into ``post_step``.

The full grammar of ``LevelGen.rand_instr`` (levelgen.py:157-210) is::

    instr  ::= clause | Before(clause, clause) | After(clause, clause)
    clause ::= leaf | And(leaf, leaf)
    leaf   ::= GoTo(d) | Open(d) | Pickup(d) | PutNext(d, d)

so the flat layout holds 2 clauses x 2 leaves x 2 descriptors:

    [0]  comb         0 = single-clause, 1 = before, 2 = after
    [1]  comb_strict
    clause X at {A: 2, B: 25}, 23 slots:
      [+0]   nand     0 = single leaf, 1 = and-pair (AndInstr)
      leaf L at {0: +1, 1: +12}, 11 slots:
        [+0] kind     0 none, 1 goto, 2 open, 3 pickup, 4 putnext
        [+1] strict
        [+2..5]  d1:  type, color, loc, plural
        [+6..9]  d2:  type, color, loc, plural   (putnext only)
    type: object-type index (4 door, 5 key, 6 ball, 7 box), 0 = any
    color: 0..5, 6 = any;  loc: 0 none, 1 left, 2 right, 3 front, 4 behind

A top-level ``AndInstr`` is encoded as comb = single with an and-pair clause.

Object identity (``ObjDesc.obj_set``, verifier.py:104-169) becomes *bit
planes*: descriptor slot k (of 8) owns bit k of ``state.marks`` — set on the
cells of matching objects at reset and carried along through pickup/drop by
the base transition kernel.  ``state.vmarks`` is the verifier's *position
snapshot* (``obj_poss``), refreshed from ``marks`` only on reset and on drop
actions, reproducing the reference's stale-position semantics
(roomgrid_level.py:89-91).  Bits 8..11 track each leaf's ``preCarrying``
object (verifier.py:336-359, :385-433).

Verifier aux slots: top-level clause dones, per-leaf dones (for and-pairs),
per-leaf pc_none flags, and the per-episode step limit
(roomgrid_level.py:76-83).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from minigrid_dynamicprogramming_tpu.core.constants import (
    ACT_DONE,
    ACT_DROP,
    ACT_PICKUP,
    ACT_TOGGLE,
    DIR_TO_VEC_ARR,
    OBJ_DOOR,
    OBJ_EMPTY,
    STATE_OPEN,
)
from minigrid_dynamicprogramming_tpu.core.state import EnvParams, EnvState
from minigrid_dynamicprogramming_tpu.ops import agnostic as AG

# -- instruction encodings ---------------------------------------------------

COMB_SINGLE, COMB_BEFORE, COMB_AFTER = 0, 1, 2
KIND_NONE, KIND_GOTO, KIND_OPEN, KIND_PICKUP, KIND_PUTNEXT = 0, 1, 2, 3, 4
LOC_NONE, LOC_LEFT, LOC_RIGHT, LOC_FRONT, LOC_BEHIND = 0, 1, 2, 3, 4
COLOR_ANY = 6
TYPE_ANY = 0

CLAUSE_OFF = (2, 25)  # mission offset of clause A / B
LEAF_OFF = (1, 12)  # offset of leaf 0 / 1 within a clause

# verifier aux slots
AUX_A_DONE = 12
AUX_B_DONE = 13
AUX_LEAF_DONE = 14  # .. 17 (clause*2 + leaf)
AUX_PC_NONE = 18  # .. 21
AUX_MAX_STEPS = 22
# BABYAI_DONE_ACTIONS mode (verifier.py:25, :230-243): bit i of this slot is
# leaf i's "lastStepMatch" — the instruction was satisfied on the previous
# verified step, so a `done` action now succeeds.
AUX_LAST_MATCH = 23

# mark bits: desc slot = ((clause*2 + leaf)*2 + d); remember bit per leaf.
N_DESC = 8


def desc_bit(clause: int, leaf: int, d: int) -> int:
    return 1 << ((clause * 2 + leaf) * 2 + d)


def remember_bit(clause: int, leaf: int) -> int:
    return 1 << (N_DESC + clause * 2 + leaf)


OBJ_TYPE_NAMES = {4: "door", 5: "key", 6: "ball", 7: "box"}
COLOR_NAMES6 = ["red", "green", "blue", "purple", "yellow", "grey"]
LOC_SUFFIX = {
    LOC_LEFT: " on your left",
    LOC_RIGHT: " on your right",
    LOC_FRONT: " in front of you",
    LOC_BEHIND: " behind you",
}


def clause(kind, strict=0, d1=(0, COLOR_ANY, 0), d2=(0, COLOR_ANY, 0)):
    """One LEAF block (10 ints; plural flags filled by init_instr)."""
    return [kind, strict, d1[0], d1[1], d1[2], 0, d2[0], d2[1], d2[2], 0]


leaf = clause  # alias: a 10-int leaf block


def and_pair(leaf_a, leaf_b):
    """An and-pair clause (AndInstr of two leaves)."""
    return ("and", list(leaf_a), list(leaf_b))


def _clause_block(c):
    """Normalize a clause spec (leaf block or and_pair) to 23 ints."""
    if c is None:
        return [0] + [0] * 11 + [0] * 11
    if isinstance(c, tuple) and c[0] == "and":
        return [1] + list(c[1]) + [0] + list(c[2]) + [0]
    return [0] + list(c) + [0] + [0] * 11


def instr_codes(comb, clause_a, clause_b=None, strict=0):
    """Full 48-int mission code vector."""
    vals = (
        [comb, strict] + _clause_block(clause_a) + _clause_block(clause_b)
    )
    return jnp.asarray(vals, dtype=jnp.int32)


# -- code-vector field accessors ----------------------------------------------


def _leaf_base(c: int, l: int) -> int:
    return CLAUSE_OFF[c] + LEAF_OFF[l]


def _desc_base(c: int, l: int, d: int) -> int:
    return _leaf_base(c, l) + 2 + d * 4


def leaf_kind(codes, c: int, l: int):
    return codes[_leaf_base(c, l)]


def leaf_strict(codes, c: int, l: int):
    return codes[_leaf_base(c, l) + 1]


def clause_is_and(codes, c: int):
    return codes[CLAUSE_OFF[c]] == 1


def desc_fields(codes, c: int, l: int, d: int):
    b = _desc_base(c, l, d)
    return codes[b], codes[b + 1], codes[b + 2]


# -- descriptor matching (ObjDesc.find_matching_objs, verifier.py:104-169) ---


def room_inside_mask(params: EnvParams, pos) -> jnp.ndarray:
    """(H, W) bool — cells inside the room containing ``pos``
    (RoomGrid.room_from_pos + Room.pos_inside, roomgrid.py:43-49, :110-121)."""
    rs = params.opt("room_size", 8)
    x, y = pos[0], pos[1]
    ri = x // (rs - 1)
    rj = y // (rs - 1)
    top_x, top_y = ri * (rs - 1), rj * (rs - 1)
    ys = jnp.arange(params.height)[:, None]
    xs = jnp.arange(params.width)[None, :]
    return (xs >= top_x) & (xs < top_x + rs) & (ys >= top_y) & (ys < top_y + rs)


def desc_match_mask(
    params: EnvParams, state: EnvState, dtype, dcolor, dloc
) -> jnp.ndarray:
    """(H, W) bool — cells whose object matches (type, color, loc), with loc
    evaluated relative to the agent's current pos/dir and restricted to the
    agent's room (verifier.py:141-163)."""
    obj = state.grid_obj
    m = obj != OBJ_EMPTY  # type None matches any object (verifier.py:133)
    m &= (dtype == TYPE_ANY) | (obj == dtype.astype(jnp.uint8))
    m &= (dcolor == COLOR_ANY) | (state.grid_color == dcolor.astype(jnp.uint8))

    h, w = obj.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    vx = xs - state.agent_pos[0]
    vy = ys - state.agent_pos[1]
    d1 = DIR_TO_VEC_ARR[state.agent_dir]
    d2x, d2y = -d1[1], d1[0]
    dot1 = vx * d1[0] + vy * d1[1]
    dot2 = vx * d2x + vy * d2y
    loc_ok = jnp.where(
        dloc == LOC_LEFT,
        dot2 < 0,
        jnp.where(
            dloc == LOC_RIGHT,
            dot2 > 0,
            jnp.where(
                dloc == LOC_FRONT,
                dot1 > 0,
                jnp.where(dloc == LOC_BEHIND, dot1 < 0, True),
            ),
        ),
    )
    in_room = room_inside_mask(params, state.agent_pos)
    m &= jnp.where(dloc == LOC_NONE, True, loc_ok & in_room)
    return m


def leaf_active(codes, c: int, l: int):
    return leaf_kind(codes, c, l) != KIND_NONE


def desc_active(codes, c: int, l: int, d: int):
    kind = leaf_kind(codes, c, l)
    return (kind != KIND_NONE) & ((d == 0) | (kind == KIND_PUTNEXT))


def num_navs(codes) -> jnp.ndarray:
    """roomgrid_level.py:215-235: putnext counts 2, other leaves 1, And/seq
    combinators sum."""
    total = jnp.asarray(0, jnp.int32)
    for c in range(2):
        for l in range(2):
            kind = leaf_kind(codes, c, l)
            total += jnp.where(
                kind == KIND_NONE, 0, jnp.where(kind == KIND_PUTNEXT, 2, 1)
            )
    return total


def active_desc_slots(params: EnvParams):
    """(c, l, d) descriptor slots this family can populate, from the static
    instruction profile (all eight when no profile narrows it)."""
    profile = params.opt("instr_profile") or GENERIC_PROFILE
    leaf_kinds = profile[1:]
    slots = []
    for c in range(2):
        for l in range(2):
            kinds = leaf_kinds[c * 2 + l]
            if not kinds:
                continue
            slots.append((c, l, 0))
            if "putnext" in kinds:
                slots.append((c, l, 1))
    return slots


def init_instr(params: EnvParams, state: EnvState, codes) -> EnvState:
    """Resolve descriptors into mark bits, set mission codes + plural flags,
    initialize verifier aux state and the per-episode step limit.  Only the
    profile's active descriptor slots are traced."""
    codes = jnp.asarray(codes, dtype=jnp.int32)
    marks = jnp.zeros_like(state.marks)
    for c, l, d in active_desc_slots(params):
        dtype, dcolor, dloc = desc_fields(codes, c, l, d)
        m = desc_match_mask(params, state, dtype, dcolor, dloc)
        m &= desc_active(codes, c, l, d)
        bit = desc_bit(c, l, d)
        marks = marks | jnp.where(m, jnp.uint16(bit), jnp.uint16(0))
        plural = (jnp.sum(m) > 1).astype(jnp.int32)
        codes = codes.at[_desc_base(c, l, d) + 3].set(plural)

    rs = params.opt("room_size", 8)
    nav_time_maze = rs * rs * params.opt("num_rows", 3) * params.opt("num_cols", 3)
    max_steps = jnp.where(
        params.opt("fixed_max_steps", False),
        params.max_steps,
        num_navs(codes) * nav_time_maze,
    )

    aux = state.aux
    aux = aux.at[AUX_A_DONE].set(0).at[AUX_B_DONE].set(0)
    for i in range(4):
        aux = aux.at[AUX_LEAF_DONE + i].set(0)
        aux = aux.at[AUX_PC_NONE + i].set(1)
    aux = aux.at[AUX_MAX_STEPS].set(max_steps.astype(jnp.int32))
    aux = aux.at[AUX_LAST_MATCH].set(0)
    return state.replace(
        marks=marks,
        vmarks=marks,
        carrying_marks=jnp.zeros((), dtype=marks.dtype),
        mission=codes,
        aux=aux,
    )


# -- per-step verification (the post_step hook) ------------------------------


def _bit(x, bit):
    return (x.astype(jnp.int32) & bit) > 0


# All leaf kinds a slot may take when no static profile narrows it.
_ALL_KINDS = ("goto", "open", "pickup", "putnext")

# Static instruction profile: (combs, leaf00, leaf01, leaf10, leaf11) where
# combs ⊆ ("single","before","after") and each leaf entry is the tuple of
# kinds that slot can take for this env id (empty = the slot is never
# active).  Stored in params.extra so jit specializes verify_step per
# family — a GoToLocal batch pays one front-cell probe instead of the full
# 4-leaf PutNext plane machinery.
GENERIC_PROFILE = (
    ("single", "before", "after"),
    _ALL_KINDS, _ALL_KINDS, _ALL_KINDS, _ALL_KINDS,
)


def single_profile(*kinds):
    """Profile of a mission that is always one ActionInstr (no combinators)."""
    return (("single",), tuple(kinds), (), (), ())


def _front_cell(params, new):
    """Shared front-cell probe: (in_bounds, obj, state, marks, vmarks).
    Leaf-independent — computed once per verify_step (each lane-layout read
    is a full-plane one-hot reduction)."""
    h, w = params.height, params.width
    ax, ay = AG.agent_xy(new)
    dx, dy = AG.dir_vec(new.agent_dir)
    fwx, fwy = ax + dx, ay + dy
    fin = (fwx >= 0) & (fwx < w) & (fwy >= 0) & (fwy < h)
    fx = jnp.clip(fwx, 0, w - 1)
    fy = jnp.clip(fwy, 0, h - 1)
    return (
        fin,
        AG.read_cell(params, new, "grid_obj", fx, fy),
        AG.read_cell(params, new, "grid_state", fx, fy),
        AG.read_cell(params, new, "marks", fx, fy),
        AG.read_cell(params, new, "vmarks", fx, fy),
    )


def _leaf_eval(params, new, action, codes, c, l, pc_none, front, kinds):
    """Evaluate one leaf without committing state: returns
    (result in {0 cont, 1 succ, 2 fail}, new_pc_none, marks', carrying')
    with the updated remembered-object bit (applied only if evaluated).

    Layout-polymorphic: runs per-env on ``EnvState`` (vmapped) and natively
    batched on the lane-major ``LaneState`` via the ops/agnostic.py helpers.
    ``kinds`` is the slot's static kind set — branches for impossible kinds
    are not traced at all.
    """
    kind = leaf_kind(codes, c, l)
    strict = leaf_strict(codes, c, l)
    bit1 = desc_bit(c, l, 0)
    bit2 = desc_bit(c, l, 1)
    rbit = remember_bit(c, l)
    fin, f_obj, f_state, f_marks, f_vmarks = front

    is_toggle = action == ACT_TOGGLE
    is_pickup = action == ACT_PICKUP
    is_drop = action == ACT_DROP
    carrying_now = new.carrying_obj != OBJ_EMPTY
    F = jnp.zeros((), jnp.bool_)

    # GoTo (verifier.py:307-314): agent faces a tracked position.
    goto_succ = (fin & _bit(f_vmarks, bit1)) if "goto" in kinds else F

    # Open (verifier.py:268-285).
    if "open" in kinds:
        f_is_door = fin & (f_obj == OBJ_DOOR)
        open_succ = (
            is_toggle & f_is_door & _bit(f_marks, bit1) & (f_state == STATE_OPEN)
        )
        open_fail = (strict == 1) & is_toggle & f_is_door & ~open_succ
    else:
        open_succ = open_fail = F

    # Pickup (verifier.py:341-361).
    if "pickup" in kinds:
        pick_succ = is_pickup & (pc_none == 1) & _bit(new.carrying_marks, bit1)
        pick_fail = (strict == 1) & is_pickup & carrying_now & ~pick_succ
    else:
        pick_succ = pick_fail = F

    # PutNext (verifier.py:409-433): the remembered object must be a tracked
    # mover now lying on the grid with a tracked fixed object 4-adjacent.
    if "putnext" in kinds:
        rem_move = _bit(new.marks, rbit) & _bit(new.marks, bit1)  # cell plane
        fixed = _bit(new.vmarks, bit2)
        up = AG.shift_cells(params, new, fixed, 0, -1)
        down = AG.shift_cells(params, new, fixed, 0, 1)
        left = AG.shift_cells(params, new, fixed, -1, 0)
        right = AG.shift_cells(params, new, fixed, 1, 0)
        put_succ = is_drop & AG.reduce_any_cells(
            params, new, rem_move & (up | down | left | right)
        )
        put_fail = (strict == 1) & is_pickup & carrying_now
    else:
        put_succ = put_fail = F

    if len(kinds) == 1:  # static dispatch: the slot has exactly one kind
        k0 = kinds[0]
        succ = {"goto": goto_succ, "open": open_succ,
                "pickup": pick_succ, "putnext": put_succ}[k0]
        fail = ~succ & {"goto": F, "open": open_fail,
                        "pickup": pick_fail, "putnext": put_fail}[k0]
    else:
        succ = jnp.where(
            kind == KIND_GOTO,
            goto_succ,
            jnp.where(
                kind == KIND_OPEN,
                open_succ,
                jnp.where(
                    kind == KIND_PICKUP,
                    pick_succ,
                    jnp.where(kind == KIND_PUTNEXT, put_succ, False),
                ),
            ),
        )
        fail = ~succ & jnp.where(
            kind == KIND_OPEN,
            open_fail,
            jnp.where(
                kind == KIND_PICKUP,
                pick_fail,
                jnp.where(kind == KIND_PUTNEXT, put_fail, False),
            ),
        )
    res = jnp.where(succ, 1, jnp.where(fail, 2, 0))

    # On evaluation, remember the current carrying
    # (preCarrying <- env.carrying, verifier.py:343-344).  Leaves that can
    # never track a carried object skip the plane updates statically.
    may_track = ("pickup" in kinds) or ("putnext" in kinds)
    if not may_track:
        return res, pc_none, new.marks, new.carrying_marks
    always_track = all(k in ("pickup", "putnext") for k in kinds)
    if always_track:
        tracks_carry = True
    else:
        tracks_carry = (kind == KIND_PICKUP) | (kind == KIND_PUTNEXT)
    new_pc_none = jnp.where(tracks_carry, (~carrying_now).astype(jnp.int32), pc_none)
    rbit16 = jnp.asarray(rbit, dtype=new.marks.dtype)
    marks_clear = new.marks & ~rbit16
    cm_clear = new.carrying_marks & ~rbit16
    cm_set = jnp.where(carrying_now, cm_clear | rbit16, cm_clear)
    if always_track:
        marks_upd, cm_upd = marks_clear, cm_set
    else:
        marks_upd = jnp.where(tracks_carry, marks_clear, new.marks)
        cm_upd = jnp.where(tracks_carry, cm_set, new.carrying_marks)
    return res, new_pc_none, marks_upd, cm_upd


def verify_step(
    params: EnvParams,
    key,
    prev: EnvState,
    new: EnvState,
    action,
    reward,
    terminated,
):
    """RoomGridLevel.step's verifier pass (roomgrid_level.py:86-103), fully
    branchless over the instruction codes."""
    action = jnp.asarray(action, dtype=jnp.int32)
    codes = new.mission
    comb = codes[0]
    comb_strict = codes[1]
    aux = new.aux

    # Static per-family instruction shape (set by make_level); narrows the
    # traced program to the kinds/slots this env id can actually emit.
    profile = params.opt("instr_profile") or GENERIC_PROFILE
    combs, leaf_kinds = profile[0], profile[1:]

    # update_objs_poss on drop actions (roomgrid_level.py:89-91); vmarks is
    # only read by goto/putnext leaves, so other families skip the update.
    if any(("goto" in ks) or ("putnext" in ks) for ks in leaf_kinds):
        new = new.replace(
            vmarks=jnp.where(action == ACT_DROP, new.marks, new.vmarks)
        )

    front = _front_cell(params, new)

    # Leaf results (computed unconditionally, committed per eval mask).
    res = {}
    pc = {}
    marks_upd = {}
    cm_upd = {}
    for c in range(2):
        for l in range(2):
            i = c * 2 + l
            if not leaf_kinds[i]:  # slot never active for this family
                res[i] = jnp.zeros((), jnp.int32)
                pc[i] = aux[AUX_PC_NONE + i]
                marks_upd[i] = new.marks
                cm_upd[i] = new.carrying_marks
                continue
            res[i], pc[i], marks_upd[i], cm_upd[i] = _leaf_eval(
                params, new, action, codes, c, l, aux[AUX_PC_NONE + i],
                front, leaf_kinds[i],
            )

    # BABYAI_DONE_ACTIONS mode (ActionInstr.verify, verifier.py:228-243):
    # instructions succeed/fail only on an explicit `done` action, judged by
    # whether the previous verified step matched; other steps record the
    # match bit and report "continue".  Static flag -> jit specializes.
    done_actions = bool(params.opt("done_actions", False))
    last_match_new = None
    if done_actions:
        last_bits = aux[AUX_LAST_MATCH]
        is_done_act = action == ACT_DONE
        last_match_new = {}
        for i in range(4):
            last = (last_bits >> i) & 1
            last_match_new[i] = jnp.where(
                is_done_act, last, (res[i] == 1).astype(jnp.int32)
            )
            res[i] = jnp.where(
                is_done_act, jnp.where(last == 1, 1, 2), 0
            )

    # Clause results: single leaf, or AndInstr of two leaves
    # (verifier.py:552-566 — And returns success when both succeed and never
    # fails outside done-actions mode; leaf dones stick on success).
    def clause_result(c, leaf_eval_mask):
        is_and = clause_is_and(codes, c)
        i0, i1 = c * 2, c * 2 + 1
        d0 = aux[AUX_LEAF_DONE + i0]
        d1 = aux[AUX_LEAF_DONE + i1]
        # single-leaf clause: result = leaf result
        single_res = res[i0]
        # and-pair: evaluate leaves not yet successful
        nd0 = jnp.where(d0 == 1, 1, res[i0])
        nd1 = jnp.where(d1 == 1, 1, res[i1])
        and_res = jnp.where((nd0 == 1) & (nd1 == 1), 1, 0)
        r = jnp.where(is_and, and_res, single_res)
        eval0 = leaf_eval_mask & jnp.where(is_and, d0 != 1, True)
        eval1 = leaf_eval_mask & is_and & (d1 != 1)
        # Leaf done flags are only meaningful for and-pairs.
        new_d0 = jnp.where(leaf_eval_mask & is_and, nd0, d0)
        new_d1 = jnp.where(leaf_eval_mask & is_and, nd1, d1)
        return r, (new_d0, new_d1), (eval0, eval1)

    a_done = aux[AUX_A_DONE]
    b_done = aux[AUX_B_DONE]
    is_single = comb == COMB_SINGLE
    is_before = comb == COMB_BEFORE
    is_after = comb == COMB_AFTER

    # Provisional clause results assuming evaluation; gating follows.
    res_a, _, _ = clause_result(0, jnp.asarray(True))
    res_b, _, _ = clause_result(1, jnp.asarray(True))

    eval_a = (
        is_single
        | (is_before & (a_done != 1))
        | (is_after & ((b_done == 1) | ((res_b == 1) & (b_done != 1))))
        | (is_after & (comb_strict == 1) & (b_done != 1))
    )
    eval_b = (
        (is_before & ((a_done == 1) | ((a_done != 1) & (res_a == 1))))
        | (is_before & (comb_strict == 1) & (a_done != 1))
        | (is_after & (b_done != 1))
    )

    # Commit clause-internal state under the eval masks.
    _, (na0, na1), (ea0, ea1) = clause_result(0, eval_a)
    _, (nb0, nb1), (eb0, eb1) = clause_result(1, eval_b)
    leaf_eval = (ea0, ea1, eb0, eb1)
    leaf_done_new = (na0, na1, nb0, nb1)

    marks = new.marks
    cmarks = new.carrying_marks
    for i in range(4):
        c, l = divmod(i, 2)
        # Remember-bit planes only change for leaves that can track a carry.
        if not any(k in ("pickup", "putnext") for k in leaf_kinds[i]):
            continue
        rb = jnp.asarray(remember_bit(c, l), dtype=marks.dtype)
        marks = jnp.where(
            leaf_eval[i], (marks & ~rb) | (marks_upd[i] & rb), marks
        )
        cmarks = jnp.where(
            leaf_eval[i], (cmarks & ~rb) | (cm_upd[i] & rb), cmarks
        )

    pc_new = [
        jnp.where(leaf_eval[i], pc[i], aux[AUX_PC_NONE + i]) for i in range(4)
    ]
    if done_actions:
        bits_old = aux[AUX_LAST_MATCH]
        packed = jnp.zeros_like(bits_old)
        for i in range(4):
            b = jnp.where(leaf_eval[i], last_match_new[i], (bits_old >> i) & 1)
            packed = packed | (b << i)

    # Top-level combinator state machine (verifier.py:465-528).
    s_status = res_a
    b_active = a_done == 1
    bf_status = jnp.where(
        b_active,
        res_b,
        jnp.where(
            res_a == 2,
            2,
            jnp.where(
                res_a == 1,
                res_b,  # recurse into b on the same step
                jnp.where((comb_strict == 1) & (res_b == 1), 2, 0),
            ),
        ),
    )
    bf_a_done = jnp.where(b_active, a_done, res_a)
    bf_b_done = jnp.where(b_active | (res_a == 1), res_b, b_done)
    a_active = b_done == 1
    af_status = jnp.where(
        a_active,
        res_a,
        jnp.where(
            res_b == 2,
            2,
            jnp.where(
                res_b == 1,
                res_a,
                jnp.where((comb_strict == 1) & (res_a == 1), 2, 0),
            ),
        ),
    )
    af_b_done = jnp.where(a_active, b_done, res_b)
    af_a_done = jnp.where(a_active | (res_b == 1), res_a, a_done)

    status = jnp.where(
        is_single, s_status, jnp.where(is_before, bf_status, af_status)
    )
    new_a_done = jnp.where(
        is_before, bf_a_done, jnp.where(is_after, af_a_done, a_done)
    )
    new_b_done = jnp.where(
        is_before, bf_b_done, jnp.where(is_after, af_b_done, b_done)
    )

    aux = aux.at[AUX_A_DONE].set(new_a_done).at[AUX_B_DONE].set(new_b_done)
    for i in range(4):
        aux = aux.at[AUX_LEAF_DONE + i].set(leaf_done_new[i])
        aux = aux.at[AUX_PC_NONE + i].set(pc_new[i])
    if done_actions:
        aux = aux.at[AUX_LAST_MATCH].set(packed)
    new = new.replace(aux=aux, marks=marks, carrying_marks=cmarks)

    succeeded = status == 1
    failed = status == 2
    # _reward uses the per-episode max_steps (minigrid_env.py:235-240 via
    # roomgrid_level.py:96-98).
    r_succ = 1.0 - 0.9 * (
        new.step_count.astype(jnp.float32) / aux[AUX_MAX_STEPS].astype(jnp.float32)
    )
    reward = jnp.where(succeeded, r_succ, jnp.where(failed, 0.0, reward))
    terminated = terminated | succeeded | failed
    return new, reward, terminated


# -- mission surface text (host-side) ---------------------------------------


def surface_text(codes) -> str:
    """Exact reference mission string (Instr.surface / ObjDesc.surface)."""
    codes = np.asarray(codes)

    def desc(c, l, d):
        b = _desc_base(c, l, d)
        t, col, loc, plural = codes[b], codes[b + 1], codes[b + 2], codes[b + 3]
        s = OBJ_TYPE_NAMES.get(int(t), "object")
        if col != COLOR_ANY:
            s = COLOR_NAMES6[int(col)] + " " + s
        if loc != LOC_NONE:
            s += LOC_SUFFIX[int(loc)]
        return ("a " if plural else "the ") + s

    def leaf_text(c, l):
        kind = int(codes[_leaf_base(c, l)])
        if kind == KIND_GOTO:
            return "go to " + desc(c, l, 0)
        if kind == KIND_OPEN:
            return "open " + desc(c, l, 0)
        if kind == KIND_PICKUP:
            return "pick up " + desc(c, l, 0)
        if kind == KIND_PUTNEXT:
            return "put " + desc(c, l, 0) + " next to " + desc(c, l, 1)
        return ""

    def clause_text(c):
        if int(codes[CLAUSE_OFF[c]]) == 1:
            return leaf_text(c, 0) + " and " + leaf_text(c, 1)
        return leaf_text(c, 0)

    comb = int(codes[0])
    a = clause_text(0)
    if comb == COMB_SINGLE:
        return a
    b = clause_text(1)
    if comb == COMB_BEFORE:
        return a + ", then " + b
    return a + " after you " + b
