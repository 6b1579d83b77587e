"""Functional RoomGrid scaffold.

Batched re-derivation of ``minigrid.core.roomgrid.RoomGrid``
(/root/reference/minigrid/core/roomgrid.py): a lattice of rooms at pitch
``room_size - 1`` with per-edge door slots, plus the level-building verbs the
env families compose — ``add_door``, ``remove_wall``, ``add_object`` /
``place_in_room``, ``place_agent`` (in-room, not-facing-objects),
``connect_all`` and ``add_distractors``.

The reference threads a Python object graph (Room instances with
``doors``/``neighbors``/``locked``); here the per-episode room topology is a
tiny traced context (:class:`RoomCtx`) of (rows, cols, 4) arrays carried
through generation, while room/row/col counts stay static.  Rejection loops
become single categorical draws over validity masks (distribution-identical);
``connect_all``'s data-dependent retry loop is the one place a bounded
``lax.while_loop`` remains, mirroring roomgrid.py:363-393.

Door-slot directions follow the reference: 0=right, 1=down, 2=left, 3=up.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core import struct
from minigrid_dynamicprogramming_tpu.core.constants import (
    DIR_TO_VEC_ARR,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_KEY,
    OBJ_WALL,
    STATE_CLOSED,
    STATE_LOCKED,
)
from minigrid_dynamicprogramming_tpu.core.state import EnvState
from minigrid_dynamicprogramming_tpu.ops import grid as G

# door_state codes (mirrors Room.doors: None / Door / True)
EDGE_NONE = 0
EDGE_DOOR = 1
EDGE_OPEN = 2  # wall removed

OBJ_KINDS = jnp.asarray([OBJ_KEY, OBJ_BALL, OBJ_BOX], dtype=jnp.int32)


@struct.dataclass
class RoomCtx:
    """Traced per-episode room topology; (rows, cols, 4) unless noted."""

    door_x: jnp.ndarray  # int32 — door-slot x per room edge
    door_y: jnp.ndarray  # int32
    has_edge: jnp.ndarray  # bool — neighbor exists (static content, traced dtype)
    edge: jnp.ndarray  # int32 — EDGE_NONE/DOOR/OPEN
    locked: jnp.ndarray  # (rows, cols) bool
    used: jnp.ndarray  # (3, 6) bool — (kind, color) combos already placed


def room_top(room_size: int, i, j) -> Tuple[jnp.ndarray, jnp.ndarray]:
    pitch = room_size - 1
    return jnp.asarray(i) * pitch, jnp.asarray(j) * pitch


def init(
    key: jax.Array, state: EnvState, room_size: int, rows: int, cols: int
) -> Tuple[EnvState, RoomCtx]:
    """Build the wall lattice and sample per-edge door slots
    (roomgrid.py:123-179); agent starts centered in the middle room."""
    h, w = state.grid_obj.shape
    pitch = room_size - 1
    ys, xs = G.coord_grids(h, w)
    lattice = (xs % pitch == 0) | (ys % pitch == 0)
    state = G.paint(state, lattice, OBJ_WALL, 5)

    keys = jax.random.split(key, 2)
    # Right-edge door y in [top+1, top+room_size-1); down-edge door x same.
    # Built as Python lists of scalars stacked ONCE: an .at[j,i,k].set
    # chain compiles to ~36 serial dynamic-update-slices (full-array copies
    # under vmap).  Values and draw keys are unchanged — bit-identical
    # tables.
    ky_flat = jax.random.split(keys[0], rows * cols * 2)
    ky = lambda j, i, s: ky_flat[(j * cols + i) * 2 + s]
    zero = jnp.asarray(0, dtype=jnp.int32)
    dx = [[[zero] * 4 for _ in range(cols)] for _ in range(rows)]
    dy = [[[zero] * 4 for _ in range(cols)] for _ in range(rows)]
    he = [[[False] * 4 for _ in range(cols)] for _ in range(rows)]
    for j in range(rows):
        for i in range(cols):
            tx, ty = i * pitch, j * pitch
            if i < cols - 1:
                y = jax.random.randint(
                    ky(j, i, 0), (), ty + 1, ty + room_size - 1
                )
                dx[j][i][0] = jnp.asarray(tx + room_size - 1, jnp.int32)
                dy[j][i][0] = y.astype(jnp.int32)
                he[j][i][0] = True
            if j < rows - 1:
                x = jax.random.randint(
                    ky(j, i, 1), (), tx + 1, tx + room_size - 1
                )
                dx[j][i][1] = x.astype(jnp.int32)
                dy[j][i][1] = jnp.asarray(ty + room_size - 1, jnp.int32)
                he[j][i][1] = True
    # Left/up mirror the neighbor's right/down slots (roomgrid.py:168-175).
    for j in range(rows):
        for i in range(cols):
            if i > 0:
                dx[j][i][2] = dx[j][i - 1][0]
                dy[j][i][2] = dy[j][i - 1][0]
                he[j][i][2] = True
            if j > 0:
                dx[j][i][3] = dx[j - 1][i][1]
                dy[j][i][3] = dy[j - 1][i][1]
                he[j][i][3] = True

    def _stack(rowsxcols):
        return jnp.stack(
            [jnp.stack([jnp.stack(c) for c in row]) for row in rowsxcols]
        )

    door_x = _stack(dx)
    door_y = _stack(dy)
    # has_edge is static per (rows, cols): materialize host-side.
    has_edge = jnp.asarray(he, dtype=bool)

    state = state.replace(
        agent_pos=jnp.asarray(
            [
                (cols // 2) * pitch + room_size // 2,
                (rows // 2) * pitch + room_size // 2,
            ],
            dtype=jnp.int32,
        ),
        agent_dir=jnp.asarray(0, dtype=jnp.int32),
    )
    ctx = RoomCtx(
        door_x=door_x,
        door_y=door_y,
        has_edge=has_edge,
        edge=jnp.zeros((rows, cols, 4), dtype=jnp.int32),
        locked=jnp.zeros((rows, cols), dtype=bool),
        used=jnp.zeros((3, 6), dtype=bool),
    )
    return state, ctx


def _neighbor(rows: int, cols: int, i, j, k):
    """Room on the other side of edge k, clipped (callers guard has_edge)."""
    di = jnp.asarray([1, 0, -1, 0], dtype=jnp.int32)[k]
    dj = jnp.asarray([0, 1, 0, -1], dtype=jnp.int32)[k]
    ni = jnp.clip(jnp.asarray(i) + di, 0, cols - 1)
    nj = jnp.clip(jnp.asarray(j) + dj, 0, rows - 1)
    return ni, nj


def _edge_set(edge, j, i, k, value):
    # one-hot where, not a scatter/DUS (see ops/grid.py:cell_set: batched
    # sub-32-bit scatters miscompiled on an earlier accelerator backend;
    # ``audit_device`` checks the live one); edge is tiny (rows, cols, 4)
    rows, cols, kk = edge.shape
    hit = (
        (jnp.arange(rows, dtype=jnp.int32)[:, None, None] == j)
        & (jnp.arange(cols, dtype=jnp.int32)[None, :, None] == i)
        & (jnp.arange(kk, dtype=jnp.int32)[None, None, :] == k)
    )
    return jnp.where(hit, jnp.asarray(value, edge.dtype), edge)


def set_edge(ctx: RoomCtx, i, j, k, value) -> RoomCtx:
    rows, cols = ctx.locked.shape
    ni, nj = _neighbor(rows, cols, i, j, k)
    edge = _edge_set(ctx.edge, j, i, jnp.asarray(k), value)
    edge = _edge_set(edge, nj, ni, (jnp.asarray(k) + 2) % 4, value)
    return ctx.replace(edge=edge)


def mark_used(ctx: RoomCtx, kind, color) -> RoomCtx:
    """Record a placed (kind, color) combo for all_unique distractor dedup.

    cell_set, NOT a bool scatter: batched sub-32-bit scatters miscompiled
    on an earlier accelerator backend; ``audit_device`` checks the live one
    (ops/grid.py:cell_set)."""
    kind_idx = jnp.argmax(OBJ_KINDS == jnp.asarray(kind, jnp.int32))
    return ctx.replace(used=G.cell_set(ctx.used, kind_idx, color, True))


def add_door(
    key: jax.Array,
    state: EnvState,
    ctx: RoomCtx,
    i,
    j,
    door_idx=None,
    color=None,
    locked=None,
) -> Tuple[EnvState, RoomCtx, Tuple[jnp.ndarray, jnp.ndarray], jnp.ndarray, jnp.ndarray]:
    """roomgrid.py:230-274. Returns (state, ctx, (x, y), color, locked)."""
    rows, cols = ctx.locked.shape
    k_idx, k_color, k_locked = jax.random.split(key, 3)
    if door_idx is None:
        # Random edge with a neighbor and no door yet.
        avail = ctx.has_edge[j, i] & (ctx.edge[j, i] == EDGE_NONE)
        logits = jnp.where(avail, 0.0, -jnp.inf)
        door_idx = jax.random.categorical(k_idx, logits)
    if color is None:
        color = jax.random.randint(k_color, (), 0, 6)
    if locked is None:
        locked = jax.random.randint(k_locked, (), 0, 2) == 0
    locked = jnp.asarray(locked)
    x = ctx.door_x[j, i, door_idx]
    y = ctx.door_y[j, i, door_idx]
    state = G.put_obj(
        state,
        x,
        y,
        OBJ_DOOR,
        color,
        jnp.where(locked, STATE_LOCKED, STATE_CLOSED),
    )
    ctx = set_edge(ctx, i, j, door_idx, EDGE_DOOR)
    ctx = ctx.replace(locked=G.cell_set(ctx.locked, j, i, locked))
    return state, ctx, (x, y), jnp.asarray(color), door_idx


def remove_wall(
    state: EnvState, ctx: RoomCtx, room_size: int, i: int, j: int, wall_idx: int
) -> Tuple[EnvState, RoomCtx]:
    """roomgrid.py:276-311 — clear the interior segment of one room wall.
    Room indices are static here (all callers use literals)."""
    tx, ty = room_top(room_size, i, j)
    h, w = state.grid_obj.shape
    ys, xs = G.coord_grids(h, w)
    if wall_idx == 0:
        m = (xs == tx + room_size - 1) & (ys > ty) & (ys < ty + room_size - 1)
    elif wall_idx == 1:
        m = (ys == ty + room_size - 1) & (xs > tx) & (xs < tx + room_size - 1)
    elif wall_idx == 2:
        m = (xs == tx) & (ys > ty) & (ys < ty + room_size - 1)
    else:
        m = (ys == ty) & (xs > tx) & (xs < tx + room_size - 1)
    state = G.paint(state, m, OBJ_EMPTY, 0)
    ctx = set_edge(ctx, i, j, wall_idx, EDGE_OPEN)
    return state, ctx


def room_rect_mask(state: EnvState, room_size: int, i, j) -> jnp.ndarray:
    h, w = state.grid_obj.shape
    tx, ty = room_top(room_size, i, j)
    return G.rect_mask(h, w, (tx, ty), (room_size, room_size))


def reject_next_to_mask(state: EnvState) -> jnp.ndarray:
    """Cells with manhattan distance < 2 from the agent (roomgrid.py:11-20)."""
    h, w = state.grid_obj.shape
    ys, xs = G.coord_grids(h, w)
    d = jnp.abs(xs - state.agent_pos[0]) + jnp.abs(ys - state.agent_pos[1])
    return d < 2


def place_in_room(
    key: jax.Array,
    state: EnvState,
    ctx: RoomCtx,
    room_size: int,
    i,
    j,
    kind,
    color,
    contains_obj: int = OBJ_EMPTY,
    contains_color: int = 0,
):
    """roomgrid.py:181-205. Returns (state, ctx, (x, y), ok)."""
    mask = room_rect_mask(state, room_size, i, j)
    state, pos, ok = G.place_obj(
        key,
        state,
        kind,
        color,
        top=None,
        size=None,
        reject_mask=(~mask) | reject_next_to_mask(state),
        contains_obj=contains_obj,
        contains_color=contains_color,
    )
    ctx = mark_used(ctx, kind, color)
    return state, ctx, pos, ok


def add_object(
    key: jax.Array,
    state: EnvState,
    ctx: RoomCtx,
    room_size: int,
    i,
    j,
    kind=None,
    color=None,
):
    """roomgrid.py:207-228. Returns (state, ctx, (x, y), kind, color)."""
    k_kind, k_color, k_place = jax.random.split(key, 3)
    if kind is None:
        kind = OBJ_KINDS[jax.random.randint(k_kind, (), 0, 3)]
    if color is None:
        color = jax.random.randint(k_color, (), 0, 6)
    state, ctx, pos, _ = place_in_room(
        k_place, state, ctx, room_size, i, j, kind, color
    )
    return state, ctx, pos, jnp.asarray(kind), jnp.asarray(color)


def place_agent(
    key: jax.Array,
    state: EnvState,
    room_size: int,
    i=None,
    j=None,
    rows: int = 1,
    cols: int = 1,
) -> EnvState:
    """roomgrid.py:313-334: uniform over (cell, dir) pairs within the room
    whose front cell is empty or wall — the joint form of the reference's
    resample-until loop."""
    k_room, k_pick = jax.random.split(key)
    if i is None or j is None:
        ki, kj = jax.random.split(k_room)
        if i is None:
            i = jax.random.randint(ki, (), 0, cols)
        if j is None:
            j = jax.random.randint(kj, (), 0, rows)
    h, w = state.grid_obj.shape
    in_room = room_rect_mask(state, room_size, i, j)
    empty = state.grid_obj == OBJ_EMPTY
    from minigrid_dynamicprogramming_tpu.core.constants import DIR_TO_VEC

    valid_dirs = []
    for d in range(4):
        dx, dy = int(DIR_TO_VEC[d][0]), int(DIR_TO_VEC[d][1])
        front = jnp.roll(state.grid_obj, shift=(-dy, -dx), axis=(0, 1))
        valid_dirs.append(
            in_room & empty & ((front == OBJ_EMPTY) | (front == OBJ_WALL))
        )
    valid = jnp.stack(valid_dirs)  # (4, H, W)
    logits = jnp.where(valid.reshape(-1), 0.0, -jnp.inf)
    idx = jax.random.categorical(k_pick, logits)
    d, rem = idx // (h * w), idx % (h * w)
    y, x = rem // w, rem % w
    return state.replace(
        agent_pos=jnp.stack([x, y]).astype(jnp.int32),
        agent_dir=d.astype(jnp.int32),
    )


def connect_all(
    key: jax.Array,
    state: EnvState,
    ctx: RoomCtx,
    room_size: int,
    max_itrs: int = 256,
    exclude_color=None,
) -> Tuple[EnvState, RoomCtx]:
    """roomgrid.py:336-394 — repeatedly add random unlocked doors until every
    room is reachable from the agent's start room.

    The reference's data-dependent retry loop is simulated in CLOSED FORM
    instead of iterated: all ``max_itrs`` candidate draws (room, dir, color)
    are iid and independent of loop state, and the accepted-edge set is a
    pure function of the draw sequence — an edge joins the graph at its
    first valid draw, and the loop stops at the first step t* where the
    room graph is connected.  t* is the minimax-over-paths join time from
    the start room (a Bellman sweep over the <=9-room graph), and the doors
    actually added are exactly the first-occurrence draws with time <= t*.
    Same law as the sequential loop draw-for-draw; zero sequential
    iteration (a 16k-env vmapped while_loop ran to the batch-max ~250
    iterations and dominated whole-generator cost for every connect_all
    family, e.g. KeyCorridorS6R3 at 18 us/layout)."""
    rows, cols = ctx.locked.shape
    pitch = room_size - 1
    start_i = state.agent_pos[0] // pitch
    start_j = state.agent_pos[1] // pitch
    i32 = jnp.int32
    T = max_itrs
    INF = i32(T + 1)

    # All candidate draws at once (iid; same per-draw law as the loop body).
    k_i, k_j, k_k, k_c = jax.random.split(key, 4)
    di = jax.random.randint(k_i, (T,), 0, cols)
    dj = jax.random.randint(k_j, (T,), 0, rows)
    dk = jax.random.randint(k_k, (T,), 0, 4)
    if exclude_color is None:
        dcolor = jax.random.randint(k_c, (T,), 0, 6)
    else:
        # Uniform over colors != exclude_color (the reference's door_colors
        # filter, roomgrid.py:336-361 / unlock.py:31-36).
        logits = jnp.where(
            jnp.arange(6) == jnp.asarray(exclude_color), -jnp.inf, 0.0
        )
        dcolor = jax.random.categorical(k_c, logits, shape=(T,)).astype(i32)

    ni, nj = _neighbor(rows, cols, di, dj, dk)
    flat4 = (dj * cols + di) * 4 + dk
    # The per-draw validity lookups index <=36-entry per-env tables with a
    # (T,)-vector; under vmap those compile to (B, T) scalar gathers.
    # Pack each table into
    # uint32 bitmask words instead — the lookup becomes an elementwise
    # shift-and-mask, which vectorizes for free.  rows*cols <= 9 always
    # (largest RoomGrid is 3x3), so flat4 < 36 needs two words and the
    # room index fits one.
    assert rows * cols <= 32
    bits = jnp.arange(rows * cols, dtype=jnp.uint32)
    locked_mask = jnp.sum(
        jnp.where(ctx.locked.reshape(-1), jnp.uint32(1) << bits, jnp.uint32(0))
    )
    avail = ctx.has_edge.reshape(-1) & (ctx.edge.reshape(-1) == EDGE_NONE)
    bits4 = jnp.arange(rows * cols * 4, dtype=jnp.uint32)
    avail_lo = jnp.sum(
        jnp.where(
            avail & (bits4 < 32), jnp.uint32(1) << (bits4 % 32), jnp.uint32(0)
        )
    )
    avail_hi = jnp.sum(
        jnp.where(
            avail & (bits4 >= 32), jnp.uint32(1) << (bits4 % 32), jnp.uint32(0)
        )
    )

    def _bit(mask, idx):
        return ((mask >> idx.astype(jnp.uint32)) & jnp.uint32(1)) != 0

    f4 = flat4.astype(jnp.uint32)
    in_lo = f4 < 32
    avail_bit = jnp.where(
        in_lo,
        _bit(avail_lo, jnp.where(in_lo, f4, 0)),
        _bit(avail_hi, jnp.where(in_lo, 0, f4 - 32)),
    )
    valid = (
        avail_bit
        & ~_bit(locked_mask, dj * cols + di)
        & ~_bit(locked_mask, nj * cols + ni)
    )
    # Canonical physical edge id: (row, col, right|down) of the owning room.
    ci = jnp.where(dk == 2, di - 1, di)
    cj = jnp.where(dk == 3, dj - 1, dj)
    ck = jnp.where(dk < 2, dk, dk - 2)

    steps = jnp.arange(T, dtype=i32)
    # Per physical edge: first valid draw time and that draw's color.
    edges = [
        (j, i, k)
        for j in range(rows)
        for i in range(cols)
        for k in range(2)
        if (k == 0 and i < cols - 1) or (k == 1 and j < rows - 1)
    ]
    time_e, color_e, init_e = [], [], []
    for (j, i, k) in edges:
        hit = valid & (ci == i) & (cj == j) & (ck == k)
        t_first = jnp.min(jnp.where(hit, steps, INF))
        first_idx = jnp.argmin(jnp.where(hit, steps, INF))
        time_e.append(t_first)
        color_e.append(dcolor[first_idx])
        # Edges already open/doored before connect_all join at time -1.
        init_e.append(ctx.edge[j, i, k] != EDGE_NONE)

    # Minimax join time from the start room over the room graph
    # (d[r] = earliest step at which r is connected to the start room).
    join = [
        jnp.where(init_e[e], i32(-1), time_e[e]) for e in range(len(edges))
    ]
    d = {
        (j, i): jnp.where(
            (i32(j) == start_j) & (i32(i) == start_i), i32(-1), INF
        )
        for j in range(rows)
        for i in range(cols)
    }
    for _ in range(rows * cols):
        for e, (j, i, k) in enumerate(edges):
            a = (j, i)
            b = (j, i + 1) if k == 0 else (j + 1, i)
            d[a] = jnp.minimum(d[a], jnp.maximum(d[b], join[e]))
            d[b] = jnp.minimum(d[b], jnp.maximum(d[a], join[e]))
    t_star = d[(0, 0)]
    for r in d.values():
        t_star = jnp.maximum(t_star, r)
    # Disconnected within the budget -> every draw executes (cap behavior).
    t_eff = jnp.minimum(t_star, i32(T - 1))

    # Doors added = first-occurrence valid draws at steps <= t_eff.
    go, gc, gs = state.grid_obj, state.grid_color, state.grid_state
    # Per-slot overrides collected as scalars and stacked ONCE (the former
    # .at[j,i,k].set chain was ~20 serial dynamic-update-slices, same
    # overhead class as the lattice build above).
    override = [[[None] * 4 for _ in range(cols)] for _ in range(rows)]
    for e, (j, i, k) in enumerate(edges):
        accept = (~init_e[e]) & (time_e[e] <= t_eff)
        # One-hot writes with x = y = -1 on reject => written nowhere
        # (ops/grid.py:cell_set semantics).
        x = jnp.where(accept, ctx.door_x[j, i, k], -1)
        y = jnp.where(accept, ctx.door_y[j, i, k], -1)
        go = G.cell_set(go, y, x, OBJ_DOOR)
        gc = G.cell_set(gc, y, x, color_e[e])
        gs = G.cell_set(gs, y, x, STATE_CLOSED)
        bj, bi = (j, i + 1) if k == 0 else (j + 1, i)
        override[j][i][k] = accept
        override[bj][bi][k + 2] = accept
    slots = []
    for j in range(rows):
        for i in range(cols):
            for k in range(4):
                ov = override[j][i][k]
                cur = ctx.edge[j, i, k]
                slots.append(
                    cur if ov is None else jnp.where(ov, i32(EDGE_DOOR), cur)
                )
    edge_arr = jnp.stack(slots).reshape(rows, cols, 4)
    state = state.replace(grid_obj=go, grid_color=gc, grid_state=gs)
    return state, ctx.replace(edge=edge_arr)


def add_distractors(
    key: jax.Array,
    state: EnvState,
    ctx: RoomCtx,
    room_size: int,
    rows: int,
    cols: int,
    i=None,
    j=None,
    num_distractors: int = 10,
    all_unique: bool = True,
):
    """roomgrid.py:396-438. Returns (state, ctx, kinds, colors, poss) with
    the distractor descriptors as (num,) arrays and positions (num, 2).

    The per-distractor loop is a ``lax.scan`` so the body traces once
    regardless of count (keeps compile time flat across the env suite).

    Fixed-room calls take a one-shot path: sequential uniform placement
    into an unchanging room rect is exactly sampling cells *without
    replacement*, which the Gumbel-top-k trick draws in one op (likewise
    the all_unique combo dedup over the 18 (kind, color) pairs).  This is
    the distribution the reference's retry loops induce — not its draw
    order — and it cuts the dominant cost of the single-room BabyAI
    generators (the device generators are property/distribution-tested;
    bit-exact seed parity is the twin's job, utils/parity_twin.py)."""
    fixed_room = (i is not None and j is not None) or (rows == 1 and cols == 1)
    if fixed_room:
        ri = jnp.asarray(0 if i is None else i)
        rj = jnp.asarray(0 if j is None else j)
        k_cells, k_combo = jax.random.split(key)
        valid = (
            room_rect_mask(state, room_size, ri, rj)
            & ~reject_next_to_mask(state)
            & G.free_cell_mask(state)
        )
        h, w = state.grid_obj.shape
        g = jnp.where(
            valid.reshape(-1),
            jax.random.gumbel(k_cells, (h * w,)),
            -jnp.inf,
        )
        top_g, idx = jax.lax.top_k(g, num_distractors)
        do = top_g > -jnp.inf  # fewer valid cells than distractors: skip
        xs = (idx % w).astype(jnp.int32)
        ys = (idx // w).astype(jnp.int32)
        # Multi-index writes unroll into scatter-free single-cell updates:
        # batched scatters miscompiled on an earlier accelerator backend;
        # ``audit_device`` checks the live one (ops/grid.py:cell_set).
        if all_unique:
            cg = jnp.where(
                ctx.used.reshape(-1), -jnp.inf, jax.random.gumbel(k_combo, (18,))
            )
            _, combos = jax.lax.top_k(cg, num_distractors)
            kinds = OBJ_KINDS[combos // 6]
            colors = (combos % 6).astype(jnp.int32)
            used = ctx.used.reshape(-1)
            for t in range(num_distractors):
                used = G.elem_set(used, combos[t], True)
            ctx = ctx.replace(used=used.reshape(3, 6))
        else:
            kk, kc = jax.random.split(k_combo)
            kinds = OBJ_KINDS[jax.random.randint(kk, (num_distractors,), 0, 3)]
            colors = jax.random.randint(kc, (num_distractors,), 0, 6)
            kind_idx = jnp.argmax(OBJ_KINDS[None, :] == kinds[:, None], axis=1)
            used = ctx.used
            for t in range(num_distractors):
                used = G.cell_set(used, kind_idx[t], colors[t], True)
            ctx = ctx.replace(used=used)
        grid_obj, grid_color = state.grid_obj, state.grid_color
        for t in range(num_distractors):
            # do=False slots write back the original cell value at (0, 0) —
            # a wall corner no valid placement can target, so sequential
            # updates reproduce the scatter exactly.
            sy = jnp.where(do[t], ys[t], 0)
            sx = jnp.where(do[t], xs[t], 0)
            grid_obj = G.cell_set(
                grid_obj, sy, sx,
                jnp.where(do[t], kinds[t].astype(jnp.uint8), grid_obj[sy, sx]),
            )
            grid_color = G.cell_set(
                grid_color, sy, sx,
                jnp.where(
                    do[t], colors[t].astype(jnp.uint8), grid_color[sy, sx]
                ),
            )
        state = state.replace(grid_obj=grid_obj, grid_color=grid_color)
        poss = jnp.stack([xs, ys], axis=1)
        return state, ctx, kinds.astype(jnp.int32), colors, poss

    keys = jax.random.split(key, num_distractors)

    def body(carry, k):
        state, ctx = carry
        k_combo, k_i, k_j, k_place = jax.random.split(k, 4)
        if all_unique:
            # Uniform draw over unused (kind, color) combos == the
            # reference's retry-until-unused loop.
            logits = jnp.where(ctx.used.reshape(-1), -jnp.inf, 0.0)
            combo = jax.random.categorical(k_combo, logits)
            kind = OBJ_KINDS[combo // 6]
            color = (combo % 6).astype(jnp.int32)
        else:
            kk, kc = jax.random.split(k_combo)
            kind = OBJ_KINDS[jax.random.randint(kk, (), 0, 3)]
            color = jax.random.randint(kc, (), 0, 6)
        ri = jax.random.randint(k_i, (), 0, cols) if i is None else jnp.asarray(i)
        rj = jax.random.randint(k_j, (), 0, rows) if j is None else jnp.asarray(j)
        state, ctx, pos, _ = place_in_room(
            k_place, state, ctx, room_size, ri, rj, kind, color
        )
        out = (
            jnp.asarray(kind, jnp.int32),
            jnp.asarray(color, jnp.int32),
            jnp.stack([pos[0], pos[1]]).astype(jnp.int32),
        )
        return (state, ctx), out

    (state, ctx), (kinds, colors, poss) = jax.lax.scan(
        body, (state, ctx), keys
    )
    return state, ctx, kinds, colors, poss
