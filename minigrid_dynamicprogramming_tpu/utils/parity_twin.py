"""NumPy seed-parity twin of the reference's procedural generation.

The reference generates layouts by threading a Gymnasium-seeded
``np.random.Generator`` (PCG64) through ``_rand_*`` helpers and rejection
loops (/root/reference/minigrid/minigrid_env.py:242-367).  This module
replays the *exact same draw order* against the exact same generator — so
for any seed it produces, without importing the reference, the layout the
reference's ``env.reset(seed)`` would produce.  That closes the SURVEY
§7.3.1 "parity twin" requirement: seed-matched parity holds from generation
onward, not merely from a snapshotted layout.

Two rules keep the twin bit-exact by construction:

1. Every ``self.np_random.X(...)`` call in the reference's generation path
   has a twin call here with identical arguments in identical order (each
   is cited).  The generator itself is NumPy's, seeded the way Gymnasium
   seeds it (``np.random.SeedSequence(seed) -> PCG64``), so the bit stream
   is the reference's bit stream.
2. Rejection loops replicate their acceptance conditions *in the same
   short-circuit order* (occupied -> agent -> reject_fn), because a
   rejected try still consumed draws.

The twin is host-side test/reset infrastructure, not a throughput path:
the device-side generators in ``envs/`` remain the production reset.
``twin_reset(env_id, seed)`` turns a twin layout into a device
:class:`EnvState`, so a fixed seed yields the reference's exact episode
end-to-end through the device step kernels.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from minigrid_dynamicprogramming_tpu.core.constants import (
    COLOR_NAMES,
    COLOR_TO_IDX,
    OBJ_BALL,
    OBJ_BOX,
    OBJ_DOOR,
    OBJ_EMPTY,
    OBJ_GOAL,
    OBJ_KEY,
    OBJ_LAVA,
    OBJ_WALL,
    OBJECT_TO_IDX,
)

# Agent direction vectors, reference constants.py:49-58 (0=E,1=S,2=W,3=N).
_DIR_VEC = ((1, 0), (0, 1), (-1, 0), (0, -1))


def gymnasium_rng(seed: int) -> np.random.Generator:
    """The generator ``gymnasium.utils.seeding.np_random(seed)`` builds."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


class TwinObj:
    """Minimal object record (type/color/state + box contents)."""

    __slots__ = ("type", "color", "state", "contains", "pos")

    def __init__(self, type_: str, color: str, state: int = 0, contains=None):
        self.type = type_
        self.color = color
        self.state = state  # doors: 0 open / 1 closed / 2 locked
        self.contains = contains
        self.pos: Optional[Tuple[int, int]] = None

    def encode(self) -> Tuple[int, int, int]:
        return (OBJECT_TO_IDX[self.type], COLOR_TO_IDX[self.color], self.state)


def _wall() -> TwinObj:
    return TwinObj("wall", "grey")


class TwinEnv:
    """Draw-order twin of ``MiniGridEnv`` generation machinery.

    Mirrors the RNG helpers (minigrid_env.py:242-306), the rejection
    sampler ``place_obj`` (:308-367) and ``place_agent`` (:378-390), and
    the grid wall builders (grid.py:80-108), over a simple record grid.
    """

    def __init__(self, width: int, height: int, seed: int):
        self.width = width
        self.height = height
        self.rng = gymnasium_rng(seed)
        self._init_grid()

    def _init_grid(self) -> None:
        self.cells: List[List[Optional[TwinObj]]] = [
            [None] * self.width for _ in range(self.height)
        ]
        # reset() clears the pose before _gen_grid (minigrid_env.py:128-129)
        self.agent_pos: Tuple[int, int] = (-1, -1)
        self.agent_dir: int = -1

    # -- grid access ---------------------------------------------------------
    def get(self, x: int, y: int) -> Optional[TwinObj]:
        return self.cells[y][x]

    def set(self, x: int, y: int, obj: Optional[TwinObj]) -> None:
        self.cells[y][x] = obj
        if obj is not None:
            obj.pos = (x, y)

    def horz_wall(self, x: int, y: int, length: Optional[int] = None) -> None:
        if length is None:
            length = self.width - x
        for i in range(length):
            self.set(x + i, y, _wall())

    def vert_wall(self, x: int, y: int, length: Optional[int] = None) -> None:
        if length is None:
            length = self.height - y
        for j in range(length):
            self.set(x, y + j, _wall())

    def wall_rect(self, x: int, y: int, w: int, h: int) -> None:
        # order matches grid.py:99-108 (no draws, but kept for clarity)
        self.horz_wall(x, y, w)
        self.horz_wall(x, y + h - 1, w)
        self.vert_wall(x, y, h)
        self.vert_wall(x + w - 1, y, h)

    # -- RNG helpers: one twin call per reference draw ------------------------
    def rand_int(self, low: int, high: int) -> int:
        return int(self.rng.integers(low, high))  # minigrid_env.py:242-247

    def rand_bool(self) -> bool:
        return self.rng.integers(0, 2) == 0  # :256-261

    def rand_float(self, low: float, high: float) -> float:
        return float(self.rng.uniform(low, high))  # :249-254

    def rand_elem(self, iterable):
        lst = list(iterable)
        return lst[self.rand_int(0, len(lst))]  # :263-270

    def rand_subset(self, iterable, num_elems: int) -> list:
        lst = list(iterable)  # :272-287 — draws one rand_elem per element
        out: list = []
        while len(out) < num_elems:
            elem = self.rand_elem(lst)
            lst.remove(elem)
            out.append(elem)
        return out

    def rand_color(self) -> str:
        return self.rand_elem(COLOR_NAMES)  # :289-294

    def rand_pos(self, xl: int, xh: int, yl: int, yh: int) -> Tuple[int, int]:
        return (  # :296-306 — x drawn before y
            int(self.rng.integers(xl, xh)),
            int(self.rng.integers(yl, yh)),
        )

    # -- placement -----------------------------------------------------------
    def place_obj(
        self,
        obj: Optional[TwinObj],
        top: Optional[Tuple[int, int]] = None,
        size: Optional[Tuple[int, int]] = None,
        reject_fn: Optional[Callable[["TwinEnv", Tuple[int, int]], bool]] = None,
        max_tries: float = math.inf,
    ) -> Tuple[int, int]:
        """Rejection sampler, draw-for-draw with minigrid_env.py:308-367."""
        if top is None:
            top = (0, 0)
        else:
            top = (max(top[0], 0), max(top[1], 0))
        if size is None:
            size = (self.width, self.height)

        num_tries = 0
        while True:
            if num_tries > max_tries:
                raise RecursionError("rejection sampling failed in place_obj")
            num_tries += 1
            # two integer draws per try, x then y (:342-345)
            pos = (
                self.rand_int(top[0], min(top[0] + size[0], self.width)),
                self.rand_int(top[1], min(top[1] + size[1], self.height)),
            )
            if self.get(*pos) is not None:  # occupied (:348)
                continue
            if pos == tuple(self.agent_pos):  # agent cell (:352)
                continue
            if reject_fn and reject_fn(self, pos):  # filter (:356)
                continue
            break

        if obj is not None:
            self.set(pos[0], pos[1], obj)
        return pos

    def put_obj(self, obj: TwinObj, x: int, y: int) -> None:
        self.set(x, y, obj)  # :369-376, no draws

    def place_agent_rect(
        self, top=None, size=None, rand_dir: bool = True, max_tries: float = math.inf
    ) -> Tuple[int, int]:
        self.agent_pos = (-1, -1)  # :383 — clears before sampling
        pos = self.place_obj(None, top, size, max_tries=max_tries)
        self.agent_pos = pos
        if rand_dir:
            self.agent_dir = self.rand_int(0, 4)  # :387-388
        return pos

    @property
    def front_pos(self) -> Tuple[int, int]:
        dx, dy = _DIR_VEC[self.agent_dir]
        return (self.agent_pos[0] + dx, self.agent_pos[1] + dy)

    # -- export ---------------------------------------------------------------
    def planes(self):
        """Encode the record grid into the SoA planes (grid.py:244-268 wire
        format, with empty cells as OBJ_EMPTY as core/state.py stores them)."""
        h, w = self.height, self.width
        obj = np.full((h, w), OBJ_EMPTY, dtype=np.uint8)
        color = np.zeros((h, w), dtype=np.uint8)
        state = np.zeros((h, w), dtype=np.uint8)
        c_obj = np.full((h, w), OBJ_EMPTY, dtype=np.uint8)
        c_color = np.zeros((h, w), dtype=np.uint8)
        for y in range(h):
            for x in range(w):
                cell = self.cells[y][x]
                if cell is None:
                    continue
                t, c, s = cell.encode()
                obj[y, x], color[y, x], state[y, x] = t, c, s
                if cell.contains is not None:
                    ct, cc, _ = cell.contains.encode()
                    c_obj[y, x], c_color[y, x] = ct, cc
        return obj, color, state, c_obj, c_color


# ---------------------------------------------------------------------------
# RoomGrid twin (reference core/roomgrid.py)
# ---------------------------------------------------------------------------


def _reject_next_to(env: TwinEnv, pos: Tuple[int, int]) -> bool:
    """roomgrid.py:11-20 — manhattan distance to agent < 2."""
    sx, sy = env.agent_pos
    x, y = pos
    return abs(sx - x) + abs(sy - y) < 2


class TwinRoom:
    __slots__ = ("top", "size", "doors", "door_pos", "neighbors", "locked", "objs")

    def __init__(self, top, size):
        self.top = top
        self.size = size
        self.doors: List = [None] * 4  # right, down, left, up
        self.door_pos: List = [None] * 4
        self.neighbors: List = [None] * 4
        self.locked = False
        self.objs: List[TwinObj] = []

    def pos_inside(self, x: int, y: int) -> bool:
        """roomgrid.py Room.pos_inside:49-63 (rect includes the wall ring)."""
        tx, ty = self.top
        sx, sy = self.size
        return tx <= x < tx + sx and ty <= y < ty + sy


class RoomGridTwin(TwinEnv):
    """Draw-order twin of ``RoomGrid`` (roomgrid.py:66-438)."""

    def __init__(self, room_size: int, num_rows: int, num_cols: int, seed: int):
        self.room_size = room_size
        self.num_rows = num_rows
        self.num_cols = num_cols
        width = (room_size - 1) * num_cols + 1
        height = (room_size - 1) * num_rows + 1
        super().__init__(width, height, seed)

    def get_room(self, i: int, j: int) -> TwinRoom:
        return self.room_grid[j][i]

    def room_from_pos(self, x: int, y: int) -> TwinRoom:
        return self.room_grid[y // (self.room_size - 1)][x // (self.room_size - 1)]

    def gen_lattice(self) -> None:
        """RoomGrid._gen_grid (roomgrid.py:123-179): walls, then the two
        door-position draws per room in row-major room order, then the
        agent pinned at the center room's center facing right."""
        self._init_grid()
        rs = self.room_size
        self.room_grid = []
        for j in range(self.num_rows):
            row = []
            for i in range(self.num_cols):
                room = TwinRoom((i * (rs - 1), j * (rs - 1)), (rs, rs))
                row.append(room)
                self.wall_rect(*room.top, *room.size)
            self.room_grid.append(row)
        for j in range(self.num_rows):
            for i in range(self.num_cols):
                room = self.room_grid[j][i]
                x_l, y_l = room.top[0] + 1, room.top[1] + 1
                x_m = room.top[0] + room.size[0] - 1
                y_m = room.top[1] + room.size[1] - 1
                if i < self.num_cols - 1:  # right neighbor draw (:159-161)
                    room.neighbors[0] = self.room_grid[j][i + 1]
                    room.door_pos[0] = (x_m, self.rand_int(y_l, y_m))
                if j < self.num_rows - 1:  # down neighbor draw (:162-164)
                    room.neighbors[1] = self.room_grid[j + 1][i]
                    room.door_pos[1] = (self.rand_int(x_l, x_m), y_m)
                if i > 0:  # shared with left neighbor (:165-167)
                    room.neighbors[2] = self.room_grid[j][i - 1]
                    room.door_pos[2] = room.neighbors[2].door_pos[0]
                if j > 0:  # shared with up neighbor (:168-170)
                    room.neighbors[3] = self.room_grid[j - 1][i]
                    room.door_pos[3] = room.neighbors[3].door_pos[1]
        self.agent_pos = (
            (self.num_cols // 2) * (rs - 1) + rs // 2,
            (self.num_rows // 2) * (rs - 1) + rs // 2,
        )
        self.agent_dir = 0

    def place_in_room(self, i: int, j: int, obj: TwinObj):
        room = self.get_room(i, j)  # roomgrid.py:181-196
        pos = self.place_obj(
            obj, room.top, room.size, reject_fn=_reject_next_to, max_tries=1000
        )
        room.objs.append(obj)
        return obj, pos

    def add_object(self, i, j, kind: Optional[str] = None, color: Optional[str] = None):
        if kind is None:  # roomgrid.py:209-213: kind drawn before color
            kind = self.rand_elem(["key", "ball", "box"])
        if color is None:
            color = self.rand_color()
        return self.place_in_room(i, j, TwinObj(kind, color))

    def add_door(
        self,
        i: int,
        j: int,
        door_idx: Optional[int] = None,
        color: Optional[str] = None,
        locked: Optional[bool] = None,
    ):
        room = self.get_room(i, j)  # roomgrid.py:230-274
        if door_idx is None:
            while True:  # retry-until-free wall: one draw per try (:247-250)
                door_idx = self.rand_int(0, 4)
                if room.neighbors[door_idx] and room.doors[door_idx] is None:
                    break
        if color is None:
            color = self.rand_color()  # :252-253
        if locked is None:
            locked = self.rand_bool()  # :255-256
        room.locked = locked
        door = TwinObj("door", color, state=2 if locked else 1)
        pos = room.door_pos[door_idx]
        self.set(pos[0], pos[1], door)
        room.doors[door_idx] = door
        room.neighbors[door_idx].doors[(door_idx + 2) % 4] = door
        return door, pos

    def remove_wall(self, i: int, j: int, wall_idx: int) -> None:
        room = self.get_room(i, j)  # roomgrid.py:276-311, no draws
        tx, ty = room.top
        w, h = room.size
        if wall_idx == 0:
            for k in range(1, h - 1):
                self.set(tx + w - 1, ty + k, None)
        elif wall_idx == 1:
            for k in range(1, w - 1):
                self.set(tx + k, ty + h - 1, None)
        elif wall_idx == 2:
            for k in range(1, h - 1):
                self.set(tx, ty + k, None)
        else:
            for k in range(1, w - 1):
                self.set(tx + k, ty, None)
        room.doors[wall_idx] = True
        room.neighbors[wall_idx].doors[(wall_idx + 2) % 4] = True

    def place_agent_room(
        self, i: Optional[int] = None, j: Optional[int] = None, rand_dir: bool = True
    ):
        if i is None:  # roomgrid.py:313-334
            i = self.rand_int(0, self.num_cols)
        if j is None:
            j = self.rand_int(0, self.num_rows)
        room = self.room_grid[j][i]
        while True:  # resample while facing a non-wall object (:328-332)
            self.place_agent_rect(room.top, room.size, rand_dir, max_tries=1000)
            front = self.get(*self.front_pos)
            if front is None or front.type == "wall":
                break
        return self.agent_pos

    def connect_all(
        self, door_colors=COLOR_NAMES, max_itrs: int = 5000
    ) -> List[TwinObj]:
        """roomgrid.py:336-394 — DFS reachability + random door insertion.
        Draw pattern per iteration: 3 ints (i, j, k); +1 color draw only when
        the (i,j,k) slot is usable."""
        start_room = self.room_from_pos(*self.agent_pos)
        added = []

        def reach_count() -> int:
            seen, stack = set(), [start_room]
            while stack:
                room = stack.pop()
                if id(room) in seen:
                    continue
                seen.add(id(room))
                for d in range(4):
                    if room.doors[d]:
                        stack.append(room.neighbors[d])
            return len(seen)

        num_itrs = 0
        while True:
            if num_itrs > max_itrs:
                raise RecursionError("connect_all failed")
            num_itrs += 1
            if reach_count() == self.num_rows * self.num_cols:
                break
            i = self.rand_int(0, self.num_cols)
            j = self.rand_int(0, self.num_rows)
            k = self.rand_int(0, 4)
            room = self.get_room(i, j)
            if not room.door_pos[k] or room.doors[k]:
                continue
            if room.locked or room.neighbors[k].locked:
                continue
            color = self.rand_elem(door_colors)
            door, _ = self.add_door(i, j, k, color, False)
            added.append(door)
        return added

    def add_distractors(
        self,
        i: Optional[int] = None,
        j: Optional[int] = None,
        num_distractors: int = 10,
        all_unique: bool = True,
    ) -> List[TwinObj]:
        """roomgrid.py:396-438 — color drawn before type; a duplicate
        (type,color) under all_unique consumes the two draws and retries."""
        objs = [
            (o.type, o.color)
            for row in self.room_grid
            for room in row
            for o in room.objs
        ]
        dists: List[TwinObj] = []
        while len(dists) < num_distractors:
            color = self.rand_elem(COLOR_NAMES)
            kind = self.rand_elem(["key", "ball", "box"])
            if all_unique and (kind, color) in objs:
                continue
            room_i = self.rand_int(0, self.num_cols) if i is None else i
            room_j = self.rand_int(0, self.num_rows) if j is None else j
            dist, _ = self.add_object(room_i, room_j, kind, color)
            objs.append((kind, color))
            dists.append(dist)
        return dists


# ---------------------------------------------------------------------------
# Per-family generators (each is the draw-order twin of one _gen_grid)
# ---------------------------------------------------------------------------


class TwinLayout:
    """Twin generation result: planes + pose + per-family episode data."""

    def __init__(self, env: TwinEnv, **extra):
        (
            self.grid_obj,
            self.grid_color,
            self.grid_state,
            self.contains_obj,
            self.contains_color,
        ) = env.planes()
        self.agent_pos = tuple(env.agent_pos)
        self.agent_dir = int(env.agent_dir)
        self.extra = extra


def gen_empty(seed, size, agent_start_pos=(1, 1), agent_start_dir=0) -> TwinLayout:
    """envs/empty.py:96-113."""
    t = TwinEnv(size, size, seed)
    t.wall_rect(0, 0, size, size)
    t.put_obj(TwinObj("goal", "green"), size - 2, size - 2)
    if agent_start_pos is not None:
        t.agent_pos, t.agent_dir = agent_start_pos, agent_start_dir
    else:
        t.place_agent_rect()
    return TwinLayout(t)


def gen_fourrooms(seed, size=19) -> TwinLayout:
    """envs/fourrooms.py:79-128 (registered with default agent/goal=None)."""
    t = TwinEnv(size, size, seed)
    t.horz_wall(0, 0)
    t.horz_wall(0, size - 1)
    t.vert_wall(0, 0)
    t.vert_wall(size - 1, 0)
    room_w, room_h = size // 2, size // 2
    for j in range(2):
        for i in range(2):
            x_l, y_t = i * room_w, j * room_h
            x_r, y_b = x_l + room_w, y_t + room_h
            if i + 1 < 2:  # vertical wall + gap draw (:101-104)
                t.vert_wall(x_r, y_t, room_h)
                t.set(x_r, t.rand_int(y_t + 1, y_b), None)
            if j + 1 < 2:  # horizontal wall + gap draw (:107-110)
                t.horz_wall(x_l, y_b, room_w)
                t.set(t.rand_int(x_l + 1, x_r), y_b, None)
    t.place_agent_rect()  # :119 (agent default pos is None in the registry)
    t.place_obj(TwinObj("goal", "green"))  # :127
    return TwinLayout(t)


def gen_doorkey(seed, size) -> TwinLayout:
    """envs/doorkey.py:75-100."""
    t = TwinEnv(size, size, seed)
    t.wall_rect(0, 0, size, size)
    t.put_obj(TwinObj("goal", "green"), size - 2, size - 2)
    split = t.rand_int(2, size - 2)
    t.vert_wall(split, 0)
    t.place_agent_rect(size=(split, size))
    door_y = t.rand_int(1, size - 2)
    t.put_obj(TwinObj("door", "yellow", state=2), split, door_y)
    t.place_obj(TwinObj("key", "yellow"), top=(0, 0), size=(split, size))
    return TwinLayout(t)


def gen_crossing(seed, size, num_crossings, lava: bool) -> TwinLayout:
    """envs/crossing.py:122-180 — rivers shuffle, river fill, path shuffle,
    one ``choice`` draw per opening."""
    t = TwinEnv(size, size, seed)
    t.wall_rect(0, 0, size, size)
    t.agent_pos, t.agent_dir = (1, 1), 0
    t.put_obj(TwinObj("goal", "green"), size - 2, size - 2)
    kind = "lava" if lava else "wall"
    color = "red" if lava else "grey"

    rivers = [("v", i) for i in range(2, size - 2, 2)]
    rivers += [("h", j) for j in range(2, size - 2, 2)]
    t.rng.shuffle(rivers)  # :144 — same length/sequence-type => same draws
    rivers = rivers[:num_crossings]
    rivers_v = sorted(pos for d, pos in rivers if d == "v")
    rivers_h = sorted(pos for d, pos in rivers if d == "h")
    import itertools as itt

    for i, j in itt.chain(
        itt.product(range(1, size - 1), rivers_h),
        itt.product(rivers_v, range(1, size - 1)),
    ):
        t.put_obj(TwinObj(kind, color), i, j)

    path = ["h"] * len(rivers_v) + ["v"] * len(rivers_h)
    t.rng.shuffle(path)  # :158
    limits_v = [0] + rivers_v + [size - 1]
    limits_h = [0] + rivers_h + [size - 1]
    room_i = room_j = 0
    for direction in path:  # :163-178
        if direction == "h":
            i = limits_v[room_i + 1]
            j = int(t.rng.choice(range(limits_h[room_j] + 1, limits_h[room_j + 1])))
            room_i += 1
        else:
            i = int(t.rng.choice(range(limits_v[room_i] + 1, limits_v[room_i + 1])))
            j = limits_h[room_j + 1]
            room_j += 1
        t.set(i, j, None)
    return TwinLayout(t)


def gen_dynamicobstacles(
    seed, size, n_obstacles, agent_start_pos=(1, 1), agent_start_dir=0
) -> TwinLayout:
    """envs/dynamicobstacles.py:111-134 (n_obstacles already clamped by the
    ctor rule :84-88: kept iff <= size/2 + 1, else size/2)."""
    if not n_obstacles <= size / 2 + 1:
        n_obstacles = int(size / 2)
    t = TwinEnv(size, size, seed)
    t.wall_rect(0, 0, size, size)
    t.set(size - 2, size - 2, TwinObj("goal", "green"))
    if agent_start_pos is not None:
        t.agent_pos, t.agent_dir = agent_start_pos, agent_start_dir
    else:
        t.place_agent_rect()
    obstacles = []
    obstacle_objs = []
    for _ in range(n_obstacles):
        ball = TwinObj("ball", "blue")
        t.place_obj(ball, max_tries=100)
        obstacles.append(ball.pos)
        obstacle_objs.append(ball)
    # The live twin env (with its RNG mid-stream) and the ball records are
    # kept so DynObsStepTwin can continue the reference's per-STEP draw
    # stream (dynamicobstacles.py:141-158) from exactly where reset left it.
    return TwinLayout(t, obstacles=obstacles, twin_env=t, obstacle_objs=obstacle_objs)


class DynObsStepTwin:
    """Host mirror of ``DynamicObstaclesEnv.step``'s RNG consumption.

    The reference consumes ``np_random`` draws *inside* ``step`` — one
    rejection-sampled ``place_obj(ball, top=old-(1,1), size=(3,3),
    max_tries=100)`` per obstacle per step, with the old cell cleared only
    after a successful placement and a fully-blocked neighborhood leaving
    the ball in place via the swallowed exception
    (/root/reference/minigrid/envs/dynamicobstacles.py:136-167).  This twin
    replays those draws from the post-reset RNG state, so a fixed seed
    defines the whole episode bit-exactly; the device step then runs with
    the ball moves and the pre-move "front not clear" flag uploaded
    (``Environment.pre_step`` disabled), making full-episode trajectory
    parity assertable for the stochastic-transition family too.
    """

    def __init__(self, layout: TwinLayout):
        self.t: TwinEnv = layout.extra["twin_env"]
        self.obstacles: List[TwinObj] = layout.extra["obstacle_objs"]

    def host_pre_step(self, action: int) -> Tuple[int, bool]:
        """Mirror dynamicobstacles.py:136-158: remap invalid actions, snap
        the pre-move front-cell flag, then move every obstacle.  Returns
        ``(remapped_action, not_clear)``."""
        if action >= 3:  # action_space.n == 3 (:104, :137-138)
            action = 0
        fx, fy = self.t.front_pos
        front = self.t.get(fx, fy)
        not_clear = front is not None and front.type != "goal"  # :140-141
        for ball in self.obstacles:  # :143-156
            old = ball.pos
            top = (old[0] - 1, old[1] - 1)
            try:
                self.t.place_obj(ball, top=top, size=(3, 3), max_tries=100)
                self.t.set(old[0], old[1], None)
            except RecursionError:  # reference: except Exception: pass
                pass
        return action, not_clear

    def mirror_agent_move(self, action: int) -> None:
        """Keep the host agent pose in sync with the (deterministic) device
        base transition (minigrid_env.py:536-553; only left/right/forward
        reach it in this family)."""
        t = self.t
        if action == 0:
            t.agent_dir = (t.agent_dir - 1) % 4
        elif action == 1:
            t.agent_dir = (t.agent_dir + 1) % 4
        elif action == 2:
            fx, fy = t.front_pos
            fwd = t.get(fx, fy)
            if fwd is None or fwd.type in ("goal", "floor", "lava"):
                t.agent_pos = (fx, fy)


# BabyAI levels live in utils/twin_babyai.py (full instruction-grammar twin).


# ---------------------------------------------------------------------------
# Twin registry + device-state construction
# ---------------------------------------------------------------------------

# env id -> layout generator (seed -> TwinLayout).  Families covered: the five
# BASELINE.json configs and their registered size variants.
TWIN_GENERATORS: Dict[str, Callable[[int], TwinLayout]] = {}


def _twin(env_id: str, fn: Callable[..., TwinLayout], **kw) -> None:
    TWIN_GENERATORS[env_id] = lambda seed: fn(seed, **kw)


for _size in (5, 6, 8, 16):
    _twin(f"MiniGrid-Empty-{_size}x{_size}-v0", gen_empty, size=_size)
for _size in (5, 6):
    _twin(
        f"MiniGrid-Empty-Random-{_size}x{_size}-v0",
        gen_empty,
        size=_size,
        agent_start_pos=None,
    )
_twin("MiniGrid-FourRooms-v0", gen_fourrooms)
for _size in (5, 6, 8, 16):
    _twin(f"MiniGrid-DoorKey-{_size}x{_size}-v0", gen_doorkey, size=_size)
for _size, _n in ((9, 1), (9, 2), (9, 3), (11, 5)):
    _twin(
        f"MiniGrid-LavaCrossingS{_size}N{_n}-v0",
        gen_crossing,
        size=_size,
        num_crossings=_n,
        lava=True,
    )
    _twin(
        f"MiniGrid-SimpleCrossingS{_size}N{_n}-v0",
        gen_crossing,
        size=_size,
        num_crossings=_n,
        lava=False,
    )
for _size, _n in ((5, 2), (6, 3), (8, 4), (16, 8)):
    _twin(
        f"MiniGrid-Dynamic-Obstacles-{_size}x{_size}-v0",
        gen_dynamicobstacles,
        size=_size,
        n_obstacles=_n,
    )
for _size, _n in ((5, 2), (6, 3)):
    _twin(
        f"MiniGrid-Dynamic-Obstacles-Random-{_size}x{_size}-v0",
        gen_dynamicobstacles,
        size=_size,
        n_obstacles=_n,
        agent_start_pos=None,
    )

def twin_ids() -> List[str]:
    return sorted(TWIN_GENERATORS)


def twin_layout(env_id: str, seed: int) -> TwinLayout:
    return TWIN_GENERATORS[env_id](seed)


def twin_reset(env_id: str, seed: int, rng=None, layout: Optional[TwinLayout] = None):
    """Seed-matched device reset: generate the layout with the parity twin
    and upload it as an :class:`EnvState` ready for the device step kernels.

    Returns ``(state, env)`` where ``env`` is the registered
    :class:`Environment` for ``env_id``.  Pass a precomputed ``layout`` to
    keep a handle on the live twin (its RNG mid-stream) — needed by
    :class:`DynObsStepTwin` to continue the per-step draw stream.
    """
    import jax
    import jax.numpy as jnp

    import minigrid_dynamicprogramming_tpu as mgtpu
    from minigrid_dynamicprogramming_tpu.core.state import (
        AUX_SLOTS,
        MISSION_SLOTS,
        EnvState,
    )

    if layout is None:
        layout = twin_layout(env_id, seed)
    env = mgtpu.make(env_id)
    h, w = layout.grid_obj.shape
    assert (w, h) == (env.params.width, env.params.height), env_id

    aux = np.zeros((AUX_SLOTS,), dtype=np.int32)
    mission = np.zeros((MISSION_SLOTS,), dtype=np.int32)
    marks = np.zeros((h, w), dtype=np.uint16)

    if "obstacles" in layout.extra:  # DynamicObstacles ball slots
        for k, (x, y) in enumerate(layout.extra["obstacles"]):
            aux[2 * k], aux[2 * k + 1] = x, y

    # Generic per-family episode constants (twin_minigrid generators).
    for slot, val in layout.extra.get("aux_map", {}).items():
        aux[slot] = val
    for slot, val in layout.extra.get("mission_map", {}).items():
        mission[slot] = val

    carrying_obj, carrying_color = OBJ_EMPTY, 0
    carrying_marks = 0
    if "instrs" in layout.extra:  # BabyAI instruction tree
        from minigrid_dynamicprogramming_tpu.envs.babyai import core as B
        from minigrid_dynamicprogramming_tpu.utils.twin_babyai import (
            encode_instrs,
        )

        mission, marks, carrying_marks = encode_instrs(layout, MISSION_SLOTS)
        for i in range(4):
            aux[B.AUX_PC_NONE + i] = 1
        aux[B.AUX_MAX_STEPS] = layout.extra["max_steps"]
        carry = layout.extra.get("carry")
        if carry is not None:  # PutNext start_carrying (putnext.py:192-201)
            t, c, _ = carry.encode()
            carrying_obj, carrying_color = t, c

    if rng is None:
        rng = jax.random.PRNGKey(seed)

    state = EnvState(
        grid_obj=jnp.asarray(layout.grid_obj),
        grid_color=jnp.asarray(layout.grid_color),
        grid_state=jnp.asarray(layout.grid_state),
        contains_obj=jnp.asarray(layout.contains_obj),
        contains_color=jnp.asarray(layout.contains_color),
        marks=jnp.asarray(marks),
        vmarks=jnp.asarray(marks),
        carrying_marks=jnp.asarray(carrying_marks, dtype=jnp.uint16),
        agent_pos=jnp.asarray(list(layout.agent_pos), dtype=jnp.int32),
        agent_dir=jnp.asarray(layout.agent_dir, dtype=jnp.int32),
        carrying_obj=jnp.asarray(carrying_obj, dtype=jnp.uint8),
        carrying_color=jnp.asarray(carrying_color, dtype=jnp.uint8),
        carrying_contains_obj=jnp.asarray(OBJ_EMPTY, dtype=jnp.uint8),
        carrying_contains_color=jnp.asarray(0, dtype=jnp.uint8),
        step_count=jnp.asarray(0, dtype=jnp.int32),
        terminated=jnp.asarray(False),
        truncated=jnp.asarray(False),
        aux=jnp.asarray(aux),
        mission=jnp.asarray(mission),
        rng=rng,
    )
    return state, env


# Register the remaining MiniGrid-family and BabyAI twin generators (imported
# for the registration side effect; the modules pull TwinEnv/RoomGridTwin from
# here, which are fully defined by this point).
from minigrid_dynamicprogramming_tpu.utils import twin_minigrid  # noqa: E402,F401
from minigrid_dynamicprogramming_tpu.utils import twin_babyai  # noqa: E402,F401
