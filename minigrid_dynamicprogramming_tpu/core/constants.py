"""Integer encodings and behavior lookup tables.

Array-native counterpart of the reference's ``minigrid/core/constants.py``
(see /root/reference/minigrid/core/constants.py:5-58) and of the
``WorldObj`` behavior predicates (``can_overlap``/``can_pickup``/``see_behind``,
/root/reference/minigrid/core/world_object.py:46-64).

The reference dispatches behavior through Python virtual methods on object
instances; here every predicate is a small dense lookup table indexed by the
object-type id so the transition kernel is a branchless gather/where program.
The integer codings themselves are kept bit-identical to the reference because
they *are* the observation wire format (``Grid.encode``,
/root/reference/minigrid/core/grid.py:244-268).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

TILE_PIXELS = 32

# --- object type ids (reference constants.py:25-37) ---
OBJ_UNSEEN = 0
OBJ_EMPTY = 1
OBJ_WALL = 2
OBJ_FLOOR = 3
OBJ_DOOR = 4
OBJ_KEY = 5
OBJ_BALL = 6
OBJ_BOX = 7
OBJ_GOAL = 8
OBJ_LAVA = 9
OBJ_AGENT = 10

NUM_OBJECTS = 11

OBJECT_TO_IDX = {
    "unseen": OBJ_UNSEEN,
    "empty": OBJ_EMPTY,
    "wall": OBJ_WALL,
    "floor": OBJ_FLOOR,
    "door": OBJ_DOOR,
    "key": OBJ_KEY,
    "ball": OBJ_BALL,
    "box": OBJ_BOX,
    "goal": OBJ_GOAL,
    "lava": OBJ_LAVA,
    "agent": OBJ_AGENT,
}
IDX_TO_OBJECT = {v: k for k, v in OBJECT_TO_IDX.items()}

# --- color ids (reference constants.py:20) ---
COLOR_RED = 0
COLOR_GREEN = 1
COLOR_BLUE = 2
COLOR_PURPLE = 3
COLOR_YELLOW = 4
COLOR_GREY = 5

NUM_COLORS = 6

COLOR_TO_IDX = {
    "red": 0,
    "green": 1,
    "blue": 2,
    "purple": 3,
    "yellow": 4,
    "grey": 5,
}
IDX_TO_COLOR = {v: k for k, v in COLOR_TO_IDX.items()}
# Sorted color-name list, mirroring reference COLOR_NAMES (constants.py:17).
COLOR_NAMES = sorted(COLOR_TO_IDX.keys())

COLORS_RGB = np.array(
    [
        [255, 0, 0],  # red
        [0, 255, 0],  # green
        [0, 0, 255],  # blue
        [112, 39, 195],  # purple
        [255, 255, 0],  # yellow
        [100, 100, 100],  # grey
    ],
    dtype=np.uint8,
)

# --- door states (reference constants.py:42-46) ---
STATE_OPEN = 0
STATE_CLOSED = 1
STATE_LOCKED = 2

STATE_TO_IDX = {"open": 0, "closed": 1, "locked": 2}

# --- actions (reference core/actions.py:7-21) ---
ACT_LEFT = 0
ACT_RIGHT = 1
ACT_FORWARD = 2
ACT_PICKUP = 3
ACT_DROP = 4
ACT_TOGGLE = 5
ACT_DONE = 6

NUM_ACTIONS = 7

# --- direction vectors, row = dir id, cols = (dx, dy)
# (reference constants.py:49-58): 0 = +x right, 1 = +y down, 2 = -x left, 3 = -y up
DIR_TO_VEC = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.int32)

# --- behavior LUTs, indexed by object-type id -------------------------------
# can_overlap: Goal/Floor/Lava True, "empty" treated as walkable; Door handled
# separately (open only) in the kernel (world_object.py:178-180).
_CAN_OVERLAP = np.zeros(NUM_OBJECTS, dtype=bool)
_CAN_OVERLAP[[OBJ_EMPTY, OBJ_FLOOR, OBJ_GOAL, OBJ_LAVA]] = True

# can_pickup: Key/Ball/Box (world_object.py:244-245, 266-267, 278-279)
_CAN_PICKUP = np.zeros(NUM_OBJECTS, dtype=bool)
_CAN_PICKUP[[OBJ_KEY, OBJ_BALL, OBJ_BOX]] = True

# see_behind is False for Wall always and for non-open Door
# (world_object.py:165-166, 182-183); everything else True.
_SEE_BEHIND_BLOCKERS = np.zeros(NUM_OBJECTS, dtype=bool)
_SEE_BEHIND_BLOCKERS[OBJ_WALL] = True

CAN_OVERLAP_LUT = jnp.asarray(_CAN_OVERLAP)
CAN_PICKUP_LUT = jnp.asarray(_CAN_PICKUP)
SEE_BEHIND_BLOCKER_LUT = jnp.asarray(_SEE_BEHIND_BLOCKERS)
DIR_TO_VEC_ARR = jnp.asarray(DIR_TO_VEC)
