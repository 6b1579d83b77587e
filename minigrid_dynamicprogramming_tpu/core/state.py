"""Struct-of-arrays environment state.

The reference keeps the world as a ``list[WorldObj | None]`` of Python object
instances (/root/reference/minigrid/core/grid.py:35) plus scalars on the env
(``agent_pos``/``agent_dir``/``carrying``/``step_count``,
/root/reference/minigrid/minigrid_env.py:105-149).  Here the *encoding* of the
grid (``Grid.encode`` → (type, color, state) uint8 triples,
/root/reference/minigrid/core/grid.py:244-268) becomes the representation
itself: three (H, W) uint8 planes, plus two planes for box contents (the one
piece of object state the wire format drops, ``Box.contains``,
/root/reference/minigrid/core/world_object.py:273-294).

Everything is a pytree of fixed-shape arrays so a batch of environments is
just a leading axis added by ``jax.vmap`` and sharded with ``NamedSharding``.

Grid planes are indexed ``[y, x]`` (row-major, like the reference's
``grid[j * width + i]`` layout, grid.py:72).  Observation images are emitted
in the reference's ``[x, y]`` layout at encode time.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core import struct
from minigrid_dynamicprogramming_tpu.core.constants import OBJ_EMPTY

# Number of env-specific int32 scratch slots (target positions, phase flags,
# per-episode constants like Memory's success position, DynamicObstacles'
# obstacle coordinates, BabyAI verifier state, ...).
AUX_SLOTS = 24
# Mission code slots.  MiniGrid envs use the first few
# ([template_id, color_a, type_a, ...]); BabyAI levels store the full
# flattened instruction tree (see envs/babyai/core.py for the layout).
MISSION_SLOTS = 48


@struct.dataclass
class EnvState:
    """Per-environment world state (batched via vmap)."""

    grid_obj: jnp.ndarray  # (H, W) uint8 — object-type plane
    grid_color: jnp.ndarray  # (H, W) uint8
    grid_state: jnp.ndarray  # (H, W) uint8 — door state / 0
    contains_obj: jnp.ndarray  # (H, W) uint8 — box contents type (OBJ_EMPTY = none)
    contains_color: jnp.ndarray  # (H, W) uint8

    # Object-identity bit planes: bit k marks cells holding an object tracked
    # by descriptor slot k (the array form of the BabyAI verifier's
    # ``ObjDesc.obj_set`` identity sets, verifier.py:104-169).  ``marks``
    # follows objects through pickup/drop (ground-truth identity);
    # ``vmarks`` is the position snapshot the verifier actually checks,
    # refreshed from ``marks`` on reset and on drop actions only
    # (roomgrid_level.py:89-91).
    marks: jnp.ndarray  # (H, W) uint16 — 8 descriptor bits + 4 remember bits
    vmarks: jnp.ndarray  # (H, W) uint16

    agent_pos: jnp.ndarray  # (2,) int32 — (x, y)
    agent_dir: jnp.ndarray  # () int32
    carrying_obj: jnp.ndarray  # () uint8 — OBJ_EMPTY = nothing
    carrying_color: jnp.ndarray  # () uint8
    carrying_contains_obj: jnp.ndarray  # () uint8 — contents if carrying a box
    carrying_contains_color: jnp.ndarray  # () uint8
    carrying_marks: jnp.ndarray  # () uint16 — identity bits of the carried obj

    step_count: jnp.ndarray  # () int32
    terminated: jnp.ndarray  # () bool
    truncated: jnp.ndarray  # () bool

    aux: jnp.ndarray  # (AUX_SLOTS,) int32 — env-family scratch
    mission: jnp.ndarray  # (MISSION_SLOTS,) int32 — mission code vector

    rng: jnp.ndarray  # PRNG key consumed by stochastic envs / auto-reset


def new_state(
    height: int,
    width: int,
    *,
    rng: jnp.ndarray,
) -> EnvState:
    """Blank state: all-empty grid, unplaced agent."""
    u8 = jnp.uint8
    return EnvState(
        grid_obj=jnp.full((height, width), OBJ_EMPTY, dtype=u8),
        grid_color=jnp.zeros((height, width), dtype=u8),
        grid_state=jnp.zeros((height, width), dtype=u8),
        contains_obj=jnp.full((height, width), OBJ_EMPTY, dtype=u8),
        contains_color=jnp.zeros((height, width), dtype=u8),
        marks=jnp.zeros((height, width), dtype=jnp.uint16),
        vmarks=jnp.zeros((height, width), dtype=jnp.uint16),
        agent_pos=jnp.array([-1, -1], dtype=jnp.int32),
        agent_dir=jnp.array(-1, dtype=jnp.int32),
        carrying_obj=jnp.array(OBJ_EMPTY, dtype=u8),
        carrying_color=jnp.array(0, dtype=u8),
        carrying_contains_obj=jnp.array(OBJ_EMPTY, dtype=u8),
        carrying_contains_color=jnp.array(0, dtype=u8),
        carrying_marks=jnp.array(0, dtype=jnp.uint16),
        step_count=jnp.array(0, dtype=jnp.int32),
        terminated=jnp.array(False),
        truncated=jnp.array(False),
        aux=jnp.zeros((AUX_SLOTS,), dtype=jnp.int32),
        mission=jnp.zeros((MISSION_SLOTS,), dtype=jnp.int32),
        rng=rng,
    )


@struct.dataclass
class EnvParams:
    """Static (trace-time) configuration shared by all env families.

    Mirrors the constructor surface of ``MiniGridEnv.__init__``
    (/root/reference/minigrid/minigrid_env.py:34-48).  Env-family-specific
    extras live in ``extra`` (a hashable tuple of key/value pairs) so the
    dataclass stays hashable and usable as a jit static argument.
    """

    width: int = struct.field(pytree_node=False, default=8)
    height: int = struct.field(pytree_node=False, default=8)
    max_steps: int = struct.field(pytree_node=False, default=100)
    see_through_walls: bool = struct.field(pytree_node=False, default=False)
    agent_view_size: int = struct.field(pytree_node=False, default=7)
    extra: tuple = struct.field(pytree_node=False, default=())

    def opt(self, name: str, default: Any = None) -> Any:
        for k, v in self.extra:
            if k == name:
                return v
        return default

    def with_extra(self, **kwargs) -> "EnvParams":
        merged = dict(self.extra)
        merged.update(kwargs)
        return self.replace(extra=tuple(sorted(merged.items())))
