"""Dynamic programming — the fork's namesake capability (SURVEY.md §0, §2.6).

Batched exact value iteration over the tabular (door-config, carrying, dir,
y, x) state space of generated layouts, as XLA structured sweeps
(:mod:`.tabular`).  The wider domains (key position, obstructing ball, two
keys) live in :mod:`.tabular_key`, :mod:`.tabular_obstructed` and
:mod:`.tabular_twokey`; :mod:`.pallas_vi` holds a fused GPU kernel for the
key-position domain.
"""

from minigrid_dynamicprogramming_tpu.dp.tabular import (
    TabularLayout,
    env_return,
    extract_layout,
    greedy_action,
    solve,
    state_value,
    steps_to_go,
    value_iteration,
)

__all__ = [
    "TabularLayout",
    "extract_layout",
    "value_iteration",
    "solve",
    "greedy_action",
    "state_value",
    "steps_to_go",
    "env_return",
]
