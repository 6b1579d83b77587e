"""Observation / action / reward wrappers.

Device-side re-derivation of the reference wrapper suite
(/root/reference/minigrid/wrappers.py).  The reference wraps stateful
``gym.Env`` objects; here a wrapper wraps an
:class:`~minigrid_dynamicprogramming_tpu.core.env.Environment` and keeps the
same pure-functional surface — ``reset(key)`` / ``step(key, state, action)``
— so wrapped envs still ``jit``/``vmap``/shard exactly like bare ones.

Wrappers that carry their own state across steps (visit counters) thread it
through a :class:`WrapperState` pytree alongside the inner state, instead of
Python-dict side effects.  Obs transforms are pure array functions fused into
the step program by XLA.

Two wrappers are host-side by design (documented on the class): mission
*strings* only exist host-side (device obs carry mission code vectors), so
``DictObservationSpaceWrapper``'s word-index encoding runs on host, as does
``FlatObsWrapper``'s char one-hot when the mission varies per episode.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from minigrid_dynamicprogramming_tpu.core import struct
from minigrid_dynamicprogramming_tpu.core.constants import (
    ACT_FORWARD,
    OBJ_EMPTY,
    OBJ_GOAL,
    OBJECT_TO_IDX,
)
from minigrid_dynamicprogramming_tpu.core.env import Environment
from minigrid_dynamicprogramming_tpu.core.state import EnvState
from minigrid_dynamicprogramming_tpu.ops.obs import gen_obs_image
from minigrid_dynamicprogramming_tpu.render import render_frame, render_pov

__all__ = [
    "Wrapper",
    "WrapperState",
    "core_state",
    "ReseedWrapper",
    "ActionBonus",
    "PositionBonus",
    "ImgObsWrapper",
    "OneHotPartialObsWrapper",
    "RGBImgObsWrapper",
    "RGBImgPartialObsWrapper",
    "FullyObsWrapper",
    "DictObservationSpaceWrapper",
    "FlatObsWrapper",
    "ViewSizeWrapper",
    "DirectionObsWrapper",
    "SymbolicObsWrapper",
    "StochasticActionWrapper",
    "NoDeath",
    "get_minigrid_words",
]


@struct.dataclass
class WrapperState:
    """Inner env state plus one wrapper's own pytree data."""

    inner: Any
    data: Any


def core_state(state) -> EnvState:
    """Unwrap nested WrapperStates down to the core :class:`EnvState`."""
    while isinstance(state, WrapperState):
        state = state.inner
    return state


class Wrapper:
    """Base wrapper: transparent delegation (wrappers.py Wrapper usage)."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    @property
    def unwrapped(self) -> Environment:
        e = self.env
        while isinstance(e, Wrapper):
            e = e.env
        return e

    def reset(self, key):
        return self.env.reset(key)

    def step(self, key, state, action):
        return self.env.step(key, state, action)


class ObservationWrapper(Wrapper):
    """Applies :meth:`observation` to every obs (gymnasium ObservationWrapper
    semantics)."""

    def observation(self, obs, state):
        raise NotImplementedError

    def reset(self, key):
        obs, state = self.env.reset(key)
        return self.observation(obs, state), state

    def step(self, key, state, action):
        obs, new_state, r, term, trunc, info = self.env.step(key, state, action)
        return self.observation(obs, new_state), new_state, r, term, trunc, info


# ---------------------------------------------------------------------------
# Reward-bonus wrappers (stateful: visit-count tables instead of dicts)
# ---------------------------------------------------------------------------


class ActionBonus(Wrapper):
    """+1/sqrt(N(s, a)) exploration bonus keyed on
    (agent_pos, agent_dir, action), matching wrappers.py:70-125.  The
    reference's dict of counts becomes a dense (W, H, 4, n_actions) int32
    table carried in :class:`WrapperState`.

    Example (first visit of a (state, action) pair earns bonus 1/sqrt(1)):

        >>> import jax, jax.numpy as jnp
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import ActionBonus
        >>> env = ActionBonus(mgtpu.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> obs, state, r, term, trunc, _ = env.step(
        ...     jax.random.PRNGKey(1), state, jnp.int32(2))
        >>> float(r)
        1.0
    """

    def reset(self, key):
        obs, state = self.env.reset(key)
        p = self.unwrapped.params
        counts = jnp.zeros(
            (p.width, p.height, 4, self.unwrapped.action_dim), dtype=jnp.int32
        )
        return obs, WrapperState(inner=state, data=counts)

    def step(self, key, wstate, action):
        obs, inner, r, term, trunc, info = self.env.step(key, wstate.inner, action)
        core = core_state(inner)
        idx = (core.agent_pos[0], core.agent_pos[1], core.agent_dir, action)
        new_count = wstate.data[idx] + 1
        # dynamic_update_slice, not a scatter (batched sub-32-bit scatters
        # miscompiled on an earlier accelerator backend; ``audit_device``
        # checks the live one, ops/grid.py:cell_set)
        counts = jax.lax.dynamic_update_slice(
            wstate.data,
            new_count.reshape(1, 1, 1, 1),
            (idx[0], idx[1], idx[2], jnp.asarray(action)),
        )
        r = r + 1.0 / jnp.sqrt(new_count.astype(jnp.float32))
        return obs, WrapperState(inner=inner, data=counts), r, term, trunc, info


class PositionBonus(Wrapper):
    """+1/sqrt(N(pos)) exploration bonus keyed on the post-step agent
    position (wrappers.py:128-187).

    Example:

        >>> import jax, jax.numpy as jnp
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import PositionBonus
        >>> env = PositionBonus(mgtpu.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> obs, state, r, term, trunc, _ = env.step(
        ...     jax.random.PRNGKey(1), state, jnp.int32(0))
        >>> float(r)  # turning in place still visits the position once
        1.0
    """

    def reset(self, key):
        obs, state = self.env.reset(key)
        p = self.unwrapped.params
        counts = jnp.zeros((p.width, p.height), dtype=jnp.int32)
        return obs, WrapperState(inner=state, data=counts)

    def step(self, key, wstate, action):
        obs, inner, r, term, trunc, info = self.env.step(key, wstate.inner, action)
        core = core_state(inner)
        idx = (core.agent_pos[0], core.agent_pos[1])
        new_count = wstate.data[idx] + 1
        counts = jax.lax.dynamic_update_slice(
            wstate.data, new_count.reshape(1, 1), (idx[0], idx[1])
        )
        r = r + 1.0 / jnp.sqrt(new_count.astype(jnp.float32))
        return obs, WrapperState(inner=inner, data=counts), r, term, trunc, info


# ---------------------------------------------------------------------------
# Observation wrappers
# ---------------------------------------------------------------------------


class ImgObsWrapper(ObservationWrapper):
    """Image-only observation (wrappers.py:190-217).

    Example:

        >>> import jax
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import ImgObsWrapper
        >>> env = ImgObsWrapper(mgtpu.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> obs.shape
        (7, 7, 3)
    """

    def observation(self, obs, state):
        return obs["image"]


class OneHotPartialObsWrapper(ObservationWrapper):
    """(v, v, 3) symbolic image -> (v, v, 20) one-hot of type/color/state
    (wrappers.py:220-287).

    Example:

        >>> import jax
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import (
        ...     OneHotPartialObsWrapper)
        >>> env = OneHotPartialObsWrapper(mgtpu.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> obs["image"].shape
        (7, 7, 20)
    """

    N_TYPE, N_COLOR, N_STATE = 11, 6, 3

    def observation(self, obs, state):
        img = obs["image"].astype(jnp.int32)
        t = jax.nn.one_hot(img[..., 0], self.N_TYPE, dtype=jnp.uint8)
        c = jax.nn.one_hot(img[..., 1], self.N_COLOR, dtype=jnp.uint8)
        s = jax.nn.one_hot(img[..., 2], self.N_STATE, dtype=jnp.uint8)
        return {**obs, "image": jnp.concatenate([t, c, s], axis=-1)}


class RGBImgObsWrapper(ObservationWrapper):
    """Full-grid RGB frame as the image obs (wrappers.py:290-334).  Rendering
    is a device-side tile-LUT gather, so this stays inside jit/vmap.

    Example (5x5 grid at 8px tiles -> 40x40 RGB):

        >>> import jax
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import RGBImgObsWrapper
        >>> env = RGBImgObsWrapper(mgtpu.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> obs["image"].shape
        (40, 40, 3)
    """

    def __init__(self, env, tile_size: int = 8, highlight: bool = True):
        super().__init__(env)
        self.tile_size = tile_size
        self.highlight = highlight

    def observation(self, obs, state):
        core = core_state(state)
        img = render_frame(
            self.unwrapped.params, core, self.tile_size, self.highlight
        )
        return {**obs, "image": img}


class RGBImgPartialObsWrapper(ObservationWrapper):
    """Agent-POV RGB frame as the image obs (wrappers.py:337-381).

    Example (7x7 view at 8px tiles -> 56x56 RGB):

        >>> import jax
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import (
        ...     RGBImgPartialObsWrapper)
        >>> env = RGBImgPartialObsWrapper(mgtpu.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> obs["image"].shape
        (56, 56, 3)
    """

    def __init__(self, env, tile_size: int = 8):
        super().__init__(env)
        self.tile_size = tile_size

    def observation(self, obs, state):
        core = core_state(state)
        return {**obs, "image": render_pov(self.unwrapped.params, core, self.tile_size)}


class FullyObsWrapper(ObservationWrapper):
    """Full symbolic (W, H, 3) grid with the agent cell encoded as
    (agent=10, red=0, dir) (wrappers.py:384-423).

    Example:

        >>> import jax
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import FullyObsWrapper
        >>> env = FullyObsWrapper(mgtpu.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> obs["image"].shape
        (5, 5, 3)
        >>> int((obs["image"][..., 0] == 10).sum())  # exactly one agent cell
        1
    """

    def observation(self, obs, state):
        core = core_state(state)
        img = jnp.stack(
            [core.grid_obj.T, core.grid_color.T, core.grid_state.T], axis=-1
        )
        # one-hot where over (W, H), not a batched dynamic_update_slice —
        # DUS is the slow lowering in vmapped contexts and inconsistent
        # with the one-hot-everywhere policy (ops/grid.py:cell_set).
        w, h = img.shape[0], img.shape[1]
        xs = jnp.arange(w, dtype=jnp.int32)[:, None]
        ys = jnp.arange(h, dtype=jnp.int32)[None, :]
        at_agent = ((xs == core.agent_pos[0]) & (ys == core.agent_pos[1]))[..., None]
        agent = jnp.array(
            [OBJECT_TO_IDX["agent"], 0, 0], dtype=jnp.uint8
        ).at[2].set(core.agent_dir.astype(jnp.uint8))
        img = jnp.where(at_agent, agent[None, None, :], img)
        return {**obs, "image": img}


class SymbolicObsWrapper(ObservationWrapper):
    """Full grid of (x, y, obj_idx) triples, empty cells -1, agent cell 10
    (wrappers.py:726-772).  Emitted as int32 (the reference emits platform
    int); values are identical.

    Example:

        >>> import jax
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import (
        ...     SymbolicObsWrapper)
        >>> env = SymbolicObsWrapper(mgtpu.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> obs["image"].shape
        (5, 5, 3)
        >>> int((obs["image"][..., 2] == 10).sum())  # the agent cell
        1
    """

    def observation(self, obs, state):
        core = core_state(state)
        w = core.grid_obj.shape[1]
        h = core.grid_obj.shape[0]
        objs = jnp.where(
            core.grid_obj == OBJ_EMPTY, -1, core.grid_obj.astype(jnp.int32)
        ).T  # [x, y]
        xs = jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32)[:, None], (w, h))
        ys = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[None, :], (w, h))
        # one-hot where, not a dynamic scatter (batched sub-32-bit scatters
        # miscompiled on an earlier accelerator backend; ``audit_device``
        # checks the live one, ops/grid.py:cell_set)
        at_agent = (xs == core.agent_pos[0]) & (ys == core.agent_pos[1])
        objs = jnp.where(at_agent, OBJECT_TO_IDX["agent"], objs)
        img = jnp.stack([xs, ys, objs], axis=-1)
        return {**obs, "image": img}


class ViewSizeWrapper(ObservationWrapper):
    """Re-renders the symbolic partial obs at a different view size
    (wrappers.py:626-670).

    Example:

        >>> import jax
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import ViewSizeWrapper
        >>> env = ViewSizeWrapper(
        ...     mgtpu.make("MiniGrid-Empty-5x5-v0"), agent_view_size=5)
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> obs["image"].shape
        (5, 5, 3)
    """

    def __init__(self, env, agent_view_size: int = 7):
        super().__init__(env)
        assert agent_view_size % 2 == 1 and agent_view_size >= 3
        self.agent_view_size = agent_view_size

    def observation(self, obs, state):
        core = core_state(state)
        p = self.unwrapped.params.replace(agent_view_size=self.agent_view_size)
        return {**obs, "image": gen_obs_image(p, core)}


class DirectionObsWrapper(ObservationWrapper):
    """Adds ``goal_direction`` — the slope (or arctan angle) toward the first
    goal cell, replicating wrappers.py:673-723 including its quirky
    coordinate pairing (goal index decoded as (idx // height, idx % width)
    and differenced against (agent_x, agent_y) crosswise).  The reference
    caches the goal across *all* resets of the wrapper object; here it is
    derived from the episode's own grid, which is identical for every
    registered env (static goals).

    Example:

        >>> import jax
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import (
        ...     DirectionObsWrapper)
        >>> env = DirectionObsWrapper(
        ...     mgtpu.make("MiniGrid-Empty-5x5-v0"), type="slope")
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> "goal_direction" in obs
        True
    """

    def __init__(self, env, type: str = "slope"):
        super().__init__(env)
        self.type = type

    def observation(self, obs, state):
        core = core_state(state)
        h, w = core.grid_obj.shape
        # Row-major over [j, i]: grid.grid index = j * width + i (grid.py:72).
        flat = (core.grid_obj == OBJ_GOAL).ravel()
        idx = jnp.argmax(flat).astype(jnp.int32)
        gy = idx // h  # reference divides by *height* (wrappers.py:705-708)
        gx = idx % w
        slope = (gx - core.agent_pos[1]) / jnp.float32(gy - core.agent_pos[0])
        val = jnp.arctan(slope) if self.type == "angle" else slope
        return {**obs, "goal_direction": val}


# ---------------------------------------------------------------------------
# Mission-text wrappers (host-side string handling)
# ---------------------------------------------------------------------------


def get_minigrid_words() -> dict:
    """The fixed 50-word vocabulary (wrappers.py:471-529)."""
    colors = ["red", "green", "blue", "yellow", "purple", "grey"]
    objects = [
        "unseen", "empty", "wall", "floor", "box", "key", "ball", "door",
        "goal", "agent", "lava",
    ]
    verbs = [
        "pick", "avoid", "get", "find", "put", "use", "open", "go", "fetch",
        "reach", "unlock", "traverse",
    ]
    extra = [
        "up", "the", "a", "at", ",", "square", "and", "then", "to", "of",
        "rooms", "near", "opening", "must", "you", "matching", "end",
        "hallway", "object", "from", "room",
    ]
    words = colors + objects + verbs + extra
    return {w: i for i, w in enumerate(words)}


class DictObservationSpaceWrapper(ObservationWrapper):
    """Mission string -> padded word-index vector over the fixed vocabulary
    (wrappers.py:426-550).

    HOST-SIDE: mission strings exist only host-side (device obs carry the
    mission *code* vector, which is already fully numerical — the on-device
    answer to this wrapper).  Use outside jit, or use ``obs['mission']``
    codes directly on device.

    Example ("get to the green goal square" over the 50-word vocabulary,
    1-offset, zero-padded to ``max_words_in_mission``):

        >>> import jax
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import (
        ...     DictObservationSpaceWrapper)
        >>> env = DictObservationSpaceWrapper(mgtpu.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> len(obs["mission"])
        50
        >>> obs["mission"][:6]
        [20, 38, 31, 2, 15, 35]
    """

    def __init__(self, env, max_words_in_mission: int = 50, word_dict=None):
        super().__init__(env)
        self.max_words_in_mission = max_words_in_mission
        self.word_dict = word_dict or get_minigrid_words()

    def string_to_indices(self, string: str, offset: int = 1):
        indices = []
        for word in string.replace(",", " , ").split():
            if word not in self.word_dict:
                raise ValueError(f"Unknown word: {word}")
            indices.append(self.word_dict[word] + offset)
        return indices

    def observation(self, obs, state):
        text = self.unwrapped.mission_text(np.asarray(obs["mission"]))
        idx = self.string_to_indices(text)
        assert len(idx) < self.max_words_in_mission
        idx = idx + [0] * (self.max_words_in_mission - len(idx))
        return {**obs, "mission": idx}


def mission_char_onehot(text: str, max_len: int = 96) -> np.ndarray:
    """(max_len, 28) float32 char one-hot (wrappers.py:589-619): a-z, space,
    comma."""
    assert len(text) <= max_len, f"mission string too long ({len(text)} chars)"
    arr = np.zeros((max_len, 28), dtype=np.float32)
    for i, ch in enumerate(text.lower()):
        if "a" <= ch <= "z":
            no = ord(ch) - ord("a")
        elif ch == " ":
            no = 26
        elif ch == ",":
            no = 27
        else:
            raise ValueError(f"Character {ch} is not available in mission string.")
        arr[i, no] = 1
    return arr


class FlatObsWrapper(ObservationWrapper):
    """Image ⊕ char-one-hot mission, flattened (wrappers.py:553-623).

    For envs with a fixed mission (most of the suite) the mission one-hot is
    precomputed at construction and the transform is fully device-side; for
    per-episode missions pass ``mission=None`` and apply host-side.

    Example (7*7*3 image + 96*28 chars = 2835 floats):

        >>> import jax
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import FlatObsWrapper
        >>> env = FlatObsWrapper(mgtpu.make("MiniGrid-Empty-5x5-v0"))
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> obs.shape
        (2835,)
    """

    def __init__(self, env, max_str_len: int = 96, mission: Optional[str] = "auto"):
        super().__init__(env)
        self.max_str_len = max_str_len
        if mission == "auto":
            # Static-mission detection: if the decoded text ignores the code
            # vector the mission is per-env-id constant and can be baked in.
            try:
                a = self.unwrapped.mission_text(np.zeros(8, dtype=np.int64))
                b = self.unwrapped.mission_text(np.ones(8, dtype=np.int64))
                mission = a if a == b else None
            except Exception:
                mission = None
        self._static_chars = (
            None
            if mission is None
            else jnp.asarray(mission_char_onehot(mission, max_str_len)).ravel()
        )

    def observation(self, obs, state):
        img = obs["image"].reshape(-1).astype(jnp.float32)
        if self._static_chars is not None:
            chars = self._static_chars
        else:
            text = self.unwrapped.mission_text(np.asarray(obs["mission"]))
            chars = jnp.asarray(
                mission_char_onehot(text, self.max_str_len)
            ).ravel()
        return jnp.concatenate([img, chars])


# ---------------------------------------------------------------------------
# Action / dynamics wrappers
# ---------------------------------------------------------------------------


class StochasticActionWrapper(Wrapper):
    """With probability ``1 - prob`` the intended action is replaced by
    ``random_action`` (or a uniform draw over actions 0..5, matching the
    reference's ``integers(0, high=6)``, wrappers.py:775-796).  Randomness
    comes from the step key instead of global numpy state.

    Example (``prob=1.0`` never substitutes, so it behaves like the bare
    env):

        >>> import jax, jax.numpy as jnp
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import (
        ...     StochasticActionWrapper)
        >>> env = StochasticActionWrapper(
        ...     mgtpu.make("MiniGrid-Empty-5x5-v0"), prob=1.0)
        >>> obs, state = env.reset(jax.random.PRNGKey(0))
        >>> obs, state, r, term, trunc, _ = env.step(
        ...     jax.random.PRNGKey(1), state, jnp.int32(0))
        >>> bool(term)
        False
    """

    def __init__(self, env, prob: float = 0.9, random_action: Optional[int] = None):
        super().__init__(env)
        self.prob = prob
        self.random_action = random_action

    def step(self, key, state, action):
        k_wrap, k_env = jax.random.split(key)
        k_u, k_a = jax.random.split(k_wrap)
        keep = jax.random.uniform(k_u) < self.prob
        if self.random_action is None:
            rand = jax.random.randint(k_a, (), 0, 6)
        else:
            rand = jnp.asarray(self.random_action)
        action = jnp.where(keep, action, rand)
        return self.env.step(k_env, state, action)


class NoDeath(Wrapper):
    """Deaths on the given cell types become ``death_cost`` reward without
    termination (wrappers.py:799-872): checks the pre-step front cell (the
    Dynamic-Obstacles pre-move snapshot) and the post-step current cell.

    Example: with seed 12 of LavaCrossingS9N1 the first forward step walks
    into lava — a terminal death on the bare env, a ``death_cost`` penalty
    without termination under the wrapper:

        >>> import jax, jax.numpy as jnp
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import NoDeath
        >>> bare = mgtpu.make("MiniGrid-LavaCrossingS9N1-v0")
        >>> obs, state = bare.reset(jax.random.PRNGKey(12))
        >>> _, _, r, term, _, _ = bare.step(
        ...     jax.random.PRNGKey(1), state, jnp.int32(2))
        >>> float(r), bool(term)
        (0.0, True)
        >>> env = NoDeath(bare, no_death_types=("lava",), death_cost=-1.0)
        >>> obs, state = env.reset(jax.random.PRNGKey(12))
        >>> _, _, r, term, _, _ = env.step(
        ...     jax.random.PRNGKey(1), state, jnp.int32(2))
        >>> float(r), bool(term)
        (-1.0, False)
    """

    def __init__(
        self,
        env,
        no_death_types: Sequence[str],
        death_cost: float = -1.0,
    ):
        assert "goal" not in no_death_types, "goal cannot be a death cell"
        super().__init__(env)
        self.death_cost = death_cost
        self.no_death_ids = jnp.asarray(
            [OBJECT_TO_IDX[t] for t in no_death_types], dtype=jnp.int32
        )

    def _is_death(self, obj):
        return jnp.any(obj.astype(jnp.int32) == self.no_death_ids)

    def step(self, key, state, action):
        prev = core_state(state)
        from minigrid_dynamicprogramming_tpu.core.constants import DIR_TO_VEC_ARR

        fwd = prev.agent_pos + DIR_TO_VEC_ARR[prev.agent_dir]
        h, w = prev.grid_obj.shape
        fx = jnp.clip(fwd[0], 0, w - 1)
        fy = jnp.clip(fwd[1], 0, h - 1)
        front_obj = prev.grid_obj[fy, fx]
        going_to_death = (action == ACT_FORWARD) & self._is_death(front_obj)

        obs, inner, r, term, trunc, info = self.env.step(key, state, action)
        core = core_state(inner)
        cur_obj = core.grid_obj[core.agent_pos[1], core.agent_pos[0]]
        in_death = self._is_death(cur_obj)

        cancel = term & (going_to_death | in_death)
        r = jnp.where(cancel, r + self.death_cost, r)
        term = term & ~cancel
        # The terminated flag lives on the core state too: clear it when a
        # death was cancelled so auto-reset machinery agrees with the return.
        new_inner = _replace_core(
            inner, core.replace(terminated=core.terminated & ~cancel)
        )
        return obs, new_inner, r, term, trunc, info


def _replace_core(state, new_core):
    if isinstance(state, WrapperState):
        return state.replace(inner=_replace_core(state.inner, new_core))
    return new_core


class ReseedWrapper(Wrapper):
    """Cycles a fixed list of seeds on reset (wrappers.py:17-67).  Host-side
    stateful like the reference (the seed cursor lives on the wrapper
    object); for batched use pass explicit per-env keys instead.

    Example (two seeds cycle, so resets 1 and 3 are identical):

        >>> import jax
        >>> import minigrid_dynamicprogramming_tpu as mgtpu
        >>> from minigrid_dynamicprogramming_tpu.wrappers import ReseedWrapper
        >>> env = ReseedWrapper(
        ...     mgtpu.make("MiniGrid-Empty-8x8-v0"), seeds=[7, 9])
        >>> o1, s1 = env.reset()
        >>> o2, s2 = env.reset()
        >>> o3, s3 = env.reset()
        >>> bool((o1["image"] == o3["image"]).all())
        True
    """

    def __init__(self, env, seeds: Sequence[int] = (0,), seed_idx: int = 0):
        super().__init__(env)
        self.seeds = list(seeds)
        self.seed_idx = seed_idx

    def reset(self, key=None):
        seed = self.seeds[self.seed_idx]
        self.seed_idx = (self.seed_idx + 1) % len(self.seeds)
        return self.env.reset(jax.random.PRNGKey(seed))
