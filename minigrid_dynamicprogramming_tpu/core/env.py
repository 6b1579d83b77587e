"""Pure-functional environment API.

The reference exposes stateful ``gym.Env`` objects
(/root/reference/minigrid/minigrid_env.py:24).  The batched surface is a
pair of jittable pure functions over an explicit :class:`EnvState` pytree —
``reset(key) -> (obs, state)`` and ``step(key, state, action) ->
(obs, state, reward, terminated, truncated, info)`` — batched with ``vmap``
and sharded with ``NamedSharding``.

Per-env-family behavior plugs in through three hooks, mirroring how the
reference's 25 env subclasses override ``_gen_grid`` and (sometimes) ``step``:

* ``generate(key, params) -> EnvState`` — the ``_gen_grid`` analog
  (minigrid_env.py:231-233); runs entirely on device from a PRNG key.
* ``pre_step`` — world dynamics that run *before* the agent's action
  (e.g. DynamicObstacles moves its balls first,
  /root/reference/minigrid/envs/dynamicobstacles.py:141-158).
* ``post_step`` — reward/termination overrides that run *after* the base
  transition (e.g. Fetch's pickup check,
  /root/reference/minigrid/envs/fetch.py:162-176).

Hooks are bound statically per environment id, so jit specializes each env
into one straight-line fused program — no runtime dispatch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from minigrid_dynamicprogramming_tpu.core.state import EnvParams, EnvState
from minigrid_dynamicprogramming_tpu.ops.obs import gen_obs_image
from minigrid_dynamicprogramming_tpu.ops.step import apply_truncation, base_step

GenerateFn = Callable[[jax.Array, EnvParams], EnvState]
PreStepFn = Callable[[EnvParams, jax.Array, EnvState, jnp.ndarray], EnvState]
PostStepFn = Callable[
    [EnvParams, jax.Array, EnvState, EnvState, jnp.ndarray, jnp.ndarray, jnp.ndarray],
    Tuple[EnvState, jnp.ndarray, jnp.ndarray],
]
MissionTextFn = Callable[[Any], str]


class Environment:
    """One registered environment id: static params + behavior hooks."""

    def __init__(
        self,
        env_id: str,
        params: EnvParams,
        generate: GenerateFn,
        pre_step: Optional[PreStepFn] = None,
        post_step: Optional[PostStepFn] = None,
        mission_text: Optional[MissionTextFn] = None,
        action_map: Optional[Callable[[EnvParams, jnp.ndarray], jnp.ndarray]] = None,
        action_dim: int = 7,
        reward_range: Tuple[float, float] = (0.0, 1.0),
        pre_step_lanes: Optional[PreStepFn] = None,
        post_step_lanes: Optional[PostStepFn] = None,
        generate_stats: Optional[Callable] = None,
        hook_rng: bool = True,
        generate_batch: Optional[Callable] = None,
    ):
        self.env_id = env_id
        self.params = params
        self.generate = generate
        self.pre_step = pre_step
        self.post_step = post_step
        self._mission_text = mission_text
        self.action_map = action_map
        self.action_dim = action_dim
        self.reward_range = reward_range
        # Lane-major (batch-last) variants of the hooks for the fast path
        # (parallel/lanes.py).  Layout-polymorphic hooks — written against
        # ops/agnostic.py — register the SAME function object for both
        # layouts; hooks with layout-specific indexing register a dedicated
        # lane implementation.
        self.pre_step_lanes = pre_step_lanes
        self.post_step_lanes = post_step_lanes
        # Optional telemetry variant of ``generate``:
        # ``(key, params) -> (EnvState, GenStats)`` exposing the bounded
        # masked-rejection loop's acceptance outcome (utils/telemetry.py).
        self.generate_stats = generate_stats
        # Optional pooled generator ``(key, params, n) -> EnvState[n]``.
        # Semantically a faster ``vmap(generate)`` over n fresh keys: envs
        # whose generate wraps a whole-episode rejection while_loop (the
        # BabyAI regenerate-on-reject analog, roomgrid_level.py:118-139) pay
        # the BATCH-MAX retry count per slot under vmap's lockstep; the
        # pooled form oversamples iid attempts once and compacts the
        # accepted ones (distribution-identical: accepted attempts are iid
        # draws from the acceptance-conditioned law).
        self.generate_batch = generate_batch
        # False when the hooks never consume their key argument (e.g. pure
        # reward overrides, the BabyAI verifier): step paths then skip the
        # per-env key split entirely — a measurable win at large batch.
        self.hook_rng = hook_rng

    # -- pure functions (jit/vmap these) ------------------------------------
    def reset(self, key: jax.Array) -> Tuple[Dict[str, jnp.ndarray], EnvState]:
        state = self.generate(key, self.params)
        return self.observation(state), state

    def step(
        self, key: jax.Array, state: EnvState, action: jnp.ndarray
    ) -> Tuple[Dict[str, jnp.ndarray], EnvState, jnp.ndarray, jnp.ndarray, jnp.ndarray, Dict]:
        params = self.params
        if self.hook_rng and (
            self.pre_step is not None or self.post_step is not None
        ):
            k_pre, k_post = jax.random.split(key)
        else:
            k_pre = k_post = None
        if self.action_map is not None:
            action = self.action_map(params, action)
        prev = state
        if self.pre_step is not None:
            state = self.pre_step(params, k_pre, state, action)
        new_state, reward, terminated = base_step(params, state, action)
        if self.post_step is not None:
            new_state, reward, terminated = self.post_step(
                params, k_post, prev, new_state, action, reward, terminated
            )
        new_state = new_state.replace(terminated=terminated)
        new_state = apply_truncation(params, new_state)
        return (
            self.observation(new_state),
            new_state,
            reward,
            terminated,
            new_state.truncated,
            {},
        )

    def observation(self, state: EnvState) -> Dict[str, jnp.ndarray]:
        return {
            "image": gen_obs_image(self.params, state),
            "direction": state.agent_dir,
            "mission": state.mission,
        }

    def in_view(self, state: EnvState, x, y) -> jnp.ndarray:
        """Whether world cell (x, y) is inside the agent's view rectangle
        (``MiniGridEnv.in_view``, minigrid_env.py:495-500).  Jittable."""
        from minigrid_dynamicprogramming_tpu.ops.obs import in_view

        return in_view(self.params, state, x, y)

    def agent_sees(self, state: EnvState, x, y) -> jnp.ndarray:
        """Whether the non-empty world cell (x, y) is visible through the
        encoded observation (``MiniGridEnv.agent_sees``,
        minigrid_env.py:502-518).  Jittable."""
        from minigrid_dynamicprogramming_tpu.ops.obs import agent_sees

        return agent_sees(self.params, state, x, y)

    # -- host-side helpers ---------------------------------------------------
    def mission_text(self, mission_codes) -> str:
        """Decode a mission code vector to the reference's mission string."""
        if self._mission_text is None:
            return ""
        import numpy as np

        return self._mission_text(np.asarray(mission_codes))

    @property
    def mission_space(self):
        """The string-facing mission space for this env id
        (core/mission.py; reference analog minigrid_env.py:72-84's
        observation-space mission entry)."""
        from minigrid_dynamicprogramming_tpu.core.mission import (
            mission_space_for,
        )

        return mission_space_for(self.env_id)

    @property
    def default_params(self) -> EnvParams:
        return self.params
