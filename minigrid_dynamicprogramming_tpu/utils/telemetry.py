"""Generation acceptance-rate telemetry (SURVEY §5).

The reference surfaces rejection-sampling exhaustion as exceptions
(``RecursionError`` after ``max_tries`` in ``place_obj``,
/root/reference/minigrid/minigrid_env.py:334-338; the BabyAI
regenerate-on-``RejectSampling`` loop, envs/babyai/core/
roomgrid_level.py:118-139).  The device generators replace those loops with
bounded masked redraws that *cannot* raise under jit — so exhaustion must be
observable as telemetry instead, or a systematically-rejecting config would
silently ship truncated (biased) layout distributions.

``generation_acceptance`` measures, over a batched reset:

- ``accept_rate``     — fraction of envs whose bounded loop accepted a draw
                        (ok=True).  Anything below 1.0 means some layouts
                        came from the loop's fallback and the distribution
                        is suspect at this config.
- ``mean_tries`` / ``p99_tries`` / ``max_tries`` — redraw pressure; a mean
                        creeping toward the bound predicts future truncation.
- ``first_try_rate``  — fraction accepted on the first draw (the reference's
                        no-exception path).

Environments expose the underlying loop state via the optional
``Environment.generate_stats`` hook; envs without one (no rejection loop, or
loop outcomes not observable post-hoc) fall back to a structural-validity
check so the report is never vacuous.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from minigrid_dynamicprogramming_tpu.core.constants import OBJ_EMPTY, OBJ_GOAL, OBJ_FLOOR

__all__ = ["GenStats", "generation_acceptance"]


class GenStats(NamedTuple):
    """Outcome of one bounded masked-rejection generation."""

    tries: jnp.ndarray  # () int32 — redraws consumed (1 = first try)
    ok: jnp.ndarray  # () bool — a draw was accepted before the bound


def generation_acceptance(env, n: int = 4096, seed: int = 0) -> dict:
    """Batched acceptance report for ``env``'s generator (see module doc)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    if env.generate_stats is not None:
        _, stats = jax.jit(
            jax.vmap(env.generate_stats, in_axes=(0, None)), static_argnums=1
        )(keys, env.params)
        tries = np.asarray(stats.tries)
        ok = np.asarray(stats.ok)
        return {
            "env_id": env.env_id,
            "n": n,
            "mode": "loop",
            "accept_rate": float(ok.mean()),
            "first_try_rate": float((tries <= 1).mean()),
            "mean_tries": float(tries.mean()),
            "p99_tries": int(np.percentile(tries, 99)),
            "max_tries": int(tries.max()),
        }

    # Fallback: structural validity of the generated batch (agent in bounds
    # on a walkable cell) — catches a generator whose masked placers all
    # failed and fell back to junk cells (ops/grid.py ok=False path).
    state = jax.jit(
        jax.vmap(env.generate, in_axes=(0, None)), static_argnums=1
    )(keys, env.params)
    pos = np.asarray(state.agent_pos)
    obj = np.asarray(state.grid_obj)
    in_bounds = (
        (pos[:, 0] >= 0)
        & (pos[:, 0] < env.params.width)
        & (pos[:, 1] >= 0)
        & (pos[:, 1] < env.params.height)
    )
    cell = obj[np.arange(n), pos[:, 1].clip(0), pos[:, 0].clip(0)]
    walkable = np.isin(cell, (OBJ_EMPTY, OBJ_GOAL, OBJ_FLOOR))
    return {
        "env_id": env.env_id,
        "n": n,
        "mode": "structural",
        "accept_rate": float((in_bounds & walkable).mean()),
        "first_try_rate": float((in_bounds & walkable).mean()),
        "mean_tries": 1.0,
        "p99_tries": 1,
        "max_tries": 1,
    }
