"""PPO learner smoke + learning tests on the virtual 8-device CPU mesh.

The reference has no learner; this guards BASELINE.json config 5 — sharded
env batches feeding a data-parallel PPO update — end to end: shapes, metric
finiteness, mesh-sharded execution, and actual reward improvement on the
easiest env.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.models import PPO, PPOConfig
from minigrid_dynamicprogramming_tpu.parallel.sharding import env_mesh


def test_ppo_update_runs_sharded():
    env = mgtpu.make("MiniGrid-Empty-5x5-v0")
    cfg = PPOConfig(num_envs=64, rollout_len=8, epochs=1, num_minibatches=2)
    ppo = PPO(env, cfg, mesh=env_mesh())
    ts = ppo.init(jax.random.PRNGKey(0))
    ts, m = ppo.update(ts)
    ts, m = ppo.update(ts)
    assert int(ts.update_idx) == 2
    for v in m:
        assert np.all(np.isfinite(np.asarray(v))), m
    # env batch stays sharded over all 8 virtual devices between updates
    assert len(ts.env_state.grid_obj.sharding.device_set) == 8


@pytest.mark.slow
def test_ppo_learns_empty_env():
    # A 1-device mesh: SPMD partitioning of the full update graph over the
    # virtual 8-CPU mesh is exercised by test_ppo_update_runs_sharded and is
    # too compile-heavy to repeat for a multi-update learning run.
    env = mgtpu.make("MiniGrid-Empty-5x5-v0")
    cfg = PPOConfig(
        num_envs=128, rollout_len=16, epochs=1, num_minibatches=1, lr=1e-3
    )
    ppo = PPO(env, cfg, mesh=env_mesh(jax.devices()[:1]))
    ts = ppo.init(jax.random.PRNGKey(1))
    first = None
    for u in range(25):
        ts, m = ppo.update(ts)
        if u == 2:
            first = float(m.mean_return)
    last = float(m.mean_return)
    # Empty-5x5 is solvable in a handful of steps; PPO must clearly improve
    # mean terminal reward over the random-ish early policy.
    assert last > first + 0.1, (first, last)


def test_ppo_on_babyai_mission_obs():
    env = mgtpu.make("BabyAI-GoToRedBallGrey-v0")
    cfg = PPOConfig(num_envs=32, rollout_len=8, epochs=1, num_minibatches=1)
    ppo = PPO(env, cfg, mesh=env_mesh(jax.devices()[:1]))
    ts = ppo.init(jax.random.PRNGKey(2))
    ts, m = ppo.update(ts)
    assert np.isfinite(float(m.loss))


@pytest.mark.slow
def test_ppo_pool_autoreset_matches_regen_shapes():
    """Pool mode (the production default) must produce identically-shaped
    train states and metrics to regen mode, with the pool cycling fresh
    layouts (reset_count advances when episodes end)."""
    env = mgtpu.make("MiniGrid-Empty-5x5-v0")
    mesh = env_mesh()
    cfgs = {
        "pool": PPOConfig(
            num_envs=64, rollout_len=16, epochs=1, num_minibatches=2,
            autoreset="pool", pool_rounds=3,
        ),
        "regen": PPOConfig(
            num_envs=64, rollout_len=16, epochs=1, num_minibatches=2,
            autoreset="regen",
        ),
    }
    out = {}
    ppos = {}
    for name, cfg in cfgs.items():
        ppo = PPO(env, cfg, mesh=mesh)
        ppos[name] = ppo
        ts = ppo.init(jax.random.PRNGKey(0))
        ts, m = ppo.update(ts)
        out[name] = (ts, m)
    ts_p, m_p = out["pool"]
    ts_r, m_r = out["regen"]
    assert ts_p.env_state.grid_obj.shape == ts_r.env_state.grid_obj.shape
    assert jax.tree_util.tree_structure(ts_p.params) == jax.tree_util.tree_structure(ts_r.params)
    for v in m_p:
        assert np.all(np.isfinite(np.asarray(v)))
    # the pool has R x B distinct layouts and stays sharded on the env axis
    assert ts_p.pool.grid_obj.shape[:2] == (3, 64)
    assert len(ts_p.pool.grid_obj.sharding.device_set) == 8
    # random-ish policy on Empty-5x5 (max_steps=100) ends episodes within
    # 16 steps only occasionally; keep updating (same compiled program)
    # until the 100-step truncation horizon has certainly passed
    ts = ts_p
    for _ in range(7):
        ts, m = ppos["pool"].update(ts)
    assert int(np.asarray(ts.reset_count).max()) > 0


def test_lane_collector_obs_matches_env_observation():
    """The lane collector's model-input obs must be bit-identical to
    env.observation on the same states (the wire format, incl. the (x, y)
    spatial axis order of gen_obs_image — a transposed image silently
    degrades learning)."""
    import numpy as np

    from minigrid_dynamicprogramming_tpu.parallel import lanes as L

    for env_id in ("MiniGrid-Empty-5x5-v0", "BabyAI-GoToDoor-v0"):
        env = mgtpu.make(env_id)
        ppo = PPO(env, PPOConfig(num_envs=8, rollout_len=4))
        st = jax.vmap(env.generate, in_axes=(0, None))(
            jax.random.split(jax.random.PRNGKey(0), 8), env.params
        )
        ref = jax.vmap(env.observation)(st)
        mine = ppo._obs_from_lanes(L.to_lanes(st))
        for k in ref:
            np.testing.assert_array_equal(
                np.asarray(ref[k]), np.asarray(mine[k]), err_msg=f"{env_id} {k}"
            )


def test_net_matches_seed_parameter_shapes():
    """The plain-JAX net keeps the layer shapes (and so the parameter
    count, 97,224 for a 7x7 view and 7 actions) of the earlier flax
    module it replaced."""
    from minigrid_dynamicprogramming_tpu.models import nets

    params = nets.init_params(jax.random.PRNGKey(0), 7, 7)
    shapes = {
        jax.tree_util.keystr(k): x.shape
        for k, x in jax.tree_util.tree_flatten_with_path(params)[0]
    }
    assert shapes == {
        "['code_embed']": (64, 32),
        "['code_pos']": (48, 32),
        "['conv_0']['bias']": (32,),
        "['conv_0']['kernel']": (3, 3, 24, 32),
        "['conv_1']['bias']": (64,),
        "['conv_1']['kernel']": (3, 3, 32, 64),
        "['conv_2']['bias']": (64,),
        "['conv_2']['kernel']": (3, 3, 64, 64),
        "['dir_embed']": (4, 16),
        "['plane_embed_0']": (16, 8),
        "['plane_embed_1']": (8, 8),
        "['plane_embed_2']": (4, 8),
        "['trunk']['bias']": (256,),
        "['trunk']['kernel']": (112, 256),
        "['policy_head']['bias']": (7,),
        "['policy_head']['kernel']": (256, 7),
        "['value_head']['bias']": (1,),
        "['value_head']['kernel']": (256, 1),
    }
    assert sum(x.size for x in jax.tree_util.tree_leaves(params)) == 97224
    assert all(
        x.dtype == np.float32 for x in jax.tree_util.tree_leaves(params)
    )


def test_net_forward_batched_and_unbatched():
    """Leading batch axes are free: a batch and its first element give the
    same row; logits/value come out float32."""
    from minigrid_dynamicprogramming_tpu.models import nets

    env = mgtpu.make("BabyAI-GoToDoor-v0")
    obs, _ = jax.vmap(env.reset)(jax.random.split(jax.random.PRNGKey(1), 4))
    params = nets.init_params(jax.random.PRNGKey(0), 7, env.action_dim)
    logits, value = nets.apply(params, obs)
    assert logits.shape == (4, env.action_dim) and value.shape == (4,)
    assert logits.dtype == np.float32 and value.dtype == np.float32
    one = jax.tree_util.tree_map(lambda x: x[0], obs)
    l1, v1 = nets.apply(params, one)
    np.testing.assert_allclose(l1, logits[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v1, value[0], rtol=1e-6, atol=1e-6)


def test_rolled_learner_matches_unrolled():
    """The rolled lax.scan learner (what accelerators run) and the
    Python-unrolled one (the CPU default) compute the same update."""
    env = mgtpu.make("MiniGrid-Empty-5x5-v0")
    out = []
    for unroll in (True, False):
        cfg = PPOConfig(
            num_envs=16, rollout_len=8, epochs=2, num_minibatches=2,
            learner_unroll=unroll,
        )
        ppo = PPO(env, cfg, mesh=env_mesh(jax.devices()[:1]))
        ts, m = ppo.update(ppo.init(jax.random.PRNGKey(4)))
        out.append(jax.device_get((ts.params, m)))
    (p_unrolled, m_unrolled), (p_rolled, m_rolled) = out
    for a, b in zip(
        jax.tree_util.tree_leaves(p_unrolled),
        jax.tree_util.tree_leaves(p_rolled),
    ):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(m_unrolled, m_rolled):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
