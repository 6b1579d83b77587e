"""Parity of the lane-major (batch-last) fast path vs the vmapped path.

The lane kernels (parallel/lanes.py) re-lay-out the step/obs math with the
batch axis last; semantics must be bit-identical to the vmapped reference
kernels (ops/step.py, ops/obs.py), which are themselves parity-tested
against /root/reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.ops.obs import gen_obs_image
from minigrid_dynamicprogramming_tpu.ops.step import apply_truncation, base_step
from minigrid_dynamicprogramming_tpu.parallel import lanes

LANE_ENVS = [
    "MiniGrid-Empty-8x8-v0",
    "MiniGrid-DoorKey-8x8-v0",
    "MiniGrid-FourRooms-v0",
    "MiniGrid-LavaGapS7-v0",
    "MiniGrid-MultiRoom-N4-S5-v0",
]

BATCH = 64
# 30 per-step parity rounds in the default tier (each round syncs both
# paths host-side, which dominates on the CI runner); the slow tier's
# registry-wide sweep plus the 64-layout batches keep coverage deep.
STEPS = 30


def _batched_state(env, key, batch):
    keys = jax.random.split(key, batch)
    return jax.vmap(env.generate, in_axes=(0, None))(keys, env.params)


@pytest.mark.parametrize("env_id", LANE_ENVS)
def test_roundtrip(env_id):
    env = mgtpu.make(env_id)
    state = _batched_state(env, jax.random.PRNGKey(0), BATCH)
    back = lanes.from_lanes(env.params, lanes.to_lanes(state))
    for name in state.__dataclass_fields__:
        np.testing.assert_array_equal(
            np.asarray(getattr(state, name)),
            np.asarray(getattr(back, name)),
            err_msg=name,
        )


@pytest.mark.parametrize("env_id", LANE_ENVS)
def test_step_obs_parity(env_id):
    """Lane step+obs == vmapped step+obs over a random action trajectory."""
    env = mgtpu.make(env_id)
    assert lanes.supports_lanes(env)
    state = _batched_state(env, jax.random.PRNGKey(1), BATCH)
    ls = lanes.to_lanes(state)

    vstep = jax.jit(jax.vmap(base_step, in_axes=(None, 0, 0)))
    vtrunc = jax.jit(jax.vmap(apply_truncation, in_axes=(None, 0)))
    vobs = jax.jit(jax.vmap(gen_obs_image, in_axes=(None, 0)))
    lstep = jax.jit(lanes.step_lanes, static_argnums=0)
    lobs = jax.jit(lanes.obs_image_lanes, static_argnums=0)

    key = jax.random.PRNGKey(2)
    for t in range(STEPS):
        key, k = jax.random.split(key)
        actions = jax.random.randint(k, (BATCH,), 0, 7)

        state, reward_v, term_v = vstep(env.params, state, actions)
        state = vtrunc(env.params, state)
        img_v = vobs(env.params, state)

        ls, reward_l, term_l = lstep(env.params, ls, actions)
        img_l = lobs(env.params, ls)

        np.testing.assert_array_equal(np.asarray(term_v), np.asarray(term_l))
        np.testing.assert_allclose(
            np.asarray(reward_v), np.asarray(reward_l), rtol=0, atol=0
        )
        np.testing.assert_array_equal(np.asarray(img_v), np.asarray(img_l))
        np.testing.assert_array_equal(
            np.asarray(state.truncated), np.asarray(ls.truncated)
        )

    back = lanes.from_lanes(env.params, ls)
    for name in ("grid_obj", "grid_color", "grid_state", "agent_dir",
                 "carrying_obj", "carrying_color", "step_count"):
        np.testing.assert_array_equal(
            np.asarray(getattr(state, name)),
            np.asarray(getattr(back, name)),
            err_msg=name,
        )
    np.testing.assert_array_equal(
        np.asarray(state.agent_pos),
        np.asarray(jnp.stack([ls.agent_x, ls.agent_y], axis=-1)),
    )


def test_lane_rollout_runs_and_resets():
    env = mgtpu.make("MiniGrid-DoorKey-5x5-v0")
    res = lanes.lane_rollout(
        env, jax.random.PRNGKey(3), 32, horizon=300, autoreset="pool",
        pool_rounds=3,
    )
    assert int(res.episodes) > 0  # max_steps=250 < 300 forces resets
    assert int(res.steps) == 32 * 300
    assert int(res.obs_checksum) != 0
    # Strictly below the max_steps=250 truncation limit: proves truncated
    # lanes were actually replaced by fresh episodes (same-step reset).
    assert int(res.final_state.step_count.max()) < 250


def test_lane_rollout_cached_mode():
    env = mgtpu.make("MiniGrid-Empty-5x5-v0")
    res = lanes.lane_rollout(
        env, jax.random.PRNGKey(4), 16, horizon=64, autoreset="cached"
    )
    assert int(res.steps) == 16 * 64


# -- hooked envs: lane hooks vs vmapped hooks --------------------------------

# One representative per hooked family (pre_step / post_step / action_map).
HOOKED_ENVS = [
    "MiniGrid-Fetch-8x8-N3-v0",
    "MiniGrid-GoToDoor-8x8-v0",
    "MiniGrid-GoToObject-8x8-N2-v0",
    "MiniGrid-MemoryS11-v0",
    "MiniGrid-RedBlueDoors-8x8-v0",
    "MiniGrid-Unlock-v0",
    "MiniGrid-UnlockPickup-v0",
    "MiniGrid-BlockedUnlockPickup-v0",
    "MiniGrid-KeyCorridorS3R3-v0",
    "MiniGrid-PutNear-8x8-N3-v0",
    "MiniGrid-Dynamic-Obstacles-8x8-v0",
    "MiniGrid-ObstructedMaze-1Dlhb-v0",
    "BabyAI-GoToRedBall-v0",
    "BabyAI-OpenTwoDoors-v0",
    "BabyAI-PutNextLocal-v0",
    "BabyAI-ActionObjDoor-v0",
    # seq-combinator coverage: GoToSeq traces the before/after machinery at
    # a fraction of SynthSeq's compile cost; SynthSeq itself (the heaviest
    # instruction profile, ~160 s mostly compile) runs in the slow tier via
    # test_hooked_step_parity_all_ids.
    "BabyAI-GoToSeqS5R2-v0",
]


def _full_step_parity(env_id, batch=8, steps=24, seed=0):
    """Full env.step (hooks + base + truncation): lane path must be
    bit-identical to the vmapped path under the same per-env keys."""
    env = mgtpu.make(env_id)
    assert lanes.supports_lanes(env), env_id
    key = jax.random.PRNGKey(seed)
    k_init, k_run = jax.random.split(key)
    state = _batched_state(env, k_init, batch)
    ls = lanes.to_lanes(state)

    def vstep(keys, st, act):
        _, ns, r, te, tr, _ = jax.vmap(env.step)(keys, st, act)
        return ns, r, te

    vstep = jax.jit(vstep)
    lstep = jax.jit(lambda keys, s, act: lanes.step_lanes_env(env, keys, s, act))

    ks = jax.random.split(k_run, steps)
    for t in range(steps):
        ka, ke = jax.random.split(ks[t])
        act = jax.random.randint(ka, (batch,), 0, env.action_dim)
        keys = jax.random.split(ke, batch)
        state, reward_v, term_v = vstep(keys, state, act)
        ls, reward_l, term_l = lstep(keys, ls, act)
        np.testing.assert_array_equal(np.asarray(term_v), np.asarray(term_l))
        np.testing.assert_allclose(
            np.asarray(reward_v), np.asarray(reward_l), rtol=0, atol=0,
            err_msg=f"{env_id} step {t}",
        )
        back = lanes.from_lanes(env.params, ls)
        for name in state.__dataclass_fields__:
            np.testing.assert_array_equal(
                np.asarray(getattr(state, name)),
                np.asarray(getattr(back, name)),
                err_msg=f"{env_id} step {t} field {name}",
            )


@pytest.mark.parametrize("env_id", HOOKED_ENVS)
def test_hooked_step_parity(env_id):
    _full_step_parity(env_id)


@pytest.mark.slow
@pytest.mark.parametrize("env_id", mgtpu.registered_ids())
def test_hooked_step_parity_all_ids(env_id):
    """Full-registry sweep (every one of the 171 ids steps bit-identically
    on the lane path); run with ``-m slow``."""
    _full_step_parity(env_id, batch=4, steps=10)


def test_all_ids_support_lanes():
    for env_id in mgtpu.registered_ids():
        assert lanes.supports_lanes(mgtpu.make(env_id)), env_id


def test_lane_rollout_hooked_env_runs():
    """lane_rollout end-to-end on a hooked env (BabyAI verifier in lanes)."""
    env = mgtpu.make("BabyAI-GoToRedBallGrey-v0")
    res = lanes.lane_rollout(
        env, jax.random.PRNGKey(5), 16, horizon=64, autoreset="pool",
        pool_rounds=2,
    )
    assert int(res.steps) == 16 * 64
    assert int(res.obs_checksum) != 0


# -- static plane-gate flags (registry._FIXED_*_FAMILIES) --------------------

# One representative per flagged family; the flags let lane_rollout skip the
# mission/aux lanes in the autoreset select, which is only sound if (a) the
# vector is one per-id constant across layouts and (b) stepping never writes
# it.  This test asserts both directly.
_FIXED_FLAG_REPS = [
    "MiniGrid-Empty-Random-6x6-v0",
    "MiniGrid-DoorKey-6x6-v0",
    "MiniGrid-FourRooms-v0",
    "MiniGrid-SimpleCrossingS9N2-v0",
    "MiniGrid-DistShift2-v0",
    "MiniGrid-LavaGapS6-v0",
    "MiniGrid-Dynamic-Obstacles-6x6-v0",
    "MiniGrid-MultiRoom-N2-S4-v0",
    "MiniGrid-RedBlueDoors-6x6-v0",
    "MiniGrid-MemoryS11-v0",
    "MiniGrid-Playground-v0",
    "MiniGrid-LockedRoom-v0",
]


@pytest.mark.parametrize("env_id", _FIXED_FLAG_REPS)
def test_fixed_flags_hold(env_id):
    env = mgtpu.make(env_id)
    fixed_mission = env.params.opt("fixed_mission", False)
    fixed_aux = env.params.opt("fixed_aux", False)
    if not (fixed_mission or fixed_aux):
        pytest.skip("family has no fixed flags")

    batch = 32
    state = _batched_state(env, jax.random.PRNGKey(17), batch)
    mission0 = np.asarray(state.mission)
    aux0 = np.asarray(state.aux)
    # (a) constant across independently generated layouts
    if fixed_mission:
        np.testing.assert_array_equal(
            mission0, np.broadcast_to(mission0[:1], mission0.shape), err_msg="mission"
        )
    if fixed_aux:
        np.testing.assert_array_equal(
            aux0, np.broadcast_to(aux0[:1], aux0.shape), err_msg="aux"
        )

    # (b) invariant under stepping (incl. the family's hooks)
    step = jax.jit(jax.vmap(env.step))
    key = jax.random.PRNGKey(23)
    for _ in range(20):
        key, ka, ks = jax.random.split(key, 3)
        acts = jax.random.randint(ka, (batch,), 0, env.action_dim)
        _, state, *_ = step(jax.random.split(ks, batch), state, acts)
    if fixed_mission:
        np.testing.assert_array_equal(np.asarray(state.mission), mission0)
    if fixed_aux:
        np.testing.assert_array_equal(np.asarray(state.aux), aux0)
