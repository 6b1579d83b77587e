"""PPO over mesh-sharded environment batches.

The reference has no learner (SURVEY.md §0); this realizes BASELINE.json
config 5 — env batches sharded over a ``Mesh`` feed an on-device PPO update.
Design:

* The whole update (rollout collection via ``lax.scan`` over the vmapped
  auto-resetting env step, GAE, epochs x minibatches of clipped-surrogate
  SGD) is ONE jitted function; nothing leaves the device between updates.
* Environments are data-parallel along the ``"env"`` mesh axis; parameters
  are replicated.  Gradients are batch means, so XLA lowers them to a single
  ``psum`` at the learner boundary — env stepping itself needs no
  communication (SURVEY.md §5, "distributed communication backend").
* Minibatching permutes the env axis only (time stays contiguous per env),
  so resharding inside the epoch loop is a cheap all-to-all at worst.
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from minigrid_dynamicprogramming_tpu.core import struct
from minigrid_dynamicprogramming_tpu.core.env import Environment
from minigrid_dynamicprogramming_tpu.models import nets
from minigrid_dynamicprogramming_tpu.parallel.rollout import (
    make_autoreset_step,
    make_pool_autoreset_step,
)
from minigrid_dynamicprogramming_tpu.parallel.sharding import (
    env_mesh,
    shard_batch,
)


@struct.dataclass
class PPOConfig:
    num_envs: int = struct.field(pytree_node=False, default=4096)
    rollout_len: int = struct.field(pytree_node=False, default=64)
    epochs: int = struct.field(pytree_node=False, default=2)
    num_minibatches: int = struct.field(pytree_node=False, default=4)
    gamma: float = struct.field(pytree_node=False, default=0.99)
    gae_lambda: float = struct.field(pytree_node=False, default=0.95)
    clip_eps: float = struct.field(pytree_node=False, default=0.2)
    vf_coef: float = struct.field(pytree_node=False, default=0.5)
    ent_coef: float = struct.field(pytree_node=False, default=0.01)
    lr: float = struct.field(pytree_node=False, default=2.5e-4)
    max_grad_norm: float = struct.field(pytree_node=False, default=0.5)
    # "pool" (default) cycles num_envs * pool_rounds pregenerated layouts at
    # gather cost per reset; "regen" pays full on-device generation in the
    # reset branch of EVERY step (generation-bound on BabyAI); "cached"
    # replays each slot's initial layout.
    autoreset: str = struct.field(pytree_node=False, default="pool")
    pool_rounds: int = struct.field(pytree_node=False, default=4)
    # XLA:CPU executes loop (scan/while) bodies with restricted intra-op
    # threading, which serializes the learner's conv backward: ANY scan
    # around the SGD step — even length-1 or unroll=True — measured ~14 s
    # vs 0.9 s straight-line at 64 envs x 16 steps on a 2-core runner.
    # None = auto: Python-unroll the epoch/minibatch loops into
    # straight-line XLA on the CPU backend (test/dev meshes), keep the
    # rolled lax.scan on accelerators where loops are free and unrolling
    # only bloats compile time.
    learner_unroll: bool | None = struct.field(
        pytree_node=False, default=None
    )
    # "lanes" collects the rollout on the lane-major (batch-last) fast path
    # (parallel/lanes.py) — one obs encode per step on the bit-sliced
    # encoder, transposed to batch-first only at the model boundary; "vmap"
    # is the batch-first fallback (required for autoreset != "pool" and
    # envs without lane support), which encodes each observation twice per
    # step on the batch-first encoder.
    collector: str = struct.field(pytree_node=False, default="lanes")


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    env_state: Any  # batched EnvState
    obs: Any  # batched observation dict
    key: jax.Array
    update_idx: jnp.ndarray
    pool: Any = None  # (R, B, ...) layout pool, autoreset="pool" only
    reset_count: Any = None  # (B,) i32 per-slot episode counter


class UpdateMetrics(NamedTuple):
    loss: jnp.ndarray
    policy_loss: jnp.ndarray
    value_loss: jnp.ndarray
    entropy: jnp.ndarray
    approx_kl: jnp.ndarray
    mean_reward: jnp.ndarray
    episodes: jnp.ndarray
    mean_return: jnp.ndarray  # mean terminal reward over finished episodes


def _gae(rewards, values, dones, last_value, gamma, lam):
    """Generalized advantage estimation over a (T, B) rollout.  Episode
    boundaries (done) zero the bootstrap, matching auto-reset semantics."""

    def step(carry, xs):
        gae, next_value = carry
        reward, value, done = xs
        nonterminal = 1.0 - done
        delta = reward + gamma * next_value * nonterminal - value
        gae = delta + gamma * lam * nonterminal * gae
        return (gae, value), gae

    (_, _), advantages = jax.lax.scan(
        step,
        (jnp.zeros_like(last_value), last_value),
        (rewards, values, dones.astype(jnp.float32)),
        reverse=True,
    )
    return advantages, advantages + values


class PPO:
    """One env family + one actor-critic net, trained data-parallel on a
    mesh."""

    def __init__(self, env: Environment, config: PPOConfig = PPOConfig(), mesh=None):
        self.env = env
        self.config = config
        self.mesh = mesh if mesh is not None else env_mesh()
        self.tx = optax.chain(
            optax.clip_by_global_norm(config.max_grad_norm),
            optax.adam(config.lr, eps=1e-5),
        )
        from minigrid_dynamicprogramming_tpu.parallel import lanes as _L

        self._use_lanes = (
            config.collector == "lanes"
            and config.autoreset == "pool"
            and _L.supports_lanes(env)
        )
        if config.autoreset == "pool":
            # pool leaves are (R, B, ...): env axis is 1
            self._step = jax.vmap(
                make_pool_autoreset_step(env), in_axes=(0, 0, 1, 0, 0)
            )
        else:
            self._step = jax.vmap(make_autoreset_step(env, config.autoreset))
        self._update = jax.jit(self._update_impl, donate_argnums=(0,))

    # -- initialization ------------------------------------------------------
    def init(self, key: jax.Array) -> TrainState:
        cfg = self.config
        k_params, k_envs, k_loop = jax.random.split(key, 3)
        params = nets.init_params(
            k_params, self.env.params.agent_view_size, self.env.action_dim
        )
        opt_state = self.tx.init(params)
        gen = jax.jit(
            jax.vmap(self.env.generate, in_axes=(0, None)), static_argnums=(1,)
        )
        pool = reset_count = None
        if cfg.autoreset == "pool":
            pool_keys = jax.random.split(
                k_envs, cfg.pool_rounds * cfg.num_envs
            )
            pool_flat = gen(pool_keys, self.env.params)
            pool = jax.tree_util.tree_map(
                lambda x: x.reshape(
                    (cfg.pool_rounds, cfg.num_envs) + x.shape[1:]
                ),
                pool_flat,
            )
            pool = shard_batch(pool, self.mesh, axis=1)
            env_state = jax.tree_util.tree_map(lambda x: x[0], pool)
            reset_count = shard_batch(
                jnp.zeros((cfg.num_envs,), jnp.int32), self.mesh
            )
        else:
            env_keys = jax.random.split(k_envs, cfg.num_envs)
            env_state = gen(env_keys, self.env.params)
            env_state = shard_batch(env_state, self.mesh)
        obs = jax.jit(jax.vmap(self.env.observation))(env_state)
        return TrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            obs=obs,
            key=k_loop,
            update_idx=jnp.zeros((), jnp.int32),
            pool=pool,
            reset_count=reset_count,
        )

    # -- one full PPO update (jitted) ----------------------------------------
    def update(self, ts: TrainState):
        return self._update(ts)

    def _obs_from_lanes(self, ls):
        """Model-ready batch-first obs dict from a lane state: one pass of
        the bit-sliced lane encoder, transposed only at the model boundary
        (unseen cells zeroed, exactly the wire format grid.py:244-268)."""
        from minigrid_dynamicprogramming_tpu.parallel import lanes as L

        p = self.env.params
        v = p.agent_view_size
        obj, color, st, vis = L.obs_lanes(p, ls)
        visu = vis.astype(jnp.uint8)
        img = jnp.stack([obj * visu, color * visu, st * visu], axis=-1)
        # Lane cells are indexed vy*v + vx; the wire format (gen_obs_image,
        # reference minigrid_env.py:629-645) is (x, y)-leading — swap the
        # spatial axes after the batch transpose.
        image = (
            jnp.transpose(img, (1, 0, 2))
            .reshape(-1, v, v, 3)
            .transpose(0, 2, 1, 3)
        )
        return {
            "image": image,
            "direction": ls.agent_dir,
            "mission": ls.mission.T,
        }

    def _collect_lanes(self, ts: TrainState):
        """Rollout on the lane-major fast path: lane stepping + pool
        autoreset identical to parallel/lanes.lane_rollout (plus the vmap
        collector's fresh-rng refresh so replayed pool rounds do not replay
        their episode randomness); trajectories come out batch-first for
        the learner."""
        from minigrid_dynamicprogramming_tpu.parallel import lanes as L

        cfg = self.config
        env = self.env
        B, T = cfg.num_envs, cfg.rollout_len
        R = cfg.pool_rounds
        pool_lanes = jax.vmap(L.to_lanes)(ts.pool)
        ls0 = L.to_lanes(ts.env_state)
        hooked = (
            env.pre_step_lanes is not None or env.post_step_lanes is not None
        ) and env.hook_rng
        skip = ()
        if env.params.opt("no_boxes", False):
            skip += ("contains_obj", "contains_color")
        if env.params.opt("no_marks", False):
            skip += ("marks", "vmarks")

        def rollout_body(carry, key_t):
            ls, reset_count = carry
            k_act, k_step, k_rng = jax.random.split(key_t, 3)
            obs = self._obs_from_lanes(ls)
            logits, value = nets.apply(ts.params, obs)
            action = jax.random.categorical(k_act, logits)
            logp = jax.nn.log_softmax(logits)[jnp.arange(B), action]
            keys = jax.random.split(k_step, B) if hooked else None
            ls2, reward, term = L.step_lanes_env(env, keys, ls, action)
            done = term | ls2.truncated
            reset_count = reset_count + done.astype(jnp.int32)
            fresh = L._select_pool(pool_lanes, reset_count % R, R)
            fresh = fresh.replace(rng=jax.random.split(k_rng, B))
            ls2 = L._select_lanes(done, fresh, ls2, skip)
            tr = (obs, action, logp, value, reward, done)
            return (ls2, reset_count), tr

        key, k_scan = jax.random.split(ts.key)
        (ls, reset_count), traj = jax.lax.scan(
            rollout_body,
            (ls0, ts.reset_count),
            jax.random.split(k_scan, T),
        )
        env_state = L.from_lanes(self.env.params, ls)
        last_obs = self._obs_from_lanes(ls)
        return key, env_state, last_obs, reset_count, traj

    def _collect_vmap(self, ts: TrainState):
        cfg = self.config
        B, T = cfg.num_envs, cfg.rollout_len

        def rollout_body(carry, key_t):
            env_state, obs, reset_count = carry
            k_act, k_step = jax.random.split(key_t)
            logits, value = nets.apply(ts.params, obs)
            action = jax.random.categorical(k_act, logits)
            logp = jax.nn.log_softmax(logits)[
                jnp.arange(B), action
            ]
            step_keys = jax.random.split(k_step, B)
            if cfg.autoreset == "pool":
                next_obs, env_state, reward, term, trunc, reset_count = (
                    self._step(
                        step_keys, env_state, ts.pool, reset_count, action
                    )
                )
            else:
                next_obs, env_state, reward, term, trunc = self._step(
                    step_keys, env_state, env_state, action
                )
            done = term | trunc
            tr = (obs, action, logp, value, reward, done)
            return (env_state, next_obs, reset_count), tr

        key, k_scan = jax.random.split(ts.key)
        (env_state, last_obs, reset_count), traj = jax.lax.scan(
            rollout_body,
            (ts.env_state, ts.obs, ts.reset_count),
            jax.random.split(k_scan, T),
        )
        return key, env_state, last_obs, reset_count, traj

    def _update_impl(self, ts: TrainState):
        cfg = self.config
        B, T = cfg.num_envs, cfg.rollout_len

        # ---- collect a rollout entirely on device --------------------------
        if self._use_lanes:
            key, env_state, last_obs, reset_count, traj = self._collect_lanes(
                ts
            )
        else:
            key, env_state, last_obs, reset_count, traj = self._collect_vmap(
                ts
            )
        obs_t, actions, logps, values, rewards, dones = traj

        _, last_value = nets.apply(ts.params, last_obs)
        advantages, returns = _gae(
            rewards, values, dones, last_value, cfg.gamma, cfg.gae_lambda
        )

        # ---- epochs x minibatches over the env axis ------------------------
        batch = (obs_t, actions, logps, values, advantages, returns)

        def loss_fn(params, mb):
            obs, action, old_logp, old_value, adv, ret = mb
            logits, value = nets.apply(params, obs)
            logp_all = jax.nn.log_softmax(logits)
            logp = jnp.take_along_axis(
                logp_all, action[..., None], axis=-1
            ).squeeze(-1)
            ratio = jnp.exp(logp - old_logp)
            adv = (adv - adv.mean()) / (adv.std() + 1e-8)
            pg1 = ratio * adv
            pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
            policy_loss = -jnp.minimum(pg1, pg2).mean()
            v_clipped = old_value + jnp.clip(
                value - old_value, -cfg.clip_eps, cfg.clip_eps
            )
            value_loss = 0.5 * jnp.maximum(
                (value - ret) ** 2, (v_clipped - ret) ** 2
            ).mean()
            entropy = -(jnp.exp(logp_all) * logp_all).sum(-1).mean()
            loss = (
                policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
            )
            approx_kl = (old_logp - logp).mean()
            return loss, (policy_loss, value_loss, entropy, approx_kl)

        def minibatch_step(carry, mb):
            params, opt_state = carry
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, mb
            )
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), (loss, *aux)

        unrolled = cfg.learner_unroll
        if unrolled is None:
            unrolled = jax.default_backend() == "cpu"
        # Zero epochs (a rollout-only update) is an empty scan either way.
        unrolled = unrolled and cfg.epochs > 0

        def epoch_step(carry, key_e):
            params, opt_state = carry
            perm = jax.random.permutation(key_e, B)
            mb_size = B // cfg.num_minibatches

            def take(x):
                # (T, B, ...) -> (n_mb, T, mb, ...): permute envs, split.
                shuffled = jnp.take(x, perm, axis=1)
                return (
                    shuffled.reshape(
                        T, cfg.num_minibatches, mb_size, *x.shape[2:]
                    ).swapaxes(0, 1)
                )

            mbs = jax.tree_util.tree_map(take, batch)
            if unrolled:
                carry2, ms = (params, opt_state), []
                for i in range(cfg.num_minibatches):
                    mb = jax.tree_util.tree_map(lambda x: x[i], mbs)
                    carry2, m = minibatch_step(carry2, mb)
                    ms.append(m)
                return carry2, jax.tree_util.tree_map(
                    lambda *xs: jnp.stack(xs), *ms
                )
            return jax.lax.scan(minibatch_step, (params, opt_state), mbs)

        key, k_epochs = jax.random.split(key)
        ep_keys = jax.random.split(k_epochs, cfg.epochs)
        if unrolled:
            carry, ms = (ts.params, ts.opt_state), []
            for e in range(cfg.epochs):
                carry, m = epoch_step(carry, ep_keys[e])
                ms.append(m)
            params, opt_state = carry
            metrics = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ms)
        else:
            (params, opt_state), metrics = jax.lax.scan(
                epoch_step, (ts.params, ts.opt_state), ep_keys
            )

        loss, policy_loss, value_loss, entropy, approx_kl = (
            m.mean() for m in metrics
        )
        n_done = dones.sum()
        out = UpdateMetrics(
            loss=loss,
            policy_loss=policy_loss,
            value_loss=value_loss,
            entropy=entropy,
            approx_kl=approx_kl,
            mean_reward=rewards.mean(),
            episodes=n_done.astype(jnp.int32),
            mean_return=jnp.where(
                n_done > 0, (rewards * dones).sum() / n_done, 0.0
            ),
        )
        new_ts = TrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            obs=last_obs,
            key=key,
            update_idx=ts.update_idx + 1,
            pool=ts.pool,
            reset_count=reset_count,
        )
        return new_ts, out


def train(
    env_id: str,
    config: PPOConfig = PPOConfig(),
    num_updates: int = 50,
    seed: int = 0,
    log_every: int = 10,
    mesh=None,
):
    """Host-side training loop; returns (final TrainState, metric history)."""
    import minigrid_dynamicprogramming_tpu as mgtpu

    env = mgtpu.make(env_id)
    ppo = PPO(env, config, mesh)
    ts = ppo.init(jax.random.PRNGKey(seed))
    history = []
    for u in range(num_updates):
        ts, m = ppo.update(ts)
        if (u + 1) % log_every == 0 or u == num_updates - 1:
            m = jax.device_get(m)
            history.append(m)
            steps = (u + 1) * config.num_envs * config.rollout_len
            print(
                f"update {u + 1}/{num_updates} steps={steps} "
                f"loss={m.loss:.4f} return={m.mean_return:.3f} "
                f"episodes={int(m.episodes)} kl={m.approx_kl:.4f}"
            )
    return ts, history


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="PPO on a batched JAX Minigrid env"
    )
    p.add_argument("--env-id", default="MiniGrid-Empty-8x8-v0")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--rollout-len", type=int, default=64)
    p.add_argument("--updates", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    from minigrid_dynamicprogramming_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    cfg = PPOConfig(num_envs=args.num_envs, rollout_len=args.rollout_len)
    train(args.env_id, cfg, num_updates=args.updates, seed=args.seed)


if __name__ == "__main__":
    main()
