#!/usr/bin/env python
"""Headline benchmark: batched env-steps/s on one GPU, honest per family.

Runs the lane-major (batch-last) fast path: full transition kernel + family
hooks (BabyAI verifier, DynamicObstacles ball moves) + egocentric observation
encoder every step (the obs output is checksummed so the compiler cannot
dead-code-eliminate it) + pool auto-reset (fresh layout per episode from a
pregenerated reservoir; the horizon exceeds max_steps so resets really fire).

Prints ONE JSON line:
  {"metric": "env_steps_per_s", "value": N, "unit": "steps/s",
   "vs_baseline": N, "device": {...}, "extra": {per-family honest steps/s +
   VI sweeps/s + PPO}}

``device`` names what ran it: JAX's platform, device kind and count, and
the card's name and power limit.  Without a GPU the script exits non-zero;
a family, DP domain or PPO run that fails makes the script fail.

``vs_baseline`` divides by the reference implementation's single-env CPU
throughput measured in this environment (see BASELINE.md): the reference
(/root/reference) runs MiniGrid-DoorKey-8x8-v0 at ~10.1k steps/s with the
same random-action, auto-resetting loop (its ``step`` also encodes the
partial observation every call, minigrid_env.py:520-645).
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import jax

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.parallel.lanes import lane_rollout
from minigrid_dynamicprogramming_tpu.utils.compile_cache import (
    enable_compile_cache,
)
from minigrid_dynamicprogramming_tpu.utils.device_info import (
    card_info,
    device_record,
    find_gpu,
)

# Reference (CPU, single env, random actions incl. obs generation), measured
# in-environment 2026-08-17; see BASELINE.md.
REFERENCE_STEPS_PER_S = 10_145.0

# DoorKey-8x8 max_steps = 640: a 768-step horizon guarantees every lane
# truncates at least once, so the pool auto-reset path is really exercised.
BATCH = 65536
HORIZON = 768
POOL_ROUNDS = 4
WARMUP_ITERS = 1
TIMED_ITERS = 3


def _lane_steps_per_s(
    env_id, batch, horizon, warmup=1, iters=2, seed=0, rounds=None
):
    env = mgtpu.make(env_id)
    rounds = POOL_ROUNDS if rounds is None else rounds
    key = jax.random.PRNGKey(seed)
    for _ in range(warmup):
        key, k = jax.random.split(key)
        res = lane_rollout(env, k, batch, horizon, "pool", rounds)
        int(res.obs_checksum)  # host materialization = real synchronization
    t0 = time.perf_counter()
    total = 0
    for _ in range(iters):
        key, k = jax.random.split(key)
        res = lane_rollout(env, k, batch, horizon, "pool", rounds)
        int(res.obs_checksum)
        total += batch * horizon
    return total / (time.perf_counter() - t0)


def _doorkey_states(batch, seed=11):
    env = mgtpu.make("MiniGrid-DoorKey-8x8-v0")
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    gen = jax.jit(jax.vmap(env.generate, in_axes=(0, None)), static_argnums=1)
    return gen(keys, env.params)


def _sync(x):
    import numpy as _np

    _np.asarray(jax.tree_util.tree_leaves(x)[0].ravel()[:1])


def _vi_sweeps_per_s(batch=1024, n_sweeps=128):
    """BASELINE.json's value-iteration sweeps/s metric (XLA backend,
    restricted (door-config, carry, dir, y, x) domain)."""
    from functools import partial

    from minigrid_dynamicprogramming_tpu.dp.tabular import (
        extract_layout,
        value_iteration,
    )

    states = _doorkey_states(batch)
    layouts = jax.jit(jax.vmap(partial(extract_layout, max_doors=2)))(states)
    vi = jax.jit(jax.vmap(partial(value_iteration, gamma=0.995, n_sweeps=n_sweeps)))
    v, _ = vi(layouts)
    _sync(v)
    t0 = time.perf_counter()
    v, _ = vi(layouts)
    _sync(v)
    return batch * n_sweeps / (time.perf_counter() - t0)


def _vi_d1_sweeps_per_s(batch=1024, n_sweeps=128):
    """Restricted-domain VI sweeps/s on its natural domain: DoorKey-8x8 has
    exactly one door, so ``max_doors=1`` (C = 6 configs)."""
    from functools import partial

    from minigrid_dynamicprogramming_tpu.dp.tabular import (
        extract_layout,
        value_iteration,
    )

    states = _doorkey_states(batch)
    layouts = jax.jit(jax.vmap(partial(extract_layout, max_doors=1)))(states)
    vi = jax.jit(
        jax.vmap(partial(value_iteration, gamma=0.995, n_sweeps=n_sweeps))
    )
    _sync(vi(layouts)[0])
    t0 = time.perf_counter()
    _sync(vi(layouts)[0])
    return batch * n_sweeps / (time.perf_counter() - t0)


def _vi_key_sweeps_per_s(batch=512, n_sweeps=96, backend="xla"):
    """Key-position-domain VI sweeps/s (state space (key-loc, door-config,
    dir, y, x) — ~21x the restricted domain's states per layout): the XLA
    sweeps or the fused kernel (dp/pallas_vi.py) on identical layouts."""
    from functools import partial

    from minigrid_dynamicprogramming_tpu.dp.pallas_vi import (
        pallas_key_value_iteration,
    )
    from minigrid_dynamicprogramming_tpu.dp.tabular_key import (
        extract_key_layout,
        key_value_iteration,
    )

    states = _doorkey_states(batch)
    layouts = jax.jit(jax.vmap(partial(extract_key_layout, max_doors=1)))(
        states
    )
    if backend == "xla":
        vi = jax.jit(
            jax.vmap(partial(key_value_iteration, gamma=0.995, n_sweeps=n_sweeps))
        )
        run = lambda: vi(layouts)[0]
    else:
        run = lambda: pallas_key_value_iteration(
            layouts, gamma=0.995, n_sweeps=n_sweeps
        )
    _sync(run())
    t0 = time.perf_counter()
    _sync(run())
    return batch * n_sweeps / (time.perf_counter() - t0)


def _vi_obstructed_sweeps_per_s(batch=4, n_sweeps=64):
    """Obstructed-domain VI sweeps/s (state space (ball-loc, key-loc,
    door-config, dir, y, x) — ~HW^2-fold the key domain's states per
    layout) on BlockedUnlockPickup layouts.  XLA backend; the dense state
    tensor is ~(HW+2)^2 * Cd * 4 * HW f32 per layout (~46 MB at 11x6), so
    the layout batch stays small."""
    from functools import partial

    from minigrid_dynamicprogramming_tpu.dp.tabular_obstructed import (
        extract_obstructed_layout,
        obstructed_value_iteration,
    )

    import jax.numpy as jnp

    env = mgtpu.make("MiniGrid-BlockedUnlockPickup-v0")
    keys = jax.random.split(jax.random.PRNGKey(17), batch)
    gen = jax.jit(jax.vmap(env.generate, in_axes=(0, None)), static_argnums=1)
    states = gen(keys, env.params)

    # The objective is the box in the far room (blockedunlockpickup.py);
    # its color varies per layout.
    def _extract(state):
        is_box = state.grid_obj == 7  # OBJ_BOX
        flat = jnp.argmax(is_box.ravel())
        c = state.grid_color.ravel()[flat].astype(jnp.int32)
        return extract_obstructed_layout(
            state, max_doors=1, target_type=7, target_color=c
        )

    layouts = jax.jit(jax.vmap(_extract))(states)
    vi = jax.jit(
        jax.vmap(
            partial(
                obstructed_value_iteration, gamma=0.995, n_sweeps=n_sweeps
            )
        )
    )
    _sync(vi(layouts)[0])
    t0 = time.perf_counter()
    _sync(vi(layouts)[0])
    return batch * n_sweeps / (time.perf_counter() - t0)


def _vi_twokey_sweeps_per_s(batch=2, n_sweeps=48):
    """Two-key-chain VI sweeps/s on BabyAI-UnlockToUnlock layouts (state
    space (key1-loc, key2-loc, door-config, dir, y, x); ~59 MB f32 per
    layout at 16x6 — the largest exact domain)."""
    from functools import partial

    import jax.numpy as jnp

    from minigrid_dynamicprogramming_tpu.dp.tabular_twokey import (
        extract_twokey_layout,
        twokey_value_iteration,
    )

    env = mgtpu.make("BabyAI-UnlockToUnlock-v0")
    keys = jax.random.split(jax.random.PRNGKey(23), batch)
    gen = jax.jit(jax.vmap(env.generate, in_axes=(0, None)), static_argnums=1)
    states = gen(keys, env.params)

    def _extract(state):
        is_ball = state.grid_obj == 6  # OBJ_BALL (the pickup target)
        flat = jnp.argmax(is_ball.ravel())
        c = state.grid_color.ravel()[flat].astype(jnp.int32)
        return extract_twokey_layout(
            state, max_doors=2, target_type=6, target_color=c
        )

    layouts = jax.jit(jax.vmap(_extract))(states)
    vi = jax.jit(
        jax.vmap(
            partial(twokey_value_iteration, gamma=0.995, n_sweeps=n_sweeps)
        )
    )
    _sync(vi(layouts)[0])
    t0 = time.perf_counter()
    _sync(vi(layouts)[0])
    return batch * n_sweeps / (time.perf_counter() - t0)


def _ppo_steps_per_s(num_envs=32768, rollout_len=32):
    """BASELINE config 5 on one card: BabyAI-GoToDoor pool-autoreset envs
    feeding the PPO learner on a single-device mesh.  Config 5 specifies
    64k envs sharded over 2+ hosts, i.e. <= 32k per device.  Returns
    (env-steps/s of the full update loop, rollout-phase seconds,
    learner-phase seconds) — the phase split comes from timing a
    zero-epoch update (rollout + GAE only) against the full update.

    Warmup is TWO calls, not one: the first call compiles; the second
    recompiles because the update's output array shardings differ from
    ``init``'s, and jit keys its cache on input shardings.  Timing from
    call 3 measures steady state.

    Per update the learner does epochs(2) x full-batch forward+backward,
    about 6 forward-equivalents per sample against the rollout's 1."""
    from minigrid_dynamicprogramming_tpu.models.ppo import PPO, PPOConfig

    env = mgtpu.make("BabyAI-GoToDoor-v0")

    def timed(epochs, n=5):
        cfg = PPOConfig(
            num_envs=num_envs,
            rollout_len=rollout_len,
            epochs=epochs,
            num_minibatches=8,
        )
        ppo = PPO(env, cfg)
        ts = ppo.init(jax.random.PRNGKey(3))
        for _ in range(2):  # compile + post-init sharding recompile
            ts, m = ppo.update(ts)
            jax.block_until_ready(m.loss)
        t0 = time.perf_counter()
        for _ in range(n):
            ts, m = ppo.update(ts)
            jax.block_until_ready(m.loss)
        return (time.perf_counter() - t0) / n

    full = timed(2)
    roll = timed(0)
    steps = num_envs * rollout_len
    return steps / full, roll, max(full - roll, 0.0)


def _ppo_learning_curve(
    env_id,
    threshold,
    num_envs=8192,
    rollout_len=64,
    max_updates=300,
    patience=3,
    seed=0,
):
    """Train PPO on ``env_id`` on the chip and record the return curve.

    Proves BASELINE config 5 end to end: not just throughput, but a policy
    actually learning a sparse-reward task harder than Empty-5x5.
    ``mean_return`` is the mean terminal reward over
    episodes finished inside each rollout window (MiniGrid terminal reward
    is ``1 - 0.9 * steps/max_steps``, so >= ``threshold`` means near-optimal
    solutions, not lucky walks).  Early-stops once the threshold holds for
    ``patience`` consecutive updates."""
    from minigrid_dynamicprogramming_tpu.models.ppo import PPO, PPOConfig

    env = mgtpu.make(env_id)
    cfg = PPOConfig(
        num_envs=num_envs, rollout_len=rollout_len, epochs=2, num_minibatches=8
    )
    ppo = PPO(env, cfg)
    ts = ppo.init(jax.random.PRNGKey(seed))
    curve = []
    t0 = time.perf_counter()
    hits = 0
    solved_at = None
    for u in range(max_updates):
        ts, m = ppo.update(ts)
        m = jax.device_get(m)
        ret, eps = float(m.mean_return), int(m.episodes)
        curve.append(
            {
                "update": u + 1,
                "env_steps": (u + 1) * num_envs * rollout_len,
                "mean_return": round(ret, 4),
                "episodes": eps,
                "entropy": round(float(m.entropy), 4),
                "wall_s": round(time.perf_counter() - t0, 2),
            }
        )
        # An update with almost no finished episodes says nothing about the
        # policy; require a meaningful sample before counting a "hit".
        hits = hits + 1 if (ret >= threshold and eps >= num_envs // 8) else 0
        if hits >= patience:
            solved_at = curve[-1]
            break
    return {
        "env_id": env_id,
        "threshold": threshold,
        "num_envs": num_envs,
        "rollout_len": rollout_len,
        "seed": seed,
        "solved": solved_at is not None,
        "solved_at": solved_at,
        "wall_s": round(time.perf_counter() - t0, 2),
        "final_return": curve[-1]["mean_return"] if curve else None,
        "curve": curve,
    }


def _git_rev() -> str:
    """HEAD of the checkout this script sits in, or ``unknown`` outside a
    git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=pathlib.Path(__file__).resolve().parent,
            capture_output=True,
            text=True,
            timeout=10,
        )
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() if out.returncode == 0 else "unknown"


def _device() -> dict:
    """The GPU this run measures, or exit: no number comes from the CPU."""
    gpu = find_gpu()
    if gpu is None:
        sys.exit("bench.py: JAX finds no GPU")
    return {**device_record(gpu), "card": card_info()}


def learn_main(out_path="LEARN.json") -> None:
    """``python bench.py --learn``: train two sparse-reward families on the
    chip (DoorKey needs pickup+toggle sequencing; GoToDoor is
    instruction-conditioned on the mission channel) and write the return
    curves + threshold crossings as a JSON artifact."""
    import datetime

    device = _device()
    runs = [
        _ppo_learning_curve("MiniGrid-DoorKey-5x5-v0", threshold=0.90),
        _ppo_learning_curve("BabyAI-GoToDoor-v0", threshold=0.90),
    ]
    artifact = {
        "metric": "ppo_learning",
        "git_rev": _git_rev(),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc
        ).isoformat(timespec="seconds"),
        "device": device,
        "runs": runs,
    }
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    for r in runs:
        s = r["solved_at"]
        print(
            f"{r['env_id']}: solved={r['solved']} "
            + (
                f"return {s['mean_return']} at {s['env_steps']/1e6:.1f}M "
                f"steps / {s['wall_s']}s"
                if s
                else f"final return {r['final_return']}"
            )
        )
    print(f"wrote {out_path}")


def main() -> None:
    device = _device()
    # Headline: DoorKey-8x8 (hook-free core MDP).
    headline = _lane_steps_per_s(
        "MiniGrid-DoorKey-8x8-v0",
        BATCH,
        HORIZON,
        warmup=WARMUP_ITERS,
        iters=TIMED_ITERS,
    )

    extra = {}
    # Per-family sweep: one representative of every generation regime on
    # the same honest fast path (pool autoreset with 2 pregenerated layout
    # rounds INCLUDED in the timing, full obs encode every step,
    # checksummed against DCE).  Smaller batch to bound runtime.
    fam = {
        "babyai_gotolocal": ("BabyAI-GoToLocal-v0", 1),
        "dynamicobstacles_8x8": ("MiniGrid-Dynamic-Obstacles-8x8-v0", 2),
        "obstructedmaze_full_v1": ("MiniGrid-ObstructedMaze-Full-v1", 3),
        "keycorridor_s6r3": ("MiniGrid-KeyCorridorS6R3-v0", 4),
        "multiroom_n6": ("MiniGrid-MultiRoom-N6-v0", 5),
        "memory_s17": ("MiniGrid-MemoryS17Random-v0", 6),
        "babyai_bosslevel": ("BabyAI-BossLevel-v0", 7),
        "fetch_8x8_n3": ("MiniGrid-Fetch-8x8-N3-v0", 8),
    }
    for name, (env_id, seed) in fam.items():
        extra[f"{name}_steps_per_s"] = round(
            _lane_steps_per_s(
                env_id, 16384, 256, warmup=1, iters=2, seed=seed, rounds=2
            ),
            1,
        )
    # vi_sweeps_per_s_legacy_padded is the restricted domain padded to
    # max_doors=2; the per-domain metrics are the vi_d1_* / vi_key_* /
    # vi_obstructed_* / vi_twokey_* entries.
    for name, fn in (
        ("vi_sweeps_per_s_legacy_padded", _vi_sweeps_per_s),
        ("vi_d1_xla_sweeps_per_s", _vi_d1_sweeps_per_s),
        ("vi_key_sweeps_per_s", lambda: _vi_key_sweeps_per_s(backend="xla")),
        (
            "vi_key_pallas_sweeps_per_s",
            lambda: _vi_key_sweeps_per_s(backend="pallas"),
        ),
        ("vi_obstructed_sweeps_per_s", _vi_obstructed_sweeps_per_s),
        ("vi_twokey_sweeps_per_s", _vi_twokey_sweeps_per_s),
    ):
        extra[name] = round(fn(), 1)

    sps, t_roll, t_learn = _ppo_steps_per_s()
    extra["ppo_steps_per_s"] = round(sps, 1)
    extra["ppo_rollout_s"] = round(t_roll, 3)
    extra["ppo_learner_s"] = round(t_learn, 3)

    # Stamp the measured revision, so a stale capture can be told apart
    # from a regression.
    import datetime

    extra["git_rev"] = _git_rev()
    extra["timestamp_utc"] = datetime.datetime.now(
        datetime.timezone.utc
    ).isoformat(timespec="seconds")

    print(
        json.dumps(
            {
                "metric": "env_steps_per_s",
                "value": round(headline, 1),
                "unit": "steps/s",
                "vs_baseline": round(headline / REFERENCE_STEPS_PER_S, 2),
                "device": device,
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    enable_compile_cache()
    if "--learn" in sys.argv:
        learn_main()
    else:
        main()
