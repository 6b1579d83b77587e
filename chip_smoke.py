#!/usr/bin/env python
"""Smoke run of the system's main paths on one GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # the sharded path on four cards only

Phases, through the public API at the sizes ``bench.py`` uses:

* device: platform, device kind and count, and the card's name and power
  limit (read by ``nvidia-smi`` in a child process that does not use JAX);
* rollout: the DoorKey-8x8 lane rollout at 65,536 envs x 768 steps with
  pool autoreset; then the same program at 1,024 envs on the GPU and on the
  CPU device, bit-equal (the env kernels are integer programs), for
  DoorKey-8x8 and BabyAI-GoToLocal (the verifier hook); and the on-device
  scatter audit (``utils/device_audit.py``);
* dp: restricted-domain VI on 1,024 layouts x 128 sweeps and key-domain VI
  on 512 layouts x 96 sweeps through the fused kernel, each against the
  plain XLA version on the CPU device (atol 1e-6: max/where/scale only, no
  matrix products), and steps-to-go against a breadth-first search through
  the env's own step on 8 layouts;
* ppo: 3 updates of PPO on BabyAI-GoToDoor at 32,768 envs x 32 steps,
  2 epochs x 8 minibatches (finite loss, parameters move), and the policy
  forward on the GPU against the CPU device (rtol 2e-2: bf16 convolutions).

Each phase prints its first-call and steady seconds and the device's peak
bytes in use.  A failed check raises; the script then exits non-zero and
prints no result.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU the script exits 2 before any phase.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.utils.compile_cache import (
    enable_compile_cache,
)
from minigrid_dynamicprogramming_tpu.utils.device_info import (
    card_info,
    device_record,
    find_gpu,
)

GAMMA = 0.995


def _report(label, device, card, first_s, steady_s=None):
    """One line per phase: seconds of the first call (compilation
    included) and of a steady call, and the device's peak bytes so far."""
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "not measured")
    steady = "" if steady_s is None else f", steady {steady_s:.3f} s"
    print(
        f"[{card}] {label}: first call {first_s:.3f} s{steady}, "
        f"peak_bytes_in_use {peak}",
        flush=True,
    )


def _timed(fn):
    """(result, seconds) of ``fn()`` until its result is ready on the
    device; copying it to the host is not timed."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def phase_device(device, card: str) -> dict:
    info = device_record(device)
    print(f"device: {json.dumps(info)}")
    print(f"card: {card}", flush=True)
    return info


def _rollout_summary(res):
    return {
        "obs_checksum": int(res.obs_checksum),
        "episodes": int(res.episodes),
        "resets_per_env": np.asarray(res.resets_per_env),
        "grid_obj": np.asarray(res.final_state.grid_obj),
        "agent_x": np.asarray(res.final_state.agent_x),
    }


def _rollout_on(device, env, batch, horizon, rounds, seed=0):
    from minigrid_dynamicprogramming_tpu.parallel.lanes import lane_rollout

    key = jax.device_put(jax.random.PRNGKey(seed), device)
    with jax.default_device(device):
        return lane_rollout(env, key, batch, horizon, "pool", rounds)


def phase_rollout(
    accel,
    card: str,
    *,
    batch: int = 65536,
    horizon: int = 768,
    rounds: int = 4,
    check_batch: int = 1024,
    check_horizon: int = 768,
    babyai_horizon: int = 256,
    audit_batch: int = 4096,
) -> None:
    cpu = jax.devices("cpu")[0]
    env = mgtpu.make("MiniGrid-DoorKey-8x8-v0")
    run = partial(_rollout_on, accel, env, batch, horizon, rounds)
    _, first = _timed(run)
    res, steady = _timed(run)
    res = _rollout_summary(res)
    assert res["episodes"] > 0, "the horizon must cross episode boundaries"
    print(
        f"rollout DoorKey-8x8: {batch} envs x {horizon} steps, "
        f"episodes {res['episodes']}, obs_checksum {res['obs_checksum']}, "
        f"{batch * horizon / steady:.4g} env-steps/s"
    )
    _report("rollout DoorKey-8x8 headline", accel, card, first, steady)

    for env_id, h, r in (
        ("MiniGrid-DoorKey-8x8-v0", check_horizon, rounds),
        ("BabyAI-GoToLocal-v0", babyai_horizon, 2),
    ):
        env = mgtpu.make(env_id)
        t0 = time.perf_counter()
        on_accel = _rollout_summary(
            _rollout_on(accel, env, check_batch, h, r, seed=1)
        )
        on_cpu = _rollout_summary(
            _rollout_on(cpu, env, check_batch, h, r, seed=1)
        )
        for name, want in on_cpu.items():
            np.testing.assert_array_equal(
                on_accel[name], want, err_msg=f"{env_id} {name}"
            )
        print(
            f"rollout {env_id}: {check_batch} envs x {h} steps bit-equal "
            f"on {accel.platform} and cpu (episodes {on_cpu['episodes']}, "
            f"obs_checksum {on_cpu['obs_checksum']})"
        )
        dt = time.perf_counter() - t0
        _report(f"rollout {env_id} check", accel, card, dt)

    from minigrid_dynamicprogramming_tpu.utils.device_audit import (
        audit_device,
    )

    with jax.default_device(accel):
        report = audit_device(batch=audit_batch)
    print(f"device_audit: {json.dumps(report)}")
    assert report["ok"], f"device audit failed: {report}"


def _doorkey_states(device, n, seed=11):
    env = mgtpu.make("MiniGrid-DoorKey-8x8-v0")
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    keys = jax.device_put(keys, device)
    gen = jax.jit(jax.vmap(env.generate, in_axes=(0, None)), static_argnums=1)
    return env, gen(keys, env.params)


def phase_dp(
    accel,
    card: str,
    *,
    d1_layouts: int = 1024,
    d1_sweeps: int = 128,
    key_layouts: int = 512,
    key_sweeps: int = 96,
    bfs_layouts: int = 8,
    interpret: bool = False,
) -> None:
    import tests.test_dp as oracle

    from minigrid_dynamicprogramming_tpu.dp.pallas_vi import (
        pallas_key_value_iteration,
    )
    from minigrid_dynamicprogramming_tpu.dp.tabular import (
        extract_layout,
        state_value,
        steps_to_go,
        value_iteration,
    )
    from minigrid_dynamicprogramming_tpu.dp.tabular_key import (
        extract_key_layout,
        key_state_value,
        key_steps_to_go,
        key_value_iteration,
    )

    cpu = jax.devices("cpu")[0]
    n = max(d1_layouts, key_layouts)
    env, states = _doorkey_states(accel, n)
    take = lambda tree, m: jax.tree_util.tree_map(lambda x: x[:m], tree)
    on_cpu = lambda tree: jax.device_put(tree, cpu)

    d1 = jax.jit(jax.vmap(partial(extract_layout, max_doors=1)))(
        take(states, d1_layouts)
    )
    vi = jax.jit(
        jax.vmap(partial(value_iteration, gamma=GAMMA, n_sweeps=d1_sweeps))
    )
    _, first = _timed(lambda: vi(d1)[0])
    v_d1, steady = _timed(lambda: vi(d1)[0])
    v_d1 = np.asarray(v_d1)
    v_ref = np.asarray(vi(on_cpu(d1))[0])
    np.testing.assert_allclose(v_d1, v_ref, atol=1e-6)
    print(
        f"dp d1: {d1_layouts} layouts x {d1_sweeps} sweeps within 1e-6 of "
        f"cpu, {d1_layouts * d1_sweeps / steady:.4g} sweeps/s"
    )
    _report("dp d1 (XLA)", accel, card, first, steady)

    kl = jax.jit(jax.vmap(partial(extract_key_layout, max_doors=1)))(
        take(states, key_layouts)
    )
    kernel = partial(
        pallas_key_value_iteration,
        gamma=GAMMA,
        n_sweeps=key_sweeps,
        interpret=interpret,
    )
    _, first = _timed(lambda: kernel(kl))
    v_key, steady = _timed(lambda: kernel(kl))
    v_key = np.asarray(v_key)
    key_vi = jax.jit(
        jax.vmap(
            partial(key_value_iteration, gamma=GAMMA, n_sweeps=key_sweeps)
        )
    )
    v_ref = np.asarray(key_vi(on_cpu(kl))[0])
    np.testing.assert_allclose(v_key, v_ref, atol=1e-6)
    print(
        f"dp key: {key_layouts} layouts x {key_sweeps} sweeps (fused kernel) "
        f"within 1e-6 of cpu XLA, {key_layouts * key_sweeps / steady:.4g} "
        "sweeps/s"
    )
    _report("dp key (kernel)", accel, card, first, steady)

    t0 = time.perf_counter()
    for i in range(bfs_layouts):
        state = jax.tree_util.tree_map(lambda x: x[i], states)
        layout = jax.tree_util.tree_map(lambda x: x[i], d1)
        want = oracle.env_bfs_optimal_steps(env, state)
        got = float(steps_to_go(state_value(v_d1[i], layout, state), GAMMA))
        assert got == want, f"layout {i}: d1 VI {got} != BFS {want}"
        if i < key_layouts:
            klayout = jax.tree_util.tree_map(lambda x: x[i], kl)
            got = float(
                key_steps_to_go(
                    key_state_value(v_key[i], klayout, state), GAMMA
                )
            )
            assert got == want, f"layout {i}: key VI {got} != BFS {want}"
    dt = time.perf_counter() - t0
    print(f"dp steps-to-go equals BFS on {bfs_layouts} layouts")
    _report("dp BFS check", accel, card, dt)


def phase_ppo(
    accel,
    card: str,
    *,
    num_envs: int = 32768,
    rollout_len: int = 32,
    epochs: int = 2,
    num_minibatches: int = 8,
    updates: int = 3,
    forward_batch: int = 256,
) -> None:
    from minigrid_dynamicprogramming_tpu.models import nets
    from minigrid_dynamicprogramming_tpu.models.ppo import PPO, PPOConfig
    from minigrid_dynamicprogramming_tpu.parallel.sharding import env_mesh

    cpu = jax.devices("cpu")[0]
    cfg = PPOConfig(
        num_envs=num_envs,
        rollout_len=rollout_len,
        epochs=epochs,
        num_minibatches=num_minibatches,
    )
    ppo = PPO(mgtpu.make("BabyAI-GoToDoor-v0"), cfg, env_mesh([accel]))
    ts = ppo.init(jax.device_put(jax.random.PRNGKey(3), accel))
    p0 = jax.device_get(ts.params)  # the update donates its input
    seconds = []
    for u in range(updates):
        t0 = time.perf_counter()
        ts, m = ppo.update(ts)
        loss = float(m.loss)
        seconds.append(time.perf_counter() - t0)
        assert np.isfinite(loss), f"update {u + 1}: loss {loss}"
        print(
            f"ppo update {u + 1}: loss {loss:.6f}, episodes "
            f"{int(m.episodes)}, {seconds[-1]:.3f} s"
        )
    p1 = jax.device_get(ts.params)
    leaves = jax.tree_util.tree_leaves
    moved = [not np.array_equal(a, b) for a, b in zip(leaves(p0), leaves(p1))]
    assert all(moved), "every parameter must move"
    print(
        f"ppo: {updates} updates at {num_envs} envs x {rollout_len} steps, "
        f"{num_envs * rollout_len / seconds[-1]:.4g} env-steps/s"
    )
    _report("ppo", accel, card, seconds[0], seconds[-1])

    # bf16 trunk features round differently on the two devices, and a head
    # output near zero (a sum of 256 products that cancel) carries that
    # rounding as a large relative error.  So the policy is compared as
    # log-probabilities (logits up to their free constant, about -2 at
    # initialisation) at rtol 2e-2, and the value, an estimate of a return
    # in [0, 1], at 2e-2 of that range.
    obs = jax.tree_util.tree_map(lambda x: x[:forward_batch], ts.obs)
    fwd = jax.jit(
        lambda p, o: (lambda lg, v: (jax.nn.log_softmax(lg), v))(
            *nets.apply(p, o)
        )
    )
    got = jax.device_get(fwd(ts.params, obs))
    want = jax.device_get(
        fwd(jax.device_put(p1, cpu), jax.device_put(obs, cpu))
    )
    np.testing.assert_allclose(got[0], want[0], rtol=2e-2, err_msg="logp")
    np.testing.assert_allclose(
        got[1], want[1], rtol=2e-2, atol=2e-2, err_msg="value"
    )
    print(f"ppo forward: {forward_batch} observations agree with cpu")


def phase_four_cards() -> None:
    """Sharded lane rollout against one device, and one PPO update whose
    gradient all-reduce crosses the cards."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--four-cards",
        action="store_true",
        help="run only the sharded path on four cards",
    )
    args = p.parse_args(argv)

    accel = find_gpu()
    if accel is None:
        print("chip_smoke: JAX finds no GPU", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = card_info()
    info = phase_device(accel, card)
    if args.four_cards:
        if info["count"] < 4:
            print(f"chip_smoke: need 4 GPUs, have {info['count']}",
                  file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        phase_four_cards()
        dt = time.perf_counter() - t0
        _report("four cards", accel, card, dt)
    else:
        for phase in (phase_rollout, phase_dp, phase_ppo):
            phase(accel, card)
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
