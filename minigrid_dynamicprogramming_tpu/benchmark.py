"""Micro-benchmark CLI.

Mirror of the reference's ``minigrid/benchmark.py`` (reset-ms / render-FPS /
agent-view-FPS over one env, /root/reference/minigrid/benchmark.py:13-49)
plus the metric the reference cannot express: batched env-steps/s on device.
Same default workload (``MiniGrid-LavaGapS7-v0``, 200 resets, 5000 frames,
benchmark.py:99-126).

Run: ``python -m minigrid_dynamicprogramming_tpu.benchmark --env-id ...``
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp

import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.parallel.lanes import (
    lane_rollout,
    supports_lanes as lane_supported,
)
from minigrid_dynamicprogramming_tpu.parallel.rollout import rollout
from minigrid_dynamicprogramming_tpu.render import render_frame, render_pov


def benchmark(
    env_id: str = "MiniGrid-LavaGapS7-v0",
    num_resets: int = 200,
    num_frames: int = 5000,
    tile_size: int = 32,
    batch: int = 4096,
    horizon: int = 256,
) -> dict:
    env = mgtpu.make(env_id)

    # --- env.reset timing (benchmark.py:16-21) ---------------------------
    reset_fn = jax.jit(env.reset)
    obs, state = reset_fn(jax.random.PRNGKey(0))  # compile
    jax.block_until_ready(state.grid_obj)
    t0 = time.perf_counter()
    for i in range(num_resets):
        obs, state = reset_fn(jax.random.PRNGKey(i))
    jax.block_until_ready(state.grid_obj)
    reset_ms = (time.perf_counter() - t0) * 1000 / num_resets

    # --- full-frame rendering FPS (benchmark.py:24-29) -------------------
    render_fn = jax.jit(lambda s: render_frame(env.params, s, tile_size))
    frame = render_fn(state)
    jax.block_until_ready(frame)
    t0 = time.perf_counter()
    for _ in range(num_frames):
        frame = render_fn(state)
    jax.block_until_ready(frame)
    render_fps = num_frames / (time.perf_counter() - t0)

    # --- agent-view FPS: step + POV render (benchmark.py:31-47) ----------
    def step_and_pov(key, s, a):
        _, ns, *_ = env.step(key, s, a)
        return ns, render_pov(env.params, ns, tile_size)

    sp = jax.jit(step_and_pov)
    key = jax.random.PRNGKey(1)
    s = state
    s, img = sp(key, s, jnp.asarray(0))
    jax.block_until_ready(img)
    t0 = time.perf_counter()
    for i in range(num_frames):
        s, img = sp(key, s, jnp.asarray(i % 3))
    jax.block_until_ready(img)
    agent_view_fps = num_frames / (time.perf_counter() - t0)

    # --- the batched headline: env-steps/s on device --------------------
    # Blocking on obs_checksum forces the obs encoder to run every step —
    # the number includes observation generation, like the reference's step.
    res = rollout(env, jax.random.PRNGKey(2), batch, None, horizon, "regen")
    jax.block_until_ready(res.obs_checksum)
    t0 = time.perf_counter()
    res = rollout(env, jax.random.PRNGKey(3), batch, None, horizon, "regen")
    jax.block_until_ready(res.obs_checksum)
    steps_per_s = batch * horizon / (time.perf_counter() - t0)

    # --- lane-major fast path (pool auto-reset, obs checksummed) ---------
    lane_steps_per_s = None
    if lane_supported(env):
        r = lane_rollout(env, jax.random.PRNGKey(4), batch, horizon, "pool")
        jax.block_until_ready(r.obs_checksum)
        t0 = time.perf_counter()
        r = lane_rollout(env, jax.random.PRNGKey(5), batch, horizon, "pool")
        jax.block_until_ready(r.obs_checksum)
        lane_steps_per_s = batch * horizon / (time.perf_counter() - t0)

    results = {
        "env_id": env_id,
        "reset_ms": round(reset_ms, 4),
        "render_fps": round(render_fps, 1),
        "agent_view_fps": round(agent_view_fps, 1),
        "batched_env_steps_per_s": round(steps_per_s, 1),
        "lane_env_steps_per_s": (
            round(lane_steps_per_s, 1) if lane_steps_per_s else None
        ),
        "batch": batch,
    }
    for k, v in results.items():
        print(f"{k}: {v}")
    return results


def benchmark_dp(
    env_id: str = "MiniGrid-DoorKey-8x8-v0",
    batch: int = 1024,
    n_sweeps: int = 128,
) -> dict:
    """Value-iteration sweeps/s — the BASELINE.json DP metric.

    One "sweep" is a full Bellman backup over the (cfg, dir, y, x) tabular
    state space of one layout; the rate is ``batch * n_sweeps / time``.
    """
    from functools import partial

    from minigrid_dynamicprogramming_tpu.dp.tabular import (
        extract_layout,
        value_iteration,
    )

    env = mgtpu.make(env_id)
    keys = jax.random.split(jax.random.PRNGKey(7), batch)
    states = jax.jit(jax.vmap(env.generate, in_axes=(0, None)), static_argnums=1)(
        keys, env.params
    )
    layouts = jax.jit(jax.vmap(partial(extract_layout, max_doors=2)))(states)

    vi = jax.jit(
        jax.vmap(partial(value_iteration, gamma=0.995, n_sweeps=n_sweeps))
    )

    v, policy = vi(layouts)  # compile
    jax.block_until_ready(v)
    t0 = time.perf_counter()
    v, policy = vi(layouts)
    jax.block_until_ready(v)
    sweeps_per_s = batch * n_sweeps / (time.perf_counter() - t0)
    results = {
        "env_id": env_id,
        "vi_backend": "xla",
        "vi_sweeps_per_s": round(sweeps_per_s, 1),
        "vi_batch": batch,
        "vi_n_sweeps": n_sweeps,
    }
    for k, val in results.items():
        print(f"{k}: {val}")
    return results


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env-id", default="MiniGrid-LavaGapS7-v0")
    p.add_argument("--num-resets", type=int, default=200)
    p.add_argument("--num-frames", type=int, default=5000)
    p.add_argument("--tile-size", type=int, default=32)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--horizon", type=int, default=256)
    p.add_argument(
        "--dp",
        action="store_true",
        help="also measure value-iteration sweeps/s (XLA)",
    )
    p.add_argument(
        "--trace",
        metavar="LOGDIR",
        default=None,
        help="capture a jax.profiler trace of the benchmark into LOGDIR "
        "(view with TensorBoard's profile plugin / Perfetto)",
    )
    p.add_argument(
        "--telemetry",
        action="store_true",
        help="also report generation acceptance-rate telemetry for --env-id",
    )
    p.add_argument(
        "--audit",
        action="store_true",
        help="run the on-device integer-lowering audit "
        "(utils/device_audit.py) before benchmarking and print the report",
    )
    args = p.parse_args()

    from minigrid_dynamicprogramming_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    if args.audit:
        import json

        from minigrid_dynamicprogramming_tpu.utils.device_audit import (
            audit_device,
        )

        print("device_audit:", json.dumps(audit_device()))

    import contextlib

    from minigrid_dynamicprogramming_tpu.utils.profiling import trace

    ctx = trace(args.trace) if args.trace else contextlib.nullcontext()
    with ctx:
        benchmark(
            args.env_id,
            args.num_resets,
            args.num_frames,
            args.tile_size,
            args.batch,
            args.horizon,
        )
    if args.telemetry:
        from minigrid_dynamicprogramming_tpu.utils.telemetry import (
            generation_acceptance,
        )

        for k, v in generation_acceptance(mgtpu.make(args.env_id)).items():
            print(f"gen_{k}: {v}")
    if args.dp:
        benchmark_dp("MiniGrid-DoorKey-8x8-v0")


if __name__ == "__main__":
    main()
