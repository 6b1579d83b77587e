"""Scaling-efficiency harness: env-steps/s vs device count.

The BASELINE target is >= 85% linear scaling of env-steps/s from 1 to N
workers.  Environments are independent, so env stepping itself needs zero
cross-device communication — the measured efficiency is bounded only by
XLA's partitioning overhead and the final metric all-reduce (see
parallel/sharding.py).  The reference has no counterpart (its only
vectorization is Gymnasium SyncVectorEnv,
/root/reference/tests/test_envs.py:318-330).

Usage::

    python -m minigrid_dynamicprogramming_tpu.parallel.scaling \
        --env-id MiniGrid-DoorKey-8x8-v0 --per-device-batch 8192

On a single host the device list comes from ``jax.devices()`` (use
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu`` for
a virtual mesh); across several hosts call
:func:`~minigrid_dynamicprogramming_tpu.parallel.distributed.initialize`
first so devices span all hosts.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence

import jax

from minigrid_dynamicprogramming_tpu.parallel.lanes import lane_rollout
from minigrid_dynamicprogramming_tpu.parallel.sharding import env_mesh


class ScalePoint(NamedTuple):
    n_devices: int
    batch: int
    steps_per_s: float
    efficiency: float  # steps_per_s / (n * steps_per_s[1 device])


def measure_scaling(
    env_id: str,
    per_device_batch: int = 4096,
    horizon: int = 256,
    device_counts: Optional[Sequence[int]] = None,
    warmup: int = 1,
    iters: int = 2,
    seed: int = 0,
) -> List[ScalePoint]:
    """Weak-scaling sweep: fixed per-device batch, growing device count.

    Efficiency(n) = steps/s(n) / (n * steps/s(1)); >= 0.85 is the BASELINE
    bar.  Uses the lane-major fast path with pool auto-reset (the production
    rollout configuration).
    """
    import minigrid_dynamicprogramming_tpu as mgtpu

    env = mgtpu.make(env_id)
    devices = jax.devices()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]

    points: List[ScalePoint] = []
    base = None
    for n in device_counts:
        mesh = env_mesh(devices[:n])
        batch = per_device_batch * n
        key = jax.random.PRNGKey(seed)
        for _ in range(warmup):
            key, k = jax.random.split(key)
            res = lane_rollout(env, k, batch, horizon, "pool", 4, mesh)
            int(res.obs_checksum)  # forced host sync
        t0 = time.perf_counter()
        total = 0
        for _ in range(iters):
            key, k = jax.random.split(key)
            res = lane_rollout(env, k, batch, horizon, "pool", 4, mesh)
            int(res.obs_checksum)
            total += batch * horizon
        sps = total / (time.perf_counter() - t0)
        if base is None:
            base = sps
        points.append(ScalePoint(n, batch, sps, sps / (n * base)))
    return points


def main() -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env-id", default="MiniGrid-DoorKey-8x8-v0")
    p.add_argument("--per-device-batch", type=int, default=4096)
    p.add_argument("--horizon", type=int, default=256)
    args = p.parse_args()
    pts = measure_scaling(args.env_id, args.per_device_batch, args.horizon)
    for pt in pts:
        print(
            json.dumps(
                {
                    "n_devices": pt.n_devices,
                    "batch": pt.batch,
                    "steps_per_s": round(pt.steps_per_s, 1),
                    "efficiency": round(pt.efficiency, 4),
                }
            )
        )


if __name__ == "__main__":
    main()
