"""Multi-host process-group initialization (SURVEY §5 "distributed
communication backend").

The reference has no distributed layer at all (no NCCL/MPI/Gloo —
SURVEY §2 verified).  Here one process drives all of a host's GPUs:
``jax.devices()`` lists them, ``parallel.sharding.env_mesh`` spans them,
and XLA lowers the cross-device reductions to NCCL collectives.  Nothing in
this module is needed for that.

``jax.distributed.initialize`` is only for several hosts: every host runs
the same program, the call forms the process group over a coordinator, and
``jax.devices()`` then spans all hosts so one ``Mesh`` covers them.  Env
stepping itself needs no communication (environments are independent), so
only metric reductions and the learner's gradient all-reduce cross
devices.

Usage (same script on every host)::

    # FIRST thing in main(), before importing the rest of the package —
    # package import builds device LUT constants, which initializes the
    # XLA backend, after which jax.distributed.initialize refuses to run.
    from minigrid_dynamicprogramming_tpu.parallel import distributed
    distributed.initialize("host0:1234", num_processes=2, process_id=0)

    import minigrid_dynamicprogramming_tpu as mgtpu
    mesh = distributed.global_env_mesh()
    res = lane_rollout(env, key, batch, horizon, "pool", 4, mesh)

(``parallel.distributed`` itself imports nothing that touches a device;
importing it does not foreclose initialization.)

Pass ``coordinator_address``/``num_processes``/``process_id`` explicitly
(mirrors ``jax.distributed.initialize``): no cluster environment is
detected here.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import jax

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    max_retries: int = 3,
    retry_delay_s: float = 5.0,
) -> None:
    """Join (or form) the multi-host process group, with bounded retries.

    Retry-on-failure mirrors the failure-detection posture of the rest of
    the framework (bounded masked retries, SURVEY §5): a coordinator that
    is still coming up is retried ``max_retries`` times before raising.
    Idempotent — a second call is a no-op, matching how
    ``jax.distributed.initialize`` refuses re-initialization.
    """
    global _initialized
    if _initialized:
        return
    last_err: Optional[Exception] = None
    for attempt in range(max_retries):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                local_device_ids=local_device_ids,
            )
            _initialized = True
            return
        except RuntimeError as err:
            msg = str(err).lower()
            # Already initialized (by the embedding program): fine.
            if "more than once" in msg or "already" in msg:
                _initialized = True
                return
            # Backend already up: retrying cannot help; fail with guidance.
            if "must be called before" in msg:
                raise RuntimeError(
                    "distributed.initialize() must run before any JAX "
                    "computation/devices call — call it first thing in main()"
                ) from err
            last_err = err
            if attempt + 1 < max_retries:
                time.sleep(retry_delay_s)
    raise RuntimeError(
        f"jax.distributed.initialize failed after {max_retries} attempts"
    ) from last_err


def is_initialized() -> bool:
    return _initialized or jax.process_count() > 1


def global_env_mesh():
    """1-D ``env`` mesh over every device in the process group (all hosts).

    Env batches shard along this axis; because the axis order follows
    ``jax.devices()`` (locals first within each process), per-device batch
    shards stay host-local and cross-host traffic is only the final metric
    all-reduce.
    """
    from minigrid_dynamicprogramming_tpu.parallel.sharding import env_mesh

    return env_mesh(jax.devices())


def process_summary() -> str:
    """One-line observability string for startup logs."""
    return (
        f"process {jax.process_index()}/{jax.process_count()} "
        f"local_devices={len(jax.local_devices())} "
        f"global_devices={len(jax.devices())}"
    )
