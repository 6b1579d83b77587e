"""Scaling-efficiency harness + multi-host entry point tests.

Runs on the virtual 8-device CPU mesh (conftest). The BASELINE target
(>= 85% linear scaling) is measured on real hardware by bench.py; here we
guard that the harness itself measures correctly and that the
``jax.distributed`` entry point forms a process group.
"""

from __future__ import annotations

import socket

import jax
import numpy as np

from minigrid_dynamicprogramming_tpu.parallel import distributed
from minigrid_dynamicprogramming_tpu.parallel.scaling import measure_scaling


def test_measure_scaling_reports_points():
    pts = measure_scaling(
        "MiniGrid-Empty-5x5-v0",
        per_device_batch=64,
        horizon=32,
        device_counts=[1, 2],
        warmup=1,
        iters=1,
    )
    assert [p.n_devices for p in pts] == [1, 2]
    assert pts[0].batch == 64 and pts[1].batch == 128
    for p in pts:
        assert p.steps_per_s > 0
    # efficiency is steps/s(n) / (n * steps/s(1)); the 1-device point is 1.0
    # by definition, the 2-device point must be finite and positive (its
    # value on a virtual CPU mesh is noise, not the BASELINE metric).
    assert pts[0].efficiency == 1.0
    assert np.isfinite(pts[1].efficiency) and pts[1].efficiency > 0


def test_distributed_initialize_single_process():
    """Forming a 1-process group through the public entry point must work
    (fresh process: jax.distributed.initialize must precede backend init)
    and be idempotent; the mesh helper must then span every device."""
    import subprocess
    import sys

    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()
    prog = f"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
# package import is lazy (PEP 562) so this does no device work and
# jax.distributed.initialize can still run
from minigrid_dynamicprogramming_tpu.parallel import distributed
distributed.initialize("{addr}", num_processes=1, process_id=0)
distributed.initialize()  # idempotent second call: no-op
assert distributed.is_initialized()
mesh = distributed.global_env_mesh()
assert mesh.devices.size == len(jax.devices()) == 4, mesh
print(distributed.process_summary())
"""
    import pathlib

    import minigrid_dynamicprogramming_tpu as mgtpu

    out = subprocess.run(
        [sys.executable, "-c", prog],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=str(pathlib.Path(mgtpu.__file__).resolve().parent.parent),
    )
    assert out.returncode == 0, out.stderr
    assert "process 0/1" in out.stdout
    assert "global_devices=4" in out.stdout


_TWOPROC_WORKER = """
import sys
addr, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
from minigrid_dynamicprogramming_tpu.utils.compile_cache import (
    enable_compile_cache,
)
enable_compile_cache()
from minigrid_dynamicprogramming_tpu.parallel import distributed
distributed.initialize(addr, num_processes=2, process_id=pid)
import numpy as np
import minigrid_dynamicprogramming_tpu as mgtpu
from minigrid_dynamicprogramming_tpu.parallel.lanes import lane_rollout
mesh = distributed.global_env_mesh()
assert mesh.devices.size == 8, mesh
env = mgtpu.make("MiniGrid-Empty-5x5-v0")
res = lane_rollout(env, jax.random.PRNGKey(0), 16, 64, "pool", 2, mesh)
jax.block_until_ready(res.final_state.grid_obj)
# Each process can address only its 4 devices' shards; dump them keyed by
# their global env-axis offset so the parent can reassemble and compare.
shards = {}
for name in ("agent_x", "resets_per_env"):
    arr = getattr(res.final_state, name, None)
    if arr is None:
        arr = getattr(res, name)
    for s in arr.addressable_shards:
        shards[name + "_" + str(s.index[-1].start or 0)] = np.asarray(s.data)
np.savez(out_path, episodes=int(res.episodes),
         obs_checksum=int(res.obs_checksum),
         total_reward=float(res.total_reward), **shards)
print("worker", pid, "ok", distributed.process_summary())
"""


def test_distributed_two_process_bit_equality(tmp_path):
    """Real 2-process ``jax.distributed`` group (coordinator + Gloo CPU
    collectives, 4 virtual devices per process = 8 global): the sharded lane
    rollout must be bit-identical to the single-process 8-device run, and the
    psum-reduced scalars (episodes / obs_checksum) must agree on BOTH
    processes.  This exercises the cross-host path that
    ``test_distributed_initialize_single_process`` cannot: non-addressable
    shards, cross-process collectives, and coordinator rendezvous.

    Reference analog: ``/root/reference/tests/test_envs.py:318-330`` smoke-
    tests SyncVectorEnv; our bar adds multi-process bit-equality.
    """
    import os
    import pathlib
    import subprocess
    import sys

    import minigrid_dynamicprogramming_tpu as mgtpu
    from minigrid_dynamicprogramming_tpu.parallel.lanes import lane_rollout
    from minigrid_dynamicprogramming_tpu.parallel.sharding import env_mesh

    pkg_root = str(pathlib.Path(mgtpu.__file__).resolve().parent.parent)
    env_vars = dict(os.environ)
    env_vars["PYTHONPATH"] = (
        pkg_root + os.pathsep + env_vars.get("PYTHONPATH", "")
    )

    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    worker_py = tmp_path / "twoproc_worker.py"
    worker_py.write_text(_TWOPROC_WORKER)
    outs = [tmp_path / "p0.npz", tmp_path / "p1.npz"]
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), addr, str(pid), str(out)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env_vars,
        )
        for pid, out in enumerate(outs)
    ]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(log)
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log}"
        assert f"worker {pid} ok" in log

    # Single-process truth on this test process's own 8-device mesh.
    mesh = env_mesh(jax.devices())
    env = mgtpu.make("MiniGrid-Empty-5x5-v0")
    res = lane_rollout(env, jax.random.PRNGKey(0), 16, 64, "pool", 2, mesh)

    dumps = [np.load(o) for o in outs]
    for name, ref in (
        ("agent_x", np.asarray(res.final_state.agent_x)),
        ("resets_per_env", np.asarray(res.resets_per_env)),
    ):
        parts = {}
        for d in dumps:
            for k in d.files:
                if k.startswith(name + "_"):
                    parts[int(k[len(name) + 1 :])] = d[k]
        got = np.concatenate([parts[k] for k in sorted(parts)])
        np.testing.assert_array_equal(got, ref, err_msg=name)
    for pid, d in enumerate(dumps):
        assert int(d["episodes"]) == int(res.episodes), pid
        assert int(d["obs_checksum"]) == int(res.obs_checksum), pid
        np.testing.assert_allclose(
            float(d["total_reward"]), float(res.total_reward), rtol=1e-5
        )


def test_distributed_initialize_after_backend_raises_with_guidance():
    jax.devices()  # backend is up in the test process
    distributed._initialized = False
    try:
        with np.testing.assert_raises(RuntimeError):
            distributed.initialize("127.0.0.1:1", 1, 0)
    finally:
        distributed._initialized = False
