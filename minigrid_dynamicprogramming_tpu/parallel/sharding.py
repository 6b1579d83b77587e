"""Device-mesh sharding of environment batches.

The reference is single-threaded Python with no distributed layer; here
the "distributed backend" is a ``jax.sharding.Mesh`` over the devices with
env state sharded along the batch axis.  Environment stepping needs ZERO cross-device communication
(envs are independent), so collectives appear only for metric reduction
(``psum``-style ``jnp.sum`` under sharding) and at the learner boundary.

Mesh convention: one axis named ``"env"`` spanning all chips (data parallel
over environments).  A learner adds its own axes on top (see
``models/ppo.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"


def env_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or given) devices, axis ``"env"``."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (ENV_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (env-batch) axis of every leaf over the mesh."""
    return NamedSharding(mesh, P(ENV_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh, axis: int = 0):
    """Place a batched pytree with its env axis sharded over the mesh.

    ``axis`` selects which axis is the env-batch axis (e.g. 1 for a layout
    pool whose leading axis is the pool-round index)."""

    def place(x):
        spec = [None] * x.ndim
        spec[axis] = ENV_AXIS
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    return jax.tree_util.tree_map(place, tree)


def sharded_keys(key: jax.Array, n: int, mesh: Mesh) -> jax.Array:
    """Split a key into n batch keys laid out along the env axis."""
    keys = jax.random.split(key, n)
    return jax.device_put(keys, NamedSharding(mesh, P(ENV_AXIS)))
