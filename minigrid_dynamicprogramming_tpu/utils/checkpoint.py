"""Checkpoint / resume.

The reference has no checkpointing; its nearest analogs are env picklability
(tested in /root/reference/tests/test_envs.py:169-183) and the ``hash()``
state digest (minigrid_env.py:159-169).  Here everything that matters — env
states (batched pytrees), PPO train state, PRNG keys — is a pytree of
arrays, so a checkpoint is a directory holding the leaves in one
``arrays.npz`` and a ``framework_meta.json`` with the tree structure they
came from.  Restore refuses a target whose structure differs.  The metadata
also records the :func:`state_hash` digests of a few env slots, so a
restore can be integrity-checked against the run it came from (SURVEY.md
§5, "Checkpoint / resume").
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import jax
import numpy as np

from minigrid_dynamicprogramming_tpu.utils.debug import state_hash

_ARRAYS = "arrays.npz"
_META = "framework_meta.json"


def _digests(env_state, n: int = 4) -> list:
    """State digests of the first ``n`` env slots of a batched EnvState."""
    batch = int(np.asarray(env_state.step_count).shape[0])
    take = min(n, batch)
    host = jax.device_get(env_state)
    out = []
    for i in range(take):
        slot = jax.tree_util.tree_map(lambda x: x[i], host)
        out.append(state_hash(slot))
    return out


def save(path: str, tree: Any, env_state: Optional[Any] = None) -> dict:
    """Save a pytree checkpoint; returns the metadata written alongside.

    ``env_state`` (a batched EnvState, possibly a leaf of ``tree``) adds
    per-slot integrity digests to the metadata."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    leaves, treedef = jax.tree_util.tree_flatten(jax.device_get(tree))
    np.savez(
        os.path.join(path, _ARRAYS),
        **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)},
    )
    meta = {"treedef": str(treedef), "num_leaves": len(leaves)}
    if env_state is not None:
        meta["env_digests"] = _digests(env_state)
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)
    return meta


def restore(path: str, target: Any, env_state_of=None, verify: bool = True):
    """Restore a checkpoint into the structure of ``target``.

    ``env_state_of`` is a callable extracting the batched EnvState from the
    restored tree; with ``verify=True`` its digests are checked against the
    saved metadata."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    treedef = jax.tree_util.tree_structure(target)
    if str(treedef) != meta["treedef"]:
        raise ValueError(
            f"checkpoint structure {meta['treedef']} does not match the "
            f"target's {treedef}"
        )
    with np.load(os.path.join(path, _ARRAYS)) as data:
        leaves = [data[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    restored = jax.tree_util.tree_unflatten(treedef, leaves)
    if verify and env_state_of is not None:
        want = meta.get("env_digests", [])
        got = _digests(env_state_of(restored))
        if want and got != want:
            raise ValueError(
                f"checkpoint integrity check failed: digests {got} != {want}"
            )
    return restored
