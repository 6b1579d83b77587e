"""On-device numerics audit: catch backend miscompiles of integer kernels.

Motivation: batched sub-32-bit scatters miscompiled on an earlier
accelerator backend — ``vmap(lambda p, x, y, v: p.at[y, x].set(v))`` on
uint8/uint16/bool planes returned CPU-identical cells at small batch and
silently wrong cells at large batch, while ``lax.dynamic_update_slice``,
one-hot ``where`` writes and gathers lowered correctly.  That bug corrupted
procedural generation (door/object writes) until the framework switched
its dynamic cell writes to ``ops.grid.cell_set``-family one-hot
compare+select writes (the oracle class below), which cannot hit it and
fuse into one pass over the plane.

``audit_device`` re-runs the probe battery on the LIVE backend, comparing
each suspect lowering against a pure-elementwise one-hot oracle evaluated
in the same program.  Run it after a JAX/runtime upgrade (or on new
hardware) before trusting large-batch results:

    python -m minigrid_dynamicprogramming_tpu.benchmark --audit

Returns per-probe booleans; ``ok`` is the conjunction.  A failing probe
means results computed through that lowering CANNOT be trusted at that
batch size on this backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["audit_device"]

_H = _W = 22


def _onehot_set(p, x, y, v):
    ys = jnp.arange(p.shape[0])[:, None]
    xs = jnp.arange(p.shape[1])[None, :]
    return jnp.where((ys == y) & (xs == x), jnp.asarray(v, p.dtype), p)


def audit_device(batch: int = 4096, seed: int = 7) -> dict:
    """Probe suspect integer lowerings at ``batch`` on the default backend."""
    key = jax.random.PRNGKey(seed)
    x = jax.random.randint(jax.random.fold_in(key, 1), (batch,), 0, _W)
    y = jax.random.randint(jax.random.fold_in(key, 2), (batch,), 0, _H)

    report = {"backend": jax.default_backend(), "batch": batch}

    def check(name, fn, oracle_fn, *args):
        got, want = jax.jit(
            lambda *a: (jax.vmap(fn)(*a), jax.vmap(oracle_fn)(*a))
        )(*args)
        report[name] = bool(np.array_equal(np.asarray(got), np.asarray(want)))

    for dtype, hi in ((jnp.uint8, 9), (jnp.uint16, 999), (jnp.int32, 9)):
        p = jax.random.randint(key, (batch, _H, _W), 0, 4).astype(dtype)
        v = jax.random.randint(
            jax.random.fold_in(key, 3), (batch,), 5, hi
        ).astype(dtype)
        check(
            f"scatter_{dtype.__name__}",
            lambda p, x, y, v: p.at[y, x].set(v),
            _onehot_set_args,
            p, x, y, v,
        )
        check(
            f"dus_{dtype.__name__}",
            lambda p, x, y, v: jax.lax.dynamic_update_slice(
                p, v.reshape(1, 1), (y, x)
            ),
            _onehot_set_args,
            p, x, y, v,
        )

    pb = jax.random.bernoulli(key, 0.5, (batch, _H, _W))
    check(
        "scatter_bool",
        lambda p, x, y: p.at[y, x].set(True),
        lambda p, x, y: _onehot_set(p, x, y, True),
        pb, x, y,
    )

    # gather probe (reads)
    p8 = jax.random.randint(key, (batch, _H, _W), 0, 200).astype(jnp.uint8)
    check(
        "gather_uint8",
        lambda p, x, y: p[y, x],
        lambda p, x, y: jnp.where(
            (jnp.arange(_H)[:, None] == y) & (jnp.arange(_W)[None, :] == x),
            p, jnp.uint8(0),
        ).max(),
        p8, x, y,
    )

    report["ok"] = all(v for k, v in report.items() if isinstance(v, bool))
    return report


def _onehot_set_args(p, x, y, v):
    return _onehot_set(p, x, y, v)


if __name__ == "__main__":
    import json

    print(json.dumps(audit_device()))
