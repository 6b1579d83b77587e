"""Batched JAX Minigrid framework.

A ground-up JAX/XLA re-design of the capabilities of
cytab/Minigrid_DynamicProgramming (a fork of Farama Minigrid v2.3.1):
struct-of-arrays world state, branchless batched transition and observation
kernels, on-device procedural generation, device-side observation wrappers, a
batched tabular value-iteration (dynamic-programming) solver, and sharding
of environment batches over device meshes.

Public names are resolved lazily (PEP 562): importing the package does no
device work, so ``parallel.distributed.initialize`` can run first in a
multi-host program (jax.distributed.initialize must precede XLA backend
initialization, which the LUT constants would otherwise trigger).
"""

__version__ = "0.1.0"

__all__ = [
    "Environment",
    "EnvParams",
    "EnvState",
    "make",
    "register",
    "registered_ids",
    "__version__",
]

_LAZY = {
    "Environment": ("minigrid_dynamicprogramming_tpu.core.env", "Environment"),
    "EnvParams": ("minigrid_dynamicprogramming_tpu.core.state", "EnvParams"),
    "EnvState": ("minigrid_dynamicprogramming_tpu.core.state", "EnvState"),
    "make": ("minigrid_dynamicprogramming_tpu.registry", "make"),
    "register": ("minigrid_dynamicprogramming_tpu.registry", "register"),
    "registered_ids": (
        "minigrid_dynamicprogramming_tpu.registry",
        "registered_ids",
    ),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
