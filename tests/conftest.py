"""Test configuration: run JAX on a virtual 8-device CPU mesh so sharding
code paths are exercised without accelerator hardware, and keep pygame
headless for the reference oracle.

The platform is set through ``jax.config`` after import, which holds even
where the environment names another platform.
"""

import os
import sys

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
os.environ.setdefault("SDL_AUDIODRIVER", "dummy")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compile cache: the registry-wide generator sweeps compile one
# program per env id, which dominates suite runtime on a cold start.
from minigrid_dynamicprogramming_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()

REFERENCE_PATH = "/root/reference"
if REFERENCE_PATH not in sys.path:
    sys.path.insert(0, REFERENCE_PATH)

