"""Which device a measurement ran on.

Every number a benchmark prints names its device: JAX's platform, device
kind and device count, and the card's name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power runs
slower under load).  ``nvidia-smi`` runs in a child process that does not
use JAX.
"""

from __future__ import annotations

import subprocess

import jax

__all__ = ["card_info", "device_record", "find_gpu"]


def find_gpu():
    """The first GPU device, or None where JAX has no GPU backend."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        return None


def card_info() -> str:
    """``name, power limit`` of the first card, from ``nvidia-smi``."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_record(device) -> dict:
    """JAX's view of ``device`` plus the device count."""
    return {
        "platform": device.platform,
        "kind": device.device_kind,
        "count": len(jax.devices()),
    }
