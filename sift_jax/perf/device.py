"""Device identity for measurement entry points.

Every number a measurement prints names the device it ran on, and a
measurement that finds no GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict


def require_gpu() -> Dict:
    """Exit non-zero unless JAX's default device is a GPU.  Returns the
    device as JAX reports it: {"platform", "kind", "count"}."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"no GPU: JAX's default device is {devs[0].platform!r} "
                 f"({devs[0].device_kind})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_identity() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (one line per card).  Runs as a child process that does not import
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
