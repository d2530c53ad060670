"""Latency measurement: the host clock around calls that end in
``jax.block_until_ready``.

JAX dispatches asynchronously, so a timing that does not wait for the
result measures the enqueue.  Each sample here is one call plus the wait
for every output leaf; the first call (compilation) is excluded and
reported separately by the caller.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import jax
import numpy as np


def time_calls(fn: Callable, *args, iters: int = 20) -> Dict[str, float]:
    """Run ``fn(*args)`` once untimed, then ``iters`` times timed.
    Returns {"median_ms", "p90_ms", "min_ms", "n"}."""
    jax.block_until_ready(fn(*args))
    samples = np.empty(iters, np.float64)
    for i in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples[i] = (time.perf_counter() - t0) * 1e3
    return {"median_ms": float(np.median(samples)),
            "p90_ms": float(np.percentile(samples, 90)),
            "min_ms": float(samples.min()),
            "n": int(iters)}
