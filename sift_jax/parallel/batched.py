"""Multi-frame batching and multi-chip sharding of the SIFT pipeline.

The reference is single-GPU and processes keyframes in a serial host loop
(/root/reference/tool/extract_and_match_example.cc:69-102).  Scaling here
(BASELINE north star) makes the *keyframe axis* the parallel axis:

* ``batched_detect_fn``  — vmap of the single-frame pipeline over a leading
  frame axis; one XLA program processes B frames.
* ``make_sharded_pipeline`` — the same batched program jitted over a
  ``jax.sharding.Mesh`` with the frame axis sharded across devices
  ("data" axis).  Sequential matching of frame t against frame t-1 uses a
  batch-axis roll, which XLA lowers to a ``ppermute``-style collective
  between devices — no host round-trips.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sift_jax.core.types import SiftPlan
from sift_jax.pipeline.detector import build_detect_fn
from sift_jax.pipeline.matcher import match_brute_force


def batched_detect_fn(plan: SiftPlan, quant_mode: str = "opencv"):
    """[B, H, W] -> SiftResult with leading batch axis on every leaf.

    lax.map: one scan over frames inside ONE program keeps every stage
    on its single-frame shapes while still amortizing dispatch; under a
    sharded batch axis each device runs its local frames' iterations.
    Whether vmap is faster on the GPU is not measured yet."""
    single = build_detect_fn(plan, quant_mode)
    return lambda frames: jax.lax.map(single, frames)


def sequential_match(descriptors: jnp.ndarray, valid: jnp.ndarray,
                     ratio: float = 0.8) -> jnp.ndarray:
    """Match frame b's descriptors against frame b-1's for every b.

    descriptors: [B, N, 128]; valid: [B, N].  Returns [B, N] int32 match
    indices into frame b-1 (row 0 is all -1).  The shift across the sharded
    batch axis becomes a device-to-device collective under jit.
    """
    prev_d = jnp.roll(descriptors, 1, axis=0)
    prev_v = jnp.roll(valid, 1, axis=0)
    m = jax.vmap(functools.partial(match_brute_force, ratio=ratio))(
        descriptors, prev_d, valid, prev_v)
    return m.at[0].set(-1)


def make_sharded_pipeline(plan: SiftPlan, mesh: Mesh,
                          axis: str = "data",
                          quant_mode: str = "opencv"):
    """Returns (fn, shard) where fn: frames [B, H, W] -> (SiftResult,
    matches [B, N]) jitted with the batch axis sharded over ``mesh[axis]``,
    and shard(x) places a host array with that sharding.

    Detection runs under shard_map: each device lax.map's the
    single-frame pipeline over its LOCAL frames (devices parallel,
    frames sequential per device — a scan over a globally sharded axis
    would serialize through cross-device slices instead).  The
    sequential match stays at the jit level, where the batch-axis roll
    lowers to a device-to-device collective."""
    single = build_detect_fn(plan, quant_mode)

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=P(axis, None, None), out_specs=P(axis))
    def detect_local(frames):
        return jax.lax.map(single, frames)

    def step(frames):
        res = detect_local(frames)
        matches = sequential_match(res.descriptors, res.keypoints.valid,
                                   plan.config.match_ratio)
        return res, matches

    in_sharding = NamedSharding(mesh, P(axis, None, None))
    fn = jax.jit(step, in_shardings=in_sharding)

    def shard(x: np.ndarray):
        return jax.device_put(jnp.asarray(x, jnp.float32), in_sharding)

    return fn, shard


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """1-D device mesh over the first ``n_devices`` available devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))
