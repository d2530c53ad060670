"""Batched square-patch gathering around keypoints.

Replacement for the reference's per-warp windowed loops over
image neighborhoods (orientation: sift_func/SiftOps.cu:299-325; descriptor:
SiftOps.cu:537-601): instead of threads striding a variable-radius window,
we gather a static-size patch per keypoint with one XLA gather, and mask
out-of-window / out-of-image pixels downstream.
"""

from __future__ import annotations

import jax.numpy as jnp


def gather_patches(block: jnp.ndarray, layer, cy, cx, size: int):
    """block: [D, H, W]; layer/cy/cx: [K] int32 patch centers.

    Returns (patch [K, size, size], dy_off [size], dx_off [size]) where
    patch[k, i, j] = block[layer[k], cy[k] + i - R, cx[k] + j - R] with
    clamped indices (R = size // 2).  Consumers must mask positions whose
    unclamped coordinates fall outside the image.
    """
    d, h, w = block.shape
    r = size // 2
    off = jnp.arange(size, dtype=jnp.int32) - r
    ys = jnp.clip(cy[:, None] + off[None, :], 0, h - 1)          # [K, S]
    xs = jnp.clip(cx[:, None] + off[None, :], 0, w - 1)          # [K, S]
    lidx = jnp.clip(layer, 0, d - 1)[:, None, None] * (h * w)
    idx = lidx + ys[:, :, None] * w + xs[:, None, :]             # [K, S, S]
    flat = block.reshape(-1)
    return jnp.take(flat, idx.reshape(idx.shape[0], -1),
                    axis=0).reshape(-1, size, size), off, off


def patch_gradients(patch: jnp.ndarray):
    """Central-difference gradients on a gathered patch.

    dx[i, j] = p[i, j+1] - p[i, j-1];  dy[i, j] = p[i-1, j] - p[i+1, j]
    (the reference's orientation/descriptor gradient convention,
    SiftOps.cu:315-317,553-556).  The one-pixel patch rim has no valid
    gradient and must be masked by the caller; returned arrays are the
    inner [K, S-2, S-2] region.
    """
    dx = patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]
    dy = patch[:, :-2, 1:-1] - patch[:, 2:, 1:-1]
    return dx, dy
