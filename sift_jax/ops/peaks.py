"""3-D DoG extrema detection.

Equivalent capability to the reference's ``findPeaks3D`` two-pass
mask + prefix-sum + scatter (/root/reference/sift_cuda/image_func/
MatOps.cu:40-182): a pixel is a candidate when |v| > threshold and v is a
(>=/<=) extremum over its 26 neighbors across three adjacent DoG layers,
within an image border margin.

Design: the 27-neighbor comparison is a fused elementwise reduction over
shifted views; compaction to a fixed candidate capacity uses tiled
top-k by |response| (ops/compact.py) instead of prefix-sum scatter — when
the capacity binds we keep the strongest candidates rather than the lowest
indices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sift_jax.ops.compact import stream_compact


def _edge(a, ax):
    """Shape of a 1-thick slice of ``a`` along axis ``ax``."""
    s = list(a.shape)
    s[ax] = 1
    return tuple(s)


def peak_mask(dog: jnp.ndarray, threshold: float, border: int):
    """dog: [D, H, W].  Returns (mask, score) of shape [D-2, H, W] aligned to
    DoG layers 1..D-2 (the candidate layer index is l+1, MatOps.cu:149-181)."""
    d, h, w = dog.shape
    c = dog[1:-1]

    # 3x3x3 max/min pooling over (layer, y, x): the window includes the
    # center, and "c is a >= / <= extremum over 26 neighbors" is exactly
    # "c equals the 27-window max/min".  Separable shifted-pad passes
    # (2 ops per axis) — lax.reduce_window lowers ~8x slower here.
    def pool3(a, op, pad):
        for ax in (0, 1, 2):
            lo = jnp.concatenate(
                [jnp.full(_edge(a, ax), pad, a.dtype),
                 jax.lax.slice_in_dim(a, 0, a.shape[ax] - 1, axis=ax)], ax)
            hi = jnp.concatenate(
                [jax.lax.slice_in_dim(a, 1, a.shape[ax], axis=ax),
                 jnp.full(_edge(a, ax), pad, a.dtype)], ax)
            a = op(op(a, lo), hi)
        return a

    mx = pool3(dog, jnp.maximum, -jnp.inf)[1:-1]
    mn = pool3(dog, jnp.minimum, jnp.inf)[1:-1]

    is_max = (c > 0) & (c >= mx)
    is_min = (c < 0) & (c <= mn)
    mask = (jnp.abs(c) > threshold) & (is_max | is_min)

    # Border mask (MatOps.cu:105-114): x,y in [border, size - border);
    # border >= 1 (SIFT_IMG_BORDER = 5) also covers the SAME-padding edge.
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inb = ((ys >= border) & (ys < h - border)
           & (xs >= border) & (xs < w - border))
    mask = mask & inb[None]
    return mask, jnp.abs(c)


def find_candidates(dog: jnp.ndarray, threshold: float, border: int,
                    cap: int):
    """Returns candidate (x, y, layer, valid) arrays of length ``cap``.
    ``layer`` is the DoG layer index (1..D-2), matching the reference's
    candidateKpts z (MatOps.cu:177)."""
    dl, h, w = dog.shape[0] - 2, dog.shape[1], dog.shape[2]
    mask, score = peak_mask(dog, threshold, border)
    idx, valid = stream_compact(mask.reshape(-1), cap)
    lyr = idx // (h * w) + 1
    rem = idx % (h * w)
    y = rem // w
    x = rem % w
    return (x.astype(jnp.int32), y.astype(jnp.int32),
            lyr.astype(jnp.int32), valid)
