"""Bilinear resize as matmuls.

Equivalent capability to the reference's ``resize_cuda_bilinear``
(/root/reference/sift_cuda/image_func/Resize.cu:6-64): center-aligned
coordinates ``(i + 0.5) * in/out - 0.5`` with edge clamping.

Bilinear resize is separable and linear, so it is expressed as two matmuls
with precomputed [out, in] operators (core/gaussian.resize_operator) — the
same matmul formulation as the blur, and it composes with the blur operators to
give each octave's base in a single matmul pair.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_PRECISION = lax.Precision.HIGHEST


def resize_matmul(img: jnp.ndarray, op_v: jnp.ndarray,
                  op_h: jnp.ndarray) -> jnp.ndarray:
    """``op_v @ img @ op_h.T``; img [..., H_in, W_in] -> [..., H_out, W_out]."""
    out = jnp.matmul(op_v, img, precision=_PRECISION)
    return jnp.matmul(out, jnp.swapaxes(op_h, -1, -2), precision=_PRECISION)


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Direct (gather-based) bilinear resize with the reference's exact
    coordinate math, for callers without precomputed operators."""
    h, w = img.shape[-2], img.shape[-1]

    def axis_taps(n_out, n_in):
        i = jnp.arange(n_out, dtype=jnp.float32)
        coord = (i + 0.5) * (n_in / n_out) - 0.5
        lo = jnp.floor(coord)
        frac = coord - lo
        i1 = jnp.clip(lo.astype(jnp.int32), 0, n_in - 1)
        i2 = jnp.clip(jnp.where(frac == 0, lo + 1,
                                jnp.ceil(coord)).astype(jnp.int32),
                      0, n_in - 1)
        return i1, i2, frac

    y1, y2, fy = axis_taps(out_h, h)
    x1, x2, fx = axis_taps(out_w, w)
    r1 = jnp.take(img, y1, axis=-2)
    r2 = jnp.take(img, y2, axis=-2)
    row = r1 * (1.0 - fy)[..., :, None] + r2 * fy[..., :, None]
    c1 = jnp.take(row, x1, axis=-1)
    c2 = jnp.take(row, x2, axis=-1)
    return c1 * (1.0 - fx) + c2 * fx
