"""Separable Gaussian blur.

Equivalent capability to the reference's ``applyFilter`` separable
convolution (/root/reference/sift_cuda/image_func/Filter.cu:8-51,
FilterImpl.cuh:22-45: vertical pass then horizontal, BORDER_REFLECT_101).

Two implementations:

* ``blur_matmul`` — the blur as two dense matmuls with precomputed banded
  operators (see core/gaussian.blur_operator).  This is the matmul path:
  boundary handling is baked into the operator, layers batch trivially, and
  operator composition collapses the whole per-octave blur chain into one
  batched matmul pair.
* ``blur_conv`` — reflect-101 gather padding + ``lax.conv_general_dilated``.
  Reference/fallback path.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from sift_jax.core.gaussian import reflect101_index

_PRECISION = lax.Precision.HIGHEST


def blur_matmul(img: jnp.ndarray, op_v: jnp.ndarray,
                op_h: jnp.ndarray) -> jnp.ndarray:
    """``op_v @ img @ op_h.T``.

    img: [..., H, W]; op_v: [H, H] (or broadcast-batched [..., H, H]);
    op_h: [W, W].  float32 with HIGHEST precision so the result tracks
    the reference's float32 FMA chain (no reduced-precision passes).
    """
    out = jnp.matmul(op_v, img, precision=_PRECISION)
    return jnp.matmul(out, jnp.swapaxes(op_h, -1, -2), precision=_PRECISION)


def blur_tiled(base: jnp.ndarray, vblk, voff, hblk, hoff) -> jnp.ndarray:
    """All of one octave's layers from its base via band-blocked
    operators (core/gaussian.banded_blocks_multi), emitting the PADDED
    pyramid layout directly: content rows at [HALO, HALO + h), content
    lanes at [0, w), zeros elsewhere — the zero padding is rows/cols of
    the operators, so it costs nothing.

    base: [h_in, w_in] f32.  vblk: [nT, NL, T, Bv]; hblk: [nTc, NL, Tc,
    Bh]; voff/hoff: static numpy offsets.  Returns [NL, nT*T, nTc*Tc].

    The dense equivalent (blur_matmul with [n, n] operators) is
    O(n^2 w); band-blocking cuts each matmul's contraction to the band
    width (~4-8x fewer FLOPs)."""
    nt, nl, t, bv = vblk.shape
    ntc, _, tc, bh = hblk.shape
    w_in = base.shape[1]
    tiles = jnp.stack([
        jax.lax.slice(base, (int(voff[i]), 0),
                      (int(voff[i]) + bv, w_in)) for i in range(nt)])
    x = jnp.einsum("tlab,tbw->ltaw", vblk, tiles,
                   precision=_PRECISION)              # [NL, nT, T, w_in]
    x = x.reshape(nl, nt * t, w_in)
    outs = []
    for i in range(ntc):
        sl = jax.lax.slice(x, (0, 0, int(hoff[i])),
                           (nl, nt * t, int(hoff[i]) + bh))
        outs.append(jnp.einsum("lhb,lcb->lhc", sl, hblk[i],
                               precision=_PRECISION))
    return jnp.concatenate(outs, axis=-1)


def _reflect_pad_1d(img: jnp.ndarray, half: int, axis: int) -> jnp.ndarray:
    """Reflect-101 padding via static index gather (works for any pad size,
    unlike jnp.pad(mode='reflect') which requires pad < dim)."""
    n = img.shape[axis]
    idx = reflect101_index(np.arange(-half, n + half), n)
    return jnp.take(img, jnp.asarray(idx), axis=axis)


def blur_conv(img: jnp.ndarray, kernel_1d: jnp.ndarray) -> jnp.ndarray:
    """Separable reflect-101 blur via XLA conv.  img: [H, W] or [B, H, W]."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    k = kernel_1d.shape[0]
    half = k // 2
    # Vertical pass first (FilterImpl.cuh:23 "Very important to call
    # vertical first" — order only matters for fp reassociation).
    x = _reflect_pad_1d(img, half, axis=1)
    x = lax.conv_general_dilated(
        x[:, None], kernel_1d.reshape(1, 1, k, 1).astype(img.dtype),
        window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=_PRECISION)[:, 0]
    x = _reflect_pad_1d(x, half, axis=2)
    x = lax.conv_general_dilated(
        x[:, None], kernel_1d.reshape(1, 1, 1, k).astype(img.dtype),
        window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=_PRECISION)[:, 0]
    return x[0] if squeeze else x
