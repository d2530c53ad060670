"""Gaussian and DoG pyramid construction.

Equivalent capability to the reference's pipeline stages
``createInitialImage`` / ``getGaussianPyramid`` / ``getDogPyramid``
(/root/reference/sift_cuda/interface/Detector.cu:235-359).

Design: with the blur expressed as precomputed banded operators
(core/gaussian.py), each octave's six layers come from the octave base via
ONE batched matmul pair, and each octave base comes from the
previous base via one composed (resize ∘ blur) matmul pair.  No sequential
per-layer kernel chain, no streams, no CUDA-graph capture — the whole
pyramid is a short static chain of large matmuls that XLA schedules.
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp

from sift_jax.core.types import SiftPlan
from sift_jax.ops.blur import blur_conv, blur_matmul, blur_tiled
from sift_jax.ops.resize import resize_matmul

# Padded octave layout: content rows start at HALO, and the row count is
# ceil(h / TILE_ROWS) * TILE_ROWS + 2 * HALO rounded up to the 128-row
# operator tiles (core/types.build_plan).  Every consumer of the padded
# pyramid (ops/records.detect_records_padded, padded_content_views) reads
# content through these offsets.
TILE_ROWS = 32
HALO = 8


def gaussian_pyramid_padded(plan: SiftPlan,
                            image: jnp.ndarray) -> List[jnp.ndarray]:
    """The pipeline's pyramid: per-octave [L+3, Hv_o, Wp_o] stacks in
    the PADDED layout (content rows at [HALO, HALO + h_o), lanes
    [0, w_o), zeros elsewhere) via band-blocked tiled matmuls — the
    padding is zero rows/cols of the operators, and the band-blocking
    keeps the blur O(n * band * w) instead of the dense operators'
    O(n^2 w).

    Octave BASES (layer-0 sources) also run through the band-blocked
    tiled path (``tiled1`` over ``plan.init_tiled`` /
    ``plan.carry_tiled``): the init and carry operators are
    band-blocked like the per-layer blurs, with resize/decimation
    folded into the composed carry operators."""
    cfg = plan.config
    if cfg.blur_impl == "conv":
        out = []
        for o, b in enumerate(_gaussian_pyramid_conv(
                plan, _init_base(plan, image))):
            vb, _ = plan.tiled_v[o]
            hb, _ = plan.tiled_h[o]
            hv, wp = vb.shape[0] * vb.shape[2], hb.shape[0] * hb.shape[2]
            out.append(jnp.pad(b, ((0, 0),
                                   (HALO, hv - HALO - b.shape[1]),
                                   (0, wp - b.shape[2]))))
        return out

    def tiled1(src, pair, h, w):
        # One banded operator pair applied via the tiled path, result
        # cut back to natural shape (the grid pads rows/cols to 128).
        (vb, vo), (hb, ho) = pair
        out = blur_tiled(src, jnp.asarray(vb), vo, jnp.asarray(hb), ho)
        return out[0, :h, :w]

    h0, w0 = plan.octaves[0].height, plan.octaves[0].width
    base = tiled1(_init_base(plan, image), plan.init_tiled, h0, w0)
    octaves = []
    for o in range(cfg.num_octaves):
        if o > 0:
            op = plan.octaves[o]
            base = tiled1(base, plan.carry_tiled[o], op.height, op.width)
        vb, vo = plan.tiled_v[o]
        hb, ho = plan.tiled_h[o]
        octaves.append(blur_tiled(base, jnp.asarray(vb), vo,
                                  jnp.asarray(hb), ho))
    return octaves


def padded_content_views(plan: SiftPlan, gp: List[jnp.ndarray]):
    """Natural-shape views [L+3, h_o, w_o] of a padded pyramid (lazy
    slices — they fuse into whatever consumes them)."""
    return [g[:, HALO:HALO + op.height, :op.width]
            for g, op in zip(gp, plan.octaves)]


def _init_base(plan: SiftPlan, image: jnp.ndarray) -> jnp.ndarray:
    if plan.config.upscale:
        return resize_matmul(image, jnp.asarray(plan.up_v),
                             jnp.asarray(plan.up_h))
    return image


def gaussian_pyramid(plan: SiftPlan, image: jnp.ndarray) -> List[jnp.ndarray]:
    """image: [H, W] float32 (0..255 range).  Returns per-octave stacks
    [L+3, H_o, W_o]."""
    cfg = plan.config
    if cfg.upscale:
        base = resize_matmul(image, jnp.asarray(plan.up_v),
                             jnp.asarray(plan.up_h))
    else:
        base = image

    if cfg.blur_impl == "conv":
        return _gaussian_pyramid_conv(plan, base)

    # Layer 0 of octave 0: base blur with sigma_diff (Detector.cu:41-60).
    base = blur_matmul(base, jnp.asarray(plan.init_v), jnp.asarray(plan.init_h))
    octaves = []
    for o in range(cfg.num_octaves):
        if o > 0:
            base = blur_matmul(base, jnp.asarray(plan.carry_v[o]),
                               jnp.asarray(plan.carry_h[o]))
        layers = blur_matmul(base, jnp.asarray(plan.blur_v[o]),
                             jnp.asarray(plan.blur_h[o]))
        octaves.append(layers)
    return octaves


def _gaussian_pyramid_conv(plan: SiftPlan, base: jnp.ndarray):
    """Sequential conv path, mirroring the reference's per-layer chain
    (Detector.cu:292-303): layer i = blur(layer i-1, sigmas[i]); octave
    base = bilinear-resize(previous octave layer L)."""
    cfg = plan.config
    layer0 = blur_conv(base, jnp.asarray(plan.init_kernel_1d))
    octaves = []
    for o in range(cfg.num_octaves):
        if o > 0:
            prev_L = octaves[o - 1][cfg.num_octave_layers]
            layer0 = resize_matmul(prev_L, jnp.asarray(plan.down_v[o]),
                                   jnp.asarray(plan.down_h[o]))
        layers = [layer0]
        for i in range(1, cfg.num_gauss_layers):
            layers.append(blur_conv(layers[-1],
                                    jnp.asarray(plan.kernels_1d[i])))
        octaves.append(jnp.stack(layers))
    return octaves


def dog_pyramid(gauss: List[jnp.ndarray]) -> List[jnp.ndarray]:
    """DoG[i] = gauss[i+1] - gauss[i] per octave (Detector.cu:347-353,
    image_func/MatOps.cu:10-37)."""
    return [g[1:] - g[:-1] for g in gauss]
