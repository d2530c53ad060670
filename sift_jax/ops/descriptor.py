"""128-D SIFT descriptor extraction.

Equivalent capability to the reference's ``genDescriptorMultiThread``
(/root/reference/sift_cuda/sift_func/SiftOps.cu:453-623): rotated 4x4
spatial x 8 orientation grid, trilinear interpolation into a
(4+2)^2 x (8+2) histogram, border folding, L2-normalize -> clip at
0.2*norm -> renormalize -> scale.

Design: the 128-threads-per-keypoint shared-memory atomicAdd scatter
becomes ONE batched pass over keypoints of ALL octaves (flat-pyramid
gather of dense precomputed gradients) + fused reductions.  Key identity:
the trilinear scatter-with-fold is exactly

    desc[k, R, C, o] = sum_p mag_p * hat(rbin_p + 1 - R) * hat(cbin_p + 1 - C)
                             * circular_hat_8(obin_p - o)

with hat(t) = max(0, 1 - |t|): only the 4x4 retained spatial cells are ever
computed (the reference's border histogram cells are written then discarded;
its orientation wrap bins 8/9 fold into 0/1, SiftOps.cu:431-446, which the
circular hat performs implicitly).  The Gaussian window weight is rotation-
invariant (|rot(i,j)| = |(i,j)|), so it is computed as two separable
s-length exp vectors.  The pixel contraction is one batched matrix
product.  No atomics, no scatter.

Output quantizations:
* "opencv"    — saturate_cast<uchar>(v * 512/norm): rounded, clamped to 255
                (what cv2.SIFT produces; the parity-gate mode);
* "reference" — clamp(v/norm, 0, 1) * 512 unrounded (SiftOps.cu:606-622).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from sift_jax.config import (SIFT_DESCR_HIST_BINS, SIFT_DESCR_SCL_FCTR,
                             SIFT_DESCR_WIDTH, SIFT_INT_DESCR_FCTR,
                             SiftConfig)
from sift_jax.ops.flatpyr import (PaddedPyramid, dense_gradients_packed,
                                  keypoint_window_packed, pad_pyramid)

_D = SIFT_DESCR_WIDTH        # 4 spatial cells per side
_NB = SIFT_DESCR_HIST_BINS   # 8 orientation bins


def max_descr_radius(cfg: SiftConfig) -> int:
    """Static window-radius bound: hist_width = 3 * scl_octv with
    scl_octv <= sigma * 2^((L+0.5)/L); radius = round(hw * sqrt2 * 2.5)."""
    scl_max = cfg.sigma * 2.0 ** ((cfg.num_octave_layers + 0.5)
                                  / cfg.num_octave_layers)
    hw = SIFT_DESCR_SCL_FCTR * scl_max
    return int(round(hw * math.sqrt(2.0) * (_D + 1) * 0.5))


def _hat(t):
    return jnp.maximum(0.0, 1.0 - jnp.abs(t))


def compute_descriptors_flat(grad: PaddedPyramid,
                             octave, x, y, layer, size, angle, valid,
                             cfg: SiftConfig, chunk: int = 512):
    """One global pass over keypoints of every octave.

    grad: PACKED dense gradient pyramid; octave [K] int32; x/y/size
    in base-image space; angle in degrees.

    Returns (desc [K, 128] float32 pre-quantization, nrm2 [K, 1]); invalid
    slots are zero.  Work is chunked over keypoints to bound temporaries.
    """
    inv = jnp.exp2(-octave.astype(jnp.float32))
    px = jnp.round(x * inv).astype(jnp.int32)
    py = jnp.round(y * inv).astype(jnp.int32)
    scl = size * 0.5 * inv
    ang = 360.0 - angle
    ang = jnp.where(jnp.abs(ang - 360.0) < 1e-6, 0.0, ang)

    rmax = max_descr_radius(cfg)
    k = x.shape[0]
    nchunk = max(1, -(-k // chunk))
    pad = nchunk * chunk - k

    def pad0(a):
        return jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]) \
            if pad else a

    args = tuple(pad0(a).reshape(nchunk, chunk, *a.shape[1:]) for a in
                 (octave, px, py, layer, scl, ang, valid))

    def body(ch):
        return _descriptor_hist(grad, *ch, rmax)

    if nchunk == 1:
        hist = body(tuple(a[0] for a in args))[None]
    else:
        hist = jax.lax.map(body, args)
    hist = hist.reshape(nchunk * chunk, _D, _D, _NB)[:k]
    return finalize_descriptor(hist)


def _descriptor_hist(grad, octave, px, py, layer, scl, ang, valid, rmax):
    """[Kc, D, D, NB] histogram via hat-function contractions."""
    hist_width = SIFT_DESCR_SCL_FCTR * scl
    arad = ang * (math.pi / 180.0)
    inv_hw = 1.0 / jnp.maximum(hist_width, 1e-12)
    cos_t = jnp.cos(arad) * inv_hw
    sin_t = jnp.sin(arad) * inv_hw

    h, w = grad.octave_geometry(octave)
    diag = jnp.sqrt((h * h + w * w).astype(jnp.float32))
    radius = jnp.minimum(
        jnp.round(hist_width * math.sqrt(2.0) * (_D + 1) * 0.5), diag)

    m_p, o_p, offy, offx = keypoint_window_packed(
        grad, octave, layer, py, px, rmax)
    offyf = offy.astype(jnp.float32)                     # [Kc, rows]
    offxf = offx.astype(jnp.float32)                     # [Kc, 256]
    ii = offyf[:, :, None]                               # rows
    jj = offxf[:, None, :]                               # cols

    c_rot = jj * cos_t[:, None, None] - ii * sin_t[:, None, None]
    r_rot = jj * sin_t[:, None, None] + ii * cos_t[:, None, None]
    rbin = r_rot + (_D / 2 - 0.5)
    cbin = c_rot + (_D / 2 - 0.5)

    # Separable window: image-bounds/radius masks per axis, and the
    # Gaussian weight exp(-(c_rot^2 + r_rot^2)/(0.5 D^2)) equals
    # exp(-(i^2 + j^2) inv_hw^2 / (0.5 D^2)) — rotation preserves norm.
    pyy = py[:, None] + offy
    pxx = px[:, None] + offx
    in_y = (pyy > 0) & (pyy < (h - 1)[:, None])
    in_x = (pxx > 0) & (pxx < (w - 1)[:, None])
    rad = radius[:, None]
    es = (inv_hw * inv_hw * (-1.0 / (_D * _D * 0.5)))[:, None]
    wy = jnp.exp(offyf ** 2 * es) * (in_y & (jnp.abs(offyf) <= rad))
    wx = jnp.exp(offxf ** 2 * es) * (in_x & (jnp.abs(offxf) <= rad))
    wgt = wy[:, :, None] * wx[:, None, :] * valid[:, None, None]

    m = (rbin > -1) & (rbin < _D) & (cbin > -1) & (cbin < _D)
    mag_w = jnp.where(m, m_p * wgt, 0.0)                 # [Kc, S, S]

    obin = (o_p - ang[:, None, None]) * (_NB / 360.0)
    ob = jnp.mod(obin, float(_NB))                       # [0, 8)

    # Separable hat tensors; the triple contraction over pixels as ONE
    # einsum, so XLA's contraction-order planner picks the order (the
    # [P, 16] product tensor need not materialize).  Default precision
    # (TF32 on the GPU's tensor cores): on an H100 it holds the parity
    # gates against the CPU backend, and HIGHEST doubled the frame time
    # (PERF.md, Findings).
    kc = px.shape[0]
    p = m_p.shape[1] * m_p.shape[2]
    cells = jnp.arange(1, _D + 1, dtype=jnp.float32)
    hr = _hat(rbin.reshape(kc, p)[:, :, None] + 1.0 - cells)   # [Kc, P, 4]
    hc = _hat(cbin.reshape(kc, p)[:, :, None] + 1.0 - cells)   # [Kc, P, 4]
    od = jnp.abs(ob.reshape(kc, p)[:, :, None]
                 - jnp.arange(_NB, dtype=jnp.float32))
    wo = jnp.maximum(0.0, 1.0 - jnp.minimum(od, float(_NB) - od))
    wo = wo * mag_w.reshape(kc, p)[:, :, None]                 # [Kc, P, 8]
    return jnp.einsum("kpr,kpc,kpo->krco", hr, hc, wo,
                      preferred_element_type=jnp.float32)      # [Kc,D,D,NB]


def compute_descriptors(block: jnp.ndarray, x, y, layer, size, angle, valid,
                        octave: int, cfg: SiftConfig, chunk: int = 512):
    """Single-octave wrapper (golden-replay API parity): block [D, H, W]
    Gaussian stack of this octave; x/y/size in base-image space."""
    grad = dense_gradients_packed(pad_pyramid([block]))
    oct_arr = jnp.zeros(x.shape, jnp.int32)
    inv = 1.0 / float(1 << octave)
    return compute_descriptors_flat(grad, oct_arr, x * inv, y * inv,
                                    layer, size * inv, angle, valid, cfg,
                                    chunk)


def finalize_descriptor(hist: jnp.ndarray):
    """hist [K, D, D, NB] -> (desc [K, 128], nrm2 [K, 1])
    (SiftOps.cu:606-616): L2-norm, clip at 0.2*norm, renorm factor."""
    k = hist.shape[0]
    desc = hist.reshape(k, _D * _D * _NB)
    nrm = jnp.sqrt(jnp.sum(desc * desc, -1, keepdims=True))
    desc = jnp.minimum(desc, nrm * 0.2)
    nrm2 = jnp.sqrt(jnp.sum(desc * desc, -1, keepdims=True))
    return desc, nrm2


def quantize_descriptor(desc, nrm2, mode: str = "opencv"):
    if mode == "opencv":
        # saturate_cast<uchar>(v * 512 / max(norm, FLT_EPSILON))
        scale = SIFT_INT_DESCR_FCTR / jnp.maximum(nrm2, 1.192092896e-07)
        return jnp.clip(jnp.round(desc * scale), 0.0, 255.0)
    # reference: __saturatef(v / max(norm, 1e-7)) * 512 (SiftOps.cu:617-622)
    scale = 1.0 / jnp.maximum(nrm2, 1e-7)
    return jnp.clip(desc * scale, 0.0, 1.0) * SIFT_INT_DESCR_FCTR
