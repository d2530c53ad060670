"""Orientation assignment — 36-bin gradient histograms + peak expansion.

Equivalent capability to the reference's ``calOriHistMultiThread``
(/root/reference/sift_cuda/sift_func/SiftOps.cu:237-376): Gaussian-weighted
gradient-orientation histogram over a square window, (6,4,1)/16 circular
smoothing, and one emitted keypoint per local max >= 0.8 * peak.

Design: warp-per-keypoint shared-memory atomics become ONE batched
masked histogram over keypoints of ALL octaves at once (flat-pyramid
gather of DENSE precomputed gradients, ops/flatpyr.py), with

* separable Gaussian window weights (two s-length exp vectors per keypoint
  instead of s^2 transcendentals);
* the bin scatter as a chunked one-hot contraction (no atomics
  — the race class the reference manages with __syncwarp is eliminated by
  construction);
* peak expansion as a fixed [K, 36] candidate grid + mask, compacted
  downstream.

Deviations from the reference, both gated on OpenCV (the reference's own
oracle, readme.md:5):
* gradients default to the Gaussian block, not the DoG block the reference
  passes in (interface/Detector.cu:489) — config.orientation_source;
* histogram bin = round(ori * 36/360) like OpenCV, not floor;
* parabolic peak interpolation like OpenCV when
  config.interpolate_orientation (the reference leaves it TODO,
  SiftOps.cu:359-371).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sift_jax.config import (SIFT_ORI_HIST_BINS, SIFT_ORI_PEAK_RATIO,
                             SIFT_ORI_RADIUS, SIFT_ORI_SIG_FCTR, SiftConfig)
from sift_jax.ops.flatpyr import (PaddedPyramid, dense_gradients_padded,
                                  keypoint_window_pair, pad_pyramid)

_NB = SIFT_ORI_HIST_BINS


def max_ori_radius(cfg: SiftConfig) -> int:
    """Static bound on the orientation window radius: scl_octv <=
    sigma * 2^((L + 0.5)/L) (layer <= L, |xi| <= 0.5)."""
    scl_max = cfg.sigma * 2.0 ** ((cfg.num_octave_layers + 0.5)
                                  / cfg.num_octave_layers)
    return int(round(SIFT_ORI_RADIUS * scl_max))


def orientation_histograms_flat(mag: PaddedPyramid, ori: PaddedPyramid,
                                octave, x, y, layer, size, valid,
                                cfg: SiftConfig,
                                chunk: int = 1024) -> jnp.ndarray:
    """One global pass over keypoints of every octave.

    mag/ori: FULL-PRECISION dense gradient pyramids (the 1-degree angle
    parity gate is sensitive to histogram perturbations; the packed slab
    is reserved for the descriptor stage).  octave: [K] int32 per
    keypoint; x/y/size in base-image space.  Returns raw histograms
    [K, 36]."""
    inv = jnp.exp2(-octave.astype(jnp.float32))
    px = jnp.round(x * inv).astype(jnp.int32)
    py = jnp.round(y * inv).astype(jnp.int32)
    scl_octv = size * 0.5 * inv
    sigma_ori = SIFT_ORI_SIG_FCTR * scl_octv
    radius = jnp.round(SIFT_ORI_RADIUS * scl_octv)

    rmax = max_ori_radius(cfg)
    k = x.shape[0]
    nchunk = max(1, -(-k // chunk))
    pad = nchunk * chunk - k

    def pad0(a):
        return jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:],
                                             a.dtype)]) if pad else a

    args = tuple(pad0(a).reshape(nchunk, chunk) for a in
                 (octave, px, py, layer, sigma_ori, radius, valid))

    def body(ch):
        coct, cpx, cpy, clyr, csig, crad, cval = ch
        return _hist_chunk(mag, ori, coct, cpx, cpy, clyr, csig, crad,
                           cval, rmax)

    if nchunk == 1:
        hist = body(tuple(a[0] for a in args))[None]
    else:
        hist = jax.lax.map(body, args)
    return hist.reshape(nchunk * chunk, _NB)[:k]


def _hist_chunk(mag, ori, octave, px, py, layer, sigma_ori, radius, valid,
                rmax):
    m_p, o_p, offy, offx = keypoint_window_pair(
        mag, ori, octave, layer, py, px, rmax)
    offyf = offy.astype(jnp.float32)                    # [K, rows]
    offxf = offx.astype(jnp.float32)                    # [K, 256]

    h, w = mag.octave_geometry(octave)
    pyy = py[:, None] + offy
    pxx = px[:, None] + offx
    in_y = (pyy >= 1) & (pyy <= (h - 2)[:, None])
    in_x = (pxx >= 1) & (pxx <= (w - 2)[:, None])
    rad = radius[:, None]
    # Separable Gaussian weights: exp(-(i^2 + j^2) es) = wy_i * wx_j.
    es = (-0.5 / jnp.maximum(sigma_ori * sigma_ori, 1e-12))[:, None]
    wy = jnp.exp(offyf ** 2 * es) * (in_y & (jnp.abs(offyf) <= rad))
    wx = jnp.exp(offxf ** 2 * es) * (in_x & (jnp.abs(offxf) <= rad))
    wgt = wy[:, :, None] * wx[:, None, :] * valid[:, None, None]

    contrib = wgt * m_p                                 # [K, S, S]
    b = jnp.round(o_p * (_NB / 360.0)).astype(jnp.int32)
    b = jnp.where(b >= _NB, b - _NB, b)
    b = jnp.where(b < 0, b + _NB, b)

    # Chunked one-hot contraction instead of atomic scatter, at default
    # precision (TF32 on the GPU; HIGHEST turns it into a batched GEMV
    # several times slower, with no parity gain the gates need —
    # PERF.md, Findings).
    kc = px.shape[0]
    p = m_p.shape[1] * m_p.shape[2]
    onehot = (b.reshape(kc, p)[:, :, None]
              == jnp.arange(_NB, dtype=jnp.int32)).astype(jnp.float32)
    return jax.lax.dot_general(
        contrib.reshape(kc, 1, p), onehot,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)[:, 0, :]    # [Kc, 36]


def orientation_histograms(block: jnp.ndarray, x, y, layer, size, valid,
                           octave: int, cfg: SiftConfig) -> jnp.ndarray:
    """Single-octave wrapper (golden-replay API parity): block [D, H, W]
    source stack; octave is this block's pyramid octave index."""
    mag, ori = dense_gradients_padded(pad_pyramid([block]))
    # base-image -> this octave's scale uses 2^octave, but the padded
    # pyramid has a single block at index 0; pre-scale coordinates.
    oct_arr = jnp.zeros(x.shape, jnp.int32)
    inv = 1.0 / float(1 << octave)
    return orientation_histograms_flat(
        mag, ori, oct_arr, x * inv, y * inv, layer, size * inv, valid, cfg)


def smooth_histogram(hist: jnp.ndarray) -> jnp.ndarray:
    """(6 h[i] + 4 (h[i-1] + h[i+1]) + h[i-2] + h[i+2]) / 16, circular
    (SiftOps.cu:329-336)."""
    r1 = jnp.roll(hist, 1, -1)
    l1 = jnp.roll(hist, -1, -1)
    r2 = jnp.roll(hist, 2, -1)
    l2 = jnp.roll(hist, -2, -1)
    return (6.0 * hist + 4.0 * (r1 + l1) + r2 + l2) / 16.0


def orientation_peaks(hist: jnp.ndarray, valid, cfg: SiftConfig):
    """Returns (angles [K, 36], peak_mask [K, 36]): one candidate orientation
    per histogram bin that is a strict local max >= 0.8 * global max
    (SiftOps.cu:338-373)."""
    sm = smooth_histogram(hist)
    left = jnp.roll(sm, 1, -1)
    right = jnp.roll(sm, -1, -1)
    peak = (sm > left) & (sm > right) \
        & (sm >= SIFT_ORI_PEAK_RATIO * jnp.max(sm, -1, keepdims=True)) \
        & valid[:, None]

    bins = jnp.arange(_NB, dtype=jnp.float32)[None, :]
    if cfg.interpolate_orientation:
        denom = left - 2.0 * sm + right
        denom = jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
        fb = bins + 0.5 * (left - right) / denom
        fb = jnp.where(fb < 0, fb + _NB, jnp.where(fb >= _NB, fb - _NB, fb))
    else:
        fb = bins
    angle = 360.0 - fb * (360.0 / _NB)
    angle = jnp.where(jnp.abs(angle - 360.0) < 1.192092896e-07, 0.0, angle)
    return angle, peak
