"""Brute-force 128-D descriptor matching with Lowe's ratio test.

Equivalent capability to the reference's ``matchBruteForce``
(/root/reference/sift_cuda/sift_func/Match.cu:8-177): all-pairs L2 on
(desc/4) — the reference pre-scales by 0.25 to dodge fp16 overflow
(Match.cu:89-99) and we keep the same distance definition so scores are
comparable — per-query top-2 minima, and the ratio test applied to the
*squared* distances (min1 < ratio * min2, hardcoded 0.8 in the reference,
Match.cu:171-175).  Unmatched queries return -1 (Match.cuh:16).

Design: the warp-per-query smem-tiled kernel becomes one matmul
(||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b) plus a fused masked top-2, all
inside jit — no [Q, S] host round-trip, no per-call allocation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("ratio",))
def match_brute_force(query: jnp.ndarray, train: jnp.ndarray,
                      q_valid=None, t_valid=None,
                      ratio: float = 0.8) -> jnp.ndarray:
    """query: [Q, 128]; train: [S, 128] — uint8 (0..255 quantized storage,
    config.descriptor_dtype="uint8") or float (0..255/0..512 quantized).
    Returns [Q] int32: index into train, or -1."""
    if (jnp.issubdtype(query.dtype, jnp.integer)
            and jnp.issubdtype(train.dtype, jnp.integer)):
        # u8-quantized descriptors: 0..255 integers are exact in bf16
        # (8 significant bits) and every product/sum stays below 2^24
        # (128 * 255^2 < 2^24), so the bf16 Gram matmul with f32
        # accumulation is BIT-IDENTICAL to f32-HIGHEST on the tensor
        # cores — the counterpart of the reference's half2 matching
        # (Match.cu:69-99, KeyPoint.cuh:27).  The ratio test is scale
        # invariant, so the reference's 0.25 pre-scale is dropped here.
        qf = query.astype(jnp.float32)
        tf = train.astype(jnp.float32)
        qn = jnp.sum(qf * qf, -1, keepdims=True)       # [Q, 1]
        tn = jnp.sum(tf * tf, -1, keepdims=True).T     # [1, S]
        d2 = qn + tn - 2.0 * jnp.matmul(
            query.astype(jnp.bfloat16), train.astype(jnp.bfloat16).T,
            preferred_element_type=jnp.float32)        # [Q, S]
    else:
        q = query.astype(jnp.float32) * 0.25
        t = train.astype(jnp.float32) * 0.25
        qn = jnp.sum(q * q, -1, keepdims=True)         # [Q, 1]
        tn = jnp.sum(t * t, -1, keepdims=True).T       # [1, S]
        d2 = qn + tn - 2.0 * jnp.matmul(
            q, t.T, precision=jax.lax.Precision.HIGHEST)
    d2 = jnp.maximum(d2, 0.0)

    # Invalid-entry sentinel: must exceed any real distance.  The
    # reference uses 1e6 on /4-scaled values (max 128*64^2, Match.cu:
    # 126-129); the unscaled u8 path reaches 128*255^2 ~ 8.3e6.
    big = jnp.float32(1e9)
    if t_valid is not None:
        d2 = jnp.where(t_valid[None, :], d2, big)

    min1 = jnp.min(d2, -1)
    idx1 = jnp.argmin(d2, -1)
    cols = jnp.arange(d2.shape[1])[None, :]
    d2b = jnp.where(cols == idx1[:, None], big, d2)
    min2 = jnp.min(d2b, -1)

    matched = min1 < ratio * min2
    if q_valid is not None:
        matched = matched & q_valid
    return jnp.where(matched, idx1, -1).astype(jnp.int32)


def match_pairs(query, train, q_valid=None, t_valid=None, ratio: float = 0.8,
                cross_check: bool = False):
    """Convenience wrapper returning (query_idx, train_idx) pairs as numpy
    arrays, with optional mutual-consistency check (no reference equivalent;
    standard SfM practice)."""
    import numpy as np

    m = np.asarray(match_brute_force(query, train, q_valid, t_valid,
                                     ratio=ratio))
    if cross_check:
        m2 = np.asarray(match_brute_force(train, query, t_valid, q_valid,
                                          ratio=ratio))
        qi = np.nonzero(m >= 0)[0]
        qi = qi[m2[m[qi]] == qi]
    else:
        qi = np.nonzero(m >= 0)[0]
    return qi, m[qi]
