"""Deterministic benchmark input image.

Multi-octave value-noise texture — a photo-like spectrum that yields a
realistic keypoint load.  White noise yields almost none and would
benchmark an empty frame.  The frame is built with numpy alone, so it is
bit-identical on every machine.
"""

from __future__ import annotations

import numpy as np


def bench_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for s in (2, 4, 8, 16, 32, 64):
        n = rng.normal(0, 1, (h // s + 2, w // s + 2)).astype(np.float32)
        img += _resize_bicubic(n, h, w) * s ** 0.4
    img -= img.min()
    return img * (255.0 / max(float(img.max()), 1e-6))


def _cubic_operator(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] bicubic interpolation matrix (Keys kernel, a=-0.75,
    half-pixel centres, replicated border: OpenCV's INTER_CUBIC
    convention)."""
    a = -0.75
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    t = f - i0
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + 1
    c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    c3 = 1.0 - c0 - c1 - c2
    op = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    for k, c in enumerate((c0, c1, c2, c3)):
        np.add.at(op, (rows, np.clip(i0 - 1 + k, 0, n_in - 1)), c)
    return op


def _resize_bicubic(a: np.ndarray, h: int, w: int) -> np.ndarray:
    out = _cubic_operator(h, a.shape[0]) @ a.astype(np.float64) \
        @ _cubic_operator(w, a.shape[1]).T
    return out.astype(np.float32)
