"""Parity checks between two runs of the pipeline and against plain
references: the GPU's output against the CPU backend's on the same
frame, and the matcher against a float64 numpy brute force.  Used by
``chip_smoke.py`` and ``tests_gpu/``."""

from __future__ import annotations

from typing import Dict

import numpy as np


def match_reference(query: np.ndarray, train: np.ndarray,
                    ratio: float = 0.8) -> np.ndarray:
    """Float64 brute-force matching with match_brute_force's semantics:
    nearest train row by squared L2, kept when min1 < ratio * min2 (ties
    go to the lowest index).  Returns [Q] int32 indices or -1."""
    q = np.asarray(query, np.float64)
    t = np.asarray(train, np.float64)
    d2 = (np.sum(q * q, 1)[:, None] + np.sum(t * t, 1)[None, :]
          - 2.0 * q @ t.T)
    d2 = np.maximum(d2, 0.0)
    idx1 = np.argmin(d2, 1)
    rows = np.arange(len(q))
    min1 = d2[rows, idx1]
    d2[rows, idx1] = np.inf
    min2 = d2.min(1)
    # The ratio test in float32, as the matcher evaluates it; squared
    # distances of 0..255 descriptors are integers below 2^24, exact in
    # both precisions.
    keep = min1.astype(np.float32) < np.float32(ratio) * min2.astype(
        np.float32)
    return np.where(keep, idx1, -1).astype(np.int32)


def compare_detections(ref, got, pos_tol: float = 0.01,
                       ang_tol: float = 0.5) -> Dict:
    """Pair each keypoint of ``ref`` (a SiftResult) with the keypoint of
    ``got`` within ``pos_tol`` px (base-image coordinates) whose angle is
    closest, if that angle is within ``ang_tol`` degrees.  Returns counts,
    the paired share of ref's keypoints, the largest position and angle
    differences among pairs, and the descriptor differences of the pairs
    in quantized units."""
    def unpack(r):
        n = int(r.count)
        k = r.keypoints
        return (n, np.asarray(k.x)[:n].astype(np.float64),
                np.asarray(k.y)[:n].astype(np.float64),
                np.asarray(k.angle)[:n].astype(np.float64),
                np.asarray(r.descriptors)[:n].astype(np.float64))

    n_ref, rx, ry, ra, rd = unpack(ref)
    n_got, gx, gy, ga, gd = unpack(got)
    pairs = np.full(n_ref, -1, np.int64)
    pos_err = np.zeros(n_ref)
    ang_err = np.zeros(n_ref)
    if n_got:
        for lo in range(0, n_ref, 512):
            sl = slice(lo, min(lo + 512, n_ref))
            dpos = np.hypot(rx[sl, None] - gx[None], ry[sl, None] - gy[None])
            dang = np.abs((ra[sl, None] - ga[None] + 180.0) % 360.0 - 180.0)
            dang = np.where(dpos <= pos_tol, dang, np.inf)
            j = np.argmin(dang, 1)
            rows = np.arange(j.size)
            ok = dang[rows, j] <= ang_tol
            pairs[sl] = np.where(ok, j, -1)
            pos_err[sl] = dpos[rows, j]
            ang_err[sl] = dang[rows, j]
    paired = pairs >= 0
    dd = np.abs(rd[paired] - gd[pairs[paired]])
    return {
        "n_ref": n_ref, "n_got": n_got,
        "count_rel_diff": abs(n_got - n_ref) / max(n_ref, 1),
        "paired_frac": float(paired.mean()) if n_ref else 1.0,
        "max_pos_err_px": float(pos_err[paired].max(initial=0.0)),
        "max_ang_err_deg": float(ang_err[paired].max(initial=0.0)),
        "desc_max_diff": float(dd.max(initial=0.0)),
        "desc_frac_elems_diff": float((dd > 0).mean()) if dd.size else 0.0,
    }
