"""OpenCV-oracle sidecar for golden checkpoints.

Golden replay (perf/replay.py) catches regressions against a recorded run
of THIS framework — it can never catch a parity drift, because expected
outputs come from the same code it re-runs.  This module records the
INDEPENDENT oracle the reference itself gates on (cv2.SIFT, readme.md:5)
next to a checkpoint, and verifies a fresh pipeline run against it with
the parity tolerances of tests/test_pipeline.py.  ``tools/perf.py
--oracle`` runs it from a checkpoint directory alone.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

ORACLE_FILE = "oracle.npz"


def capture_oracle(cfg, image: np.ndarray, path: str) -> Dict:
    """Record cv2.SIFT keypoints/descriptors for ``image`` (requires
    opencv; config must describe the same image geometry)."""
    import cv2

    img8 = np.asarray(image).astype(np.uint8)
    sift = cv2.SIFT_create(contrastThreshold=cfg.contrast_threshold,
                           edgeThreshold=cfg.edge_threshold,
                           sigma=cfg.sigma)
    kps, desc = sift.detectAndCompute(img8, None)
    out = {
        "x": np.array([k.pt[0] for k in kps], np.float32),
        "y": np.array([k.pt[1] for k in kps], np.float32),
        "angle": np.array([k.angle for k in kps], np.float32),
        "size": np.array([k.size for k in kps], np.float32),
        "descriptors": (np.zeros((0, 128), np.float32)
                        if desc is None else desc.astype(np.float32)),
    }
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, ORACLE_FILE), **out)
    return out


def has_oracle(path: str) -> bool:
    return os.path.exists(os.path.join(path, ORACLE_FILE))


def verify_oracle(path: str) -> Dict:
    """Run the full pipeline from a checkpoint directory's image + params
    and gate keypoints/descriptors against the recorded cv2.SIFT oracle.

    Thresholds match tests/test_pipeline.py: <=1% oracle keypoints
    unmatched within 0.5 px, >=95% of ours near an oracle keypoint,
    p90 descriptor max-abs error <= 2/255 on angle-matched pairs.
    Returns per-check dicts with an "ok" flag."""
    import jax.numpy as jnp

    from sift_jax.perf.checkpoint import config_from_params, load_golden
    from sift_jax.pipeline.detector import SiftDetector

    params, inputs, _ = load_golden(path)
    orc = dict(np.load(os.path.join(path, ORACLE_FILE),
                       allow_pickle=False))
    cfg = config_from_params(params)
    det = SiftDetector(cfg)
    res = det.detect_and_compute(jnp.asarray(inputs["image"]))
    n = int(res.count)
    kp = res.keypoints
    kx = np.asarray(kp.x)[:n]
    ky = np.asarray(kp.y)[:n]
    ka = np.asarray(kp.angle)[:n]
    desc = np.asarray(res.descriptors)[:n].astype(np.float32)

    ox, oy, oa = orc["x"], orc["y"], orc["angle"]
    odesc = orc["descriptors"]
    checks = {}

    missed = sum(1 for j in range(len(ox))
                 if n == 0 or np.hypot(kx - ox[j], ky - oy[j]).min() > 0.5)
    checks["recall"] = {
        "missed": missed, "oracle_kpts": len(ox),
        "ok": missed <= max(2, len(ox) // 100)}

    spurious = sum(1 for i in range(n)
                   if len(ox) == 0
                   or np.hypot(ox - kx[i], oy - ky[i]).min() > 0.5)
    checks["precision"] = {
        "spurious": spurious, "ours": n,
        "ok": spurious <= max(2, n // 20)}

    errs = []
    for i in range(n):
        d = np.hypot(ox - kx[i], oy - ky[i])
        da = np.abs(((oa - ka[i]) + 180) % 360 - 180)
        cand = np.where((d < 0.5) & (da < 1.0))[0]
        if len(cand):
            j = cand[np.argmin(d[cand])]
            errs.append(np.abs(odesc[j] - desc[i]).max())
    # No matched pair -> p90 is inf directly; running np.percentile on
    # an inf sentinel interpolates inf - inf = NaN (RuntimeWarning and a
    # latent false-positive in the gate).
    npairs = len(errs)
    p90 = float(np.percentile(np.asarray(errs), 90)) if errs \
        else float("inf")
    checks["descriptor"] = {
        "pairs": npairs, "p90_err": p90,
        "ok": bool(npairs >= min(50, max(1, n // 2)) and p90 <= 2.0)}

    checks["ok"] = all(c["ok"] for c in checks.values())
    for name, c in checks.items():
        if isinstance(c, dict):
            assert not any(isinstance(v, float) and np.isnan(v)
                           for v in c.values()), f"NaN in check {name}"
    return checks
