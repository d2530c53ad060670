"""Synthetic geometry problems with known ground truth, built from a
seed: a two-view scene for relative-pose estimation and a bundle-
adjustment problem.  The tests and ``chip_smoke.py`` share them."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from sift_jax.geometry import se3
from sift_jax.geometry.ba import BAProblem


def two_view_scene(seed=0, n=200, outlier_frac=0.0):
    """Random 3D points seen by two cameras with known relative pose.
    Returns (p1, p2, R, t, points, n_outliers); p1/p2 are normalized
    image coordinates and the first n_outliers rows of p2 are random."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    w = np.array([0.05, -0.12, 0.08])
    r = np.asarray(se3.so3_exp(jnp.asarray(w)))
    t = np.array([0.5, -0.1, 0.05])
    p1 = pts[:, :2] / pts[:, 2:]
    pc2 = pts @ r.T + t
    p2 = pc2[:, :2] / pc2[:, 2:]
    n_out = int(outlier_frac * n)
    if n_out:
        p2[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    return (jnp.asarray(p1, jnp.float32), jnp.asarray(p2, jnp.float32),
            r, t, pts, n_out)


def synthetic_ba(seed=0, n_cams=6, n_pts=120, noise_px=0.0,
                 perturb=0.02):
    """Cameras on an arc looking at a point cloud; observations = exact
    projections + noise; initial estimate = ground truth perturbed."""
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    pts = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3))

    rots, trs = [], []
    for i in range(n_cams):
        w = np.array([0.0, 0.25 * (i / max(n_cams - 1, 1) - 0.5), 0.0])
        r = np.asarray(se3.so3_exp(jnp.asarray(w)))
        t = np.array([-0.8 * i / max(n_cams - 1, 1) + 0.4, 0.0, 0.0])
        rots.append(r)
        trs.append(t)
    rots, trs = np.stack(rots), np.stack(trs)

    cam_idx, pt_idx, uvs = [], [], []
    for c in range(n_cams):
        pc = pts @ rots[c].T + trs[c]
        uv = np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                       pc[:, 1] / pc[:, 2] * fy + cy], -1)
        cam_idx += [c] * n_pts
        pt_idx += list(range(n_pts))
        uvs.append(uv + rng.normal(0, noise_px, uv.shape))
    uv = np.concatenate(uvs)

    # Perturb all but camera 0 (the gauge anchor) and all points.
    rots_i = rots.copy()
    trs_i = trs.copy()
    for c in range(1, n_cams):
        dw = rng.normal(0, perturb, 3)
        rots_i[c] = np.asarray(se3.so3_exp(jnp.asarray(dw))) @ rots[c]
        trs_i[c] = trs[c] + rng.normal(0, perturb, 3)
    pts_i = pts + rng.normal(0, perturb, pts.shape)

    prob = BAProblem(
        rotations=jnp.asarray(rots_i, jnp.float32),
        translations=jnp.asarray(trs_i, jnp.float32),
        points=jnp.asarray(pts_i, jnp.float32),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        pt_idx=jnp.asarray(pt_idx, jnp.int32),
        uv=jnp.asarray(uv, jnp.float32),
        valid=jnp.ones(len(cam_idx), bool),
        fx=jnp.float32(fx), fy=jnp.float32(fy),
        cx=jnp.float32(cx), cy=jnp.float32(cy))
    return prob, rots, trs, pts
