"""Perspective-n-Point: robust Gauss-Newton pose from 3D-2D
correspondences.

New capability (SfM layer).  For video odometry the previous frame's pose
is an excellent initialization, so a damped GN on the 6-DOF left-increment
twist with a truncated reprojection loss is both simpler and more robust
than minimal-solver RANSAC — and it is one fixed-iteration jittable
program (vmap-able over frames).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sift_jax.geometry import se3
from sift_jax.geometry.se3 import ein, mm


def pnp_gn(points_w: jnp.ndarray, uv: jnp.ndarray, valid: jnp.ndarray,
           fx, fy, cx, cy, r0: jnp.ndarray, t0: jnp.ndarray,
           iters: int = 12, threshold_px: float = 3.0,
           damping: float = 1e-6):
    """points_w: [N, 3] world points; uv: [N, 2] pixels; (r0, t0) initial
    world->camera pose.  Returns (r, t, inliers, mean_err_px).

    Robust truncated loss with ANNEALED threshold: iteration i gates at
    ``threshold_px * max(2^(iters/2 - i), 1)`` so far-off initializations
    (where a fixed tight gate would zero every weight and freeze the
    solver) converge first coarsely, then tightly; the final inlier set
    uses the tight gate."""
    anneal = [max(2.0 ** (iters / 2 - i), 1.0) for i in range(iters)]
    anneal_arr = jnp.asarray(anneal, points_w.dtype)

    def residuals(xi, r, t):
        dr, dt = se3.se3_exp(xi)
        rr = mm(dr, r)
        tt = mm(dr, t[..., None])[..., 0] + dt
        pc = mm(points_w, rr.T) + tt
        z = jnp.maximum(pc[:, 2], 1e-6)
        proj = jnp.stack([pc[:, 0] / z * fx + cx,
                          pc[:, 1] / z * fy + cy], -1)
        behind = pc[:, 2] <= 1e-6
        return proj - uv, behind

    def step(carry, mult):
        r, t = carry
        thr2 = (threshold_px * mult) ** 2
        zero = jnp.zeros((6,), points_w.dtype)
        res, behind = residuals(zero, r, t)
        err2 = jnp.sum(res * res, -1)
        w = (valid & ~behind & (err2 < thr2)).astype(points_w.dtype)

        jac = jax.jacfwd(lambda xi: residuals(xi, r, t)[0])(zero)  # [N,2,6]
        jw = jac * w[:, None, None]
        h = ein("nki,nkj->ij", jw, jac) \
            + damping * jnp.eye(6, dtype=points_w.dtype)
        g = ein("nki,nk->i", jw, res)
        d = -jnp.linalg.solve(h, g)
        dr, dt = se3.se3_exp(d)
        return (mm(dr, r), mm(dr, t[..., None])[..., 0] + dt), None

    (r, t), _ = jax.lax.scan(step, (r0, t0), anneal_arr)
    res, behind = residuals(jnp.zeros((6,), points_w.dtype), r, t)
    err2 = jnp.sum(res * res, -1)
    inliers = valid & ~behind & (err2 < threshold_px * threshold_px)
    n = jnp.maximum(jnp.sum(inliers), 1)
    mean_err = jnp.sqrt(jnp.sum(jnp.where(inliers, err2, 0.0)) / n)
    return r, t, inliers, mean_err
