"""SO(3)/SE(3) utilities for the SfM layer.

New capability (no reference equivalent — the reference is feature
extraction + matching only, SURVEY.md §2.2): minimal, fully batchable
rotation/pose math used by two-view geometry, pose-graph optimization and
bundle adjustment.  Everything is pure jnp and vmap/jit-safe.

Conventions: rotations are 3x3 matrices; poses (R, t) map world points to
camera frame: x_cam = R @ x_world + t.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Every product in geometry/ and parallel/dba.py runs at full float32
# precision: the operands are 3x3 and 6x6 blocks, normal equations and
# Schur complements, where a TF32 tensor-core pass would cost accuracy
# and save nothing.
PRECISION = jax.lax.Precision.HIGHEST


def mm(a, b):
    """``a @ b`` at PRECISION."""
    return jnp.matmul(a, b, precision=PRECISION)


def ein(spec, *operands):
    """``jnp.einsum`` at PRECISION."""
    return jnp.einsum(spec, *operands, precision=PRECISION)

_EPS = 1e-9


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], -1),
        jnp.stack([wz, z, -wx], -1),
        jnp.stack([-wy, wx, z], -1),
    ], -2)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta = jnp.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    k = hat(w)
    k2 = mm(k, k)
    t = jnp.maximum(theta, _EPS)
    a = jnp.sin(t) / t
    b = (1.0 - jnp.cos(t)) / (t * t)
    eye = jnp.broadcast_to(jnp.eye(3), k.shape)
    small = theta[..., 0, 0] < 1e-7
    r = eye + a * k + b * k2
    r_small = eye + k + 0.5 * k2
    return jnp.where(small[..., None, None], r_small, r)


def so3_log(r: jnp.ndarray) -> jnp.ndarray:
    """[..., 3, 3] rotation -> [..., 3] axis-angle."""
    tr = jnp.trace(r, axis1=-2, axis2=-1)
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    v = jnp.stack([r[..., 2, 1] - r[..., 1, 2],
                   r[..., 0, 2] - r[..., 2, 0],
                   r[..., 1, 0] - r[..., 0, 1]], -1)
    s = jnp.maximum(2.0 * jnp.sin(theta), _EPS)
    w = v * (theta / s)[..., None]
    # theta -> 0: log(R) ~ v / 2
    return jnp.where((theta < 1e-7)[..., None], v * 0.5, w)


def se3_exp(xi: jnp.ndarray):
    """[..., 6] twist (v, w) -> (R [...,3,3], t [...,3])."""
    v, w = xi[..., :3], xi[..., 3:]
    r = so3_exp(w)
    theta = jnp.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    k = hat(w)
    k2 = mm(k, k)
    t_ = jnp.maximum(theta, _EPS)
    b = (1.0 - jnp.cos(t_)) / (t_ * t_)
    c = (t_ - jnp.sin(t_)) / (t_ * t_ * t_)
    eye = jnp.broadcast_to(jnp.eye(3), k.shape)
    jac = eye + b * k + c * k2
    jac_small = eye + 0.5 * k
    small = theta[..., 0, 0] < 1e-7
    jac = jnp.where(small[..., None, None], jac_small, jac)
    t = mm(jac, v[..., None])[..., 0]
    return r, t


def compose(ra, ta, rb, tb):
    """(Ra, ta) ∘ (Rb, tb): first apply b, then a."""
    return mm(ra, rb), mm(ra, tb[..., None])[..., 0] + ta


def inverse(r, t):
    rt = jnp.swapaxes(r, -1, -2)
    return rt, -mm(rt, t[..., None])[..., 0]


def transform(r, t, pts):
    """Apply pose to [..., N, 3] points."""
    return mm(pts, jnp.swapaxes(r, -1, -2)) + t[..., None, :]


def project(pts_cam: jnp.ndarray, fx, fy, cx, cy) -> jnp.ndarray:
    """Pinhole projection of camera-frame points [..., N, 3] -> [..., N, 2]."""
    z = jnp.maximum(pts_cam[..., 2:3], 1e-9)
    uv = pts_cam[..., :2] / z
    return jnp.stack([uv[..., 0] * fx + cx, uv[..., 1] * fy + cy], -1)
