"""Robust GN PnP vs ground truth."""
import numpy as np
import jax.numpy as jnp

from sift_jax.geometry import se3
from sift_jax.geometry.pnp import pnp_gn


def _scene(seed=0, n=80, outliers=0, noise_px=0.0):
    rng = np.random.default_rng(seed)
    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    pts = rng.uniform([-3, -2, 5], [3, 2, 15], (n, 3)).astype(np.float32)
    r = np.asarray(se3.so3_exp(jnp.asarray([0.05, -0.1, 0.02],
                                           jnp.float32)))
    t = np.array([0.3, -0.1, 0.2], np.float32)
    pc = pts @ r.T + t
    uv = np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                   pc[:, 1] / pc[:, 2] * fy + cy], -1)
    uv += rng.normal(0, noise_px, uv.shape)
    if outliers:
        uv[:outliers] += rng.uniform(30, 100, (outliers, 2))
    return pts, uv.astype(np.float32), r, t, (fx, fy, cx, cy)


def test_pnp_exact():
    pts, uv, r_gt, t_gt, (fx, fy, cx, cy) = _scene()
    r, t, inl, err = pnp_gn(jnp.asarray(pts), jnp.asarray(uv),
                            jnp.ones(len(pts), bool), fx, fy, cx, cy,
                            jnp.eye(3), jnp.zeros(3))
    assert np.asarray(inl).all()
    np.testing.assert_allclose(np.asarray(r), r_gt, atol=1e-4)
    np.testing.assert_allclose(np.asarray(t), t_gt, atol=1e-4)
    assert float(err) < 0.01


def test_pnp_robust_to_outliers():
    pts, uv, r_gt, t_gt, (fx, fy, cx, cy) = _scene(seed=1, outliers=20,
                                                   noise_px=0.5)
    r, t, inl, err = pnp_gn(jnp.asarray(pts), jnp.asarray(uv),
                            jnp.ones(len(pts), bool), fx, fy, cx, cy,
                            jnp.eye(3), jnp.zeros(3))
    inl = np.asarray(inl)
    assert inl[20:].mean() > 0.9   # real points kept
    assert inl[:20].mean() < 0.2   # outliers rejected
    dr = np.linalg.norm(np.asarray(se3.so3_log(
        jnp.asarray(r_gt.T, jnp.float32) @ r)))
    assert dr < 0.01
    np.testing.assert_allclose(np.asarray(t), t_gt, atol=0.02)


def test_pnp_respects_valid_mask():
    pts, uv, r_gt, t_gt, (fx, fy, cx, cy) = _scene(seed=2)
    uv2 = uv.copy()
    uv2[:30] += 500.0  # corrupted but masked out
    valid = np.arange(len(pts)) >= 30
    r, t, inl, err = pnp_gn(jnp.asarray(pts), jnp.asarray(uv2),
                            jnp.asarray(valid), fx, fy, cx, cy,
                            jnp.eye(3), jnp.zeros(3))
    assert not np.asarray(inl)[:30].any()
    np.testing.assert_allclose(np.asarray(r), r_gt, atol=1e-4)
