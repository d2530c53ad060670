"""Two-view geometry vs known ground truth and the cv2 oracle."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sift_jax.geometry import se3
from sift_jax.geometry.twoview import (eight_point, pixels_to_normalized,
                                       ransac_essential, sampson_error,
                                       triangulate)
from sift_jax.perf.scenes import two_view_scene as _synthetic_scene


def test_so3_exp_log_roundtrip():
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.uniform(-1, 1, (32, 3)), jnp.float32)
    r = se3.so3_exp(w)
    # orthonormal, det 1
    eye = jnp.eye(3)[None]
    np.testing.assert_allclose(np.asarray(r @ jnp.swapaxes(r, -1, -2)),
                               np.broadcast_to(eye, r.shape), atol=1e-5)
    w2 = se3.so3_log(r)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w), atol=1e-5)


def test_eight_point_exact():
    p1, p2, r, t, _, _ = _synthetic_scene(n=50)
    e = eight_point(p1, p2)
    err = np.asarray(sampson_error(e, p1, p2))
    assert err.max() < 1e-8
    # E should be parallel to hat(t) @ R up to scale
    e_gt = np.asarray(se3.hat(jnp.asarray(t))) @ r
    e_np = np.asarray(e)
    cosang = abs(np.sum(e_np * e_gt)) / (
        np.linalg.norm(e_np) * np.linalg.norm(e_gt))
    assert cosang > 0.999


@pytest.mark.parametrize("outlier_frac", [0.0, 0.3])
def test_ransac_pose_recovery(outlier_frac):
    p1, p2, r_gt, t_gt, pts_gt, n_out = _synthetic_scene(
        seed=2, n=300, outlier_frac=outlier_frac)
    valid = jnp.ones(p1.shape[0], bool)
    res = jax.jit(ransac_essential)(p1, p2, valid, jax.random.key(0))
    # inliers: all true matches, none of the outliers
    inl = np.asarray(res.inliers)
    assert inl[n_out:].mean() > 0.98
    if n_out:
        assert inl[:n_out].mean() < 0.05
    # rotation error < 0.2 deg
    r_err = np.asarray(se3.so3_log(
        jnp.asarray(r_gt.T) @ res.rotation))
    assert np.linalg.norm(r_err) < 0.005
    # translation direction error
    t_est = np.asarray(res.translation)
    cosang = abs(t_est @ t_gt) / (np.linalg.norm(t_est)
                                  * np.linalg.norm(t_gt))
    assert cosang > 0.999
    # triangulated depths match ground truth up to global scale
    pts = np.asarray(res.points3d)[n_out:]
    scale = np.median(pts_gt[n_out:, 2] / pts[:, 2])
    np.testing.assert_allclose(pts * scale, pts_gt[n_out:],
                               rtol=0.05, atol=0.05)


def test_matches_opencv_recover_pose():
    import cv2

    p1, p2, r_gt, t_gt, _, _ = _synthetic_scene(seed=3, n=150,
                                                outlier_frac=0.2)
    valid = jnp.ones(p1.shape[0], bool)
    res = ransac_essential(p1, p2, valid, jax.random.key(1))

    a1, a2 = np.asarray(p1, np.float64), np.asarray(p2, np.float64)
    e_cv, _ = cv2.findEssentialMat(a1, a2, np.eye(3), cv2.RANSAC, 0.999,
                                   1e-3)
    _, r_cv, t_cv, _ = cv2.recoverPose(e_cv, a1, a2, np.eye(3))
    # Both solvers must land near the ground truth; ours must not be worse
    # than the cv2 oracle by more than a small margin.
    err_ours = np.linalg.norm(np.asarray(se3.so3_log(
        jnp.asarray(r_gt.T, jnp.float32) @ res.rotation)))
    err_cv = np.linalg.norm(np.asarray(se3.so3_log(
        jnp.asarray(r_cv.T @ r_gt, jnp.float32))))
    assert err_ours < 0.02
    assert err_ours < max(2.0 * err_cv, 0.01)
    cos_ours = abs(np.asarray(res.translation) @ t_gt) \
        / np.linalg.norm(t_gt)
    assert cos_ours > 0.99


def test_pixels_to_normalized():
    pts = jnp.asarray([[320.0, 240.0], [0.0, 0.0]])
    n = pixels_to_normalized(pts, 500.0, 500.0, 320.0, 240.0)
    np.testing.assert_allclose(np.asarray(n),
                               [[0, 0], [-0.64, -0.48]], atol=1e-6)


def test_triangulate_exact():
    p1, p2, r, t, pts_gt, _ = _synthetic_scene(seed=4, n=60)
    x = triangulate(jnp.asarray(r, jnp.float32),
                    jnp.asarray(t, jnp.float32), p1, p2)
    np.testing.assert_allclose(np.asarray(x), pts_gt, rtol=2e-3, atol=2e-3)
