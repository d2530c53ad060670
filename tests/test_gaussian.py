"""Host-side Gaussian/operator math vs OpenCV (the reference's own oracle,
/root/reference/readme.md:5) and vs the reference's formulas
(sift_cuda/utils/GaussianUtils.cc)."""
import cv2
import numpy as np
import pytest

from sift_jax.core import gaussian as g


def test_kernel_size_formula():
    # size = int(round(sigma*truncate + 1)) | 1 (GaussianUtils.cc:8,40)
    assert g.kernel_size(1.6, 6.0) == 11
    # OpenCV auto-ksize for f32: round(8*sigma + 1) | 1
    assert g.kernel_size(1.6, 8.0) == 15


def test_kernel_matches_opencv():
    for sigma in [0.8, 1.2262735, 1.6, 2.0158736]:
        size = g.kernel_size(sigma, 8.0)
        ours = g.gaussian_kernel_1d(sigma, 8.0)
        ref = cv2.getGaussianKernel(size, sigma, cv2.CV_64F).ravel()
        np.testing.assert_allclose(ours, ref, atol=1e-12)


def test_kernel_2d_normalized():
    k = g.gaussian_kernel_2d(1.6)
    assert abs(k.sum() - 1.0) < 1e-12
    assert k.shape[0] == k.shape[1] == g.kernel_size(1.6)


def test_reflect101_matches_opencv():
    n = 16
    idx = np.arange(-8, n + 8)
    ours = g.reflect101_index(idx, n)
    src = np.arange(n, dtype=np.float32).reshape(1, n)
    padded = cv2.copyMakeBorder(src, 0, 0, 8, 8, cv2.BORDER_REFLECT_101)
    np.testing.assert_array_equal(ours, padded.ravel().astype(int))


def test_blur_operator_matches_opencv_gaussianblur():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (64, 48)).astype(np.float32)
    sigma = 1.6
    size = g.kernel_size(sigma, 8.0)
    ref = cv2.GaussianBlur(img, (size, size), sigma,
                           borderType=cv2.BORDER_DEFAULT)
    k = g.gaussian_kernel_1d(sigma, 8.0)
    v = g.blur_operator(64, k, np.float64)
    hh = g.blur_operator(48, k, np.float64)
    ours = (v @ img.astype(np.float64) @ hh.T).astype(np.float32)
    np.testing.assert_allclose(ours, ref, atol=2e-3)


def test_resize_operator_matches_opencv_bilinear():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (40, 60)).astype(np.float32)
    up = g.resize_operator(80, 40, np.float64)
    uph = g.resize_operator(120, 60, np.float64)
    ours = (up @ img.astype(np.float64) @ uph.T).astype(np.float32)
    ref = cv2.resize(img, (120, 80), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(ours, ref, atol=2e-3)


def test_decimation_matches_opencv_nearest():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (40, 60)).astype(np.float32)
    dv = g.decimation_operator(20, 40)
    dh = g.decimation_operator(30, 60)
    ours = dv @ img @ dh.T
    ref = cv2.resize(img, (30, 20), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(ours, ref)


def test_sigma_schedule():
    # interface/Detector.cu:63-71: sigmas[0]=sigma; k=2^(1/L)
    s = g.sigma_schedule(1.6, 3)
    assert len(s) == 6
    assert s[0] == 1.6
    k = 2.0 ** (1.0 / 3.0)
    for i in range(1, 6):
        prev = (k ** (i - 1)) * 1.6
        expected = np.sqrt((prev * k) ** 2 - prev ** 2)
        assert abs(s[i] - expected) < 1e-12


def test_initial_sigma_diff():
    # sqrt(max(sigma^2 - 4*0.5^2, 0.01)) (Detector.cu:54-56)
    assert abs(g.initial_sigma_diff(1.6, True)
               - np.sqrt(1.6 ** 2 - 1.0)) < 1e-12
