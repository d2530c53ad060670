"""Gaussian/DoG pyramid parity vs an OpenCV-op replication of
cv2 SIFT's buildGaussianPyramid (the oracle flow, reference readme.md:5)."""
import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from sift_jax.config import SiftConfig
from sift_jax.core.types import build_plan
from sift_jax.core import gaussian as g
from sift_jax.ops.pyramid import dog_pyramid, gaussian_pyramid


def _opencv_pyramid(img, cfg: SiftConfig):
    """Replicate OpenCV SIFT's float pyramid with cv2 primitives."""
    sigma, L = cfg.sigma, cfg.num_octave_layers
    if cfg.upscale:
        base = cv2.resize(img, (img.shape[1] * 2, img.shape[0] * 2),
                          interpolation=cv2.INTER_LINEAR)
    else:
        base = img.copy()
    sig_diff = g.initial_sigma_diff(sigma, cfg.upscale)
    base = cv2.GaussianBlur(base, (0, 0), sig_diff,
                            borderType=cv2.BORDER_DEFAULT)
    sig = g.sigma_schedule(sigma, L)
    pyr = []
    for o in range(cfg.num_octaves):
        if o == 0:
            lay = [base]
        else:
            prev = pyr[o - 1][L]
            lay = [cv2.resize(prev, (prev.shape[1] // 2, prev.shape[0] // 2),
                              interpolation=cv2.INTER_NEAREST)]
        for i in range(1, L + 3):
            lay.append(cv2.GaussianBlur(lay[-1], (0, 0), float(sig[i]),
                                        borderType=cv2.BORDER_DEFAULT))
        pyr.append(lay)
    return pyr


@pytest.mark.parametrize("upscale", [False, True])
def test_pyramid_matches_opencv(test_image, upscale):
    h, w = test_image.shape
    cfg = SiftConfig(width=w, height=h, upscale=upscale)
    plan = build_plan(cfg)
    ours = gaussian_pyramid(plan, jnp.asarray(test_image))
    ref = _opencv_pyramid(test_image, cfg)
    assert len(ours) == cfg.num_octaves
    for o in range(cfg.num_octaves):
        for l in range(cfg.num_gauss_layers):
            a, b = np.asarray(ours[o][l]), ref[o][l]
            assert a.shape == b.shape, (o, l, a.shape, b.shape)
            if min(a.shape) >= 8:  # tiny octaves: kernel > dim edge cases
                np.testing.assert_allclose(a, b, atol=5e-3,
                                           err_msg=f"octave {o} layer {l}")


def test_dog(test_image):
    h, w = test_image.shape
    cfg = SiftConfig(width=w, height=h)
    plan = build_plan(cfg)
    gp = gaussian_pyramid(plan, jnp.asarray(test_image))
    dp = dog_pyramid(gp)
    assert len(dp) == cfg.num_octaves
    for o in range(cfg.num_octaves):
        assert dp[o].shape[0] == cfg.num_dog_layers
        np.testing.assert_allclose(np.asarray(dp[o][0]),
                                   np.asarray(gp[o][1] - gp[o][0]),
                                   atol=1e-6)


def test_conv_path_matches_matmul_path(test_image):
    h, w = test_image.shape
    cfg_m = SiftConfig(width=w, height=h, blur_impl="matmul")
    cfg_c = SiftConfig(width=w, height=h, blur_impl="conv",
                       downsample="nearest")
    pm = gaussian_pyramid(build_plan(cfg_m), jnp.asarray(test_image))
    pc = gaussian_pyramid(build_plan(cfg_c), jnp.asarray(test_image))
    for o in range(min(3, cfg_m.num_octaves)):
        np.testing.assert_allclose(np.asarray(pm[o]), np.asarray(pc[o]),
                                   atol=2e-2)


def test_padded_tiled_pyramid_matches_dense(test_image):
    """gaussian_pyramid_padded (band-blocked tiled matmuls, the
    pipeline path) must equal the dense-operator pyramid on the content
    region to f32 noise, and its padding must be exactly zero (the
    fused detect kernel and the slab builder rely on both)."""
    import jax.numpy as jnp
    import numpy as np

    from sift_jax.config import SiftConfig
    from sift_jax.core.types import build_plan
    from sift_jax.ops.pyramid import (gaussian_pyramid,
                                      gaussian_pyramid_padded,
                                      padded_content_views)

    h, w = test_image.shape
    cfg = SiftConfig(width=w, height=h)
    plan = build_plan(cfg)
    dense = gaussian_pyramid(plan, jnp.asarray(test_image))
    gp = gaussian_pyramid_padded(plan, jnp.asarray(test_image))
    views = padded_content_views(plan, gp)
    for o in range(cfg.num_octaves):
        a, b = np.asarray(dense[o]), np.asarray(views[o])
        np.testing.assert_allclose(a, b, atol=2e-4)
        g = np.asarray(gp[o])
        hh, ww = a.shape[1], a.shape[2]
        assert np.abs(g[:, :8]).max() == 0.0
        assert np.abs(g[:, 8 + hh:]).max() == 0.0
        assert np.abs(g[:, :, ww:]).max() == 0.0
