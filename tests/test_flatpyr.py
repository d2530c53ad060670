"""The flat-pyramid keypoint stages against plain references.

* ``shift_copies`` (the lane-shifted gradient slabs the orientation and
  descriptor windows read) against a numpy lane shift;
* ``orientation_histograms_flat`` and ``compute_descriptors_flat``
  against per-keypoint float64 numpy loops written from OpenCV's
  ``calcOrientationHist`` / ``calcSIFTDescriptor`` (modules/features2d/
  src/sift.simd.hpp), on random Gaussian stacks and random keypoints.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from sift_jax.config import (SIFT_DESCR_HIST_BINS, SIFT_DESCR_SCL_FCTR,
                             SIFT_DESCR_WIDTH, SIFT_ORI_HIST_BINS,
                             SIFT_ORI_RADIUS, SIFT_ORI_SIG_FCTR, SiftConfig)
from sift_jax.ops import descriptor as D
from sift_jax.ops import orientation as O
from sift_jax.ops.flatpyr import (PaddedPyramid, dense_gradients_packed,
                                  dense_gradients_padded, pad_pyramid,
                                  shift_copies)


@pytest.mark.parametrize("n,hs,ws", [(1, 8, 128)] + [
    (n, hs, ws) for n in (2, 4) for hs, ws in (
        (256, 256), (512, 384), (40, 256), (8, 128), (256, 2560))])
def test_shift_copies_matches_numpy_lane_shift(n, hs, ws):
    rng = np.random.default_rng(hs * 7 + ws + n)
    vals = rng.normal(0, 50, (3, hs, ws)).astype(np.float32)
    p = PaddedPyramid(values=jnp.asarray(vals),
                      height=jnp.asarray([hs], jnp.int32),
                      width=jnp.asarray([ws], jnp.int32), layers=3)
    got = shift_copies(p, n)
    step = 128 // n
    want = np.zeros((n * 3, hs, ws), np.float32)
    for c in range(n):
        s = c * step
        want[c * 3:(c + 1) * 3, :, :ws - s] = vals[:, :, s:]
    assert got.copies == n
    np.testing.assert_array_equal(np.asarray(got.values), want)


@pytest.fixture(scope="module")
def stage_setup():
    """Random Gaussian stacks (3 octaves of 6 layers at 240x320) and 48
    random keypoints across them, every one inside the static window
    bounds the pipeline guarantees (scl_octv <= sigma * 2^((L+.5)/L))."""
    rng = np.random.default_rng(0)
    cfg = SiftConfig(width=320, height=240)
    nl = cfg.num_octave_layers + 3
    blocks = [rng.normal(100, 40, (nl, 240 >> o, 320 >> o))
              .astype(np.float32) for o in range(3)]
    k = 48
    octv = rng.integers(0, 3, k).astype(np.int32)
    hs = np.array([240, 120, 60])[octv]
    ws = np.array([320, 160, 80])[octv]
    px = rng.uniform(2, ws - 3)
    py = rng.uniform(2, hs - 3)
    scl_max = cfg.sigma * 2.0 ** ((cfg.num_octave_layers + 0.5)
                                  / cfg.num_octave_layers)
    scl = rng.uniform(0.8, scl_max, k)
    kp = dict(
        octave=octv,
        x=(px * 2.0 ** octv).astype(np.float32),
        y=(py * 2.0 ** octv).astype(np.float32),
        layer=rng.integers(1, nl - 2, k).astype(np.int32),
        size=(2.0 * scl * 2.0 ** octv).astype(np.float32),
        angle=rng.uniform(0, 360, k).astype(np.float32),
        valid=rng.uniform(0, 1, k) > 0.1)
    return cfg, blocks, kp


def _keypoint_image(blocks, kp, i):
    """(float64 layer image, integer centre, scl_octv) of keypoint i in
    its own octave, as OpenCV's callers derive them."""
    o = int(kp["octave"][i])
    img = blocks[o][int(kp["layer"][i])].astype(np.float64)
    inv = np.float32(2.0 ** -o)
    cx = int(np.round(np.float32(kp["x"][i]) * inv))
    cy = int(np.round(np.float32(kp["y"][i]) * inv))
    return img, cx, cy, float(np.float32(kp["size"][i]) * 0.5 * inv)


def _gradients(img, ys, xs):
    dx = img[ys, xs + 1] - img[ys, xs - 1]
    dy = img[ys - 1, xs] - img[ys + 1, xs]
    ori = np.degrees(np.arctan2(dy, dx)) % 360.0
    return np.hypot(dx, dy), ori


def _ref_orientation_hist(img, cx, cy, scl):
    """calcOrientationHist before smoothing: the raw 36-bin histogram."""
    n = SIFT_ORI_HIST_BINS
    radius = int(np.round(SIFT_ORI_RADIUS * scl))
    sigma = SIFT_ORI_SIG_FCTR * scl
    i, j = np.meshgrid(np.arange(-radius, radius + 1),
                       np.arange(-radius, radius + 1), indexing="ij")
    y, x = cy + i, cx + j
    ok = (y > 0) & (y < img.shape[0] - 1) & (x > 0) & (x < img.shape[1] - 1)
    i, j, y, x = i[ok], j[ok], y[ok], x[ok]
    mag, ori = _gradients(img, y, x)
    w = np.exp(-(i * i + j * j) / (2.0 * sigma * sigma))
    b = np.round(ori * (n / 360.0)).astype(np.int64) % n
    hist = np.zeros(n)
    np.add.at(hist, b, w * mag)
    return hist


def _ref_descriptor(img, cx, cy, ori, scl):
    """calcSIFTDescriptor up to (and excluding) the final byte cast:
    the 4x4x8 trilinear histogram, clipped at 0.2 * norm and scaled by
    512 / norm."""
    d, n = SIFT_DESCR_WIDTH, SIFT_DESCR_HIST_BINS
    hist_width = SIFT_DESCR_SCL_FCTR * scl
    radius = int(np.round(hist_width * np.sqrt(2.0) * (d + 1) * 0.5))
    radius = min(radius, int(np.hypot(*img.shape)))
    cos_t = np.cos(np.radians(ori)) / hist_width
    sin_t = np.sin(np.radians(ori)) / hist_width
    i, j = np.meshgrid(np.arange(-radius, radius + 1),
                       np.arange(-radius, radius + 1), indexing="ij")
    c_rot = j * cos_t - i * sin_t
    r_rot = j * sin_t + i * cos_t
    rbin = r_rot + d / 2 - 0.5
    cbin = c_rot + d / 2 - 0.5
    y, x = cy + i, cx + j
    ok = ((rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
          & (y > 0) & (y < img.shape[0] - 1)
          & (x > 0) & (x < img.shape[1] - 1))
    rbin, cbin, c_rot, r_rot = rbin[ok], cbin[ok], c_rot[ok], r_rot[ok]
    mag, gori = _gradients(img, y[ok], x[ok])
    mag = mag * np.exp(-(c_rot ** 2 + r_rot ** 2) / (d * d * 0.5))
    obin = (gori - ori) * (n / 360.0)
    r0, c0, o0 = (np.floor(v).astype(np.int64) for v in (rbin, cbin, obin))
    fr, fc, fo = rbin - r0, cbin - c0, obin - o0
    o0 %= n
    hist = np.zeros((d + 2, d + 2, n + 2))
    for dr in (0, 1):
        for dc in (0, 1):
            for do in (0, 1):
                wgt = (mag * (fr if dr else 1 - fr) * (fc if dc else 1 - fc)
                       * (fo if do else 1 - fo))
                np.add.at(hist, (r0 + 1 + dr, c0 + 1 + dc, o0 + do), wgt)
    hist[:, :, 0] += hist[:, :, n]
    hist[:, :, 1] += hist[:, :, n + 1]
    desc = hist[1:d + 1, 1:d + 1, :n].reshape(-1)
    desc = np.minimum(desc, 0.2 * np.sqrt(np.sum(desc * desc)))
    return desc * (512.0 / max(np.sqrt(np.sum(desc * desc)), 1.19e-7))


def _jnp_kp(kp):
    return {k: jnp.asarray(v) for k, v in kp.items()}


def test_orientation_flat_matches_opencv_loop(stage_setup):
    cfg, blocks, kp = stage_setup
    mag, ori = dense_gradients_padded(pad_pyramid(
        [jnp.asarray(b) for b in blocks]))
    k = _jnp_kp(kp)
    got = np.asarray(O.orientation_histograms_flat(
        shift_copies(mag), shift_copies(ori), k["octave"], k["x"], k["y"],
        k["layer"], k["size"], k["valid"], cfg), np.float64)
    assert not got[~kp["valid"]].any()
    for i in np.flatnonzero(kp["valid"]):
        want = _ref_orientation_hist(*_keypoint_image(blocks, kp, i))
        # float32 weights and gradients against float64: the total
        # error stays at f32 rounding (measured <= 2e-7 of the mass on
        # this data); a pixel moved to a neighbouring bin would not.
        assert np.abs(got[i] - want).sum() <= 1e-5 * want.sum(), i


def test_descriptor_flat_matches_opencv_loop(stage_setup):
    cfg, blocks, kp = stage_setup
    grad = shift_copies(dense_gradients_packed(pad_pyramid(
        [jnp.asarray(b) for b in blocks])))
    k = _jnp_kp(kp)
    desc, nrm2 = D.compute_descriptors_flat(
        grad, k["octave"], k["x"], k["y"], k["layer"], k["size"],
        k["angle"], k["valid"], cfg)
    got = np.asarray(D.quantize_descriptor(desc, nrm2, "opencv"))
    assert not got[~kp["valid"]].any()
    errs = []
    for i in np.flatnonzero(kp["valid"]):
        ang = 360.0 - float(kp["angle"][i])
        img, cx, cy, scl = _keypoint_image(blocks, kp, i)
        want = np.clip(np.round(_ref_descriptor(img, cx, cy, ang, scl)),
                       0, 255)
        errs.append(np.abs(got[i] - want).max())
    # The flat path reads 10/14-bit packed gradients (ops/flatpyr.py),
    # which moves a rounded value by at most one quantized unit — the
    # reference's own descriptor tolerance (HostInterface.cu:369-376).
    assert max(errs) <= 1.0, errs
