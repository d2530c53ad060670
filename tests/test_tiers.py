"""Capacity-tier dispatch: tiered results must equal full-capacity
results exactly, including the saturation fallback."""
import numpy as np
import pytest

from sift_jax.config import SiftConfig
from sift_jax.pipeline.detector import SiftDetector


@pytest.fixture(scope="module")
def detectors(test_image):
    h, w = test_image.shape
    cfg = SiftConfig(width=w, height=h, num_features=1000)
    return (SiftDetector(cfg), SiftDetector(cfg, tiers=(128, 256)),
            test_image)


def _np_result(res):
    n = int(res.count)
    return n, {f: np.asarray(getattr(res.keypoints, f))
               for f in res.keypoints._fields}, np.asarray(res.descriptors)


def test_tier_matches_full(detectors):
    full, tiered, img = detectors
    # frame 1 runs full (no prior count); frame 2 picks a tier
    r_full = full.detect_and_compute(img)
    tiered.detect_and_compute(img)
    r_tier = tiered.detect_and_compute(img)
    n1, k1, d1 = _np_result(r_full)
    n2, k2, d2 = _np_result(r_tier)
    assert n1 == n2
    assert d1.shape == d2.shape  # padded to num_features
    for f in k1:
        np.testing.assert_array_equal(k1[f][:n1], k2[f][:n1], err_msg=f)
    np.testing.assert_array_equal(d1[:n1], d2[:n1])


def test_tier_selection_logic(detectors):
    _, tiered, img = detectors
    tiered._last_count = 10
    assert tiered._pick_tier() == 128
    tiered._last_count = 100
    assert tiered._pick_tier() == 256
    tiered._last_count = 200
    assert tiered._pick_tier() is None  # needs full capacity
    tiered._last_count = None
    assert tiered._pick_tier() is None  # first frame -> full


def test_saturation_falls_back_to_full(test_image):
    """A tier too small for the frame must trigger the exact re-run."""
    h, w = test_image.shape
    cfg = SiftConfig(width=w, height=h, num_features=1000)
    det = SiftDetector(cfg, tiers=(16,))
    r1 = det.detect_and_compute(test_image)   # full (first frame)
    n_true = int(r1.count)
    assert n_true > 16
    det._last_count = 5                        # force the tiny tier
    r2 = det.detect_and_compute(test_image)
    assert int(r2.count) == n_true             # fallback produced full set
