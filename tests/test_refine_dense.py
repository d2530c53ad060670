"""Refinement gates: the all-octave fused walk vs the per-octave walk
(two code paths over the one Newton implementation), and bfloat16 record
storage vs float32 (the memory/bandwidth knob must not move decisions or
positions materially)."""
import numpy as np
import jax.numpy as jnp

from sift_jax.config import SIFT_IMG_BORDER, SiftConfig
from sift_jax.core.types import build_plan
from sift_jax.ops.peaks import find_candidates
from sift_jax.ops.pyramid import dog_pyramid, gaussian_pyramid
from sift_jax.ops.refine_dense import refine_keypoints_dense


def _pyr_and_cands(test_image, cfg):
    plan = build_plan(cfg)
    gauss = gaussian_pyramid(plan, jnp.asarray(test_image))
    dogs = dog_pyramid(gauss)
    cands = [find_candidates(dogs[o], cfg.peak_threshold, SIFT_IMG_BORDER,
                             plan.octaves[o].cand_cap)
             for o in range(cfg.num_octaves)]
    return dogs, cands


def test_refine_shim_is_the_dense_impl():
    """perf/replay and perf/checkpoint gate refine_keypoints; it must BE
    the consolidated dense implementation (one Newton impl, VERDICT r2)."""
    from sift_jax.ops.refine import refine_keypoints
    assert refine_keypoints is refine_keypoints_dense


def test_fused_all_octave_walk_matches_per_octave(test_image):
    """refine_keypoints_dense_all (one walk over every octave's
    candidates, the pipeline path) must equal the per-octave walks."""
    from sift_jax.ops.refine_dense import refine_keypoints_dense_all

    h, w = test_image.shape
    cfg = SiftConfig(width=w, height=h)
    dogs, cands = _pyr_and_cands(test_image, cfg)
    ref, octv = refine_keypoints_dense_all(dogs, cands, cfg)

    pos = 0
    total = 0
    for o, (cx, cy, cl, cv) in enumerate(cands):
        n = cx.shape[0]
        a = refine_keypoints_dense(dogs[o], cx, cy, cl, cv, o, cfg)
        sl = slice(pos, pos + n)
        np.testing.assert_array_equal(np.asarray(octv[sl]), o)
        np.testing.assert_array_equal(np.asarray(a.valid),
                                      np.asarray(ref.valid[sl]))
        m = np.asarray(a.valid)
        total += int(m.sum())
        for f in ("x", "y", "layer", "xi", "size", "response"):
            np.testing.assert_allclose(
                np.asarray(getattr(a, f))[m],
                np.asarray(getattr(ref, f)[sl])[m],
                rtol=1e-5, atol=1e-5, err_msg=f"octave {o} field {f}")
        pos += n
    assert total > 30


def test_bfloat16_records_match_float32(test_image):
    """bfloat16 record storage (refine_record_dtype, the default at
    >= 1 MP): decisions may flip only on threshold-straddling candidates
    (< 2%), surviving positions agree to ~1e-2 px in octave space."""
    h, w = test_image.shape
    cfg32 = SiftConfig(width=w, height=h, refine_record_dtype="float32")
    cfg16 = SiftConfig(width=w, height=h, refine_record_dtype="bfloat16")
    dogs, cands = _pyr_and_cands(test_image, cfg32)

    total = 0
    for o, (cx, cy, cl, cv) in enumerate(cands[:4]):
        a = refine_keypoints_dense(dogs[o], cx, cy, cl, cv, o, cfg32)
        b = refine_keypoints_dense(dogs[o], cx, cy, cl, cv, o, cfg16)
        va, vb = np.asarray(a.valid), np.asarray(b.valid)
        n_live = max(1, int(va.sum()))
        assert (va != vb).sum() <= max(2, 0.02 * n_live), f"octave {o}"
        m = va & vb
        total += int(m.sum())
        scale = float(1 << o)
        np.testing.assert_allclose(np.asarray(a.x)[m], np.asarray(b.x)[m],
                                   atol=0.02 * scale, err_msg=f"o{o} x")
        np.testing.assert_allclose(np.asarray(a.y)[m], np.asarray(b.y)[m],
                                   atol=0.02 * scale, err_msg=f"o{o} y")
        np.testing.assert_array_equal(np.asarray(a.layer)[m],
                                      np.asarray(b.layer)[m])
        np.testing.assert_allclose(np.asarray(a.size)[m],
                                   np.asarray(b.size)[m], rtol=0.02)
    assert total > 30


def test_auto_record_dtype_policy():
    from sift_jax.ops.refine_dense import record_dtype
    assert record_dtype(SiftConfig(width=752, height=480)) == jnp.float32
    assert record_dtype(SiftConfig(width=1920, height=1200)) == jnp.bfloat16
    assert record_dtype(SiftConfig(width=752, height=480,
                                   refine_record_dtype="bfloat16")) \
        == jnp.bfloat16
