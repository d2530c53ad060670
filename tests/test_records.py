"""Plane-layout record-field parity (ops/records.py).

The pipeline computes DoG + extrema + Newton records in one pass per
octave.  Gates: (a) the record pass on the padded pyramid layout equals
records_jnp on natural-shape octaves, (b) candidates off the flags peak
bit equal ops/peaks.find_candidates, (c) the plane-layout walk equals
the stacked-record walk the replay/parity layer uses.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from sift_jax.config import SIFT_IMG_BORDER, SiftConfig
from sift_jax.core.types import build_plan
from sift_jax.ops.peaks import find_candidates
from sift_jax.ops.pyramid import (HALO, dog_pyramid, gaussian_pyramid,
                                  gaussian_pyramid_padded)
from sift_jax.ops.records import (candidates_from_records,
                                  detect_records_padded, records_jnp,
                                  walk_records_all)
from sift_jax.ops.refine_dense import refine_keypoints_dense_all


def _gauss(test_image, cfg):
    plan = build_plan(cfg)
    return plan, gaussian_pyramid(plan, jnp.asarray(test_image))


@pytest.mark.parametrize("octave", [0, 1])
def test_padded_records_match_natural(test_image, octave):
    """The pipeline's record pass reads the padded pyramid layout
    (gaussian_pyramid_padded, content at rows [HALO, HALO+h), zeros
    around it); it must equal records_jnp on the natural-shape octave of
    the dense-operator pyramid, up to the two pyramids' f32 rounding."""
    h, w = test_image.shape
    cfg = SiftConfig(width=w, height=h)
    plan, gauss = _gauss(test_image, cfg)
    gp = np.asarray(gaussian_pyramid_padded(plan, jnp.asarray(test_image))
                    [octave])
    op = plan.octaves[octave]
    content = gp[:, HALO:HALO + op.height, :op.width]
    np.testing.assert_allclose(content, np.asarray(gauss[octave]),
                               atol=2e-4)
    rim = gp.copy()
    rim[:, HALO:HALO + op.height, :op.width] = 0.0
    assert not rim.any()                            # zeros around it

    got = detect_records_padded(jnp.asarray(gp), op.height, op.width, cfg)
    ref = records_jnp(gauss[octave], cfg)
    assert got.values.shape == ref.values.shape
    assert (got.h, got.w) == (ref.h, ref.w)
    a = np.asarray(ref.values[:, :, 1:ref.h - 1, 1:ref.w - 1],
                   np.float64).astype(np.int64)
    b = np.asarray(got.values[:, :, 1:ref.h - 1, 1:ref.w - 1],
                   np.float64).astype(np.int64)
    # The peak bit (the candidate set) agrees exactly; the other decision
    # bits (conv, div, edge, contrast) may flip only on the rare pixels
    # whose f32 expressions sit at a threshold (measured: 4 of 55932 in
    # octave 1).
    np.testing.assert_array_equal((a[0] >> 3) & 1, (b[0] >> 3) & 1)
    assert ((a[0] % 32) != (b[0] % 32)).sum() <= max(3, a[0].size // 5_000)
    # Where both converge, the sub-pixel payloads B/C differ by at most
    # one quantization step of one of their fields.
    conv = ((a[0] & b[0]) % 2).astype(bool)
    for ch, quanta in ((1, (1, 2047, 2048, 2049)),
                       (2, (1, 1023, 1024, 1025))):
        d = np.abs(np.where(conv, a[ch] - b[ch], 0))
        assert np.isin(d[d > 0], quanta).all(), f"channel {ch}"


def test_candidates_match_find_candidates(test_image):
    h, w = test_image.shape
    cfg = SiftConfig(width=w, height=h)
    plan, gauss = _gauss(test_image, cfg)
    dogs = dog_pyramid(gauss)
    total = 0
    for o in range(3):
        cap = plan.octaves[o].cand_cap
        ax, ay, al, av = find_candidates(dogs[o], cfg.peak_threshold,
                                         SIFT_IMG_BORDER, cap)
        rec = records_jnp(gauss[o], cfg)
        bx, by, bl, bv = candidates_from_records(rec, cap)
        np.testing.assert_array_equal(np.asarray(av), np.asarray(bv))
        m = np.asarray(av)
        total += int(m.sum())
        for name, pa, pb in (("x", ax, bx), ("y", ay, by), ("l", al, bl)):
            np.testing.assert_array_equal(
                np.asarray(pa)[m], np.asarray(pb)[m],
                err_msg=f"octave {o} {name}")
    assert total > 50


def test_plane_walk_matches_stacked_walk(test_image):
    h, w = test_image.shape
    cfg = SiftConfig(width=w, height=h)
    plan, gauss = _gauss(test_image, cfg)
    dogs = dog_pyramid(gauss)
    recs = [records_jnp(gauss[o], cfg) for o in range(cfg.num_octaves)]
    cands = [candidates_from_records(recs[o], plan.octaves[o].cand_cap)
             for o in range(cfg.num_octaves)]
    a, aoct = refine_keypoints_dense_all(dogs, cands, cfg)
    b, boct = walk_records_all(recs, cands, cfg)
    np.testing.assert_array_equal(np.asarray(aoct), np.asarray(boct))
    # Accept decisions are bit-identical (contrast_ok is decided at
    # full precision in the record pass; both walks clamp steps the
    # same way) — only the OUTPUT values carry the packing quantization
    # (x0/x1 at 1/2000 px in octave coords, x2 at 1/1000, response at
    # 1/8191).
    np.testing.assert_array_equal(np.asarray(a.valid), np.asarray(b.valid))
    m = np.asarray(a.valid)
    assert m.sum() > 30
    scale = 2.0 ** np.asarray(aoct, np.float64)[m]
    tol = {"x": scale * 6e-4, "y": scale * 6e-4, "layer": 0.0,
           "xi": 6e-4, "size": None, "response": 7e-5}
    for f in ("x", "y", "layer", "xi", "response"):
        d = np.abs(np.asarray(getattr(a, f), np.float64)[m]
                   - np.asarray(getattr(b, f), np.float64)[m])
        assert (d <= tol[f] + 1e-9).all(), (f, d.max())
    np.testing.assert_allclose(np.asarray(a.size)[m],
                               np.asarray(b.size)[m], rtol=2e-4)


def test_walk_global_candidate_cap(test_image):
    """The pre-walk global candidate compaction (active when the summed
    per-octave candidate capacity exceeds 2*num_features) is a pure
    capacity change: when the frame's raw candidate count fits the
    bound, survivors are identical to the uncapped walk."""
    h, w = test_image.shape
    big = SiftConfig(width=w, height=h, num_features=5000)
    plan, gauss = _gauss(test_image, big)
    recs = [records_jnp(gauss[o], big) for o in range(big.num_octaves)]
    cands = [candidates_from_records(recs[o], plan.octaves[o].cand_cap)
             for o in range(big.num_octaves)]
    n_raw = int(sum(np.asarray(cc[3]).sum() for cc in cands))
    total_cap = sum(cc[0].shape[0] for cc in cands)
    # Small feature budget but still above the frame's raw candidate
    # count: the capped walk must keep every live candidate.
    small = SiftConfig(width=w, height=h,
                       num_features=max(64, (n_raw + 1) // 2 + 1))
    assert 2 * small.num_features < total_cap, "cap path not exercised"
    assert 2 * small.num_features >= n_raw

    a, aoct = walk_records_all(recs, cands, big)       # uncapped
    b, boct = walk_records_all(recs, cands, small)     # capped walk
    ma = np.asarray(a.valid)
    mb = np.asarray(b.valid)
    assert ma.sum() == mb.sum() > 30
    # Survivor streams agree field-by-field (order is octave-major on
    # both sides; the capped walk just dropped dead padding rows).
    for f in ("x", "y", "layer", "xi", "size", "response"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f))[ma], np.asarray(getattr(b, f))[mb],
            err_msg=f)
    np.testing.assert_array_equal(np.asarray(aoct)[ma],
                                  np.asarray(boct)[mb])
