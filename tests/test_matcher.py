"""Brute-force matcher parity vs cv2.BFMatcher ratio-test flow
(the reference's matchBruteForce + Lowe 0.8, sift_func/Match.cu:8-177)."""
import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from sift_jax.pipeline.matcher import match_brute_force, match_pairs


@pytest.fixture(scope="module")
def desc_pair(test_image_pair):
    a, b, _ = test_image_pair
    sift = cv2.SIFT_create()
    _, da = sift.detectAndCompute(a.astype(np.uint8), None)
    _, db = sift.detectAndCompute(b.astype(np.uint8), None)
    return da, db


def _ref_matches(da, db, ratio=0.8):
    """Reference semantics: squared-distance ratio min1 < r*min2
    (Match.cu:171-175).  cv2 knnMatch returns unsquared distances."""
    bf = cv2.BFMatcher(cv2.NORM_L2)
    out = np.full(len(da), -1, np.int32)
    for m in bf.knnMatch(da, db, k=2):
        if len(m) == 2 and m[0].distance ** 2 < ratio * m[1].distance ** 2:
            out[m[0].queryIdx] = m[0].trainIdx
    return out

def test_matches_opencv_bruteforce(desc_pair):
    da, db = desc_pair
    ours = np.asarray(match_brute_force(jnp.asarray(da), jnp.asarray(db)))
    ref = _ref_matches(da, db)
    # fp32-matmul vs exact distance can flip decisions right at the ratio
    # boundary; demand 99% agreement.
    agree = (ours == ref).mean()
    assert agree >= 0.99, f"match agreement {agree}"
    assert (ref >= 0).sum() > 20


def test_validity_masks(desc_pair):
    da, db = desc_pair
    q = jnp.asarray(da)
    t = jnp.asarray(db)
    qv = jnp.asarray(np.arange(len(da)) < 10)
    m = np.asarray(match_brute_force(q, t, q_valid=qv))
    assert (m[10:] == -1).all()
    tv = jnp.asarray(np.zeros(len(db), bool))
    m2 = np.asarray(match_brute_force(q, t, t_valid=tv))
    assert (m2 == -1).all()


def test_match_pairs_cross_check(desc_pair):
    da, db = desc_pair
    qi, ti = match_pairs(jnp.asarray(da), jnp.asarray(db), cross_check=True)
    assert len(qi) > 10
    # mutual consistency
    back = np.asarray(match_brute_force(jnp.asarray(db), jnp.asarray(da)))
    assert (back[ti] == qi).all()


def test_uint8_path_identical_indices(desc_pair):
    """uint8 storage + bf16 Gram matching must be BIT-IDENTICAL to the f32
    path: cv2 descriptors are 0..255-integer-valued, every bf16 value and
    product is exact, and sums stay under 2^24 (pipeline/matcher.py)."""
    da, db = desc_pair
    f32 = np.asarray(match_brute_force(jnp.asarray(da), jnp.asarray(db)))
    u8 = np.asarray(match_brute_force(
        jnp.asarray(da.astype(np.uint8)), jnp.asarray(db.astype(np.uint8))))
    assert (f32 == u8).all()
    tv = jnp.asarray(np.arange(len(db)) % 2 == 0)
    f32m = np.asarray(match_brute_force(
        jnp.asarray(da), jnp.asarray(db), t_valid=tv))
    u8m = np.asarray(match_brute_force(
        jnp.asarray(da.astype(np.uint8)), jnp.asarray(db.astype(np.uint8)),
        t_valid=tv))
    assert (f32m == u8m).all()


def test_self_match_identity(desc_pair):
    """Matching a set against itself: with ratio test the second-best is a
    different descriptor, so matches that survive must be the identity."""
    da, _ = desc_pair
    m = np.asarray(match_brute_force(jnp.asarray(da), jnp.asarray(da)))
    hit = m >= 0
    assert (m[hit] == np.nonzero(hit)[0]).all()
