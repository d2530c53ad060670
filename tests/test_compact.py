"""Fixed-capacity compaction vs the reference's prefix-sum + scatter
semantics (sift_func/SiftOps.cu:210-235: first-K valid entries in index
order, capacity-capped)."""
import numpy as np
import jax.numpy as jnp
import pytest

from sift_jax.ops.compact import mask_compact, stream_compact, topk_compact


def _ref_compact(mask, cap):
    idx = np.nonzero(mask)[0][:cap]
    out = np.zeros(cap, np.int32)
    out[: len(idx)] = idx
    v = np.zeros(cap, bool)
    v[: len(idx)] = True
    return out, v


@pytest.mark.parametrize("n,cap,p,seed", [
    (100, 16, 0.3, 0),     # single-block path
    (100, 16, 0.0, 1),     # empty
    (100, 200, 1.0, 2),    # cap > count, all valid
    (5000, 256, 0.05, 3),  # multi-block
    (5000, 256, 0.9, 4),   # capacity binds
    (4096, 512, 0.5, 5),   # exact multiple of block
    (70000, 1000, 0.01, 6),
])
def test_stream_compact(n, cap, p, seed):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=n) < p
    idx, valid = stream_compact(jnp.asarray(mask), cap)
    ref_idx, ref_valid = _ref_compact(mask, cap)
    np.testing.assert_array_equal(np.asarray(valid), ref_valid)
    np.testing.assert_array_equal(np.asarray(idx)[ref_valid],
                                  ref_idx[ref_valid])


def test_mask_compact_matches_stream_compact():
    rng = np.random.default_rng(7)
    mask = rng.uniform(size=3000) < 0.1
    i1, v1 = stream_compact(jnp.asarray(mask), 128)
    i2, v2 = mask_compact(jnp.asarray(mask), 128)
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(i1)[np.asarray(v1)],
                                  np.asarray(i2)[np.asarray(v2)])


def test_topk_compact_small():
    score = jnp.asarray(np.array([5.0, 1.0, 3.0, 9.0, 2.0], np.float32))
    valid = jnp.asarray(np.array([True, True, False, True, True]))
    idx, v = topk_compact(score, valid, 3)
    assert np.asarray(v).all()
    np.testing.assert_array_equal(np.asarray(idx), [3, 0, 4])


def test_topk_compact_large():
    rng = np.random.default_rng(8)
    score = rng.standard_normal(20000).astype(np.float32)
    valid = rng.uniform(size=20000) < 0.5
    idx, v = topk_compact(jnp.asarray(score), jnp.asarray(valid), 64)
    got = np.asarray(idx)[np.asarray(v)]
    ref = np.argsort(-np.where(valid, score, -np.inf))[:64]
    np.testing.assert_array_equal(np.sort(got), np.sort(ref))
