"""Multi-chip sharding tests on the 8-device virtual CPU mesh
(the keyframe axis is the sharded axis — BASELINE north star)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sift_jax.config import SiftConfig
from sift_jax.core.types import build_plan
from sift_jax.parallel.batched import (batched_detect_fn, make_mesh,
                                       make_sharded_pipeline,
                                       sequential_match)


@pytest.fixture(scope="module")
def small_plan():
    cfg = SiftConfig(width=64, height=64, num_features=128,
                     max_candidates_per_octave=256)
    return build_plan(cfg)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    f = np.zeros((8, 64, 64), np.float32)
    for b in range(8):
        img = np.clip(rng.normal(128, 30, (64, 64)), 0, 255)
        f[b] = img
    return f


def test_eight_virtual_devices():
    assert jax.device_count() >= 8


def test_batched_matches_single(small_plan, frames):
    batched = jax.jit(batched_detect_fn(small_plan))
    res_b = batched(jnp.asarray(frames[:2]))
    from sift_jax.pipeline.detector import build_detect_fn

    single = jax.jit(build_detect_fn(small_plan))
    r0 = single(jnp.asarray(frames[0]))
    np.testing.assert_allclose(np.asarray(res_b.descriptors[0]),
                               np.asarray(r0.descriptors), atol=1e-3)
    assert int(res_b.count[0]) == int(r0.count)


def test_sharded_pipeline_matches_unsharded(small_plan, frames):
    mesh = make_mesh(8)
    fn, shard = make_sharded_pipeline(small_plan, mesh)
    res_s, matches_s = jax.block_until_ready(fn(shard(frames)))

    batched = jax.jit(batched_detect_fn(small_plan))
    res_u = batched(jnp.asarray(frames))
    matches_u = sequential_match(res_u.descriptors, res_u.keypoints.valid)

    np.testing.assert_allclose(np.asarray(res_s.descriptors),
                               np.asarray(res_u.descriptors), atol=1e-3)
    np.testing.assert_array_equal(np.asarray(matches_s),
                                  np.asarray(matches_u))
    assert (np.asarray(matches_s[0]) == -1).all()


def test_sequential_match_self(small_plan, frames):
    """Identical consecutive frames must match to themselves heavily."""
    batched = jax.jit(batched_detect_fn(small_plan))
    same = jnp.asarray(np.stack([frames[0]] * 4))
    res = batched(same)
    m = np.asarray(sequential_match(res.descriptors, res.keypoints.valid))
    n = int(res.count[0])
    if n > 4:
        hit = m[1] >= 0
        assert hit[:n].sum() >= 0.5 * n


def test_scale_bench_cli(capsys):
    """Scaling-efficiency benchmark runs end-to-end and reports one JSON
    point per device count (efficiency numbers are meaningful on real
    chips; here we gate the machinery)."""
    import json

    from sift_jax.tools import scale_bench

    scale_bench.main(["--width", "64", "--height", "64",
                      "--num-features", "128", "--frames-per-device", "1",
                      "--iters", "2"])
    rows = [json.loads(l) for l in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert all(r["frames_per_s"] > 0 for r in rows)
    assert rows[0]["efficiency_vs_1"] == 1.0
