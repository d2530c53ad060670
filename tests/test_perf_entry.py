"""Measurement plumbing on the CPU: the compile-cache location, the
measurement entry points' refusal to run without a GPU, and the parity
helpers that chip_smoke.py and tests_gpu/ compare with."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sift_jax.perf import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them (the
    cache settings would otherwise leak into the rest of the worker)."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    monkeypatch.setenv("SIFT_JAX_CACHE_CPU", "1")
    return calls


def test_cache_uses_jax_compilation_cache_dir(config_updates, monkeypatch,
                                              tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; no other path is set in code.
    assert "jax_compilation_cache_dir" not in config_updates


def test_cache_fixed_repo_path_when_unset(config_updates, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert cache.DEFAULT_CACHE_DIR == want
    assert cache.enable_compilation_cache() == want
    assert config_updates["jax_compilation_cache_dir"] == want


def _import_root_script(name):
    sys.path.insert(0, REPO)
    try:
        return __import__(name)
    finally:
        sys.path.remove(REPO)


def test_bench_exits_without_gpu():
    bench = _import_root_script("bench")
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)


def test_chip_smoke_exits_without_gpu(capsys):
    smoke = _import_root_script("chip_smoke")
    with pytest.raises(SystemExit) as exc:
        smoke.phase0_identity()
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_match_reference_agrees_with_matcher():
    from sift_jax.perf.parity import match_reference
    from sift_jax.pipeline.matcher import match_brute_force

    rng = np.random.default_rng(3)
    q = rng.integers(0, 256, (300, 128))
    t = rng.integers(0, 256, (400, 128))
    t[:150] = np.clip(q[:150] + rng.integers(-4, 5, (150, 128)), 0, 255)
    q, t = q.astype(np.uint8), t.astype(np.uint8)
    want = match_reference(q, t)
    assert (want[:150] == np.arange(150)).all()
    np.testing.assert_array_equal(
        np.asarray(match_brute_force(jnp.asarray(q), jnp.asarray(t))), want)


def test_compare_detections_pairs_and_misses(test_image):
    from sift_jax.config import SiftConfig
    from sift_jax.core.types import build_plan
    from sift_jax.perf.parity import compare_detections
    from sift_jax.pipeline.detector import build_detect_fn

    h, w = test_image.shape
    fn = jax.jit(build_detect_fn(build_plan(
        SiftConfig(width=w, height=h, num_features=500))))
    res = fn(jnp.asarray(test_image))
    same = compare_detections(res, res)
    assert same["n_ref"] > 50 and same["paired_frac"] == 1.0
    assert same["desc_max_diff"] == 0.0 and same["count_rel_diff"] == 0.0
    moved = res._replace(keypoints=res.keypoints._replace(
        x=res.keypoints.x + 0.02))
    assert compare_detections(res, moved)["paired_frac"] == 0.0
