"""The pipeline and the matcher on the GPU against the CPU backend and a
float64 reference.  The CPU backend's pipeline output is itself held to
OpenCV by tests/test_pipeline.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sift_jax.config import SiftConfig
from sift_jax.core.types import build_plan
from sift_jax.perf.benchimg import bench_image
from sift_jax.perf.parity import compare_detections, match_reference
from sift_jax.pipeline.detector import build_detect_fn
from sift_jax.pipeline.matcher import match_brute_force

pytestmark = pytest.mark.gpu


def test_flat_pipeline_matches_cpu(gpu):
    cfg = SiftConfig(width=320, height=240, num_features=1024)
    fn = jax.jit(build_detect_fn(build_plan(cfg)))
    frame = bench_image(240, 320)
    got = fn(jax.device_put(frame, gpu))
    ref = fn(jax.device_put(frame, jax.devices("cpu")[0]))
    s = compare_detections(ref, got, pos_tol=0.01, ang_tol=0.1)
    assert s["n_ref"] > 50
    assert s["count_rel_diff"] <= 0.005, s
    assert s["paired_frac"] >= 0.99, s
    assert s["desc_max_diff"] <= 2.0, s
    assert s["desc_frac_elems_diff"] <= 0.01, s


def test_uint8_matcher_exact(gpu):
    rng = np.random.default_rng(11)
    q = rng.integers(0, 256, (1000, 128))
    t = rng.integers(0, 256, (1200, 128))
    t[:500] = np.clip(q[rng.permutation(1000)[:500]]
                      + rng.integers(-4, 5, (500, 128)), 0, 255)
    q, t = q.astype(np.uint8), t.astype(np.uint8)
    got = np.asarray(match_brute_force(jax.device_put(jnp.asarray(q), gpu),
                                       jax.device_put(jnp.asarray(t), gpu)))
    want = match_reference(q, t)
    assert (want >= 0).sum() >= 250
    np.testing.assert_array_equal(got, want)
