"""Test configuration: force the CPU backend with 8 virtual devices so
single-device numerics and multi-device sharding are both testable
without a GPU (tests_gpu/ holds the tests that need one).

The platform is pinned through jax.config, so the suite runs on the CPU
whatever JAX_PLATFORMS says.
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compilation cache: the suite is compile-dominated (many
# full-pipeline programs); warm-cache reruns skip all of it.
from sift_jax.perf.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np
import pytest


def synthetic_image(height=240, width=320, seed=0, n_blobs=40):
    """Structured synthetic test frame: random filled circles + noise.
    Deterministic per seed; produces 100+ SIFT keypoints at 240x320."""
    import cv2

    rng = np.random.default_rng(seed)
    img = np.zeros((height, width), np.float32)
    for _ in range(n_blobs):
        y = int(rng.integers(20, height - 20))
        x = int(rng.integers(20, width - 20))
        r = int(rng.integers(3, 15))
        cv2.circle(img, (x, y), r, float(rng.uniform(50, 255)), -1)
    img += rng.normal(0, 5, (height, width)).astype(np.float32)
    return np.clip(img, 0, 255)


def textured_image(height=240, width=320, seed=1, tilt=0.12):
    """Perspective-projected value-noise plane: smooth gradients
    EVERYWHERE (photo-like keypoint statistics), unlike the disc scene's
    step edges.  The reference was developed against real photographs
    (tool/extract_and_match_example.cc:14-34); this is the equivalent
    correctness workload for the parity gates."""
    import cv2

    from sift_jax.perf.benchimg import bench_image

    base = bench_image(int(height * 1.5), int(width * 1.5), seed=seed)
    h, w = base.shape
    src = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
    rng = np.random.default_rng(seed + 100)
    dst = (np.float32([[0, 0], [width, 0], [width, height], [0, height]])
           + (rng.uniform(-tilt, tilt, (4, 2))
              * (width, height)).astype(np.float32))
    m = cv2.getPerspectiveTransform(src, dst)
    out = cv2.warpPerspective(base, m, (width, height),
                              flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_REFLECT_101)
    return np.clip(out, 0, 255)


@pytest.fixture(scope="session")
def test_image():
    return synthetic_image()


@pytest.fixture(scope="session")
def test_image_pair():
    """Two views of the same synthetic scene related by a small warp
    (for matching / two-view geometry tests)."""
    import cv2

    a = synthetic_image(seed=0)
    h, w = a.shape
    m = cv2.getRotationMatrix2D((w / 2, h / 2), 5.0, 1.02)
    m[:, 2] += (3.0, -2.0)
    b = cv2.warpAffine(a, m, (w, h), flags=cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_REFLECT_101)
    return a, b, m
