"""Headline benchmark: detect+compute latency at 752x480, the reference's
primary published number (0.95 ms on RTX 4070 Super excluding transfers,
/root/reference/readme.md:13-15; mirrored in BASELINE.md).

Prints ONE JSON line with the median and p90 of timed calls (host clock
around ``block_until_ready``), the sample count, the compile time as
set-up, the keypoint count, and the device and card it ran on.
``vs_baseline`` is median / reference time (< 1.0 is faster than the
reference GPU).  The input is placed on the device first, so timing
excludes host<->device transfer, as the reference's does (readme.md:11).

Exits non-zero when JAX finds no GPU.  Usage: python bench.py
"""

import json
import time

BASELINE_MS = 0.95  # RTX 4070 Super, 752x480 (readme.md:13-15)


def main():
    from sift_jax.perf.device import card_identity, require_gpu

    device = require_gpu()

    from sift_jax.perf.cache import enable_compilation_cache
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from sift_jax.config import SiftConfig
    from sift_jax.core.types import build_plan
    from sift_jax.perf.benchimg import bench_image
    from sift_jax.perf.timing import time_calls
    from sift_jax.pipeline.detector import build_detect_fn

    cfg = SiftConfig(width=752, height=480, num_features=5000)
    img = jax.device_put(jnp.asarray(bench_image(480, 752), jnp.float32))
    t0 = time.perf_counter()
    detect = jax.jit(build_detect_fn(build_plan(cfg))).lower(img).compile()
    compile_s = time.perf_counter() - t0
    count = int(detect(img).count)
    stats = time_calls(detect, img, iters=20)
    print(json.dumps({
        "metric": "detect_compute_752x480",
        "median_ms": stats["median_ms"],
        "p90_ms": stats["p90_ms"],
        "n": stats["n"],
        "unit": "ms",
        "vs_baseline": stats["median_ms"] / BASELINE_MS,
        "keypoints": count,
        "compile_s": compile_s,
        "device": device,
        "card": card_identity(),
    }), flush=True)


if __name__ == "__main__":
    main()
