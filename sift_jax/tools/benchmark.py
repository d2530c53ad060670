"""CLI: the BASELINE.md benchmark table on the current backend.

Reproduces the reference's published workload set (readme.md:9-16 —
detect+compute at 752x480 / 1600x900 / 1920x1200, brute-force match of
2000x2000 descriptors), timed by the host clock around
``block_until_ready`` (perf/timing.py).  Prints one JSON line per metric
with the median and p90 of 20 calls (50 for the match) and the device
it ran on.

Usage: python -m sift_jax.tools.benchmark [--quick] [--sizes WxH ...]
"""

from __future__ import annotations

import argparse
import json


BASELINES_MS = {
    "detect_compute_752x480": 0.95,
    "detect_compute_1600x900": 2.5,
    "detect_compute_1920x1200": 3.1,
    "match_2000x2000": 1.0,
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true",
                   help="752x480 + match only")
    p.add_argument("--sizes", nargs="*", default=None,
                   help="override detect sizes, e.g. 752x480 1920x1200")
    p.add_argument("--num-features", type=int, default=5000)
    p.add_argument("--batch", type=int, default=0,
                   help="also measure single-device THROUGHPUT with this "
                        "many frames in one program (reports per-frame "
                        "ms)")
    p.add_argument("--tiers", nargs="*", type=int, default=None,
                   help="also measure the capacity-TIER programs "
                        "(detector.py tier dispatch) at these internal "
                        "keypoint capacities — the device-side latency a "
                        "tracking loop pays when the tier fits the frame")
    args = p.parse_args(argv)

    import numpy as np
    import jax
    import jax.numpy as jnp

    from sift_jax.config import SiftConfig
    from sift_jax.core.types import build_plan
    from sift_jax.perf.benchimg import bench_image
    from sift_jax.perf.timing import time_calls
    from sift_jax.pipeline.detector import build_detect_fn
    from sift_jax.pipeline.matcher import match_brute_force

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    def emit(name, stats, unit="ms", scale=1.0, **extra):
        base = BASELINES_MS.get(name.split("_tier")[0].split("_batch")[0])
        med = stats["median_ms"] / scale
        print(json.dumps({
            "metric": name, "median_ms": med,
            "p90_ms": stats["p90_ms"] / scale, "n": stats["n"],
            "unit": unit, "vs_baseline": med / base if base else None,
            "device": device, **extra}), flush=True)

    rng = np.random.default_rng(0)
    sizes = args.sizes or (["752x480"] if args.quick
                           else ["752x480", "1600x900", "1920x1200"])

    for spec in sizes:
        w, h = (int(v) for v in spec.split("x"))
        cfg = SiftConfig(width=w, height=h,
                         num_features=args.num_features)
        detect = jax.jit(build_detect_fn(build_plan(cfg)))
        img = jax.device_put(jnp.asarray(bench_image(h, w), jnp.float32))
        count = int(detect(img).count)
        emit(f"detect_compute_{w}x{h}",
             time_calls(detect, img), keypoints=count)

        for tier in args.tiers or ():
            tfn = jax.jit(build_detect_fn(build_plan(cfg), kpt_cap=tier))
            emit(f"detect_compute_{w}x{h}_tier{tier}",
                 time_calls(tfn, img), keypoints=count)

        if args.batch:
            from sift_jax.parallel.batched import batched_detect_fn
            bfn = jax.jit(batched_detect_fn(build_plan(cfg)))
            batch = jax.device_put(
                jnp.broadcast_to(img, (args.batch,) + img.shape))
            emit(f"detect_compute_{w}x{h}_batch{args.batch}",
                 time_calls(bfn, batch),
                 unit="ms/frame", scale=float(args.batch))

    # Brute-force matching (readme.md:11: 2000x2000 in < 1 ms) on uint8
    # storage — the pipeline's default descriptor dtype.
    q = jax.device_put(jnp.asarray(rng.integers(0, 256, (2000, 128)),
                                   jnp.uint8))
    t = jax.device_put(jnp.asarray(rng.integers(0, 256, (2000, 128)),
                                   jnp.uint8))
    emit("match_2000x2000",
         time_calls(match_brute_force, q, t, iters=50))


if __name__ == "__main__":
    main()
