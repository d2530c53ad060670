"""CLI: multi-device scaling efficiency of the keyframe-sharded pipeline.

BASELINE north star: >= 80% frames/s scaling efficiency at 2+ hosts.
Measures detect+match throughput of parallel/batched.make_sharded_pipeline
at growing device counts on the current backend (the GPUs of one host,
or the virtual CPU mesh for plumbing runs) and prints one JSON line per
point:

    {"metric": "scaling", "devices": N, "frames_per_s": F,
     "efficiency_vs_1": E}

Frames per device is fixed, so perfect scaling doubles frames/s per
doubling of devices; efficiency = (F_N / N) / F_1.

Usage: python -m sift_jax.tools.scale_bench [--width 752] [--height 480]
           [--num-features 512] [--frames-per-device 2] [--iters 4]
"""

from __future__ import annotations

import argparse
import json
import time


def measure(n_devices: int, cfg, frames_per_device: int,
            iters: int) -> float:
    import jax
    import numpy as np

    from sift_jax.core.types import build_plan
    from sift_jax.parallel.batched import make_mesh, make_sharded_pipeline

    plan = build_plan(cfg)
    mesh = make_mesh(n_devices)
    fn, shard = make_sharded_pipeline(plan, mesh)

    from sift_jax.perf.benchimg import bench_image

    # Textured frames (distinct seeds), NOT white noise: a noise frame
    # (near-zero keypoints) would benchmark an almost-empty workload
    # (see perf/benchimg.py).
    b = frames_per_device * n_devices
    frames = np.stack([bench_image(cfg.height, cfg.width, seed=i)
                       for i in range(b)]).astype(np.float32)
    garr = shard(frames)
    res, matches = fn(garr)            # compile + warm
    jax.block_until_ready((res, matches))

    t0 = time.perf_counter()
    for _ in range(iters):
        res, matches = fn(garr)
        # Block EVERY iteration: blocking only on the last call's
        # outputs measures dispatch rate, not computation.
        jax.block_until_ready((res, matches))
    dt = time.perf_counter() - t0
    return b * iters / dt


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=752)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--num-features", type=int, default=512)
    p.add_argument("--frames-per-device", type=int, default=2)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--cpu-mesh", type=int, default=0,
                   help="force the CPU backend with N virtual devices "
                        "(a plumbing run: its rates are CPU rates)")
    args = p.parse_args(argv)

    import jax
    if args.cpu_mesh:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu_mesh)
    from sift_jax.perf.cache import enable_compilation_cache
    enable_compilation_cache()

    from sift_jax.config import SiftConfig

    cfg = SiftConfig(width=args.width, height=args.height,
                     num_features=args.num_features)

    nd = jax.device_count()
    points = sorted({1, 2, 4, 8, nd} & set(range(1, nd + 1)))
    base = None
    for n in points:
        fps = measure(n, cfg, args.frames_per_device, args.iters)
        if base is None:
            base = fps
        print(json.dumps({
            "metric": "scaling", "devices": n,
            "frames_per_s": round(fps, 3),
            "efficiency_vs_1": round(fps / (n * base), 4)}), flush=True)


if __name__ == "__main__":
    main()
