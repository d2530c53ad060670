"""CLI: single-image detection (≙ /root/reference/tool/
detection_example.cc: load grayscale image, run detectAndCompute N times for
profiling, optional golden-checkpoint dump via --debug-path).

Usage: python -m sift_jax.tools.detect IMAGE [--iters 10]
       [--debug-path DIR] [--num-features 5000] [--upscale] [--profile DIR]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image", help="path to an image (read as grayscale)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--debug-path", default=None,
                   help="dump golden checkpoints here (≙ setDataGen)")
    p.add_argument("--num-features", type=int, default=5000)
    p.add_argument("--upscale", action="store_true")
    p.add_argument("--profile", default=None,
                   help="write a jax.profiler trace to this directory")
    args = p.parse_args(argv)

    import numpy as np
    import jax

    from sift_jax.config import SiftConfig
    from sift_jax.io.image import load_grayscale
    from sift_jax.pipeline.detector import SiftDetector

    img = load_grayscale(args.image)
    h, w = img.shape
    cfg = SiftConfig(width=w, height=h, num_features=args.num_features,
                     upscale=args.upscale)
    print(f"image {w}x{h}, {cfg.num_octaves} octaves")

    det = SiftDetector(cfg)
    t0 = time.perf_counter()
    det.warm_up()
    print(f"compile: {time.perf_counter() - t0:.2f}s")

    if args.debug_path:
        from sift_jax.perf.checkpoint import capture_golden
        capture_golden(cfg, img, args.debug_path)
        try:
            from sift_jax.perf.oracle import capture_oracle
            capture_oracle(cfg, img, args.debug_path)
            print(f"golden checkpoint + cv2 oracle written to "
                  f"{args.debug_path}")
        except ImportError:
            print(f"golden checkpoint written to {args.debug_path} "
                  f"(no cv2: oracle skipped)")

    if args.profile:
        jax.profiler.start_trace(args.profile)
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        res = jax.block_until_ready(det.detect_and_compute(img))
        times.append((time.perf_counter() - t0) * 1e3)
    if args.profile:
        jax.profiler.stop_trace()
        print(f"profile trace in {args.profile}")

    n = int(res.count)
    print(f"keypoints: {n}")
    print(f"detect+compute: median {np.median(times):.3f} ms "
          f"min {min(times):.3f} ms over {args.iters} iters")


if __name__ == "__main__":
    main()
