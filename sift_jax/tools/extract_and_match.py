"""CLI: directory sweep with sequential matching (≙ /root/reference/tool/
extract_and_match_example.cc: per-frame detect+compute, match against the
previous frame's descriptors on device, optionally draw matches).

Usage: python -m sift_jax.tools.extract_and_match DIR [--num-features 2000]
       [--out-dir DIR] [--ratio 0.8]
All frames must share frame 0's dimensions (the reference's single-
preallocation contract, extract_and_match_example.cc:57-64).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dir", help="directory of same-size images")
    p.add_argument("--num-features", type=int, default=2000)
    p.add_argument("--ratio", type=float, default=0.8)
    p.add_argument("--out-dir", default=None,
                   help="write drawMatches visualizations here")
    p.add_argument("--tiers", action="store_true",
                   help="enable capacity-tier dispatch (off by default; "
                        "not measured on the GPU)")
    args = p.parse_args(argv)

    import numpy as np
    import jax

    from sift_jax.config import SiftConfig
    from sift_jax.io.image import (load_image_directory,
                                   matches_to_cv_dmatches, to_cv_keypoints)
    from sift_jax.pipeline.detector import SiftDetector
    from sift_jax.pipeline.matcher import match_brute_force

    names, frames = load_image_directory(args.dir)
    if not frames:
        raise SystemExit(f"no images in {args.dir}")
    h, w = frames[0].shape
    cfg = SiftConfig(width=w, height=h, num_features=args.num_features)
    # Full capacity by default (doc/performance.md "Knobs").
    tiers = tuple(t for t in (args.num_features // 4,
                              args.num_features // 2)
                  if t >= 256) if args.tiers else ()
    det = SiftDetector(cfg, tiers=tiers)
    det.warm_up()

    prev_kps = None
    for i, (name, frame) in enumerate(zip(names, frames)):
        t0 = time.perf_counter()
        res = det.detect_and_compute(frame)
        n = int(res.count)
        line = f"[{i}] {name}: {n} kpts"
        if det.prev_result is not None:
            m = match_brute_force(
                res.descriptors, det.prev_result.descriptors,
                res.keypoints.valid, det.prev_result.keypoints.valid,
                ratio=args.ratio)
            m = np.asarray(jax.block_until_ready(m))
            nm = int((m >= 0).sum())
            line += f", {nm} matches to prev"
            if args.out_dir:
                import os

                import cv2

                kps = to_cv_keypoints(res)
                vis = cv2.drawMatches(
                    frame.astype(np.uint8), kps,
                    prev_frame.astype(np.uint8), prev_kps,
                    matches_to_cv_dmatches(m), None)
                os.makedirs(args.out_dir, exist_ok=True)
                cv2.imwrite(os.path.join(args.out_dir, f"match_{i:04d}.png"),
                            vis)
        else:
            jax.block_until_ready(res.descriptors)
        line += f" ({(time.perf_counter() - t0) * 1e3:.2f} ms)"
        print(line)
        if args.out_dir:
            prev_kps = to_cv_keypoints(res)
            prev_frame = frame


if __name__ == "__main__":
    main()
