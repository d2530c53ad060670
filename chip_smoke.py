"""Smoke test of the SIFT pipeline on one NVIDIA GPU, through the entry
points a user calls, at the reference's real sizes.

    python chip_smoke.py            # one GPU: phases 0-4
    python chip_smoke.py --multi    # four GPUs: the sharded phase only

Phases (each prints one JSON line; any failure raises, so the script
exits non-zero without the final line):

0. identity: JAX's device, the card's name and power limit from
   nvidia-smi, the compile-cache directory;
1. detect+compute at 752x480 and 1920x1200 (num_features=5000) through
   ``SiftDetector``, against the same program on the CPU backend, with
   compile time, memory analysis, peak device memory and host-clock
   timings (information, not a claim);
2. 2000x2000 uint8 matching against a float64 numpy brute force;
3. matching of two shifted crops, RANSAC relative pose on a synthetic
   scene, and bundle adjustment on the GPU against the CPU;
4. the on-card tests, ``pytest tests_gpu -m gpu``, in this process.

``--multi`` runs only the four-card phase: 8 frames sharded over four
GPUs against the same frames on one, and distributed bundle adjustment
against the single-device solver.  The last line is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# Phase-1 tolerances: GPU against the CPU backend on the same frame.
# Measured on an H100 (700 W) at 752x480 and 1920x1200: equal counts,
# every CPU keypoint paired, positions within 0.002 px, angles within
# 0.005 deg, descriptors within 1 unit on 0.1% of elements.  The bounds
# keep a margin for XLA choosing other algorithms in another process.
COUNT_REL_TOL = 0.005     # keypoint count
PAIR_POS_TOL_PX = 0.01    # base-image px
PAIR_ANG_TOL_DEG = 0.1
MIN_PAIRED_FRAC = 0.99    # of the CPU keypoints
DESC_TOL = 2.0            # quantized units, the repository's descriptor gate
DESC_FRAC_TOL = 0.01      # share of paired descriptor elements that differ


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def require(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase0_identity() -> tuple:
    """Fails unless JAX's default device is a GPU."""
    from sift_jax.perf.cache import enable_compilation_cache
    from sift_jax.perf.device import card_identity, require_gpu

    device = require_gpu()
    card = card_identity()
    print(card, flush=True)
    emit({"phase": 0, "device": device, "card": card,
          "compile_cache": enable_compilation_cache()})
    return device, card


def check_detection(stats: dict) -> None:
    require(stats["count_rel_diff"] <= COUNT_REL_TOL, stats)
    require(stats["paired_frac"] >= MIN_PAIRED_FRAC, stats)
    require(stats["desc_max_diff"] <= DESC_TOL, stats)
    require(stats["desc_frac_elems_diff"] <= DESC_FRAC_TOL, stats)


def phase1_detect(width: int, height: int, num_features: int,
                  card: str) -> dict:
    import jax

    from sift_jax.config import SiftConfig
    from sift_jax.perf.benchimg import bench_image
    from sift_jax.perf.parity import compare_detections
    from sift_jax.perf.timing import time_calls
    from sift_jax.pipeline.detector import SiftDetector, build_detect_fn

    cfg = SiftConfig(width=width, height=height, num_features=num_features)
    frame = bench_image(height, width)
    det = SiftDetector(cfg)
    t0 = time.perf_counter()
    det.warm_up()
    compile_s = time.perf_counter() - t0
    res = det.detect_and_compute(frame)

    # The same program, compiled ahead of time for its memory analysis
    # and timed on a device-resident frame (the persistent compile cache
    # serves it).
    img = jax.device_put(np.asarray(frame, np.float32), jax.devices()[0])
    compiled = jax.jit(build_detect_fn(det.plan)).lower(img).compile()
    mem = compiled.memory_analysis()
    timing = time_calls(compiled, img, iters=20)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")

    cpu = jax.devices("cpu")[0]
    res_cpu = jax.jit(build_detect_fn(det.plan))(
        jax.device_put(np.asarray(frame, np.float32), cpu))
    stats = compare_detections(res_cpu, res, PAIR_POS_TOL_PX,
                               PAIR_ANG_TOL_DEG)
    record = {
        "phase": 1, "size": f"{width}x{height}",
        "num_features": num_features, "parity_vs_cpu": stats,
        "compile_s": compile_s,
        "memory_analysis": {
            "temp_bytes": mem.temp_size_in_bytes,
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "generated_code_bytes": mem.generated_code_size_in_bytes},
        "peak_bytes_in_use": peak,
        "timing_ms": timing, "card": card}
    emit(record)
    check_detection(stats)
    return record


def phase2_match(card: str, n: int = 2000) -> dict:
    """n x n uint8 matching on the GPU against the float64 reference.
    Half the train rows are noisy copies of query rows, so the ratio test
    accepts real matches as well as rejecting the random rest."""
    import jax
    import jax.numpy as jnp

    from sift_jax.perf.parity import match_reference
    from sift_jax.perf.timing import time_calls
    from sift_jax.pipeline.matcher import match_brute_force

    rng = np.random.default_rng(7)
    q = rng.integers(0, 256, (n, 128))
    t = rng.integers(0, 256, (n, 128))
    src = rng.permutation(n)[:n // 2]
    t[:n // 2] = np.clip(q[src] + rng.integers(-4, 5, (n // 2, 128)),
                         0, 255)
    q, t = q.astype(np.uint8), t.astype(np.uint8)
    qd, td = jax.device_put(jnp.asarray(q)), jax.device_put(jnp.asarray(t))
    got = np.asarray(match_brute_force(qd, td))
    want = match_reference(q, t)
    record = {"phase": 2, "size": f"{n}x{n}",
              "matched": int((want >= 0).sum()),
              "mismatches": int((got != want).sum()),
              "timing_ms": time_calls(match_brute_force, qd, td, iters=50),
              "card": card}
    emit(record)
    require(record["matched"] >= n // 4, record)
    require(record["mismatches"] == 0, record)
    return record


def phase3_geometry(width: int = 752, height: int = 480,
                    num_features: int = 5000, shift=(37, 21)) -> dict:
    import jax
    import jax.numpy as jnp

    from sift_jax.config import SiftConfig
    from sift_jax.geometry.ba import lm_optimize
    from sift_jax.geometry.twoview import ransac_essential
    from sift_jax.perf.benchimg import bench_image
    from sift_jax.perf.scenes import synthetic_ba, two_view_scene
    from sift_jax.pipeline.detector import SiftDetector
    from sift_jax.pipeline.matcher import match_brute_force

    # Two crops of one larger frame: a point at (x, y) in A sits at
    # (x - dx, y - dy) in B.
    dx, dy = shift
    big = bench_image(height + dy, width + dx, seed=3)
    frame_a = big[:height, :width]
    frame_b = big[dy:dy + height, dx:dx + width]
    det = SiftDetector(SiftConfig(width=width, height=height,
                                  num_features=num_features))
    ra = det.detect_and_compute(frame_a)
    rb = det.detect_and_compute(frame_b)
    m = np.asarray(match_brute_force(ra.descriptors, rb.descriptors,
                                     ra.keypoints.valid, rb.keypoints.valid))
    qi = np.flatnonzero(m >= 0)
    ka, kb = ra.keypoints, rb.keypoints
    ex = np.asarray(ka.x)[qi] - dx - np.asarray(kb.x)[m[qi]]
    ey = np.asarray(ka.y)[qi] - dy - np.asarray(kb.y)[m[qi]]
    shift_ok = float((np.hypot(ex, ey) <= 1.0).mean()) if qi.size else 0.0

    # Relative pose on a synthetic scene with 20% outliers.
    p1, p2, r_gt, t_gt, _, _ = two_view_scene(n=300, outlier_frac=0.2)
    pose = jax.jit(ransac_essential)(p1, p2, jnp.ones(p1.shape[0], bool),
                                     jax.random.key(0))
    r_rel = r_gt.T @ np.asarray(pose.rotation, np.float64)
    r_err = float(np.degrees(np.arccos(np.clip(
        (np.trace(r_rel) - 1.0) / 2.0, -1.0, 1.0))))
    t_est = np.asarray(pose.translation, np.float64)
    t_err = float(np.degrees(np.arccos(min(1.0, abs(t_est @ t_gt) / (
        np.linalg.norm(t_est) * np.linalg.norm(t_gt))))))

    # Bundle adjustment on the GPU and on the CPU.
    prob, *_ = synthetic_ba(seed=1, noise_px=0.5)
    ba = jax.jit(lambda p: lm_optimize(p, iterations=15))
    cost_gpu = float(ba(prob).cost)
    cost_cpu = float(ba(jax.device_put(prob, jax.devices("cpu")[0])).cost)
    record = {"phase": 3, "shift_matches": int(qi.size),
              "shift_agree_frac": shift_ok,
              "rotation_err_deg": r_err, "translation_err_deg": t_err,
              "ba_cost_gpu": cost_gpu, "ba_cost_cpu": cost_cpu,
              "ba_cost_rel_diff": abs(cost_gpu - cost_cpu) / cost_cpu}
    emit(record)
    require(qi.size >= 100 and shift_ok >= 0.9, record)
    require(r_err < 0.5 and t_err < 1.0, record)
    require(record["ba_cost_rel_diff"] <= 1e-4, record)
    return record


def phase4_tests() -> None:
    import pytest

    rc = pytest.main(["tests_gpu", "-m", "gpu", "-n", "0", "-q",
                      "-p", "no:cacheprovider"])
    emit({"phase": 4, "pytest_exit_code": int(rc)})
    require(rc == 0, f"tests_gpu failed: exit code {rc}")


def phase_multi(n_frames: int = 8, width: int = 752, height: int = 480,
                num_features: int = 5000, n_devices: int = 4) -> dict:
    """Sharded detect+match over ``n_devices`` against the same frames on
    one device, and distributed BA against the single-device solver."""
    import jax

    from sift_jax.config import SiftConfig
    from sift_jax.core.types import build_plan
    from sift_jax.geometry.ba import lm_optimize
    from sift_jax.parallel.batched import (batched_detect_fn, make_mesh,
                                           make_sharded_pipeline,
                                           sequential_match)
    from sift_jax.parallel.dba import make_distributed_lm
    from sift_jax.perf.benchimg import bench_image
    from sift_jax.perf.parity import compare_detections
    from sift_jax.perf.scenes import synthetic_ba
    from sift_jax.perf.timing import time_calls

    require(len(jax.devices()) >= n_devices, jax.devices())
    cfg = SiftConfig(width=width, height=height, num_features=num_features)
    plan = build_plan(cfg)
    frames = np.stack([bench_image(height, width, seed=i)
                       for i in range(n_frames)]).astype(np.float32)

    mesh = make_mesh(n_devices)
    sharded, shard = make_sharded_pipeline(plan, mesh)
    garr = shard(frames)
    res_n, m_n = sharded(garr)
    one = jax.jit(batched_detect_fn(plan))
    larr = jax.device_put(frames, jax.devices()[0])
    res_1 = one(larr)
    m_1 = sequential_match(res_1.descriptors, res_1.keypoints.valid,
                           cfg.match_ratio)

    per_frame = []
    for i in range(n_frames):
        pick = lambda r: jax.tree.map(lambda a: a[i], r)
        per_frame.append(compare_detections(pick(res_1), pick(res_n),
                                            PAIR_POS_TOL_PX,
                                            PAIR_ANG_TOL_DEG))
    match_agree = float((np.asarray(m_1) == np.asarray(m_n)).mean())
    fps_n = n_frames / (time_calls(sharded, garr, iters=10)["median_ms"]
                        / 1e3)
    fps_1 = n_frames / (time_calls(one, larr, iters=10)["median_ms"] / 1e3)

    prob, *_ = synthetic_ba(seed=1, noise_px=0.5)
    dist, place = make_distributed_lm(mesh, iterations=15)
    cost_n = float(dist(place(prob)).cost)
    cost_1 = float(jax.jit(lambda p: lm_optimize(p, iterations=15))(
        jax.device_put(prob, jax.devices()[0])).cost)
    record = {"phase": "multi", "devices": n_devices, "frames": n_frames,
              "size": f"{width}x{height}",
              "worst_frame": min(per_frame, key=lambda s: s["paired_frac"]),
              "match_agree_frac": match_agree,
              "frames_per_s_1": fps_1, f"frames_per_s_{n_devices}": fps_n,
              "scaling_efficiency": fps_n / (n_devices * fps_1),
              "dba_cost": cost_n, "ba_cost": cost_1,
              "ba_cost_rel_diff": abs(cost_n - cost_1) / cost_1}
    emit(record)
    for s in per_frame:
        check_detection(s)
    require(match_agree >= 0.99, record)
    require(record["ba_cost_rel_diff"] <= 1e-4, record)
    return record


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-GPU sharded phase")
    args = p.parse_args(argv)

    import jax

    # The GPU must exist; the CPU backend is there for the references.
    jax.config.update("jax_platforms", "cuda,cpu")
    device, card = phase0_identity()
    if args.multi:
        phase_multi()
    else:
        for width, height in ((752, 480), (1920, 1200)):
            phase1_detect(width, height, 5000, card)
        phase2_match(card)
        phase3_geometry()
        phase4_tests()
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
