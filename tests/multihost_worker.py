"""Worker process for tests/test_multihost.py.

Runs one process of a 2-process x 4-CPU-device cluster: joins via
jax.distributed, executes the keyframe-sharded detect+match pipeline and
the distributed BA over the GLOBAL mesh, and (process 0) writes the
allgathered results for the test to compare against single-process.

Usage: python tests/multihost_worker.py PID NPROC PORT OUTDIR
"""

import sys

import numpy as np


def det_frames(b, h, w):
    # Textured frames (noise would be an almost-empty workload —
    # perf/benchimg.py), distinct seed per keyframe.
    from sift_jax.perf.benchimg import bench_image
    return np.stack([bench_image(h, w, seed=i)
                     for i in range(b)]).astype(np.float32)


def main():
    # Configure BEFORE any backend touch (and only when run as a
    # worker process — the test imports det_frames from an already-
    # initialized interpreter).
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)

    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    outdir = sys.argv[4]

    from sift_jax.parallel.multihost import (allgather, global_mesh,
                                             initialize, shard_from_local,
                                             warmup_collectives)
    initialize(f"127.0.0.1:{port}", nproc, pid)
    assert jax.process_count() == nproc
    assert jax.device_count() == 4 * nproc
    warmup_collectives()

    from sift_jax.perf.cache import enable_compilation_cache
    enable_compilation_cache()

    from sift_jax.config import SiftConfig
    from sift_jax.core.types import build_plan
    from sift_jax.parallel.batched import make_sharded_pipeline
    from sift_jax.parallel.dba import make_distributed_lm

    # --- keyframe-sharded detect + sequential match over the global mesh
    cfg = SiftConfig(width=752, height=480, num_features=512)
    plan = build_plan(cfg)
    mesh = global_mesh()
    fn, _ = make_sharded_pipeline(plan, mesh)

    b_local = 4
    frames = det_frames(b_local * nproc, cfg.height, cfg.width)
    local = frames[pid * b_local:(pid + 1) * b_local]
    garr = shard_from_local(mesh, local)
    # AOT-compile, then BARRIER before executing: compile durations vary
    # between processes, and a cross-process collective whose peers
    # arrive more than gloo's connect timeout apart fails its context
    # init.  The coordination-service barrier (minutes of budget)
    # absorbs the skew.
    from jax.experimental import multihost_utils
    compiled = fn.lower(garr).compile()
    multihost_utils.sync_global_devices("detect compiled")
    res, matches = compiled(garr)

    out = {
        "x": allgather(res.keypoints.x),
        "desc": allgather(res.descriptors),
        "count": allgather(res.count),
        "matches": allgather(matches),
    }

    # --- distributed BA over the same global mesh
    sys.path.insert(0, "tests")
    from test_ba import synthetic_ba
    prob, _, _, _ = synthetic_ba(seed=0, n_cams=5, n_pts=96)
    lm, place = make_distributed_lm(mesh, iterations=10)
    placed = place(prob)
    lm_c = lm.lower(placed).compile()
    multihost_utils.sync_global_devices("ba compiled")
    state = lm_c(placed)
    # BA outputs are fully replicated: any local shard holds the value.
    out["ba_cost"] = np.asarray(state.cost.addressable_data(0))
    out["ba_rot"] = np.asarray(state.rotations.addressable_data(0))

    if pid == 0:
        np.savez(f"{outdir}/multihost_out.npz", **out)
    print(f"worker {pid} done", flush=True)


if __name__ == "__main__":
    main()
