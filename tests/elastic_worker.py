"""Worker process for the elastic-recovery test
(tests/test_multihost.py::test_worker_loss_resume_from_checkpoint).

Runs one process of a 2-process x 4-CPU-device cluster executing a
chunked distributed LM (parallel/dba.make_lm_stepper), checkpointing the
replicated BAState after every chunk (perf/checkpoint.save_ba_state).
If DIE_AFTER_CHUNK >= 0 and this is process 1, the process exits hard
(os._exit) right after that chunk's checkpoint is durable — simulating a
worker loss mid-optimization.  A restarted cluster resumes from the
checkpoint and completes the remaining chunks.

Usage: python tests/elastic_worker.py PID NPROC PORT OUTDIR DIE_AFTER_CHUNK
"""

import os
import sys

import numpy as np

TOTAL_ITERS = 15
CHUNK = 5


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)

    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    outdir = sys.argv[4]
    die_after_chunk = int(sys.argv[5])

    from sift_jax.parallel.multihost import (global_mesh, initialize,
                                             warmup_collectives)
    initialize(f"127.0.0.1:{port}", nproc, pid)
    warmup_collectives()

    from sift_jax.perf.cache import enable_compilation_cache
    enable_compilation_cache()

    from jax.experimental import multihost_utils

    from sift_jax.parallel.dba import make_lm_stepper
    from sift_jax.perf.checkpoint import load_ba_state, save_ba_state

    sys.path.insert(0, os.path.join(os.path.dirname(__file__)))
    from test_ba import synthetic_ba

    prob, *_ = synthetic_ba(seed=3, n_cams=5, n_pts=96)
    mesh = global_mesh()
    init, step, place = make_lm_stepper(mesh, chunk=CHUNK)
    placed = place(prob)

    ckpt = os.path.join(outdir, "ba_ckpt.npz")
    state_host, done = load_ba_state(ckpt)
    if state_host is None:
        state = init(placed)
    else:
        # Re-place the host checkpoint as replicated arrays on this
        # cluster's mesh (the saved state is replicated, so any process's
        # copy is THE state).
        from jax.sharding import NamedSharding, PartitionSpec as P
        state = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, NamedSharding(mesh, P())),
            state_host)
    print(f"worker {pid}: resuming at iteration {done}", flush=True)

    step_c = step.lower(placed, state).compile()
    multihost_utils.sync_global_devices("lm compiled")

    for chunk_i in range(done // CHUNK, TOTAL_ITERS // CHUNK):
        state = step_c(placed, state)
        if pid == 0:
            save_ba_state(ckpt, state, iteration=(chunk_i + 1) * CHUNK)
        # Checkpoint is durable before anyone proceeds (or dies).
        multihost_utils.sync_global_devices(f"chunk {chunk_i} saved")
        if chunk_i == die_after_chunk and pid == 1:
            print(f"worker {pid}: simulating crash after chunk {chunk_i}",
                  flush=True)
            os._exit(17)

    if pid == 0:
        final = {k: np.asarray(v.addressable_data(0))
                 for k, v in state._asdict().items()}
        np.savez(os.path.join(outdir, "elastic_final.npz"), **final)
    print(f"worker {pid} done", flush=True)


if __name__ == "__main__":
    main()
