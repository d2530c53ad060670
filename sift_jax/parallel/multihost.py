"""Multi-host (multi-process) execution.

The reference is single-GPU/single-process; its comm backend is stream
ordering inside one CUDA context.  Scaling past one process here
(SURVEY §2.2) is:

* ``jax.distributed.initialize`` — one controller process per host (or
  per device); the PJRT runtime wires the collectives between them
  (NCCL between GPUs, gloo between CPU processes).
* ONE global ``Mesh`` over ``jax.devices()`` (all processes see all
  devices); arrays are assembled from per-process shards with
  ``jax.make_array_from_process_local_data``.
* The same jitted programs as single-process — XLA inserts the
  cross-host collectives (the keyframe-axis roll in
  parallel/batched.sequential_match, the psums in parallel/dba) as the
  sharding dictates.  No rank loops.

tests/test_multihost.py proves 2 processes x 4 CPU devices produce
results identical to a single process.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join (or create) the multi-process runtime.  With no arguments,
    auto-detects cluster environments (SLURM, GKE, ...) the way
    jax.distributed does; on a machine no launcher describes, pass the
    coordinator ("localhost:<port>"), world size and this process's
    rank.  Call BEFORE any other jax API touches the backend."""
    import jax
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def warmup_collectives():
    """Establish the cross-process collective transport (gloo TCP pairs
    on CPU backends) with one tiny allgather WHILE processes are still
    synchronized from initialize().  Without this, the first real
    collective opens the pairs lazily — if processes reach it with large
    skew (e.g. one compiles from a warm cache and the other cold), the
    slower side trips the transport's connect timeout."""
    import jax
    from jax.experimental import multihost_utils
    multihost_utils.process_allgather(
        np.zeros((jax.process_count(),), np.float32))


def global_mesh(axis: str = "data"):
    """1-D mesh over every device of every process (jax.devices()
    enumerates process-by-process, so neighboring mesh positions are
    intra-host and batch-axis collectives stay on the host's links
    first)."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis,))


def shard_from_local(mesh, local_batch: np.ndarray, axis: str = "data"):
    """Assemble the GLOBAL batch-sharded array from this process's local
    frames.  Each process passes its own [B_local, H, W] block; the
    global shape is [B_local * num_processes, H, W]."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P(axis, *([None] * (local_batch.ndim - 1))))
    return jax.make_array_from_process_local_data(sharding, local_batch)


def allgather(x):
    """Replicate a (possibly sharded) result onto every process as a
    host numpy value — the cross-host readback for verification/IO."""
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
