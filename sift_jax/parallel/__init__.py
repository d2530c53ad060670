"""Multi-chip scaling: keyframe-axis sharding and distributed BA."""

from sift_jax.parallel.batched import (batched_detect_fn, make_mesh,
                                       make_sharded_pipeline,
                                       sequential_match)
from sift_jax.parallel.dba import make_distributed_lm

__all__ = [
    "batched_detect_fn", "make_mesh", "make_sharded_pipeline",
    "sequential_match", "make_distributed_lm",
]
