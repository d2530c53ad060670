"""Keypoint refinement — thin parity shim over the one Newton
implementation in ops/refine_dense.py.

``refine_keypoints`` is the single-octave per-stage contract used by the
golden-checkpoint replay harness (perf/replay.py run_adjust, ≙ the
reference's HostInterface::runAdjustPts, interface/HostInterface.cu) and
the cv2-oracle gate (perf/oracle.py).  Equivalence is gated by replay
against golden checkpoints rather than by maintaining duplicate math.
"""

from __future__ import annotations

from sift_jax.ops.refine_dense import (RefinedKeypoints,
                                       refine_keypoints_dense)

__all__ = ["RefinedKeypoints", "refine_keypoints"]

refine_keypoints = refine_keypoints_dense
