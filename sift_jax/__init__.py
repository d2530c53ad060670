"""sift_jax — a SIFT / SfM framework in JAX/XLA.

Brand-new implementation with the capabilities of the reference CUDA SIFT
(Cryptum169/another-cuda-sift): Gaussian/DoG pyramids, keypoint detection and
refinement, orientation assignment, 128-D descriptors, brute-force matching —
re-architected for XLA (static shapes, masked fixed-capacity keypoint sets,
matmul blur/resize operators, histogram contractions), plus multi-device
scaling and a geometry/bundle-adjustment layer the reference lacks.
"""

from sift_jax.config import SiftConfig
from sift_jax.core.types import Keypoints, SiftResult, build_plan
from sift_jax.pipeline.detector import SiftDetector, build_detect_fn
from sift_jax.pipeline.matcher import match_brute_force, match_pairs

__version__ = "0.1.0"

__all__ = [
    "SiftConfig", "Keypoints", "SiftResult", "build_plan",
    "SiftDetector", "build_detect_fn",
    "match_brute_force", "match_pairs",
]
