"""Geometry / SfM layer: SE(3) math, two-view estimation, triangulation,
pose graphs, bundle adjustment, odometry, trajectory metrics."""

from sift_jax.geometry.ba import BAProblem, BAState, lm_optimize
from sift_jax.geometry.posegraph import (IncrementalPoseGraph, PoseGraph,
                                         edge_residuals)
from sift_jax.geometry.twoview import (TwoViewResult, eight_point,
                                       pixels_to_normalized,
                                       ransac_essential, recover_pose,
                                       sampson_error, triangulate)

__all__ = [
    "BAProblem", "BAState", "lm_optimize",
    "IncrementalPoseGraph", "PoseGraph", "edge_residuals",
    "TwoViewResult", "eight_point", "pixels_to_normalized",
    "ransac_essential", "recover_pose", "sampson_error", "triangulate",
]
