"""Incremental pose graph + pose-graph optimization.

New capability (BASELINE north star config #4).  The graph accumulates
relative-pose constraints (from two-view geometry between matched frames)
into fixed-capacity edge tables; optimization is batched Gauss-Newton on
SE(3) residuals log(Z_ij^-1 * X_i^-1 * X_j), assembled with segment_sum
and solved densely over the (small) pose axis — same masked static-shape
discipline as the rest of the framework.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sift_jax.geometry import se3
from sift_jax.geometry.se3 import mm


class PoseGraph(NamedTuple):
    """Fixed-capacity pose graph.  Poses are world->camera (R, t);
    edges store the measured relative pose of j in i's frame."""

    rotations: jnp.ndarray   # [N, 3, 3]
    translations: jnp.ndarray  # [N, 3]
    pose_valid: jnp.ndarray  # [N]
    edge_i: jnp.ndarray      # [E] int32
    edge_j: jnp.ndarray      # [E] int32
    rel_rot: jnp.ndarray     # [E, 3, 3]  R_ij: x_j = R_ij x_i + t_ij
    rel_t: jnp.ndarray       # [E, 3]
    edge_weight: jnp.ndarray  # [E] (0 = invalid)

    @staticmethod
    def empty(n_poses: int, n_edges: int) -> "PoseGraph":
        eye = jnp.broadcast_to(jnp.eye(3), (n_poses, 3, 3))
        return PoseGraph(
            rotations=eye,
            translations=jnp.zeros((n_poses, 3)),
            pose_valid=jnp.zeros((n_poses,), bool),
            edge_i=jnp.zeros((n_edges,), jnp.int32),
            edge_j=jnp.zeros((n_edges,), jnp.int32),
            rel_rot=jnp.broadcast_to(jnp.eye(3), (n_edges, 3, 3)),
            rel_t=jnp.zeros((n_edges, 3)),
            edge_weight=jnp.zeros((n_edges,)))


def edge_residuals(g: PoseGraph) -> jnp.ndarray:
    """[E, 6] residual log(T_meas^-1 * T_j * T_i^-1) per edge — zero when
    pose_j == T_rel ∘ pose_i."""
    ri = g.rotations[g.edge_i]
    ti = g.translations[g.edge_i]
    rj = g.rotations[g.edge_j]
    tj = g.translations[g.edge_j]
    # actual relative: T_j * T_i^-1 (maps camera-i coords to camera-j)
    rii, tii = se3.inverse(ri, ti)
    ra, ta = se3.compose(rj, tj, rii, tii)
    # error transform: T_meas^-1 * T_actual
    rmi, tmi = se3.inverse(g.rel_rot, g.rel_t)
    re, te = se3.compose(rmi, tmi, ra, ta)
    w = se3.so3_log(re)
    return jnp.concatenate([te, w], -1)


def optimize(g: PoseGraph, iterations: int = 20,
             damping: float = 1e-6) -> PoseGraph:
    """Batched Gauss-Newton on all poses (pose 0 fixed as gauge).
    Jacobians by forward-mode autodiff of the residual wrt left-increment
    twists — exact, batched over edges."""
    n = g.rotations.shape[0]

    def residual_of_twists(xi_all, rot, tr):
        dr, dt = se3.se3_exp(xi_all)
        r2 = mm(dr, rot)
        t2 = mm(dr, tr[..., None])[..., 0] + dt
        return edge_residuals(g._replace(rotations=r2, translations=t2))

    def gn_step(carry, _):
        rot, tr = carry
        zero = jnp.zeros((n, 6))
        res0 = residual_of_twists(zero, rot, tr)              # [E, 6]
        jac = jax.jacfwd(residual_of_twists)(zero, rot, tr)   # [E,6,N,6]
        w = g.edge_weight[:, None]
        res0 = res0 * w
        jac = jac * w[..., None, None]
        jdense = jac.reshape(-1, n * 6)
        h = mm(jdense.T, jdense)
        b = mm(jdense.T, res0.reshape(-1))
        mask = jnp.concatenate([jnp.zeros(6), jnp.ones(6 * (n - 1))])
        h = h * mask[:, None] * mask[None, :] + jnp.diag(
            (1.0 - mask) + damping * mask)
        dx = -jnp.linalg.solve(h, b * mask).reshape(n, 6)
        dr, dt = se3.se3_exp(dx)
        rot2 = mm(dr, rot)
        tr2 = mm(dr, tr[..., None])[..., 0] + dt
        return (rot2, tr2), jnp.sum(res0 * res0)

    (rot, tr), _ = jax.lax.scan(
        gn_step, (g.rotations, g.translations), None, length=iterations)
    return g._replace(rotations=rot, translations=tr)


class IncrementalPoseGraph:
    """Host-side incremental builder: add keyframes and two-view
    constraints as they arrive (numpy mutation), optimize on device.
    The device arrays stay fixed-capacity; this wrapper only fills them."""

    def __init__(self, max_poses: int, max_edges: int):
        self.max_poses = max_poses
        self.max_edges = max_edges
        self.n_poses = 0
        self.n_edges = 0
        self._rot = np.tile(np.eye(3, dtype=np.float32), (max_poses, 1, 1))
        self._t = np.zeros((max_poses, 3), np.float32)
        self._ei = np.zeros(max_edges, np.int32)
        self._ej = np.zeros(max_edges, np.int32)
        self._rr = np.tile(np.eye(3, dtype=np.float32), (max_edges, 1, 1))
        self._rt = np.zeros((max_edges, 3), np.float32)
        self._w = np.zeros(max_edges, np.float32)

    def add_pose(self, rot=None, t=None) -> int:
        if self.n_poses >= self.max_poses:
            raise ValueError("pose capacity exceeded")
        i = self.n_poses
        if rot is not None:
            self._rot[i] = rot
            self._t[i] = t
        elif i > 0:
            self._rot[i] = self._rot[i - 1]
            self._t[i] = self._t[i - 1]
        self.n_poses += 1
        return i

    def add_edge(self, i: int, j: int, rel_rot, rel_t, weight=1.0):
        """Constraint: pose_j ≈ (rel_rot, rel_t) ∘ pose_i."""
        if self.n_edges >= self.max_edges:
            raise ValueError("edge capacity exceeded")
        e = self.n_edges
        self._ei[e] = i
        self._ej[e] = j
        self._rr[e] = rel_rot
        self._rt[e] = rel_t
        self._w[e] = weight
        self.n_edges += 1
        # chain initialization of pose j from i when j is the newest pose
        if j == self.n_poses - 1 and self._w[:e][
                (self._ej[:e] == j)].sum() == 0:
            rj = np.asarray(rel_rot) @ self._rot[i]
            tj = (np.asarray(rel_rot) @ self._t[i]) + np.asarray(rel_t)
            self._rot[j] = rj
            self._t[j] = tj

    def to_device(self) -> PoseGraph:
        return PoseGraph(
            rotations=jnp.asarray(self._rot),
            translations=jnp.asarray(self._t),
            pose_valid=jnp.asarray(np.arange(self.max_poses)
                                   < self.n_poses),
            edge_i=jnp.asarray(self._ei), edge_j=jnp.asarray(self._ej),
            rel_rot=jnp.asarray(self._rr), rel_t=jnp.asarray(self._rt),
            edge_weight=jnp.asarray(self._w))

    def optimize(self, iterations: int = 20) -> PoseGraph:
        out = optimize(self.to_device(), iterations)
        self._rot[:] = np.asarray(out.rotations)
        self._t[:] = np.asarray(out.translations)
        return out
