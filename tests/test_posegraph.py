"""Pose-graph optimization: loop closure on synthetic trajectories."""
import numpy as np
import jax.numpy as jnp

from sift_jax.geometry import se3
from sift_jax.geometry.posegraph import (IncrementalPoseGraph, PoseGraph,
                                         edge_residuals, optimize)


def _ring_trajectory(n=8, noise=0.0, seed=0):
    """Ground-truth poses on a circle; relative measurements with noise."""
    rng = np.random.default_rng(seed)
    rots, trs = [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        r = np.asarray(se3.so3_exp(jnp.asarray([0.0, ang, 0.0])),
                       np.float32)
        t = np.array([np.cos(ang), 0.0, np.sin(ang)], np.float32)
        rots.append(r)
        trs.append(t)
    meas = []
    for i in range(n):
        j = (i + 1) % n
        ri, ti = rots[i], trs[i]
        rj, tj = rots[j], trs[j]
        rrel = rj @ ri.T
        trel = tj - rrel @ ti
        if noise:
            dw = rng.normal(0, noise, 3)
            rrel = np.asarray(se3.so3_exp(jnp.asarray(dw)),
                              np.float32) @ rrel
            trel = trel + rng.normal(0, noise, 3)
        meas.append((i, j, rrel, trel))
    return rots, trs, meas


def test_residual_zero_at_ground_truth():
    rots, trs, meas = _ring_trajectory()
    g = PoseGraph.empty(len(rots), len(meas))
    g = g._replace(
        rotations=jnp.asarray(np.stack(rots)),
        translations=jnp.asarray(np.stack(trs)),
        edge_i=jnp.asarray([m[0] for m in meas], jnp.int32),
        edge_j=jnp.asarray([m[1] for m in meas], jnp.int32),
        rel_rot=jnp.asarray(np.stack([m[2] for m in meas])),
        rel_t=jnp.asarray(np.stack([m[3] for m in meas])),
        edge_weight=jnp.ones(len(meas)))
    r = np.asarray(edge_residuals(g))
    assert np.abs(r).max() < 1e-5


def test_optimize_corrects_drift():
    """Chain-initialized odometry with noisy edges + loop closure: the
    optimizer must pull poses back near ground truth."""
    rots, trs, meas = _ring_trajectory(n=8, noise=0.02, seed=1)
    g = IncrementalPoseGraph(8, 16)
    g.add_pose(rots[0], trs[0])
    for (i, j, rr, rt) in meas[:-1]:
        g.add_pose()
        g.add_edge(i, j, rr, rt)
    # loop closure edge (n-1 -> 0) with the exact measurement
    i, j, rr, rt = meas[-1]
    ri, ti = rots[i], trs[i]
    rj, tj = rots[j], trs[j]
    rrel = rj @ ri.T
    g.add_edge(i, j, rrel, tj - rrel @ ti, weight=4.0)

    before = np.asarray(edge_residuals(g.to_device()))
    out = g.optimize(iterations=25)
    after = np.asarray(edge_residuals(out))
    assert (after ** 2).sum() < 0.5 * (before ** 2).sum()
    # pose 0 pinned
    np.testing.assert_allclose(np.asarray(out.rotations[0]), rots[0],
                               atol=1e-5)
    # all poses near ground truth
    for c in range(8):
        dr = np.asarray(se3.so3_log(jnp.asarray(
            rots[c].T @ np.asarray(out.rotations[c]), jnp.float32)))
        assert np.linalg.norm(dr) < 0.08, c


def test_incremental_capacity():
    g = IncrementalPoseGraph(2, 1)
    g.add_pose()
    g.add_pose()
    try:
        g.add_pose()
        assert False
    except ValueError:
        pass
