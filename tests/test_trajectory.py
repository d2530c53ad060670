"""Trajectory metrics + TUM/KITTI IO round-trips."""
import numpy as np
import jax.numpy as jnp
import pytest

from sift_jax.geometry import se3
from sift_jax.geometry.trajectory import (associate_timestamps, ate_rmse,
                                          positions_from_rt,
                                          read_kitti_trajectory,
                                          read_tum_trajectory, rpe,
                                          umeyama_alignment,
                                          write_kitti_trajectory,
                                          write_tum_trajectory)


def _random_traj(n=20, seed=0):
    rng = np.random.default_rng(seed)
    poses = []
    m = np.eye(4)
    for _ in range(n):
        d = np.eye(4)
        d[:3, :3] = np.asarray(se3.so3_exp(
            jnp.asarray(rng.normal(0, 0.05, 3), jnp.float32)))
        d[:3, 3] = rng.normal(0, 0.2, 3) + [0.5, 0, 0]
        m = m @ d
        poses.append(m.copy())
    return poses


def test_umeyama_recovers_similarity():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(50, 3))
    r_gt = np.asarray(se3.so3_exp(jnp.asarray([0.3, -0.2, 0.5],
                                              jnp.float32)), np.float64)
    s_gt, t_gt = 2.5, np.array([1.0, -2.0, 0.5])
    dst = s_gt * src @ r_gt.T + t_gt
    s, r, t = umeyama_alignment(src, dst)
    assert abs(s - s_gt) < 1e-6
    np.testing.assert_allclose(r, r_gt, atol=1e-6)
    np.testing.assert_allclose(t, t_gt, atol=1e-6)


def test_ate_zero_for_similar_trajectories():
    poses = _random_traj()
    pos = np.stack([p[:3, 3] for p in poses])
    # apply a global similarity: ATE must be ~0
    r = np.asarray(se3.so3_exp(jnp.asarray([0.1, 0.2, -0.3],
                                           jnp.float32)), np.float64)
    warped = 1.7 * pos @ r.T + np.array([3, 4, 5.0])
    assert ate_rmse(warped, pos) < 1e-6
    # with noise: ATE ~ noise scale
    noisy = warped + np.random.default_rng(2).normal(0, 0.05, pos.shape)
    a = ate_rmse(noisy, pos)
    assert 0.01 < a < 0.12


def test_rpe_identity():
    poses = _random_traj()
    t_err, r_err = rpe(poses, poses)
    assert t_err < 1e-12 and r_err < 1e-6


def test_positions_from_rt():
    rng = np.random.default_rng(3)
    r = np.asarray(se3.so3_exp(jnp.asarray(rng.normal(0, 0.3, (5, 3)),
                                           jnp.float32)), np.float64)
    c_gt = rng.normal(size=(5, 3))
    t = -np.einsum("nij,nj->ni", r, c_gt)
    np.testing.assert_allclose(positions_from_rt(r, t), c_gt, atol=1e-6)


def test_tum_roundtrip(tmp_path):
    poses = _random_traj(10)
    ts = np.arange(10) * 0.1
    p = str(tmp_path / "traj.txt")
    write_tum_trajectory(p, ts, poses)
    ts2, poses2 = read_tum_trajectory(p)
    np.testing.assert_allclose(ts2, ts, atol=1e-6)
    for a, b in zip(poses, poses2):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_kitti_roundtrip(tmp_path):
    poses = _random_traj(10, seed=4)
    p = str(tmp_path / "00.txt")
    write_kitti_trajectory(p, poses)
    poses2 = read_kitti_trajectory(p)
    for a, b in zip(poses, poses2):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_associate():
    ts_a = np.array([0.0, 0.1, 0.2, 0.3])
    ts_b = np.array([0.005, 0.11, 0.32, 1.0])
    pairs = associate_timestamps(ts_a, ts_b, max_dt=0.025)
    assert (0, 0) in pairs and (1, 1) in pairs and (3, 2) in pairs
    assert all(abs(ts_a[i] - ts_b[j]) <= 0.025 for i, j in pairs)
