"""Distributed BA on the 8-device virtual mesh: must match single-device
LM exactly (the psum-reduced normal equations are the same sums)."""
import numpy as np
import jax
import pytest

from sift_jax.geometry.ba import lm_optimize
from sift_jax.parallel.batched import make_mesh
from sift_jax.parallel.dba import make_distributed_lm
from tests.test_ba import synthetic_ba


def test_distributed_matches_single_device():
    prob, rots_gt, _, _ = synthetic_ba(seed=0, n_cams=5, n_pts=96)
    single = jax.jit(lambda p: lm_optimize(p, iterations=10))(prob)

    mesh = make_mesh(8)
    fn, place = make_distributed_lm(mesh, iterations=10)
    dist = fn(place(prob))

    assert float(dist.cost) < 1e-4
    np.testing.assert_allclose(np.asarray(dist.cost),
                               np.asarray(single.cost), rtol=1e-2,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(dist.rotations),
                               np.asarray(single.rotations), atol=1e-4)


def test_distributed_handles_nondivisible_observations():
    prob, *_ = synthetic_ba(seed=1, n_cams=4, n_pts=37)  # 148 obs % 8 != 0
    mesh = make_mesh(8)
    fn, place = make_distributed_lm(mesh, iterations=8)
    out = fn(place(prob))
    assert float(out.cost) < 1e-4


def test_distributed_cg_solver_converges():
    """solver="cg" (observation-space PCG Schur matvecs, psum-reduced;
    geometry/ba.solve_schur_cg) reaches the dense solver's cost floor on
    the same problem."""
    prob, *_ = synthetic_ba(seed=0, n_cams=5, n_pts=96)
    mesh = make_mesh(8)
    fn, place = make_distributed_lm(mesh, iterations=12, solver="cg")
    out = fn(place(prob))
    assert float(out.cost) < 1e-4


def synthetic_ba_chain(seed=0, n_cams=2000, pts_per_cam=2, window=3,
                       perturb=0.01):
    """Long-trajectory BA: cameras on a line, each observing only nearby
    points (KITTI-like sparsity).  The dense Schur path is infeasible at
    this scale — [P, C, 6, 3] coupling blocks are ~2.3 GB and the
    replicated reduced system [6C, 6C] is 576 MB — which is exactly what
    solver="cg" avoids."""
    import jax.numpy as jnp

    from sift_jax.geometry.ba import BAProblem

    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    n_pts = n_cams * pts_per_cam
    px = (np.arange(n_pts) / pts_per_cam) * 0.05 \
        + rng.normal(0, 0.2, n_pts)
    pts = np.stack([px, rng.uniform(-2, 2, n_pts),
                    rng.uniform(6, 10, n_pts)], -1)
    centers = np.stack([0.05 * np.arange(n_cams),
                        np.zeros(n_cams), np.zeros(n_cams)], -1)
    rots = np.tile(np.eye(3), (n_cams, 1, 1))
    trs = -centers

    cam_idx, pt_idx = [], []
    for c in range(n_cams):
        lo = max(0, (c - window) * pts_per_cam)
        hi = min(n_pts, (c + window + 1) * pts_per_cam)
        for j in range(lo, hi):
            cam_idx.append(c)
            pt_idx.append(j)
    cam_idx = np.asarray(cam_idx, np.int32)
    pt_idx = np.asarray(pt_idx, np.int32)
    pc = np.einsum("oij,oj->oi", rots[cam_idx],
                   pts[pt_idx]) + trs[cam_idx]
    uv = np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                   pc[:, 1] / pc[:, 2] * fy + cy], -1)

    rots_i = rots.copy()
    trs_i = trs + np.concatenate(
        [np.zeros((1, 3)), rng.normal(0, perturb, (n_cams - 1, 3))])
    pts_i = pts + rng.normal(0, perturb, pts.shape)
    prob = BAProblem(
        rotations=jnp.asarray(rots_i, jnp.float32),
        translations=jnp.asarray(trs_i, jnp.float32),
        points=jnp.asarray(pts_i, jnp.float32),
        cam_idx=jnp.asarray(cam_idx), pt_idx=jnp.asarray(pt_idx),
        uv=jnp.asarray(uv, jnp.float32),
        valid=jnp.ones(len(cam_idx), bool),
        fx=jnp.float32(fx), fy=jnp.float32(fy),
        cx=jnp.float32(cx), cy=jnp.float32(cy))
    return prob


@pytest.mark.slow
def test_cg_scales_to_2000_cameras():
    """Map-block-scale BA (round-3 worklist #8): 2000 cameras / 4000
    points / ~28k observations on the 8-device mesh with solver="cg" —
    nothing dense in C is ever materialized.  Gate: an order of
    magnitude cost reduction in 6 LM iterations."""
    from sift_jax.geometry.ba import _mean_cost

    prob = synthetic_ba_chain(n_cams=2000)
    c0 = float(_mean_cost(prob, prob.rotations, prob.translations,
                          prob.points))
    mesh = make_mesh(8)
    fn, place = make_distributed_lm(mesh, iterations=6, solver="cg",
                                    cg_iters=30)
    out = fn(place(prob))
    assert float(out.cost) < c0 / 10, (c0, float(out.cost))


def test_stepper_chunked_resume_bit_identical(tmp_path):
    """Elastic-recovery contract: k chunks of n LM iterations through
    make_lm_stepper — with a save/load_ba_state npz round-trip between
    chunks — equals one uninterrupted run bit-for-bit."""
    from sift_jax.parallel.dba import make_lm_stepper
    from sift_jax.perf.checkpoint import load_ba_state, save_ba_state

    prob, *_ = synthetic_ba(seed=3, n_cams=5, n_pts=96)
    mesh = make_mesh(8)

    init, step, place = make_lm_stepper(mesh, chunk=5)
    placed = place(prob)
    straight = step(placed, step(placed, init(placed)))

    path = str(tmp_path / "ba_ckpt.npz")
    state = step(placed, init(placed))
    save_ba_state(path, state, iteration=5)
    loaded, it = load_ba_state(path)
    assert it == 5
    resumed = step(placed, loaded)

    for k in straight._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(straight, k)),
            np.asarray(getattr(resumed, k)), err_msg=k)
