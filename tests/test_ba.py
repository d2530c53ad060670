"""Bundle adjustment on synthetic problems with known ground truth."""
import numpy as np
import jax
import jax.numpy as jnp

from sift_jax.geometry import se3
from sift_jax.geometry.ba import lm_optimize, lm_step, _mean_cost
from sift_jax.perf.scenes import synthetic_ba


def test_ba_converges_noiseless():
    prob, rots_gt, trs_gt, pts_gt = synthetic_ba()
    c0 = float(_mean_cost(prob, prob.rotations, prob.translations,
                          prob.points))
    assert c0 > 1.0  # perturbed start has pixels of error
    out = jax.jit(lambda p: lm_optimize(p, iterations=15))(prob)
    c1 = float(out.cost)
    assert c1 < 1e-4, f"cost {c0} -> {c1}"
    # camera poses recovered (gauge = cam0 fixed, scene scale held by
    # fixing cam0 only — compare rotations which are scale-free)
    for c in range(len(rots_gt)):
        dr = np.asarray(se3.so3_log(
            jnp.asarray(rots_gt[c].T, jnp.float32) @ out.rotations[c]))
        assert np.linalg.norm(dr) < 2e-3, (c, dr)


def test_ba_noise_floor():
    prob, *_ = synthetic_ba(noise_px=0.5, seed=1)
    out = jax.jit(lambda p: lm_optimize(p, iterations=15))(prob)
    # converges to approximately the noise variance (0.5^2 = 0.25 per
    # axis -> mean squared residual over both axes ~ 0.25)
    assert float(out.cost) < 0.6


def test_ba_respects_valid_mask():
    prob, *_ = synthetic_ba(seed=2)
    # corrupt half the observations but mask them out
    n = prob.uv.shape[0]
    bad = np.zeros(n, bool)
    bad[::2] = True
    uv = np.asarray(prob.uv).copy()
    uv[bad] += 500.0
    prob2 = prob._replace(uv=jnp.asarray(uv),
                          valid=jnp.asarray(~bad))
    out = jax.jit(lambda p: lm_optimize(p, iterations=15))(prob2)
    assert float(out.cost) < 1e-4


def test_ba_fixed_first_camera():
    prob, rots_gt, trs_gt, _ = synthetic_ba(seed=3)
    out = lm_optimize(prob, iterations=8)
    np.testing.assert_allclose(np.asarray(out.rotations[0]), rots_gt[0],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.translations[0]), trs_gt[0],
                               atol=1e-6)


def test_cg_schur_matches_dense_f64():
    """solve_schur_cg is the SAME operator as the dense Schur solve: in
    f64 (where the U - A V^-1 A^T cancellation is benign) the two steps
    agree to ~1e-10.  In f32 both are conditioning-limited and LM's
    accept/reject absorbs the difference (gated separately by the
    convergence tests)."""
    from sift_jax.geometry.ba import solve_schur_cg

    prob, *_ = synthetic_ba(seed=0, n_cams=5, n_pts=96)
    jax.config.update("jax_enable_x64", True)
    try:
        p64 = jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, prob)
        lam = jnp.asarray(1e-4, jnp.float64)
        dc_d, dp_d = lm_step(p64, lam)
        dc_c, dp_c = solve_schur_cg(p64, lam, cg_iters=40)
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(np.asarray(dc_c), np.asarray(dc_d),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(dp_c), np.asarray(dp_d),
                               atol=1e-7)
