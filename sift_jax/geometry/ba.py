"""Bundle adjustment: Levenberg-Marquardt with Schur-complement reduction,
fully batched.

New capability (BASELINE north star config #5; nothing distributed exists
in the reference, SURVEY.md §2.2).  Design:

* Fixed-capacity observation table (camera_idx, point_idx, uv, valid mask)
  — the same masked static-shape discipline as the keypoint pipeline.
* Analytic Jacobians per observation, batched [O, 2, 6] / [O, 2, 3]
  (vmap over observations; no autodiff tracing of the whole graph).
* Normal equations assembled with segment_sum (no atomics),
  dense per-camera 6x6 and per-point 3x3 blocks.
* Schur complement: eliminate points (3x3 block inverses, batched), solve
  the reduced camera system [6C, 6C] densely — C is small (keyframes);
  the observation/point axis is the large, shardable one.  In the
  distributed version (parallel/dba.py) observations are sharded and the
  reduced-system assembly becomes a psum.

Parameterization: camera i has twist xi in se(3) applied on the left of
(R_i, t_i); world points X_j; intrinsics fixed per problem.  Camera 0 and
the gauge scale are fixed by masking its update.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sift_jax.geometry import se3
from sift_jax.geometry.se3 import ein, mm


class BAProblem(NamedTuple):
    """Static-capacity bundle-adjustment problem."""

    rotations: jnp.ndarray     # [C, 3, 3] world->camera
    translations: jnp.ndarray  # [C, 3]
    points: jnp.ndarray        # [P, 3] world points
    cam_idx: jnp.ndarray       # [O] int32
    pt_idx: jnp.ndarray        # [O] int32
    uv: jnp.ndarray            # [O, 2] observed pixels
    valid: jnp.ndarray         # [O] bool
    fx: jnp.ndarray            # scalar intrinsics
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray


class BAState(NamedTuple):
    rotations: jnp.ndarray
    translations: jnp.ndarray
    points: jnp.ndarray
    cost: jnp.ndarray          # mean squared reprojection error (valid obs)
    lm_lambda: jnp.ndarray


def _project_residual(r, t, x, uv, fx, fy, cx, cy):
    """Residual [2] and Jacobians d_res/d_twist [2, 6], d_res/d_point [2, 3]
    for one observation.  Twist is a left-multiplied increment:
    (R', t') = exp(xi) * (R, t)."""
    pc = mm(r, x) + t
    z = jnp.maximum(pc[2], 1e-6)
    inv_z = 1.0 / z
    u = pc[0] * inv_z * fx + cx
    v = pc[1] * inv_z * fy + cy
    res = jnp.stack([u, v]) - uv

    # d(uv)/d(pc)
    j_proj = jnp.stack([
        jnp.stack([fx * inv_z, 0.0, -fx * pc[0] * inv_z * inv_z]),
        jnp.stack([0.0, fy * inv_z, -fy * pc[1] * inv_z * inv_z]),
    ])                                     # [2, 3]
    # Left-increment: d(pc)/d(v) = I, d(pc)/d(w) = -hat(pc)
    j_cam = jnp.concatenate([j_proj, mm(j_proj, -se3.hat(pc))], -1)  # [2,6]
    j_pt = mm(j_proj, r)                                             # [2,3]
    return res, j_cam, j_pt


def _residuals_and_jacobians(p: BAProblem):
    r = p.rotations[p.cam_idx]
    t = p.translations[p.cam_idx]
    x = p.points[p.pt_idx]
    f = jax.vmap(_project_residual, in_axes=(0, 0, 0, 0, None, None, None,
                                             None))
    res, j_cam, j_pt = f(r, t, x, p.uv, p.fx, p.fy, p.cx, p.cy)
    w = p.valid.astype(res.dtype)[:, None]
    return res * w, j_cam * w[..., None], j_pt * w[..., None]


def _mean_cost(p: BAProblem, rot, tr, pts):
    q = p._replace(rotations=rot, translations=tr, points=pts)
    res, _, _ = _residuals_and_jacobians(q)
    n = jnp.maximum(jnp.sum(p.valid), 1)
    return jnp.sum(res * res) / n


def normal_equation_terms(p: BAProblem):
    """Observation-reduction half of the LM step: everything that is a
    sum over observations.  This is the part that shards across devices in
    the distributed solver (parallel/dba.py psums exactly these five
    arrays); shapes depend only on (C, P), never on the observation count.

    Returns (jtj_c [C,6,6], g_c [C,6], jtj_p [P,3,3], g_p [P,3],
    a_j [P,C,6,3])."""
    nc = p.rotations.shape[0]
    npts = p.points.shape[0]
    res, j_c, j_p = _residuals_and_jacobians(p)

    jtj_c = jax.ops.segment_sum(
        ein("oki,okj->oij", j_c, j_c), p.cam_idx, nc)   # [C, 6, 6]
    g_c = jax.ops.segment_sum(
        ein("oki,ok->oi", j_c, res), p.cam_idx, nc)      # [C, 6]
    jtj_p = jax.ops.segment_sum(
        ein("oki,okj->oij", j_p, j_p), p.pt_idx, npts)   # [P, 3, 3]
    g_p = jax.ops.segment_sum(
        ein("oki,ok->oi", j_p, res), p.pt_idx, npts)     # [P, 3]

    # Camera-point coupling blocks W_{c,j} = sum_{o: cam=c, pt=j} Jc^T Jp,
    # assembled dense over the (small) camera axis per point.
    w_o = ein("oki,okj->oij", j_c, j_p)                  # [O, 6, 3]
    oc = jax.nn.one_hot(p.cam_idx, nc, dtype=res.dtype)         # [O, C]
    a_j = jax.ops.segment_sum(
        ein("oc,oij->ocij", oc, w_o), p.pt_idx, npts)    # [P,C,6,3]
    return jtj_c, g_c, jtj_p, g_p, a_j


def solve_schur(jtj_c, g_c, jtj_p, g_p, a_j, lm_lambda,
                fix_first_cam: bool = True):
    """Replicated half of the LM step: Schur-complement elimination of the
    point blocks and dense solve of the reduced camera system.
    S = U - sum_j A_j V_j^-1 A_j^T;  rhs = g_c - sum_j A_j V_j^-1 g_p_j."""
    nc = jtj_c.shape[0]
    jtj_c = jtj_c + lm_lambda * jnp.eye(6)[None]
    jtj_p = jtj_p + lm_lambda * jnp.eye(3)[None]
    vinv = jnp.linalg.inv(jtj_p)                                # [P, 3, 3]

    av = ein("pcij,pjk->pcik", a_j, vinv)                # [P,C,6,3]
    s_off = ein("pcik,pdjk->cidj", av, a_j)              # [C,6,C,6]
    u_diag = jnp.zeros((nc, 6, nc, 6)).at[
        jnp.arange(nc), :, jnp.arange(nc), :].set(jtj_c)
    s = (u_diag - s_off).reshape(nc * 6, nc * 6)
    rhs = (g_c - ein("pcik,pk->ci", av, g_p)).reshape(-1)

    if fix_first_cam:
        # Gauge fixing: pin camera 0 by zeroing its rows/cols and setting
        # identity on the diagonal.
        mask = jnp.concatenate([jnp.zeros(6), jnp.ones(6 * (nc - 1))])
        s = s * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
        rhs = rhs * mask

    d_cam = -jnp.linalg.solve(s, rhs).reshape(nc, 6)

    # Back-substitute points: dx_j = -V^-1 (g_p_j + A_j^T dcam)
    at_dc = ein("pcij,ci->pj", a_j, d_cam)
    d_pt = -ein("pij,pj->pi", vinv, g_p + at_dc)
    return d_cam, d_pt


def solve_schur_cg(p: BAProblem, lm_lambda, cg_iters: int = 25,
                   fix_first_cam: bool = True, reduce=None):
    """LM step via preconditioned CG on the Schur complement, WITHOUT
    forming the [P, C, 6, 3] coupling blocks or the dense [6C, 6C]
    reduced system — the scalable path for C in the thousands (the dense
    solve_schur replicates a (6C)^2 matrix on every device).

    Every S-matvec is computed in observation space:
        S x = (Jc^T Jc + lam I) x - A V^-1 A^T x
        (A^T x)_j = sum_{o: pt=j} W_o^T x_{cam(o)},   W_o = Jc_o^T Jp_o
        (A y)_c   = sum_{o: cam=c} W_o y_{pt(o)}
    i.e. two segment-sums over the observation table — exactly the axis
    the distributed solver shards, so ``reduce`` (psum over the mesh in
    parallel/dba.py, identity single-device) makes the matvec exact.
    Preconditioner: block-Jacobi with the exact 6x6 diagonal blocks of S
    (exact when each (camera, point) pair is observed at most once).
    Memory: O(O + P + C) vs O(P C) + O(C^2) for the dense path.

    Returns (d_cam [C, 6], d_pt [P, 3]) like solve_schur."""
    red = reduce if reduce is not None else (lambda x: x)
    nc = p.rotations.shape[0]
    npts = p.points.shape[0]
    res, j_c, j_p = _residuals_and_jacobians(p)

    seg = jax.ops.segment_sum
    jtj_c = red(seg(ein("oki,okj->oij", j_c, j_c), p.cam_idx, nc))
    g_c = red(seg(ein("oki,ok->oi", j_c, res), p.cam_idx, nc))
    jtj_p = red(seg(ein("oki,okj->oij", j_p, j_p), p.pt_idx, npts))
    g_p = red(seg(ein("oki,ok->oi", j_p, res), p.pt_idx, npts))

    u = jtj_c + lm_lambda * jnp.eye(6)[None]                    # [C, 6, 6]
    vinv = jnp.linalg.inv(jtj_p + lm_lambda * jnp.eye(3)[None])  # [P, 3, 3]
    w_o = ein("oki,okj->oij", j_c, j_p)                   # [O, 6, 3]

    def a_t(x):                       # A^T x: [C, 6] -> [P, 3]
        t = ein("oij,oi->oj", w_o, x[p.cam_idx])
        return red(seg(t, p.pt_idx, npts))

    def a_(y):                        # A y: [P, 3] -> [C, 6]
        t = ein("oij,oj->oi", w_o, y[p.pt_idx])
        return red(seg(t, p.cam_idx, nc))

    if fix_first_cam:
        gmask = jnp.concatenate([jnp.zeros((1, 6)),
                                 jnp.ones((nc - 1, 6))])
    else:
        gmask = jnp.ones((nc, 6))

    def matvec(x):
        x = x * gmask
        y = ein("pij,pj->pi", vinv, a_t(x))
        return (ein("cij,cj->ci", u, x) - a_(y)) * gmask

    # Exact block-diagonal of S (one obs per (cam, pt) pair):
    # S_cc = U_c - sum_{o: cam=c} W_o V_{pt(o)}^-1 W_o^T.
    wvw = ein("oij,ojk,olk->oil", w_o, vinv[p.pt_idx], w_o)
    m_c = u - red(seg(wvw, p.cam_idx, nc))                       # [C, 6, 6]
    if fix_first_cam:
        m_c = m_c.at[0].set(jnp.eye(6))
    minv = jnp.linalg.inv(m_c)
    prec = lambda r: ein("cij,cj->ci", minv, r)

    rhs = (g_c - a_(ein("pij,pj->pi", vinv, g_p))) * gmask

    def dot(a, b):
        return jnp.sum(a * b)

    def body(_, carry):
        x, r, d, rz = carry
        q = matvec(d)
        dq = dot(d, q)
        alpha = jnp.where(dq > 0, rz / jnp.maximum(dq, 1e-30), 0.0)
        x = x + alpha * d
        r = r - alpha * q
        z = prec(r)
        rz_new = dot(r, z)
        beta = jnp.where(rz > 0, rz_new / jnp.maximum(rz, 1e-30), 0.0)
        return x, r, z + beta * d, rz_new

    x0 = jnp.zeros((nc, 6))
    z0 = prec(rhs)
    x, _, _, _ = jax.lax.fori_loop(
        0, cg_iters, body, (x0, rhs, z0, dot(rhs, z0)))

    d_cam = -x
    d_pt = -ein("pij,pj->pi", vinv, g_p + a_t(d_cam))
    return d_cam, d_pt


def lm_step(p: BAProblem, lm_lambda, fix_first_cam: bool = True):
    """One damped Gauss-Newton (LM) step with Schur elimination of points.
    Returns (d_twist [C,6], d_points [P,3])."""
    terms = normal_equation_terms(p)
    return solve_schur(*terms, lm_lambda, fix_first_cam)


def apply_step(p: BAProblem, d_cam, d_pt):
    dr, dt = se3.se3_exp(d_cam)
    rot = mm(dr, p.rotations)
    tr = mm(dr, p.translations[..., None])[..., 0] + dt
    return rot, tr, p.points + d_pt


def lm_optimize(p: BAProblem, iterations: int = 10,
                init_lambda: float = 1e-4) -> BAState:
    """Full LM loop under jit: accept/reject via lax.cond-free masking."""

    def body(state, _):
        q = p._replace(rotations=state.rotations,
                       translations=state.translations,
                       points=state.points)
        d_cam, d_pt = lm_step(q, state.lm_lambda)
        rot, tr, pts = apply_step(q, d_cam, d_pt)
        new_cost = _mean_cost(p, rot, tr, pts)
        accept = new_cost < state.cost
        lam = jnp.where(accept, state.lm_lambda * 0.5,
                        state.lm_lambda * 4.0)
        lam = jnp.clip(lam, 1e-8, 1e4)
        pick = lambda a, b: jnp.where(accept, a, b)
        nxt = BAState(
            rotations=pick(rot, state.rotations),
            translations=pick(tr, state.translations),
            points=pick(pts, state.points),
            cost=pick(new_cost, state.cost),
            lm_lambda=lam)
        return nxt, new_cost

    init = BAState(rotations=p.rotations, translations=p.translations,
                   points=p.points,
                   cost=_mean_cost(p, p.rotations, p.translations,
                                   p.points),
                   lm_lambda=jnp.asarray(init_lambda))
    out, _ = jax.lax.scan(body, init, None, length=iterations)
    return out
