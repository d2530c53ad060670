"""Two-view geometry: batched 8-point essential/fundamental estimation,
vectorized RANSAC, pose recovery and triangulation.

New capability (BASELINE north star config #4; the reference stops at
descriptor matching).  Design: RANSAC is not a sequential
hypothesize-and-verify loop — ALL hypotheses are solved in one vmapped
batch (stacked 8x9 SVDs) and scored against all correspondences with one
[H, N] fused computation, then argmax.  No data-dependent control flow;
jit/vmap-safe end to end.  OpenCV (findEssentialMat/recoverPose) is the
test oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from sift_jax.geometry import se3
from sift_jax.geometry.se3 import mm


class TwoViewResult(NamedTuple):
    e_matrix: jnp.ndarray   # [3, 3] essential matrix
    rotation: jnp.ndarray   # [3, 3]
    translation: jnp.ndarray  # [3] unit norm
    inliers: jnp.ndarray    # [N] bool
    points3d: jnp.ndarray   # [N, 3] triangulated (in camera-1 frame)
    num_inliers: jnp.ndarray  # scalar int32


def pixels_to_normalized(pts: jnp.ndarray, fx, fy, cx, cy) -> jnp.ndarray:
    """[N, 2] pixels -> normalized camera coordinates."""
    return jnp.stack([(pts[..., 0] - cx) / fx, (pts[..., 1] - cy) / fy], -1)


def _epipolar_system(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """[..., N, 2] point pairs -> [..., N, 9] rows of the epipolar
    constraint x2^T E x1 = 0 (x = (u, v, 1))."""
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    one = jnp.ones_like(u1)
    return jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                      u1, v1, one], -1)


def eight_point(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Least-squares epipolar matrix from [..., N>=8, 2] normalized
    correspondences; returns [..., 3, 3] with essential-matrix singular
    values enforced (1, 1, 0)."""
    a = _epipolar_system(p1, p2)
    # Null vector: right-singular vector of smallest singular value.
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    e = vt[..., -1, :].reshape(*a.shape[:-2], 3, 3)
    u, _, vt2 = jnp.linalg.svd(e)
    s = jnp.asarray([1.0, 1.0, 0.0], e.dtype)
    return mm(u * s[..., None, :], vt2)


def sampson_error(e: jnp.ndarray, p1: jnp.ndarray,
                  p2: jnp.ndarray) -> jnp.ndarray:
    """First-order geometric (Sampson) error, [..., N]."""
    one = jnp.ones_like(p1[..., :1])
    x1 = jnp.concatenate([p1, one], -1)
    x2 = jnp.concatenate([p2, one], -1)
    ex1 = mm(x1, jnp.swapaxes(e, -1, -2))         # E @ x1, batched
    etx2 = mm(x2, e)                              # E^T @ x2
    num = jnp.sum(x2 * ex1, -1) ** 2
    den = (ex1[..., 0] ** 2 + ex1[..., 1] ** 2
           + etx2[..., 0] ** 2 + etx2[..., 1] ** 2)
    return num / jnp.maximum(den, 1e-12)


def _tangent_basis(t):
    """Two unit vectors orthogonal to t (and each other)."""
    helper = jnp.where(jnp.abs(t[0]) < 0.9,
                       jnp.asarray([1.0, 0.0, 0.0], t.dtype),
                       jnp.asarray([0.0, 1.0, 0.0], t.dtype))
    b1 = jnp.cross(t, helper)
    b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-12)
    b2 = jnp.cross(t, b1)
    return b1, b2


def _signed_sampson(e, p1, p2):
    one = jnp.ones_like(p1[..., :1])
    x1 = jnp.concatenate([p1, one], -1)
    x2 = jnp.concatenate([p2, one], -1)
    ex1 = mm(x1, jnp.swapaxes(e, -1, -2))
    etx2 = mm(x2, e)
    num = jnp.sum(x2 * ex1, -1)
    den = (ex1[..., 0] ** 2 + ex1[..., 1] ** 2
           + etx2[..., 0] ** 2 + etx2[..., 1] ** 2)
    return num / jnp.sqrt(jnp.maximum(den, 1e-12))


def refine_essential_gn(r0, t0, p1, p2, valid, threshold,
                        iters: int = 10, damping: float = 1e-8):
    """Gauss-Newton polish ON the essential manifold: 5 DOF (left-rotation
    increment + translation-sphere tangent), robust truncated Sampson loss.

    Unlike least-squares-then-project refits (which optimize a general
    3x3 matrix and can slide off into near-degenerate valleys before the
    rank projection), every iterate here IS an essential matrix — the
    polish cannot leave the manifold, which is what makes small-baseline /
    quasi-degenerate flow fields recoverable.  Fully jittable, fixed
    iteration count.
    """
    def step(carry, _):
        r, t = carry
        b1, b2 = _tangent_basis(t)

        def res_of(params):
            rr = mm(se3.so3_exp(params[:3]), r)
            tt = t + b1 * params[3] + b2 * params[4]
            tt = tt / jnp.maximum(jnp.linalg.norm(tt), 1e-12)
            e = mm(se3.hat(tt), rr)
            return _signed_sampson(e, p1, p2)

        zero = jnp.zeros((5,), p1.dtype)
        r_vec = res_of(zero)
        jac = jax.jacfwd(res_of)(zero)                 # [N, 5]
        w = ((r_vec * r_vec < threshold) & valid).astype(p1.dtype)
        jw = jac * w[:, None]
        h = mm(jw.T, jac) + damping * jnp.eye(5, dtype=p1.dtype)
        g = mm(jw.T, r_vec)
        d = -jnp.linalg.solve(h, g)
        rr = mm(se3.so3_exp(d[:3]), r)
        tt = t + b1 * d[3] + b2 * d[4]
        tt = tt / jnp.maximum(jnp.linalg.norm(tt), 1e-12)
        return (rr, tt), None

    (r, t), _ = jax.lax.scan(step, (r0, t0), None, length=iters)
    return r, t


def ransac_essential(p1: jnp.ndarray, p2: jnp.ndarray, valid: jnp.ndarray,
                     key: jax.Array, n_hypotheses: int = 512,
                     threshold: float = 1e-5,
                     sample_size: int = 16,
                     refit_iters: int = 10) -> TwoViewResult:
    """Vectorized RANSAC over normalized correspondences.

    p1/p2: [N, 2]; valid: [N] bool; threshold on SQUARED Sampson error in
    normalized coords ((px_err / f)^2 scale; the 1e-5 default is ~0.9 px
    at f=288 — callers with a known focal should pass (t_px/f)^2).

    All hypotheses are solved in one vmapped batch of least-squares
    ``sample_size``-point systems and scored against all correspondences
    at once.  Non-minimal sampling matters: with ~0.3 px detection noise
    at small baselines, minimal 8-point fits are so ill-conditioned that
    even all-inlier samples score a fraction of the true consensus
    (measured: median 12 of 137 at 8 points vs 42 at 16).  The top seeds
    are polished in parallel by ``refine_essential_gn`` — Gauss-Newton on
    the essential manifold with a truncated Sampson loss — and the final
    estimate is the polished candidate with the largest consensus.  No
    data-dependent control flow anywhere: one jittable program.
    """
    # Sample correspondences per hypothesis, biased to valid entries
    # (invalid rows get ~zero probability).
    logits = jnp.where(valid, 0.0, -1e9)
    idx = jax.vmap(
        lambda k: jax.random.categorical(k, logits,
                                         shape=(sample_size,)))(
        jax.random.split(key, n_hypotheses))           # [H, S]
    h1 = jnp.take(p1, idx, axis=0)                     # [H, S, 2]
    h2 = jnp.take(p2, idx, axis=0)
    es = eight_point(h1, h2)                           # [H, 3, 3]

    err = sampson_error(es, p1[None], p2[None])        # [H, N]
    inl = (err < threshold) & valid[None]
    scores = jnp.sum(inl, -1)

    # Local optimization from the TOP-M seeds in parallel, selecting by
    # post-polish consensus: pre-polish counts are a noisy ranking —
    # near-degenerate wrong solutions can outscore every raw true-basin
    # hypothesis, but only true-basin seeds grow to the full consensus
    # under a manifold-constrained polish.
    m_seeds = min(24, n_hypotheses)
    _, seed_idx = jax.lax.top_k(scores, m_seeds)

    def polish(seed):
        r0, t0, _ = recover_pose(es[seed], p1, p2, inl[seed])
        r, t = refine_essential_gn(r0, t0, p1, p2, valid, threshold,
                                   iters=refit_iters)
        e = mm(se3.hat(t), r)
        err2 = sampson_error(e, p1, p2)
        inliers = (err2 < threshold) & valid
        return e, inliers, jnp.sum(inliers)

    es_m, inl_m, counts_m = jax.vmap(polish)(seed_idx)
    b = jnp.argmax(counts_m)
    e = es_m[b]
    inliers = inl_m[b]

    r, t, pts3d = recover_pose(e, p1, p2, inliers)
    return TwoViewResult(e_matrix=e, rotation=r, translation=t,
                         inliers=inliers, points3d=pts3d,
                         num_inliers=jnp.sum(inliers).astype(jnp.int32))


def triangulate(r: jnp.ndarray, t: jnp.ndarray, p1: jnp.ndarray,
                p2: jnp.ndarray) -> jnp.ndarray:
    """Linear (DLT) triangulation in camera-1 frame.  Camera 1 is
    [I | 0], camera 2 is [R | t]; p1/p2 normalized coords [..., N, 2].
    Closed-form 4x4 homogeneous solve via SVD, batched."""
    # Projection rows: for P = [I|0]: rows (2) u*P3 - P1, v*P3 - P2.
    n = p1.shape[-2]
    eye = jnp.broadcast_to(jnp.eye(3), (*p1.shape[:-1], 3, 3))

    def rows(proj_r, proj_t, p):
        p3 = jnp.concatenate([proj_r[..., 2, :], proj_t[..., 2:3]], -1)
        p1_ = jnp.concatenate([proj_r[..., 0, :], proj_t[..., 0:1]], -1)
        p2_ = jnp.concatenate([proj_r[..., 1, :], proj_t[..., 1:2]], -1)
        return (p[..., 0:1] * p3 - p1_, p[..., 1:2] * p3 - p2_)

    z = jnp.zeros((*p1.shape[:-1], 3))
    r1a, r1b = rows(eye, z, p1)
    rb = jnp.broadcast_to(r, (*p1.shape[:-1], 3, 3))
    tb = jnp.broadcast_to(t, (*p1.shape[:-1], 3))
    r2a, r2b = rows(rb, tb, p2)
    a = jnp.stack([r1a, r1b, r2a, r2b], -2)           # [..., 4, 4]
    _, _, vt = jnp.linalg.svd(a)
    x = vt[..., -1, :]
    return x[..., :3] / jnp.where(
        jnp.abs(x[..., 3:]) < 1e-12, 1e-12, x[..., 3:])


def recover_pose(e: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray,
                 inliers: jnp.ndarray):
    """Decompose E into the 4 candidate (R, t) and pick the one with the
    most points in front of both cameras (cheirality), vectorized
    (≙ cv2.recoverPose)."""
    u, _, vt = jnp.linalg.svd(e)
    # det(U), det(V) sign fix to keep rotations proper.
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    wmat = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                       e.dtype)
    r1 = mm(mm(u, wmat), vt)
    r2 = mm(mm(u, wmat.T), vt)
    tt = u[:, 2]
    cands = [(r1, tt), (r1, -tt), (r2, tt), (r2, -tt)]

    def score(rc, tc):
        x1 = triangulate(rc, tc, p1, p2)
        z1 = x1[..., 2]
        x2 = se3.transform(rc, tc, x1)
        z2 = x2[..., 2]
        ok = (z1 > 0) & (z2 > 0) & inliers
        return jnp.sum(ok), x1

    scores, pts = zip(*(score(rc, tc) for rc, tc in cands))
    scores = jnp.stack(scores)
    pts = jnp.stack(pts)
    rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    b = jnp.argmax(scores)
    return rs[b], ts[b], pts[b]
