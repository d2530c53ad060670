"""CLI: two-view (or short-sequence) metric reconstruction — the SfM flow
on top of the feature pipeline (new capability; BASELINE configs #4/#5).

detect+compute per frame -> ratio-test matching -> vectorized RANSAC on
the essential matrix -> pose recovery + triangulation -> bundle adjustment.

Usage: python -m sift_jax.tools.reconstruct IMG1 IMG2 [IMG...]
       [--fx F] [--fy F] [--cx X] [--cy Y] [--num-features 2000]
       [--ba-iters 10] [--distributed]
Intrinsics default to fx=fy=0.9*max(W,H), principal point at the center.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("images", nargs="+", help="two or more same-size images")
    p.add_argument("--fx", type=float, default=None)
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--num-features", type=int, default=2000)
    p.add_argument("--ba-iters", type=int, default=10)
    p.add_argument("--ransac-iters", type=int, default=256)
    p.add_argument("--distributed", action="store_true",
                   help="run BA with observations sharded over all devices")
    args = p.parse_args(argv)
    if len(args.images) < 2:
        raise SystemExit("need at least two images")

    import numpy as np
    import jax
    import jax.numpy as jnp

    from sift_jax.config import SiftConfig
    from sift_jax.geometry import se3
    from sift_jax.geometry.ba import BAProblem, lm_optimize
    from sift_jax.geometry.twoview import (pixels_to_normalized,
                                           ransac_essential)
    from sift_jax.io.image import load_grayscale
    from sift_jax.pipeline.detector import SiftDetector
    from sift_jax.pipeline.matcher import match_pairs

    frames = [load_grayscale(f) for f in args.images]
    h, w = frames[0].shape
    fx = args.fx or 0.9 * max(w, h)
    fy = args.fy or fx
    cx = args.cx if args.cx is not None else w / 2
    cy = args.cy if args.cy is not None else h / 2

    det = SiftDetector(SiftConfig(width=w, height=h,
                                  num_features=args.num_features))
    results = [det.detect_and_compute(f) for f in frames]
    for i, r in enumerate(results):
        print(f"frame {i}: {int(r.count)} keypoints")

    # Pairwise sequential reconstruction: frame 0 is the world frame.
    rots = [np.eye(3, dtype=np.float32)]
    trs = [np.zeros(3, np.float32)]
    cam_idx, pt_idx, uvs = [], [], []
    n_points = 0
    all_points = []
    for i in range(1, len(frames)):
        a, b = results[i - 1], results[i]
        qi, ti = match_pairs(b.descriptors, a.descriptors,
                             b.keypoints.valid, a.keypoints.valid)
        print(f"pair ({i - 1}, {i}): {len(qi)} ratio-test matches")
        pa = np.stack([np.asarray(a.keypoints.x)[ti],
                       np.asarray(a.keypoints.y)[ti]], -1)
        pb = np.stack([np.asarray(b.keypoints.x)[qi],
                       np.asarray(b.keypoints.y)[qi]], -1)
        na = pixels_to_normalized(jnp.asarray(pa), fx, fy, cx, cy)
        nb = pixels_to_normalized(jnp.asarray(pb), fx, fy, cx, cy)
        valid = jnp.ones(na.shape[0], bool)
        res = ransac_essential(na, nb, valid, jax.random.key(i),
                               n_hypotheses=args.ransac_iters)
        n_inl = int(res.num_inliers)
        print(f"  essential RANSAC: {n_inl} inliers; "
              f"t = {np.round(np.asarray(res.translation), 3)}")

        # compose into world frame: pose_i = rel ∘ pose_{i-1}
        r_w = np.asarray(res.rotation) @ rots[i - 1]
        t_w = np.asarray(res.rotation) @ trs[i - 1] \
            + np.asarray(res.translation)
        rots.append(r_w.astype(np.float32))
        trs.append(t_w.astype(np.float32))

        # triangulated points (camera i-1 frame) -> world.  Gate on
        # cheirality + depth range + reprojection error so degenerate
        # matches (no-parallax pairs, mismatches) never reach BA.
        pts_all = np.asarray(res.points3d)
        z1 = pts_all[:, 2]
        pc2 = pts_all @ np.asarray(res.rotation).T \
            + np.asarray(res.translation)
        proj1 = pts_all[:, :2] / np.maximum(z1[:, None], 1e-9)
        proj2 = pc2[:, :2] / np.maximum(pc2[:, 2:], 1e-9)
        e1 = np.linalg.norm(proj1 - np.asarray(na), axis=-1) * fx
        e2 = np.linalg.norm(proj2 - np.asarray(nb), axis=-1) * fx
        inl = (np.asarray(res.inliers) & (z1 > 0.1) & (z1 < 1e3)
               & (pc2[:, 2] > 0.1) & (e1 < 2.0) & (e2 < 2.0))
        print(f"  triangulation gate: {int(inl.sum())} of "
              f"{int(np.asarray(res.inliers).sum())} inliers kept")
        pts_c = pts_all[inl]
        r_prev_inv, t_prev_inv = se3.inverse(
            jnp.asarray(rots[i - 1]), jnp.asarray(trs[i - 1]))
        pts_w = np.asarray(se3.transform(r_prev_inv, t_prev_inv,
                                         jnp.asarray(pts_c)))
        ids = np.arange(n_points, n_points + len(pts_w))
        n_points += len(pts_w)
        all_points.append(pts_w)
        cam_idx += [i - 1] * len(ids) + [i] * len(ids)
        pt_idx += list(ids) * 2
        uvs.append(pa[inl])
        uvs.append(pb[inl])

    points = np.concatenate(all_points).astype(np.float32)
    uv = np.concatenate(uvs).astype(np.float32)
    prob = BAProblem(
        rotations=jnp.asarray(np.stack(rots)),
        translations=jnp.asarray(np.stack(trs)),
        points=jnp.asarray(points),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        pt_idx=jnp.asarray(pt_idx, jnp.int32),
        uv=jnp.asarray(uv),
        valid=jnp.ones(len(cam_idx), bool),
        fx=jnp.float32(fx), fy=jnp.float32(fy),
        cx=jnp.float32(cx), cy=jnp.float32(cy))

    from sift_jax.geometry.ba import _mean_cost
    c0 = float(_mean_cost(prob, prob.rotations, prob.translations,
                          prob.points))
    if args.distributed:
        from sift_jax.parallel.batched import make_mesh
        from sift_jax.parallel.dba import make_distributed_lm

        mesh = make_mesh()
        fn, place = make_distributed_lm(mesh, iterations=args.ba_iters)
        out = fn(place(prob))
        mode = f"distributed over {mesh.devices.size} devices"
    else:
        out = jax.jit(lambda q: lm_optimize(q, args.ba_iters))(prob)
        mode = "single device"
    print(f"BA ({mode}): mean sq reproj {c0:.4f} -> {float(out.cost):.4f} "
          f"px^2 over {len(cam_idx)} observations, {n_points} points")
    for i in range(len(frames)):
        ang = np.linalg.norm(np.asarray(se3.so3_log(out.rotations[i])))
        print(f"pose {i}: |rot| {np.degrees(ang):.2f} deg, "
              f"t {np.round(np.asarray(out.translations[i]), 4)}")


if __name__ == "__main__":
    main()
