"""Monocular visual odometry: landmark tracking with PnP pose estimation.

New capability (BASELINE configs #4/#5: pose estimation on sequences,
ATE-gated).  Architecture (standard feature-based VO, built on the device
pipeline):

* bootstrap: first pair -> vectorized essential-matrix RANSAC with
  manifold-GN polish (twoview.py), unit-scale triangulation seeds the map;
* tracking: every later frame matches to the previous frame; matches whose
  previous keypoint carries a landmark give 3D-2D pairs -> robust
  Gauss-Newton PnP from the previous pose (pnp.py).  Pose AND metric scale
  come from the map — no fragile per-pair scale chaining;
* mapping: matches without landmarks are triangulated with the PnP pose
  (depth/reprojection gated) and added to the map;
* optional sliding-window BA over recent frames (geometry/ba.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from sift_jax.config import SiftConfig
from sift_jax.core.types import Keypoints, SiftResult
from sift_jax.geometry import se3
from sift_jax.geometry.ba import BAProblem, lm_optimize
from sift_jax.geometry.pnp import pnp_gn
from sift_jax.geometry.twoview import (pixels_to_normalized,
                                       ransac_essential, triangulate)
from sift_jax.pipeline.detector import SiftDetector
from sift_jax.pipeline.matcher import match_pairs


class OdometryResult:
    def __init__(self):
        self.rotations: List[np.ndarray] = []     # world->camera
        self.translations: List[np.ndarray] = []
        self.n_matches: List[int] = []
        self.n_inliers: List[int] = []            # PnP/essential inliers
        self.modes: List[str] = []                # init/pnp/bootstrap/fallback

    def poses_cam_to_world(self) -> List[np.ndarray]:
        out = []
        for r, t in zip(self.rotations, self.translations):
            m = np.eye(4)
            m[:3, :3] = r.T
            m[:3, 3] = -r.T @ t
            out.append(m)
        return out

    def positions(self) -> np.ndarray:
        return np.stack([-r.T @ t for r, t in
                         zip(self.rotations, self.translations)])


def _res_to_dict(d: dict, prefix: str, res) -> None:
    for name, val in zip(Keypoints._fields, res.keypoints):
        d[f"{prefix}_kp_{name}"] = np.asarray(val)
    d[f"{prefix}_descriptors"] = np.asarray(res.descriptors)
    d[f"{prefix}_count"] = np.asarray(res.count)
    d[f"{prefix}_raw_count"] = np.asarray(res.raw_count)


def _res_from_dict(d: dict, prefix: str):
    kps = Keypoints(*[jnp.asarray(d[f"{prefix}_kp_{n}"])
                      for n in Keypoints._fields])
    return SiftResult(keypoints=kps,
                      descriptors=jnp.asarray(d[f"{prefix}_descriptors"]),
                      count=jnp.asarray(d[f"{prefix}_count"]),
                      raw_count=jnp.asarray(d[f"{prefix}_raw_count"]))


class MonocularOdometry:
    def __init__(self, config: SiftConfig, fx: float, fy: float,
                 cx: float, cy: float, ratio: float = 0.8,
                 ransac_iters: int = 512,
                 ransac_threshold: Optional[float] = None,
                 min_pnp_points: int = 12, pnp_threshold_px: float = 3.0,
                 max_depth: float = 1e3, min_depth: float = 1e-2,
                 triangulation_err_px: float = 2.0,
                 ba_interval: int = 0, ba_window: int = 5, seed: int = 0,
                 tiers: tuple = (), loop_closure: bool = False,
                 kf_interval: int = 4, loop_min_gap: int = 8,
                 loop_min_matches: int = 25, loop_min_inliers: int = 20,
                 loop_edge_weight: float = 5.0,
                 loop_max_candidates: int = 8, telemetry=None):
        from sift_jax.perf.telemetry import get as _tel_get
        self.telemetry = _tel_get(telemetry)
        self.detector = SiftDetector(config, tiers=tiers)
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.ratio = ratio
        self.ransac_iters = ransac_iters
        # Squared Sampson threshold in normalized coords: ~0.75 px.
        self.ransac_threshold = ransac_threshold if ransac_threshold \
            is not None else (0.75 / fx) ** 2
        self.min_pnp_points = min_pnp_points
        self.pnp_threshold_px = pnp_threshold_px
        self.max_depth = max_depth
        self.min_depth = min_depth
        self.triangulation_err_px = triangulation_err_px
        self.ba_interval = ba_interval
        self.ba_window = ba_window
        self._key = jax.random.key(seed)
        self.result = OdometryResult()
        self._prev = None                 # previous frame's SiftResult
        # landmark map: previous-frame keypoint index -> landmark id
        self._prev_lms: Dict[int, int] = {}
        self._points: List[np.ndarray] = []   # landmark world positions
        self._obs = []                    # (frame, landmark, uv) for BA
        # loop closure
        self.loop_closure = loop_closure
        self.kf_interval = kf_interval
        self.loop_min_gap = loop_min_gap
        self.loop_min_matches = loop_min_matches
        self.loop_min_inliers = loop_min_inliers
        self.loop_edge_weight = loop_edge_weight
        self.loop_max_candidates = loop_max_candidates
        self._keyframes = []      # (fidx, SiftResult, {kpt_idx: landmark})
        # Per-keyframe global descriptor signature (normalized mean
        # descriptor) for the O(1)-per-keyframe loop-closure pre-filter.
        self._kf_sigs: List[np.ndarray] = []
        self.closures: List[tuple] = []   # (kf_fidx, fidx, n_inliers)

    def _split_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    # ------------------------------------------------------------------

    def process(self, frame: np.ndarray) -> np.ndarray:
        """Returns the 4x4 cam-to-world pose of this frame."""
        res = self.detector.detect_and_compute(frame)
        out = self.result
        if self._prev is None:
            out.rotations.append(np.eye(3, dtype=np.float32))
            out.translations.append(np.zeros(3, np.float32))
            out.n_matches.append(0)
            out.n_inliers.append(0)
            out.modes.append("init")
            self._prev = res
            return self._pose_mat(-1)

        a, b = self._prev, res
        qi, ti = match_pairs(b.descriptors, a.descriptors,
                             b.keypoints.valid, a.keypoints.valid,
                             ratio=self.ratio)
        pa = np.stack([np.asarray(a.keypoints.x)[ti],
                       np.asarray(a.keypoints.y)[ti]], -1) \
            if len(qi) else np.zeros((0, 2), np.float32)
        pb = np.stack([np.asarray(b.keypoints.x)[qi],
                       np.asarray(b.keypoints.y)[qi]], -1) \
            if len(qi) else np.zeros((0, 2), np.float32)

        # 3D-2D pairs through existing landmarks.
        lm_rows = [k for k in range(len(qi))
                   if int(ti[k]) in self._prev_lms]
        fidx = len(out.rotations)

        if len(lm_rows) >= self.min_pnp_points:
            ok = self._track_pnp(qi, ti, pb, lm_rows, fidx)
            mode = "pnp"
        else:
            ok = False
        if not ok:
            ok = self._bootstrap(qi, ti, pa, pb, fidx)
            mode = "bootstrap"
        if not ok:
            self._append_fallback()
            out.n_matches.append(len(qi))
            out.n_inliers.append(0)
            out.modes.append("fallback")
            self._prev_lms = {}
        else:
            out.n_matches.append(len(qi))
            out.modes.append(mode)
        self._prev = res

        if self.ba_interval and ok and fidx % self.ba_interval == 0 \
                and fidx >= 2:
            self._run_window_ba(fidx)
        if self.loop_closure and ok:
            if fidx % self.kf_interval == 0 and self._prev_lms:
                self._keyframes.append((fidx, res, dict(self._prev_lms)))
                self._kf_sigs.append(self._signature(res))
            self._try_loop_closure(res, fidx)
        self.telemetry.emit(
            "frame", frame=fidx, mode=out.modes[-1],
            keypoints=int(res.count), matches=out.n_matches[-1],
            inliers=out.n_inliers[-1], landmarks=len(self._points),
            keyframes=len(self._keyframes), closures=len(self.closures))
        self.telemetry.count("frames")
        self.telemetry.count("mode_" + out.modes[-1])
        return self._pose_mat(-1)

    # ------------------------------------------------------------------

    def _track_pnp(self, qi, ti, pb, lm_rows, fidx) -> bool:
        out = self.result
        pts_w = np.stack([self._points[self._prev_lms[int(ti[k])]]
                          for k in lm_rows])
        uv = pb[lm_rows]
        r, t, inl, err = pnp_gn(
            jnp.asarray(pts_w, jnp.float32), jnp.asarray(uv, jnp.float32),
            jnp.ones(len(lm_rows), bool),
            self.fx, self.fy, self.cx, self.cy,
            jnp.asarray(out.rotations[-1]),
            jnp.asarray(out.translations[-1]),
            threshold_px=self.pnp_threshold_px)
        n_inl = int(inl.sum())
        if n_inl < self.min_pnp_points:
            return False
        r_w = np.asarray(r, np.float32)
        t_w = np.asarray(t, np.float32)
        if not (np.isfinite(r_w).all() and np.isfinite(t_w).all()):
            # Degenerate geometry (e.g. the scene left the view): a NaN
            # pose would poison every subsequent frame through the
            # constant-velocity fallback.
            return False
        out.rotations.append(r_w)
        out.translations.append(t_w)
        out.n_inliers.append(n_inl)

        # carry landmark associations + PnP observations
        new_lms: Dict[int, int] = {}
        inl_np = np.asarray(inl)
        for j, k in enumerate(lm_rows):
            if inl_np[j]:
                lm = self._prev_lms[int(ti[k])]
                new_lms[int(qi[k])] = lm
                self._obs.append((fidx, lm, uv[j]))
        self._triangulate_new(qi, ti, pb, fidx, new_lms, set(lm_rows))
        self._prev_lms = new_lms
        return True

    def _bootstrap(self, qi, ti, pa, pb, fidx) -> bool:
        """Two-view initialization (first pair, or re-init after a track
        loss): essential RANSAC + unit-scale triangulation."""
        out = self.result
        if len(qi) < 16:
            return False
        na = pixels_to_normalized(jnp.asarray(pa, jnp.float32),
                                  self.fx, self.fy, self.cx, self.cy)
        nb = pixels_to_normalized(jnp.asarray(pb, jnp.float32),
                                  self.fx, self.fy, self.cx, self.cy)
        tv = ransac_essential(na, nb, jnp.ones(len(qi), bool),
                              self._split_key(),
                              n_hypotheses=self.ransac_iters,
                              threshold=self.ransac_threshold)
        n_inl = int(tv.num_inliers)
        if n_inl < self.min_pnp_points:
            return False
        prev_r = out.rotations[-1]
        prev_t = out.translations[-1]
        r_rel = np.asarray(tv.rotation)
        t_rel = np.asarray(tv.translation)
        r_w = (r_rel @ prev_r).astype(np.float32)
        t_w = (r_rel @ prev_t + t_rel).astype(np.float32)
        if not (np.isfinite(r_w).all() and np.isfinite(t_w).all()):
            return False
        out.rotations.append(r_w)
        out.translations.append(t_w)
        out.n_inliers.append(n_inl)

        # triangulated points are in the previous camera's frame
        pts_c = np.asarray(tv.points3d)
        pc2 = pts_c @ r_rel.T + t_rel
        inl = np.asarray(tv.inliers) & (pts_c[:, 2] > self.min_depth) \
            & (pts_c[:, 2] < self.max_depth) & (pc2[:, 2] > self.min_depth)
        ra_inv, ta_inv = se3.inverse(jnp.asarray(prev_r),
                                     jnp.asarray(prev_t))
        pts_w = np.asarray(se3.transform(ra_inv, ta_inv,
                                         jnp.asarray(pts_c, jnp.float32)))
        new_lms: Dict[int, int] = {}
        for k in np.nonzero(inl)[0]:
            lm = len(self._points)
            self._points.append(pts_w[k].astype(np.float32))
            self._obs.append((fidx - 1, lm, pa[k]))
            self._obs.append((fidx, lm, pb[k]))
            new_lms[int(qi[k])] = lm
        self._prev_lms = new_lms
        return True

    def _triangulate_new(self, qi, ti, pb, fidx, new_lms, used_rows):
        """Triangulate landmark-less matches with the last two poses."""
        out = self.result
        rows = [k for k in range(len(qi)) if k not in used_rows]
        if not rows:
            return
        a = self._prev
        pa = np.stack([np.asarray(a.keypoints.x)[ti[rows]],
                       np.asarray(a.keypoints.y)[ti[rows]]], -1)
        pbn = pb[rows]
        r_a = out.rotations[-2]
        t_a = out.translations[-2]
        r_b = out.rotations[-1]
        t_b = out.translations[-1]
        r_rel = r_b @ r_a.T
        t_rel = t_b - r_rel @ t_a
        na = pixels_to_normalized(jnp.asarray(pa, jnp.float32),
                                  self.fx, self.fy, self.cx, self.cy)
        nb = pixels_to_normalized(jnp.asarray(pbn, jnp.float32),
                                  self.fx, self.fy, self.cx, self.cy)
        pts_c = np.asarray(triangulate(
            jnp.asarray(r_rel, jnp.float32), jnp.asarray(t_rel, jnp.float32),
            na, nb))
        z1 = pts_c[:, 2]
        pc2 = pts_c @ r_rel.T + t_rel
        e1 = np.linalg.norm(pts_c[:, :2] / np.maximum(z1[:, None], 1e-9)
                            - np.asarray(na), axis=-1) * self.fx
        e2 = np.linalg.norm(pc2[:, :2] / np.maximum(pc2[:, 2:], 1e-9)
                            - np.asarray(nb), axis=-1) * self.fx
        good = ((z1 > self.min_depth) & (z1 < self.max_depth)
                & (pc2[:, 2] > self.min_depth)
                & (e1 < self.triangulation_err_px)
                & (e2 < self.triangulation_err_px))
        ra_inv, ta_inv = se3.inverse(jnp.asarray(r_a), jnp.asarray(t_a))
        pts_w = np.asarray(se3.transform(ra_inv, ta_inv,
                                         jnp.asarray(pts_c, jnp.float32)))
        for j in np.nonzero(good)[0]:
            k = rows[j]
            lm = len(self._points)
            self._points.append(pts_w[j].astype(np.float32))
            self._obs.append((fidx - 1, lm, pa[j]))
            self._obs.append((fidx, lm, pbn[j]))
            new_lms[int(qi[k])] = lm

    # ------------------------------------------------------------------
    # Checkpoint / resume (failure recovery for the SfM layer: a process
    # can die anywhere and a replacement resumes BIT-IDENTICAL tracking
    # from the last checkpoint — pose chain, landmark map, observations,
    # keyframes, match state and the RANSAC PRNG stream are all state).

    def save_state(self, path: str) -> None:
        """Serialize the full tracking state to one npz file."""
        out = self.result
        d = {
            "rotations": (np.stack(out.rotations).astype(np.float32)
                          if out.rotations else np.zeros((0, 3, 3),
                                                         np.float32)),
            "translations": (np.stack(out.translations).astype(np.float32)
                             if out.translations else np.zeros((0, 3),
                                                               np.float32)),
            "n_matches": np.asarray(out.n_matches, np.int32),
            "n_inliers": np.asarray(out.n_inliers, np.int32),
            "modes": np.asarray(out.modes),
            "points": (np.stack(self._points).astype(np.float32)
                       if self._points else np.zeros((0, 3), np.float32)),
            "obs_frame": np.asarray([f for f, _, _ in self._obs],
                                    np.int32),
            "obs_lm": np.asarray([l for _, l, _ in self._obs], np.int32),
            "obs_uv": (np.stack([uv for _, _, uv in self._obs])
                       .astype(np.float32) if self._obs
                       else np.zeros((0, 2), np.float32)),
            "prev_lms_k": np.asarray(list(self._prev_lms.keys()),
                                     np.int32),
            "prev_lms_v": np.asarray(list(self._prev_lms.values()),
                                     np.int32),
            "rng_key": np.asarray(jax.random.key_data(self._key)),
            "closures": np.asarray(self.closures, np.int32).reshape(-1, 3),
            "kf_fidx": np.asarray([f for f, _, _ in self._keyframes],
                                  np.int32),
            "kf_sigs": (np.stack(self._kf_sigs).astype(np.float32)
                        if self._kf_sigs else np.zeros((0, 128),
                                                       np.float32)),
            "has_prev": np.asarray(self._prev is not None),
        }
        if self._prev is not None:
            _res_to_dict(d, "prev", self._prev)
        for i, (_, res, lms) in enumerate(self._keyframes):
            _res_to_dict(d, f"kf{i}", res)
            d[f"kf{i}_lms_k"] = np.asarray(list(lms.keys()), np.int32)
            d[f"kf{i}_lms_v"] = np.asarray(list(lms.values()), np.int32)
        np.savez_compressed(path, **d)

    def load_state(self, path: str) -> None:
        """Restore a save_state checkpoint; subsequent process() calls
        continue bit-identically to an uninterrupted run."""
        d = dict(np.load(path, allow_pickle=False))
        out = self.result = OdometryResult()
        out.rotations = [r for r in d["rotations"]]
        out.translations = [t for t in d["translations"]]
        out.n_matches = [int(v) for v in d["n_matches"]]
        out.n_inliers = [int(v) for v in d["n_inliers"]]
        out.modes = [str(m) for m in d["modes"]]
        self._points = [p for p in d["points"]]
        self._obs = [(int(f), int(l), uv) for f, l, uv in
                     zip(d["obs_frame"], d["obs_lm"], d["obs_uv"])]
        self._prev_lms = {int(k): int(v) for k, v in
                          zip(d["prev_lms_k"], d["prev_lms_v"])}
        self._key = jax.random.wrap_key_data(jnp.asarray(d["rng_key"]))
        self.closures = [tuple(int(v) for v in row)
                         for row in d["closures"]]
        self._kf_sigs = [s for s in d["kf_sigs"]]
        self._prev = _res_from_dict(d, "prev") if bool(d["has_prev"]) \
            else None
        self._keyframes = []
        for i, fidx in enumerate(d["kf_fidx"]):
            lms = {int(k): int(v) for k, v in
                   zip(d[f"kf{i}_lms_k"], d[f"kf{i}_lms_v"])}
            self._keyframes.append(
                (int(fidx), _res_from_dict(d, f"kf{i}"), lms))

    def _try_loop_closure(self, res, fidx: int):
        """Relocalization-style closure: match the current frame against
        old keyframes; landmarks seen from the keyframe give METRIC 3D-2D
        pairs -> PnP -> an absolute corrected pose; a high-weight pose-
        graph edge then redistributes the drift over the trajectory."""
        from sift_jax.geometry.posegraph import PoseGraph, optimize

        out = self.result
        # Candidate pre-filter: rank eligible keyframes by global-signature
        # similarity (normalized mean descriptor) and run the full matcher
        # on at most ``loop_max_candidates`` of them — bounds per-frame
        # closure cost to O(loop_max_candidates) matcher calls instead of
        # O(keyframes).
        sig = self._signature(res)
        eligible = [i for i, (kf_fidx, _, _) in enumerate(self._keyframes)
                    if fidx - kf_fidx >= self.loop_min_gap]
        if len(eligible) > self.loop_max_candidates:
            sims = np.array([float(sig @ self._kf_sigs[i])
                             for i in eligible])
            order = np.argsort(-sims)[: self.loop_max_candidates]
            eligible = [eligible[int(j)] for j in order]
        best = None
        if not eligible:
            return
        # ONE padded vmapped matcher dispatch for all candidates instead
        # of one host round-trip per keyframe (the round-trip, not the
        # matmul, dominates per-call cost); padding to the static
        # loop_max_candidates keeps a single compiled program.
        import functools

        from sift_jax.pipeline.matcher import match_brute_force

        cc = self.loop_max_candidates
        train = np.stack(
            [np.asarray(self._keyframes[i][1].descriptors)
             for i in eligible]
            + [np.zeros_like(np.asarray(res.descriptors))]
            * (cc - len(eligible)))
        tval = np.stack(
            [np.asarray(self._keyframes[i][1].keypoints.valid)
             for i in eligible]
            + [np.zeros(res.descriptors.shape[0], bool)]
            * (cc - len(eligible)))
        mm = np.asarray(jax.vmap(
            functools.partial(match_brute_force, ratio=self.ratio),
            in_axes=(None, 0, None, 0))(
                res.descriptors, jnp.asarray(train),
                res.keypoints.valid, jnp.asarray(tval)))
        for c, i in enumerate(eligible):
            kf_fidx, kf_res, kf_lms = self._keyframes[i]
            qi = np.nonzero(mm[c] >= 0)[0]
            ti = mm[c][qi]
            rows = [k for k in range(len(qi)) if int(ti[k]) in kf_lms]
            if len(rows) >= self.loop_min_matches and \
                    (best is None or len(rows) > best[0]):
                best = (len(rows), kf_fidx, kf_lms, qi, ti, rows)
        if best is None:
            return
        _, kf_fidx, kf_lms, qi, ti, rows = best
        pts_w = np.stack([self._points[kf_lms[int(ti[k])]] for k in rows])
        uv = np.stack([[np.asarray(res.keypoints.x)[qi[k]],
                        np.asarray(res.keypoints.y)[qi[k]]] for k in rows])
        r, t, inl, err = pnp_gn(
            jnp.asarray(pts_w, jnp.float32), jnp.asarray(uv, jnp.float32),
            jnp.ones(len(rows), bool), self.fx, self.fy, self.cx, self.cy,
            jnp.asarray(out.rotations[-1]),
            jnp.asarray(out.translations[-1]),
            threshold_px=self.pnp_threshold_px)
        n_inl = int(inl.sum())
        if n_inl < self.loop_min_inliers:
            return
        self.closures.append((kf_fidx, fidx, n_inl))
        self.telemetry.emit("loop_closure", frame=fidx,
                            keyframe=kf_fidx, inliers=n_inl)

        # Pose graph over all frames: sequential odometry edges + the
        # closure edge anchoring the corrected current pose to the
        # keyframe (relative measurement from the PnP result).
        n = len(out.rotations)
        g = PoseGraph.empty(n, n + len(self.closures))
        rots = jnp.asarray(np.stack(out.rotations))
        trs = jnp.asarray(np.stack(out.translations))
        ei, ej, rrel, trel, wts = [], [], [], [], []
        for i in range(n - 1):
            ri, tsi = out.rotations[i], out.translations[i]
            rj, tsj = out.rotations[i + 1], out.translations[i + 1]
            rr = rj @ ri.T
            ei.append(i)
            ej.append(i + 1)
            rrel.append(rr)
            trel.append(tsj - rr @ tsi)
            wts.append(1.0)
        r_c = np.asarray(r, np.float32)
        t_c = np.asarray(t, np.float32)
        r_kf = out.rotations[kf_fidx]
        t_kf = out.translations[kf_fidx]
        rr = r_c @ r_kf.T
        ei.append(kf_fidx)
        ej.append(n - 1)
        rrel.append(rr)
        trel.append(t_c - rr @ t_kf)
        wts.append(self.loop_edge_weight)
        pad = g.edge_i.shape[0] - len(ei)
        g = g._replace(
            rotations=rots, translations=trs,
            pose_valid=jnp.ones((n,), bool),
            edge_i=jnp.asarray(ei + [0] * pad, jnp.int32),
            edge_j=jnp.asarray(ej + [0] * pad, jnp.int32),
            rel_rot=jnp.asarray(np.stack(rrel + [np.eye(3,
                dtype=np.float32)] * pad)),
            rel_t=jnp.asarray(np.stack(trel + [np.zeros(3,
                np.float32)] * pad)),
            edge_weight=jnp.asarray(wts + [0.0] * pad, jnp.float32))
        opt = optimize(g, iterations=15)
        for i in range(n):
            out.rotations[i] = np.asarray(opt.rotations[i], np.float32)
            out.translations[i] = np.asarray(opt.translations[i],
                                             np.float32)

    def _append_fallback(self):
        """Constant-velocity fallback when tracking fails."""
        out = self.result
        if len(out.rotations) >= 2:
            r_prev2 = out.rotations[-2]
            t_prev2 = out.translations[-2]
            r_rel = out.rotations[-1] @ r_prev2.T
            t_rel = out.translations[-1] - r_rel @ t_prev2
        else:
            r_rel, t_rel = np.eye(3, dtype=np.float32), np.zeros(3)
        out.rotations.append(
            (r_rel @ out.rotations[-1]).astype(np.float32))
        out.translations.append(
            (r_rel @ out.translations[-1] + t_rel).astype(np.float32))

    def _run_window_ba(self, fidx: int):
        from collections import Counter

        lo = max(0, fidx - self.ba_window + 1)
        frames = list(range(lo, fidx + 1))
        fmap = {f: i for i, f in enumerate(frames)}
        obs = [(f, lm, uv) for (f, lm, uv) in self._obs if f in fmap]
        cnt = Counter(lm for _, lm, _ in obs)
        lms = sorted(lm for lm in cnt if cnt[lm] >= 2)
        if len(lms) < 8 or len(obs) < 24:
            return
        lmap = {lm: i for i, lm in enumerate(lms)}
        obs = [(f, lm, uv) for (f, lm, uv) in obs if lm in lmap]

        out = self.result
        prob = BAProblem(
            rotations=jnp.asarray(np.stack(
                [out.rotations[f] for f in frames])),
            translations=jnp.asarray(np.stack(
                [out.translations[f] for f in frames])),
            points=jnp.asarray(np.stack(
                [self._points[lm] for lm in lms]), jnp.float32),
            cam_idx=jnp.asarray([fmap[f] for f, _, _ in obs], jnp.int32),
            pt_idx=jnp.asarray([lmap[lm] for _, lm, _ in obs], jnp.int32),
            uv=jnp.asarray(np.stack([uv for _, _, uv in obs]),
                           jnp.float32),
            valid=jnp.ones(len(obs), bool),
            fx=jnp.float32(self.fx), fy=jnp.float32(self.fy),
            cx=jnp.float32(self.cx), cy=jnp.float32(self.cy))
        with self.telemetry.timer("window_ba"):
            ba = lm_optimize(prob, iterations=6)
        self.telemetry.emit("window_ba", frame=fidx, cams=len(frames),
                            points=len(lms), obs=len(obs),
                            cost=float(ba.cost))
        rot = np.asarray(ba.rotations)
        tr = np.asarray(ba.translations)
        pts = np.asarray(ba.points)
        if not (np.isfinite(rot).all() and np.isfinite(tr).all()
                and np.isfinite(pts).all()):
            return  # diverged LM: keep the tracked poses
        for f in frames:
            i = fmap[f]
            out.rotations[f] = rot[i]
            out.translations[f] = tr[i]
        for lm in lms:
            self._points[lm] = pts[lmap[lm]]

    @staticmethod
    def _signature(res) -> np.ndarray:
        """Global frame signature: L2-normalized mean of valid
        descriptors.  Cosine similarity between signatures is the
        loop-closure candidate pre-filter (cheap proxy for match count)."""
        d = np.asarray(res.descriptors, np.float32)
        v = np.asarray(res.keypoints.valid)
        m = d[v].mean(axis=0) if v.any() else np.zeros(d.shape[1], np.float32)
        n = np.linalg.norm(m)
        return m / n if n > 0 else m

    def _pose_mat(self, idx: int) -> np.ndarray:
        r = self.result.rotations[idx]
        t = self.result.translations[idx]
        m = np.eye(4)
        m[:3, :3] = r.T
        m[:3, 3] = -r.T @ t
        return m
