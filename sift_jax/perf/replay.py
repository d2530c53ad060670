"""Per-stage golden-checkpoint replay + verification.

Equivalent capability to the reference's ``HostInterface`` seven ``run*``
functions (/root/reference/sift_cuda/interface/HostInterface.{hh,cu}) and
``tool/perf.cu``: each function re-executes exactly one pipeline stage on
deserialized inputs and compares against the golden output — simultaneously
a regression test and an isolated per-stage benchmark target (the
reference feeds these into ncu, perf.cu:17-19; here each stage is one small
jitted XLA program for `jax.profiler`).

Comparison contract mirrors the reference: exact-ish (tiny float tolerance)
for images, exact for candidate indices/masks, tolerance for descriptors
(±1 in the reference's half space, HostInterface.cu:369-376; ±1 of 255
here against the quantized output).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import jax.numpy as jnp

from sift_jax.config import SIFT_IMG_BORDER
from sift_jax.core.types import build_plan
from sift_jax.ops import compact as C
from sift_jax.ops import descriptor as D
from sift_jax.ops import orientation as O
from sift_jax.ops.peaks import find_candidates
from sift_jax.ops.pyramid import gaussian_pyramid
from sift_jax.ops.refine import refine_keypoints

from sift_jax.perf.checkpoint import config_from_params


def _close(a, b, atol) -> Tuple[bool, float]:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False, float("inf")
    if a.dtype == bool or b.dtype == bool:
        err = float(np.logical_xor(a, b).sum())
    else:
        err = float(np.abs(a - b).max()) if a.size else 0.0
    return err <= atol, err


class Replayer:
    """Loads a golden checkpoint and exposes one verify function per stage
    (≙ HostInterface::runFilter/runResize/runMinus/runFindPeaks/
    runAdjustPts/runOrientationHist/runDescriptor)."""

    def __init__(self, params: Dict, inputs: Dict, expected: Dict):
        self.cfg = config_from_params(params)
        self.plan = build_plan(self.cfg)
        self.inp = inputs
        self.exp = expected

    # -- stage 1: base blur + per-octave blur chain (runFilter) --
    def run_filter(self):
        gauss = gaussian_pyramid(self.plan, jnp.asarray(self.inp["image"]))
        ok, err = _close(gauss[0], self.exp["gauss0"], 1e-2)
        return ok, {"max_err": err}

    # -- stage 2: octave downsample (runResize) --
    def run_resize(self):
        if len(self.plan.octaves) < 2:
            return True, {"skipped": "single octave"}
        gauss = gaussian_pyramid(self.plan, jnp.asarray(self.inp["image"]))
        ok, err = _close(gauss[1][0], self.exp["resized1"], 1e-2)
        return ok, {"max_err": err}

    # -- stage 3: DoG subtraction (runMinus) --
    def run_minus(self):
        g0 = jnp.asarray(self.inp["gauss0"])
        dog = g0[1:] - g0[:-1]
        ok, err = _close(dog, self.exp["dog0"], 1e-4)
        return ok, {"max_err": err}

    # -- stage 4: extrema detection (runFindPeaks) --
    def run_find_peaks(self):
        dog = jnp.asarray(self.inp["dog0"])
        cap = self.plan.octaves[0].cand_cap
        cx, cy, clyr, cval = find_candidates(
            dog, self.cfg.peak_threshold, SIFT_IMG_BORDER, cap)
        ok_v, _ = _close(cval, self.exp["cand_valid"], 0)
        m = np.asarray(cval)
        ok_x, _ = _close(np.asarray(cx)[m], self.exp["cand_x"][m], 0)
        ok_y, _ = _close(np.asarray(cy)[m], self.exp["cand_y"][m], 0)
        ok_l, _ = _close(np.asarray(clyr)[m], self.exp["cand_layer"][m], 0)
        n = int(m.sum())
        return ok_v and ok_x and ok_y and ok_l, {"count": n}

    # -- stage 5: refinement (runAdjustPts) --
    def run_adjust_pts(self):
        dog = jnp.asarray(self.inp["dog0"])
        ref = refine_keypoints(
            dog, jnp.asarray(self.inp["cand_x"]),
            jnp.asarray(self.inp["cand_y"]),
            jnp.asarray(self.inp["cand_layer"]),
            jnp.asarray(self.inp["cand_valid"]), 0, self.cfg)
        ok_v, _ = _close(ref.valid, self.exp["ref_valid"], 0)
        m = np.asarray(ref.valid)
        ok_x, ex = _close(np.asarray(ref.x)[m], self.exp["ref_x"][m], 1e-3)
        ok_y, ey = _close(np.asarray(ref.y)[m], self.exp["ref_y"][m], 1e-3)
        ok_s, es = _close(np.asarray(ref.size)[m],
                          self.exp["ref_size"][m], 1e-3)
        return ok_v and ok_x and ok_y and ok_s, \
            {"count": int(m.sum()), "max_err": max(ex, ey, es)}

    # -- stage 6: orientation (runOrientationHist) --
    def run_orientation_hist(self):
        gauss = jnp.asarray(self.inp["gauss0"])
        dog = jnp.asarray(self.inp["dog0"])
        block = gauss if self.cfg.orientation_source == "gaussian" else dog
        ref = refine_keypoints(
            dog, jnp.asarray(self.inp["cand_x"]),
            jnp.asarray(self.inp["cand_y"]),
            jnp.asarray(self.inp["cand_layer"]),
            jnp.asarray(self.inp["cand_valid"]), 0, self.cfg)
        idx, val = C.stream_compact(ref.valid, self.plan.octaves[0].kpt_cap)
        kx, ky = jnp.take(ref.x, idx), jnp.take(ref.y, idx)
        klyr, ksize = jnp.take(ref.layer, idx), jnp.take(ref.size, idx)
        hist = O.orientation_histograms(block, kx, ky, klyr, ksize, val,
                                        0, self.cfg)
        angles, peaks = O.orientation_peaks(hist, val, self.cfg)
        ok_h, eh = _close(hist, self.exp["hist"], 1e-2)
        ok_p, _ = _close(peaks, self.exp["peaks"], 0)
        ok_a, ea = _close(np.asarray(angles)[np.asarray(peaks)],
                          self.exp["angles"][self.exp["peaks"]], 1e-3)
        return ok_h and ok_p and ok_a, {"hist_err": eh, "angle_err": ea}

    # -- stage 7: descriptor (runDescriptor) --
    def run_descriptor(self):
        gauss = jnp.asarray(self.inp["gauss0"])
        desc, nrm2 = D.compute_descriptors(
            gauss, jnp.asarray(self.inp["kpt_x"]),
            jnp.asarray(self.inp["kpt_y"]),
            jnp.asarray(self.inp["kpt_layer"]),
            jnp.asarray(self.inp["kpt_size"]),
            jnp.asarray(self.inp["kpt_angle"]),
            jnp.asarray(self.inp["kpt_valid"]), 0, self.cfg)
        q = D.quantize_descriptor(desc, nrm2, "opencv")
        q = jnp.where(jnp.asarray(self.inp["kpt_valid"])[:, None], q, 0.0)
        # ±1 quantization-step tolerance (≙ HostInterface.cu:369-376).
        ok, err = _close(q, self.exp["descriptor"], 1.0)
        return ok, {"max_err": err}

    ALL = ("filter", "resize", "minus", "find_peaks", "adjust_pts",
           "orientation_hist", "descriptor")

    def run_all(self):
        results = {}
        for name in self.ALL:
            ok, info = getattr(self, f"run_{name}")()
            results[name] = (bool(ok), info)
        return results
