"""Golden-checkpoint capture — stage-boundary state dumps for replay/verify.

Equivalent capability to the reference's serialization sidecar
(/root/reference/sift_cuda/perf/*: msgpack+zlib ``saveCompressed``/
``loadCompressed``, Serialization.hpp:10-93; capture hooks
interface/Detector.cu:145-228) re-expressed as compressed npz with the same
three-file contract: ``params`` (config), ``input`` (stage inputs for
octave 0), ``expected`` (stage outputs for octave 0).

Captured stages mirror the seven ``HostInterface::run*`` targets
(interface/HostInterface.hh:11-69): filter, resize, minus, find_peaks,
adjust_pts, orientation_hist, descriptor.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import jax.numpy as jnp

from sift_jax.config import SIFT_IMG_BORDER, SiftConfig
from sift_jax.core.types import SiftPlan, build_plan
from sift_jax.ops import compact as C
from sift_jax.ops import descriptor as D
from sift_jax.ops import orientation as O
from sift_jax.ops.peaks import find_candidates
from sift_jax.ops.pyramid import dog_pyramid, gaussian_pyramid
from sift_jax.ops.refine import refine_keypoints

PARAMS_FILE = "params.npz"
INPUT_FILE = "input.npz"
EXPECTED_FILE = "expected.npz"


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _staged_capture(plan: SiftPlan, img: jnp.ndarray) -> Dict:
    """All stage-boundary intermediates for octave 0, as one traceable
    computation (compiled once — each eager op would otherwise be its own
    program)."""
    cfg = plan.config
    op = plan.octaves[0]

    gauss = gaussian_pyramid(plan, img)
    dogs = dog_pyramid(gauss)

    cx, cy, clyr, cval = find_candidates(
        dogs[0], cfg.peak_threshold, SIFT_IMG_BORDER, op.cand_cap)
    ref = refine_keypoints(dogs[0], cx, cy, clyr, cval, 0, cfg)
    idx, val = C.stream_compact(ref.valid, op.kpt_cap)
    kx, ky = jnp.take(ref.x, idx), jnp.take(ref.y, idx)
    klyr = jnp.take(ref.layer, idx)
    ksize = jnp.take(ref.size, idx)

    ori_block = gauss[0] if cfg.orientation_source == "gaussian" else dogs[0]
    hist = O.orientation_histograms(ori_block, kx, ky, klyr, ksize, val,
                                    0, cfg)
    angles, peaks = O.orientation_peaks(hist, val, cfg)
    eidx, evalid = C.stream_compact(peaks.reshape(-1), op.kpt_cap)
    src = eidx // angles.shape[1]
    ox = jnp.take(kx, src)
    oy = jnp.take(ky, src)
    olyr = jnp.take(klyr, src)
    osize = jnp.take(ksize, src)
    oang = jnp.take(angles.reshape(-1), eidx)

    desc, nrm2 = D.compute_descriptors(gauss[0], ox, oy, olyr, osize, oang,
                                       evalid, 0, cfg)
    desc_q = D.quantize_descriptor(desc, nrm2, "opencv")
    desc_q = jnp.where(evalid[:, None], desc_q, 0.0)
    return dict(
        gauss0=gauss[0],
        gauss1=gauss[1] if len(gauss) > 1 else jnp.zeros(1),
        dog0=dogs[0], cx=cx, cy=cy, clyr=clyr, cval=cval, ref=ref,
        hist=hist, angles=angles, peaks=peaks,
        ox=ox, oy=oy, olyr=olyr, osize=osize, oang=oang, evalid=evalid,
        desc_q=desc_q)


def capture_golden(cfg: SiftConfig, image: np.ndarray, path: str) -> Dict:
    """Run the pipeline once on ``image``, recording octave-0 inputs and
    outputs of every stage (≙ Detector::setDataGen + one detectAndCompute,
    Detector.hh:46-51).  Writes params/input/expected npz files to ``path``.
    """
    import functools

    import jax

    os.makedirs(path, exist_ok=True)
    plan = build_plan(cfg)
    img = jnp.asarray(image, jnp.float32)
    s = jax.jit(functools.partial(_staged_capture, plan))(img)
    (gauss0, gauss1, dog0, cx, cy, clyr, cval, ref, hist, angles, peaks,
     ox, oy, olyr, osize, oang, evalid, desc_q) = (
        s["gauss0"], s["gauss1"], s["dog0"], s["cx"], s["cy"], s["clyr"],
        s["cval"], s["ref"], s["hist"], s["angles"], s["peaks"], s["ox"],
        s["oy"], s["olyr"], s["osize"], s["oang"], s["evalid"], s["desc_q"])

    np.savez_compressed(
        os.path.join(path, PARAMS_FILE),
        width=cfg.width, height=cfg.height,
        num_features=cfg.num_features,
        num_octave_layers=cfg.num_octave_layers,
        contrast_threshold=cfg.contrast_threshold,
        edge_threshold=cfg.edge_threshold, sigma=cfg.sigma,
        upscale=cfg.upscale, kernel_truncate=cfg.kernel_truncate,
        downsample=cfg.downsample,
        orientation_source=cfg.orientation_source,
        subpixel=cfg.subpixel,
        interpolate_orientation=cfg.interpolate_orientation)

    inputs = {
        "image": image.astype(np.float32),
        "init_kernel": plan.init_kernel_1d,
        "kernels": np.concatenate([k for k in plan.kernels_1d]),
        "kernel_sizes": np.array([len(k) for k in plan.kernels_1d]),
        "gauss0": np.asarray(gauss0),
        "gauss1": np.asarray(gauss1),
        "dog0": np.asarray(dog0),
        "cand_x": np.asarray(cx), "cand_y": np.asarray(cy),
        "cand_layer": np.asarray(clyr), "cand_valid": np.asarray(cval),
        "kpt_x": np.asarray(ox), "kpt_y": np.asarray(oy),
        "kpt_layer": np.asarray(olyr), "kpt_size": np.asarray(osize),
        "kpt_angle": np.asarray(oang), "kpt_valid": np.asarray(evalid),
    }
    np.savez_compressed(os.path.join(path, INPUT_FILE), **inputs)

    expected = {
        "gauss0": np.asarray(gauss0),
        "resized1": np.asarray(gauss1[0]) if gauss1.ndim == 3
        else np.zeros(1),
        "dog0": np.asarray(dog0),
        "cand_x": np.asarray(cx), "cand_y": np.asarray(cy),
        "cand_layer": np.asarray(clyr), "cand_valid": np.asarray(cval),
        "ref_x": np.asarray(ref.x), "ref_y": np.asarray(ref.y),
        "ref_layer": np.asarray(ref.layer), "ref_xi": np.asarray(ref.xi),
        "ref_size": np.asarray(ref.size),
        "ref_response": np.asarray(ref.response),
        "ref_valid": np.asarray(ref.valid),
        "hist": np.asarray(hist),
        "angles": np.asarray(angles), "peaks": np.asarray(peaks),
        "descriptor": np.asarray(desc_q),
        "desc_valid": np.asarray(evalid),
    }
    np.savez_compressed(os.path.join(path, EXPECTED_FILE), **expected)
    return {"input": inputs, "expected": expected}


def load_golden(path: str):
    """Load the checkpoint triple (≙ loadCompressed, Serialization.hpp:46-93
    + perf.cu:31-36)."""
    # allow_pickle stays False: the params file holds only scalar/str
    # arrays, and checkpoint directories may come from untrusted sources.
    params = dict(np.load(os.path.join(path, PARAMS_FILE),
                          allow_pickle=False))
    inputs = dict(np.load(os.path.join(path, INPUT_FILE)))
    expected = dict(np.load(os.path.join(path, EXPECTED_FILE)))
    return params, inputs, expected


def save_ba_state(path: str, state, iteration: int) -> None:
    """Checkpoint a (replicated) BAState mid-LM for elastic recovery of
    the distributed layer: atomic write (tmp + rename) so a worker dying
    mid-save never leaves a torn checkpoint."""
    import jax

    arrs = {k: np.asarray(jax.device_get(v))
            for k, v in state._asdict().items()}
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, iteration=np.int64(iteration), **arrs)
    os.replace(tmp, path)


def load_ba_state(path: str):
    """Returns (BAState of host arrays, iteration) — None if no
    checkpoint exists (fresh start)."""
    from sift_jax.geometry.ba import BAState

    if not os.path.exists(path):
        return None, 0
    d = dict(np.load(path, allow_pickle=False))
    it = int(d.pop("iteration"))
    return BAState(**{k: d[k] for k in BAState._fields}), it


def config_from_params(params) -> SiftConfig:
    def val(k):
        v = params[k]
        return v.item() if hasattr(v, "item") else v

    return SiftConfig(
        width=int(val("width")), height=int(val("height")),
        num_features=int(val("num_features")),
        num_octave_layers=int(val("num_octave_layers")),
        contrast_threshold=float(val("contrast_threshold")),
        edge_threshold=float(val("edge_threshold")),
        sigma=float(val("sigma")), upscale=bool(val("upscale")),
        kernel_truncate=float(val("kernel_truncate")),
        downsample=str(val("downsample")),
        orientation_source=str(val("orientation_source")),
        subpixel=bool(val("subpixel")),
        interpolate_orientation=bool(val("interpolate_orientation")))
