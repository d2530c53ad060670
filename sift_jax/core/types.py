"""Core data model: fixed-capacity masked keypoint SoA and the static plan.

Equivalent capability to the reference's device data model
(``KeypointCollections``, /root/reference/sift_cuda/types/KeyPoint.cuh:9-33;
``SiftData``, types/SiftData.cuh:26-39) re-designed for XLA: instead of
prefix-sum compaction with device-side dynamic counts, every keypoint array
has a *static* capacity and a ``valid`` mask.  Counts live on device as
``valid.sum()`` and never round-trip to the host mid-pipeline (the reference's
pinned-memory readback, interface/Detector.cu:542-559, has no jit-idiomatic
equivalent and is deliberately absent).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import jax.numpy as jnp

from sift_jax.config import SiftConfig
from sift_jax.core import gaussian as g


class Keypoints(NamedTuple):
    """Fixed-capacity SoA keypoint store (cap = leading dim of every field).

    Mirrors the reference's float3 kpt + float4 feature packing
    (sift_func/SiftOps.cu:200-207) but unpacked into named fields:
      x, y      — coordinates in *original image* space (float)
      layer     — integer DoG layer index within the octave
      octave    — octave index (>= 0; -1 means the upscaled base octave when
                  the caller treats octave 0 of an upscaled pyramid as -1)
      xi        — sub-pixel layer offset from refinement (for octave packing)
      size      — keypoint diameter in original-image pixels
      response  — |contrast|
      angle     — orientation in degrees, [0, 360)
      valid     — liveness mask (the compaction mask)
    """

    x: jnp.ndarray
    y: jnp.ndarray
    layer: jnp.ndarray
    octave: jnp.ndarray
    xi: jnp.ndarray
    size: jnp.ndarray
    response: jnp.ndarray
    angle: jnp.ndarray
    valid: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)

    @staticmethod
    def empty(cap: int) -> "Keypoints":
        zf = jnp.zeros((cap,), jnp.float32)
        zi = jnp.zeros((cap,), jnp.int32)
        return Keypoints(x=zf, y=zf, layer=zi, octave=zi, xi=zf, size=zf,
                         response=zf, angle=zf,
                         valid=jnp.zeros((cap,), bool))

    def packed_octave(self) -> jnp.ndarray:
        """Reference/OpenCV octave packing (SiftOps.cu:204):
        octave | (layer << 8) | (round((xi + 0.5) * 255) << 16).
        Negative octaves wrap into the low byte (two's complement & 255)."""
        oct_byte = jnp.where(self.octave < 0, self.octave + 256, self.octave)
        xi_byte = jnp.clip(jnp.round((self.xi + 0.5) * 255.0), 0, 255)
        return (oct_byte.astype(jnp.int32)
                + (self.layer.astype(jnp.int32) << 8)
                + (xi_byte.astype(jnp.int32) << 16))


class SiftResult(NamedTuple):
    """Final per-frame output: keypoints + 128-D descriptors, capacity =
    ``num_features`` (reference result buffers, interface/Detector.hh:54-62)."""

    keypoints: Keypoints
    descriptors: jnp.ndarray  # [num_features, 128] float
    count: jnp.ndarray        # scalar int32 (== keypoints.count())
    # Pre-orientation-expansion keypoint count (after the first global
    # compaction).  Capacity-tier saturation must test BOTH counts: the
    # keypoint-stage compaction can saturate while zero-peak keypoints
    # keep the final count below the tier.
    raw_count: jnp.ndarray = np.int32(0)


@dataclasses.dataclass(frozen=True)
class OctavePlan:
    """Static geometry + capacities for one octave."""

    index: int
    height: int
    width: int
    cand_cap: int   # capacity for raw extrema candidates
    kpt_cap: int    # capacity after refinement / orientation expansion


@dataclasses.dataclass(frozen=True)
class SiftPlan:
    """Everything static the jitted pipeline closes over.

    Host-built (numpy) analogue of the reference's
    ``gpuWarmUpAndAllocate`` memory plan (interface/Detector.cu:17-131):
    octave shapes, per-layer blur operators, resize operators, capacities.
    """

    config: SiftConfig
    octaves: Tuple[OctavePlan, ...]
    # Per-octave [L+3, H, H] / [L+3, W, W] composed blur operators mapping the
    # octave *base* (layer 0) to every layer directly (f32).
    blur_v: Tuple[np.ndarray, ...]
    blur_h: Tuple[np.ndarray, ...]
    # Base-image blur operators (initial sigma_diff) for base H/W.
    init_v: np.ndarray
    init_h: np.ndarray
    # Upscale (2x) operators, only when config.upscale.
    up_v: Any
    up_h: Any
    # Per-octave downsample operators: octave o base = Dv @ prev_layer_L @ Dh.T
    down_v: Tuple[np.ndarray, ...]
    down_h: Tuple[np.ndarray, ...]
    # Composed carry operators (resize ∘ blur-to-layer-L): octave o base
    # directly from octave o-1 base — one [h_o, h_{o-1}] matmul per side.
    carry_v: Tuple[np.ndarray, ...]
    carry_h: Tuple[np.ndarray, ...]
    # 1-D kernels kept for the "conv" blur implementation and for golden
    # checkpoints (reference keeps them in SiftData, types/SiftData.cuh:28).
    kernels_1d: Tuple[np.ndarray, ...]
    init_kernel_1d: np.ndarray
    # Band-blocked per-octave blur operators (gaussian.banded_blocks_multi)
    # for the padded-layout pyramid (ops/blur.blur_tiled): per octave
    # ((vblocks, voffs), (hblocks, hoffs)).  Output layout: content rows
    # at [8, 8 + h), lanes [0, w), total rows/cols from the block grids.
    tiled_v: Tuple[tuple, ...] = ()
    tiled_h: Tuple[tuple, ...] = ()
    # Band-blocked init blur ((vblocks, voffs), (hblocks, hoffs)) and
    # per-octave carry operators (None for octave 0).  The dense init /
    # carry matmuls are O(n^2 w) — ~18 GFLOP at 1920x1200; banded they are
    # O(n * band * w).  (Carry bands have slope 2 — output row r reads
    # input ~2r — which banded_blocks_multi's per-tile nonzero scan
    # handles naturally.)
    init_tiled: tuple = ()
    carry_tiled: Tuple[Any, ...] = ()


def _octave_dims(cfg: SiftConfig) -> List[Tuple[int, int]]:
    """Per-octave (H, W).  "bilinear" mode round-halves from the base
    (interface/Detector.cu:80-86 uses round(init / 2^oct); the in-graph
    resize halves the previous octave with roundf(prev/2),
    Detector.cu:282-291 — identical results for positive dims).
    "nearest" mode floor-halves (OpenCV buildGaussianPyramid: size/2)."""
    dims = []
    h, w = cfg.base_height, cfg.base_width
    for o in range(cfg.num_octaves):
        if o > 0:
            if cfg.downsample == "nearest":
                h, w = h // 2, w // 2
            else:
                h, w = int(round(h / 2.0)), int(round(w / 2.0))
        h, w = max(h, 1), max(w, 1)
        dims.append((h, w))
    return dims


def _candidate_capacity(cfg: SiftConfig, h: int, w: int, layers: int) -> int:
    """Heuristic replacing the reference's min(x*y, numFeatures*10)
    (types/KeyPoint.cu:13, interface/Detector.cu:108-109) with something
    top_k-friendly: real images produce far fewer raw extrema than pixels."""
    if cfg.max_candidates_per_octave is not None:
        cap = cfg.max_candidates_per_octave
    else:
        # Calibrated against measured worst cases: heavy fractal texture at
        # 752x480 yields 948 octave-0 extrema; //384 gives ~3x headroom
        # (2820) while keeping the refinement stage's static work bounded.
        cap = max(512, min(h * w * layers // 384, 2 * cfg.num_features))
    return int(min(cap, h * w * layers))


def build_plan(cfg: SiftConfig) -> SiftPlan:
    sigmas = g.sigma_schedule(cfg.sigma, cfg.num_octave_layers)
    nL = cfg.num_gauss_layers
    dims = _octave_dims(cfg)

    octaves = []
    blur_v, blur_h, down_v, down_h = [], [], [], []
    carry_v, carry_h = [], []
    carry64 = [None]   # per-octave f64 (cv, ch) for band-blocking; o=0 none
    acc64_v, acc64_h = [], []  # float64 composed blur chains for carry fold
    for o, (h, w) in enumerate(dims):
        cand = _candidate_capacity(cfg, h, w, cfg.num_dog_layers - 2)
        kpt = int(min(max(128, cand), cfg.num_features))
        octaves.append(OctavePlan(index=o, height=h, width=w,
                                  cand_cap=cand, kpt_cap=kpt))
        # Composed operators: layer i = (B_i ... B_1) @ base.  Products are
        # taken in float64; the result applies the *exact* sequential
        # reflect-101 blur chain as a single matmul per layer.
        vs = np.empty((nL, h, h), np.float32)
        hs = np.empty((nL, w, w), np.float32)
        accv = np.eye(h, dtype=np.float64)
        acch = np.eye(w, dtype=np.float64)
        vs[0], hs[0] = accv.astype(np.float32), acch.astype(np.float32)
        accs_v, accs_h = [accv], [acch]
        for i in range(1, nL):
            k = g.gaussian_kernel_1d(float(sigmas[i]), cfg.kernel_truncate)
            accv = g.blur_operator(h, k, np.float64) @ accv
            acch = g.blur_operator(w, k, np.float64) @ acch
            vs[i], hs[i] = accv.astype(np.float32), acch.astype(np.float32)
            accs_v.append(accv)
            accs_h.append(acch)
        acc64_v.append(accs_v)
        acc64_h.append(accs_h)
        blur_v.append(vs)
        blur_h.append(hs)
        if o > 0:
            ph, pw = dims[o - 1]
            if cfg.downsample == "nearest":
                dv = g.decimation_operator(h, ph)
                dh = g.decimation_operator(w, pw)
            else:
                dv = g.resize_operator(h, ph)
                dh = g.resize_operator(w, pw)
            down_v.append(dv)
            down_h.append(dh)
            # carry: this octave's base from the previous octave's base,
            # folding resize and blur-to-layer-L into one operator per side
            # (≙ the resize at interface/Detector.cu:282-291).
            L = cfg.num_octave_layers
            cv64 = dv.astype(np.float64) @ acc64_v[o - 1][L]
            ch64 = dh.astype(np.float64) @ acc64_h[o - 1][L]
            carry_v.append(cv64.astype(np.float32))
            carry_h.append(ch64.astype(np.float32))
            carry64.append((cv64, ch64))
        else:
            down_v.append(np.eye(h, dtype=np.float32))
            down_h.append(np.eye(w, dtype=np.float32))
            carry_v.append(np.eye(h, dtype=np.float32))
            carry_h.append(np.eye(w, dtype=np.float32))

    sd = g.initial_sigma_diff(cfg.sigma, cfg.upscale)
    init_k = g.gaussian_kernel_1d(sd, cfg.kernel_truncate)
    bh, bw = dims[0]
    init_v = g.blur_operator(bh, init_k)
    init_h = g.blur_operator(bw, init_k)
    if cfg.upscale:
        up_v = g.resize_operator(bh, cfg.height)
        up_h = g.resize_operator(bw, cfg.width)
    else:
        up_v = up_h = None

    kernels_1d = tuple(
        g.gaussian_kernel_1d(float(s), cfg.kernel_truncate,
                             np.float32) for s in sigmas)

    # Band-blocked operators for the padded-layout tiled pyramid.
    # Row grid covers the padded octave layout (ops/pyramid.py:
    # ceil(h/32)*32 + 16 rows, content at row 8) in 128-row/col tiles.
    from sift_jax.ops.pyramid import HALO as _DH, TILE_ROWS as _DT
    tiled_v, tiled_h = [], []
    for o, (h, w) in enumerate(dims):
        need = _DT * (-(-h // _DT)) + 2 * _DH
        hv = 128 * (-(-need // 128))
        wp = 128 * (-(-max(w, 128) // 128))
        tiled_v.append(g.banded_blocks_multi(acc64_v[o], 128, 8, hv))
        tiled_h.append(g.banded_blocks_multi(acc64_h[o], 128, 0, wp))

    def _band_pair(v64, h64):
        rows = 128 * (-(-v64.shape[0] // 128))
        cols = 128 * (-(-h64.shape[0] // 128))
        return (g.banded_blocks_multi([v64], 128, 0, rows),
                g.banded_blocks_multi([h64], 128, 0, cols))

    init_tiled = _band_pair(g.blur_operator(bh, init_k, np.float64),
                            g.blur_operator(bw, init_k, np.float64))
    carry_tiled = tuple(None if c is None else _band_pair(*c)
                        for c in carry64)

    return SiftPlan(config=cfg, octaves=tuple(octaves),
                    blur_v=tuple(blur_v), blur_h=tuple(blur_h),
                    init_v=init_v, init_h=init_h, up_v=up_v, up_h=up_h,
                    down_v=tuple(down_v), down_h=tuple(down_h),
                    carry_v=tuple(carry_v), carry_h=tuple(carry_h),
                    kernels_1d=kernels_1d,
                    init_kernel_1d=init_k.astype(np.float32),
                    tiled_v=tuple(tiled_v), tiled_h=tuple(tiled_h),
                    init_tiled=init_tiled, carry_tiled=carry_tiled)
