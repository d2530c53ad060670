"""The SIFT pipeline orchestrator — the public detect-and-compute API.

Equivalent capability to the reference's ``Detector``
(/root/reference/sift_cuda/interface/Detector.{hh,cu}):

* ctor + ``gpuWarmUpAndAllocate``  ->  ``SiftDetector(config)`` builds the
  static plan (octave shapes, blur operators, capacities) and traces/compiles
  one XLA program.  Static shapes + jit + XLA's buffer allocator replace the
  explicit preallocation (Detector.cu:17-131); the first call compiles
  (the reference's warm-up/graph-capture contract, doc/faq.md:3).
* ``detectAndCompute``             ->  ``detect_and_compute(image)``; the
  full pipeline is ONE jitted program (the CUDA-graph replay equivalent,
  with zero mid-pipeline host synchronization — the reference's pinned-memory
  count readback, Detector.cu:542-559, does not exist here).
* ``prev_descriptor`` rotation (Detector.cu:136-141) -> kept by the host
  wrapper for sequential matching.

Pipeline shape: detection/refinement run per octave (cheap,
shapes differ per octave), then keypoints of ALL octaves are compacted into
ONE fixed-capacity set and orientation + descriptors run as single global
batched passes over a flattened gradient pyramid (ops/flatpyr.py) — the
expensive per-keypoint work costs one capacity, not one per octave (the
reference instead launches per-octave kernels on round-robin streams,
Detector.cu:555-582).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from sift_jax.config import SiftConfig
from sift_jax.core.types import Keypoints, SiftPlan, SiftResult, build_plan
from sift_jax.ops import compact as C
from sift_jax.ops import descriptor as D
from sift_jax.ops import orientation as O
from sift_jax.ops.flatpyr import (dense_gradients_packed,
                                  dense_gradients_padded, pad_pyramid,
                                  shift_copies)
from sift_jax.ops.pyramid import (dog_pyramid, gaussian_pyramid_padded,
                                  padded_content_views)
from sift_jax.ops.records import (WalkState, candidates_from_records,
                                  detect_records_padded, finalize_walk,
                                  walk_records_positions)


def build_detect_fn(plan: SiftPlan, quant_mode: str = "opencv",
                    kpt_cap: Optional[int] = None):
    """Returns the pure function image [H, W] f32 -> SiftResult.

    ``kpt_cap`` bounds the INTERNAL keypoint capacity of the global
    orientation/descriptor passes (a capacity tier; defaults to
    num_features).  Outputs are always padded to num_features so every
    tier produces identical shapes; if a frame saturates the tier
    (count == kpt_cap) the caller should re-run a larger tier."""
    cfg = plan.config
    kcap = int(kpt_cap or cfg.num_features)

    def detect(image: jnp.ndarray) -> SiftResult:
        # Padded-layout pyramid (content rows at [HALO, HALO+h)): the
        # zero padding is baked into the band-blocked blur operators;
        # all other consumers take lazy content views.
        gp = gaussian_pyramid_padded(plan, image)
        gauss = padded_content_views(plan, gp)

        # Dense detection: ONE record pass per octave (DoG + extrema +
        # Newton records, ops/records.py), per-octave candidate
        # compaction (octave-major order, matching the reference's
        # cross-octave collection order, utils/CudaMemcpyUtils.cu:21-70),
        # then ONE Newton walk over all octaves' candidates.
        recs = [detect_records_padded(gp[o], plan.octaves[o].height,
                                      plan.octaves[o].width, cfg)
                for o in range(cfg.num_octaves)]
        cands = [candidates_from_records(recs[o],
                                         plan.octaves[o].cand_cap)
                 for o in range(cfg.num_octaves)]
        st, rflat = walk_records_positions(recs, cands, cfg)

        # Global compaction: ONE fixed-capacity keypoint set across all
        # octaves (≙ collectKpts per octave + the cross-octave gather).
        # The walk's B/C planes (sub-pixel offsets, response) are only
        # gathered AFTER compaction — kcap rows, not candidate capacity.
        idx, val = C.stream_compact(st.ok, kcap)
        # ONE [N, 6] row-gather instead of 6 scalar [N] gathers.
        stm = jnp.stack([st.l, st.r, st.c, st.ok.astype(jnp.int32),
                         st.octv, st.fi], axis=1)
        stg = jnp.take(stm, idx, axis=0)
        stc = WalkState(l=stg[:, 0], r=stg[:, 1], c=stg[:, 2],
                        ok=stg[:, 3].astype(bool), octv=stg[:, 4],
                        fi=stg[:, 5])
        ref, koct = finalize_walk(rflat, stc, val, cfg)
        kx, ky, klyr, kxi = ref.x, ref.y, ref.layer, ref.xi
        ksize, kresp = ref.size, ref.response

        # Dense gradients once per frame on the padded uniform stack
        # (window gathers need uniform octave shapes); lane-shifted copies
        # shrink per-keypoint windows to 128 lanes.  The descriptor reads
        # a PACKED (mag, ori) slab — one gather per window; orientation
        # keeps the full-precision pair (its 1-degree parity gate is
        # sensitive to quantization).  The 128-lane shifted-copy contract
        # needs patch radius <= 47; legal configs with larger sigma use
        # unshifted 256-lane windows instead of silently dropping
        # patch-edge pixels.
        rmax = max(D.max_descr_radius(cfg), O.max_ori_radius(cfg))
        shift = shift_copies if rmax <= 47 else (lambda p: p)
        padded_gauss = pad_pyramid(gauss)
        gradf = shift(dense_gradients_packed(padded_gauss))
        if cfg.orientation_source == "gaussian":
            o_mag, o_ori = dense_gradients_padded(padded_gauss)
        else:
            # The DoG pyramid exists only for the non-default DoG
            # orientation source.
            o_mag, o_ori = dense_gradients_padded(
                pad_pyramid(dog_pyramid(gauss)))
        o_mag, o_ori = shift(o_mag), shift(o_ori)
        hist = O.orientation_histograms_flat(
            o_mag, o_ori, koct, kx, ky, klyr, ksize, val, cfg)

        angles, peaks = O.orientation_peaks(hist, val, cfg)

        # Expansion: up to 36 oriented copies per keypoint
        # (SiftOps.cu:338-373), flattened and compacted to num_features.
        nb = angles.shape[1]
        eidx, evalid = C.stream_compact(peaks.reshape(-1), kcap)
        src = eidx // nb

        # Packed row-gathers: one f32 and one i32 matrix instead of 7
        # scalar gathers, and the angle
        # comes from a row-gather of [kcap, nb] + a one-hot bin select
        # instead of a scalar gather over the flattened [kcap*nb] array.
        fm = jnp.take(jnp.stack([kx, ky, kxi, ksize, kresp], axis=1),
                      src, axis=0)
        im = jnp.take(jnp.stack([klyr, koct], axis=1), src, axis=0)
        arow = jnp.take(angles, src, axis=0)            # [kcap, nb]
        bsel = (eidx % nb)[:, None] == jnp.arange(nb, dtype=jnp.int32)
        kps = Keypoints(
            x=fm[:, 0], y=fm[:, 1],
            layer=im[:, 0],
            octave=im[:, 1],
            xi=fm[:, 2], size=fm[:, 3],
            response=fm[:, 4],
            angle=jnp.sum(jnp.where(bsel, arow, 0.0), axis=1),
            valid=evalid)

        desc, nrm2 = D.compute_descriptors_flat(
            gradf, kps.octave, kps.x, kps.y, kps.layer, kps.size,
            kps.angle, kps.valid, cfg)
        desc = D.quantize_descriptor(desc, nrm2, quant_mode)
        desc = jnp.where(evalid[:, None], desc, 0.0)
        if quant_mode == "opencv" and cfg.descriptor_dtype == "uint8":
            # Integer-quantized values fit one byte; the matcher's bf16
            # path matches bit-identically (config.descriptor_dtype).
            desc = desc.astype(jnp.uint8)

        if cfg.upscale:
            # OpenCV firstOctave = -1 final adjustment: halve coords/size,
            # octave index shifts down by one.
            kps = kps._replace(x=kps.x * 0.5, y=kps.y * 0.5,
                               size=kps.size * 0.5, octave=kps.octave - 1)
        if kcap < cfg.num_features:
            # Pad tiered outputs to the uniform num_features shape.
            pad = cfg.num_features - kcap

            def padf(a):
                return jnp.concatenate(
                    [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])

            kps = Keypoints(*[padf(f) for f in kps])
            desc = padf(desc)
        return SiftResult(keypoints=kps, descriptors=desc,
                          count=kps.count().astype(jnp.int32),
                          raw_count=jnp.sum(val.astype(jnp.int32)))

    return detect


class SiftDetector:
    """Host-side convenience wrapper (≙ the reference ``Detector`` object).

    Keeps ``prev_descriptors``/``prev_result`` for sequential matching
    (≙ prev_descriptor rotation, Detector.cu:136-141)."""

    def __init__(self, config: SiftConfig, quant_mode: str = "opencv",
                 jit: bool = True, tiers: tuple = ()):
        """``tiers``: optional ascending internal keypoint-capacity tiers
        (e.g. (1024, 2048)).  Tier selection is automatic per frame
        (scaled previous count, with an exact saturation fallback that
        re-runs the full program), and every tier pads its output to
        num_features so downstream shapes never change.  Tiers are off
        by default; no measurement on the current device shows them
        paying for their extra programs yet."""
        self.config = config
        self.plan = build_plan(config)
        wrap = jax.jit if jit else (lambda f: f)
        self._fn = wrap(build_detect_fn(self.plan, quant_mode))
        self.tiers = tuple(int(t) for t in sorted(tiers)
                           if t < config.num_features)
        self._tier_fns = {t: wrap(build_detect_fn(self.plan, quant_mode, t))
                          for t in self.tiers}
        self._last_count: Optional[int] = None
        self.prev_result: Optional[SiftResult] = None  # frame t-1
        self.last_result: Optional[SiftResult] = None  # frame t

    def warm_up(self):
        """Compile every program — full capacity AND all tiers — so no
        frame inside a tracking loop pays a mid-sequence compile
        (≙ gpuWarmUpAndAllocate + graph capture)."""
        img = jnp.zeros((self.config.height, self.config.width), jnp.float32)
        outs = [self._fn(img)] + [fn(img) for fn in self._tier_fns.values()]
        jax.block_until_ready(outs)
        return True

    def _pick_tier(self) -> Optional[int]:
        """Smallest tier with 1.5x headroom over the previous frame's
        count; None = full capacity (also for the first frame)."""
        if self._last_count is None or not self.tiers:
            return None
        need = max(64, int(self._last_count * 1.5))
        for t in self.tiers:
            if t >= need:
                return t
        return None

    def detect_and_compute(self, image) -> SiftResult:
        image = jnp.asarray(image, jnp.float32)
        if image.shape != (self.config.height, self.config.width):
            raise ValueError(
                f"image shape {image.shape} != configured "
                f"{(self.config.height, self.config.width)}")
        tier = self._pick_tier()
        if tier is None:
            result = self._fn(image)
        else:
            result = self._tier_fns[tier](image)
            # Saturated tier -> a compaction may have truncated; re-run at
            # full capacity for exact results.  Both compactions (keypoint
            # stage and post-expansion) run at the tier, so test both
            # counts — the final count alone can sit below the tier while
            # the keypoint-stage compaction truncated.
            if max(int(result.count), int(result.raw_count)) >= tier:
                result = self._fn(image)
        if self.tiers:
            # Host count readback steers the next frame's tier (the only
            # host sync; ≙ the reference's pinned-count sync,
            # Detector.cu:542-559).
            self._last_count = int(result.count)
        self.prev_result = self.last_result
        self.last_result = result
        return result

    @property
    def prev_descriptors(self):
        """Descriptors of the frame before the most recent one
        (≙ Detector::prev_descriptor, Detector.hh:54-62)."""
        return None if self.prev_result is None \
            else self.prev_result.descriptors
