"""Plane-layout Newton record fields: the dense detection stages
(DoG, extrema, per-pixel quadratic records) as ONE field per octave,
with candidate compaction and the Newton walk reading it.

This is the successor of the (ops/peaks.find_candidates +
ops/refine_dense.refine_keypoints_dense_all) pipeline stage pair:
equivalent capability to the reference's ``findPeaks3D`` +
``adjustExtrema`` + ``collectKpts`` chain
(/root/reference/sift_cuda/image_func/MatOps.cu:92-181,
sift_func/SiftOps.cu:63-235), restructured so the whole dense part is
one elementwise stencil pass per octave (``records_jnp``) whose only
output is the record field itself.

Record packing — built for the walk's scattered gathers: a 5-step walk
over K candidates that read 5 channels a step would move 30K elements.
Three f32 planes per record layer; integer payloads, exact in f32:

    A = flags + 32*(sx+32) + 2048*(sy+32) + 131072*(sl+8)
        flags = conv | div<<1 | edge_ok<<2 | peak<<3 | contrast_ok<<4
        sx/sy = round(x0/x1) clamped to [-32, 31], sl = round(x2)
        clamped to [-8, 7] — everything a walk STEP consumes, one
        element per candidate per step.
    B = round((x0+0.5)*2000) + 2048*round((x1+0.5)*2000)
    C = round((x2+0.5)*1000) + 1024*round(min(|contrast|,1)*8191)
        — sub-pixel offsets and the response value, consumed ONCE at
        the final (converged) position, where |x_i| < 0.5 by the
        convergence test.  contrast_ok is decided in the record pass at
        FULL f32 precision (bit 4 of A), so quantization never moves
        an accept decision; C's payloads only shape output values
        (x/y to 5e-4 px in octave coords, response to 1.2e-4).

The extrema mask rides flags bit 3, so candidates are one compaction
over the A plane.  ``records_jnp`` builds the packing from the shared
record math (ops/refine_dense.record_fields + ops/peaks pooling).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax.numpy as jnp

from sift_jax.config import (SIFT_IMG_BORDER, SIFT_MAX_INTERP_STEPS,
                             SiftConfig)
from sift_jax.ops.compact import stream_compact
from sift_jax.ops.peaks import peak_mask
from sift_jax.ops.pyramid import HALO
from sift_jax.ops.refine_dense import RefinedKeypoints, record_fields

# Step clamps (see module docstring).  The stacked-record walk
# (ops/refine_dense._newton_walk) applies the same clamps so the two
# paths stay decision-identical.
STEP_CLIP_XY = 31
STEP_CLIP_L = 7
_XSCALE = 2000.0     # sub-pixel x0/x1 resolution (1/2000 px)
_SSCALE = 1000.0     # x2 resolution
_CSCALE = 8191.0     # |contrast| resolution


def pack_record_channels(x0, x1, x2, contrast, flags, peak, cok):
    """(x0, x1, x2, |contrast|, flags<=7) + peak/contrast_ok bits ->
    (A, B, C) f32 planes."""
    def clip_step(x, c):
        return jnp.clip(jnp.round(x), -(c + 1), c)

    a = (flags + 8.0 * peak.astype(jnp.float32)
         + 16.0 * cok.astype(jnp.float32)
         + 32.0 * (clip_step(x0, STEP_CLIP_XY) + 32.0)
         + 2048.0 * (clip_step(x1, STEP_CLIP_XY) + 32.0)
         + 131072.0 * (clip_step(x2, STEP_CLIP_L) + 8.0))
    qx0 = jnp.clip(jnp.round((x0 + 0.5) * _XSCALE), 0.0, 2047.0)
    qx1 = jnp.clip(jnp.round((x1 + 0.5) * _XSCALE), 0.0, 2047.0)
    b = qx0 + 2048.0 * qx1
    qx2 = jnp.clip(jnp.round((x2 + 0.5) * _SSCALE), 0.0, 1023.0)
    qc = jnp.clip(jnp.round(contrast * _CSCALE), 0.0, _CSCALE)
    c = qx2 + 1024.0 * qc
    return a, b, c


def _bit(a, k):
    return jnp.mod(jnp.floor(a * (1.0 / (1 << k))), 2.0) > 0.5


def decode_steps(a):
    """A plane -> (conv, div, sx, sy, sl): everything a walk step needs."""
    conv = _bit(a, 0)
    div = _bit(a, 1)
    sx = jnp.mod(jnp.floor(a * (1.0 / 32.0)), 64.0) - 32.0
    sy = jnp.mod(jnp.floor(a * (1.0 / 2048.0)), 64.0) - 32.0
    sl = jnp.mod(jnp.floor(a * (1.0 / 131072.0)), 16.0) - 8.0
    return conv, div, (sx.astype(jnp.int32), sy.astype(jnp.int32),
                       sl.astype(jnp.int32))


def decode_final(a, b, c):
    """(A, B, C) at the final position -> (edge_ok, contrast_ok,
    x0, x1, x2, response)."""
    edge = _bit(a, 2)
    cok = _bit(a, 4)
    x0 = jnp.mod(b, 2048.0) * (1.0 / _XSCALE) - 0.5
    x1 = jnp.floor(b * (1.0 / 2048.0)) * (1.0 / _XSCALE) - 0.5
    x2 = jnp.mod(c, 1024.0) * (1.0 / _SSCALE) - 0.5
    resp = jnp.floor(c * (1.0 / 1024.0)) * (1.0 / _CSCALE)
    return edge, cok, x0, x1, x2, resp


class OctaveRecords(NamedTuple):
    """One octave's packed record field.

    values: [3, L, Hq, Wp] f32, PLANE-major (channels A/B/C, then
    record layers 1..L of the DoG stack; Hq >= h, Wp >= w row/lane
    padding — padded pixels carry A without the peak bit, so they can
    never become candidates, and the walk's clamps keep live
    candidates off them).  Plane-major so per-plane flattening (the
    walk/finalize gather sources) slices nothing.
    """

    values: jnp.ndarray
    h: int
    w: int


def records_jnp(gauss_oct: jnp.ndarray, cfg: SiftConfig) -> OctaveRecords:
    """Record field of one natural-shape Gaussian octave [NL, H, W]:
    [3, L, Hq, Wp] with Hq = align8(H), Wp = align128(W)."""
    nl, h, w = gauss_oct.shape
    dog = gauss_oct[1:] - gauss_oct[:-1]
    x0, x1, x2, contrast, flags = record_fields(dog, cfg)
    mask, _ = peak_mask(dog, cfg.peak_threshold, SIFT_IMG_BORDER)
    cok = contrast * cfg.num_octave_layers >= cfg.contrast_threshold
    a, b, c = pack_record_channels(x0, x1, x2, contrast, flags, mask, cok)
    rec = jnp.stack([a, b, c], axis=0)                  # [3, L, H, W]
    hq = -(-max(h, 8) // 8) * 8
    wp = -(-max(w, 128) // 128) * 128
    rec = jnp.pad(rec, ((0, 0), (0, 0), (0, hq - h), (0, wp - w)))
    return OctaveRecords(values=rec, h=h, w=w)


def detect_records_padded(gp: jnp.ndarray, h: int, w: int,
                          cfg: SiftConfig) -> OctaveRecords:
    """Record field from a PADDED-layout octave [NL, Hv, Wp] (content
    rows [HALO, HALO + h), lanes [0, w) — what gaussian_pyramid_padded
    emits)."""
    return records_jnp(gp[:, HALO:HALO + h, :w], cfg)


def candidates_from_records(rec: OctaveRecords, cap: int):
    """Extrema candidates from the A plane's peak bit — the
    find_candidates equivalent (same compaction semantics: first ``cap``
    set bits in layer-major index order).  Returns (x, y, layer, valid),
    layer in 1..L (DoG layer index, MatOps.cu:177)."""
    _, nrec, hq, wp = rec.values.shape
    mask = _bit(rec.values[0], 3).reshape(-1)
    idx, valid = stream_compact(mask, cap)
    lyr = idx // (hq * wp) + 1
    rem = idx % (hq * wp)
    y = rem // wp
    x = rem % wp
    return (x.astype(jnp.int32), y.astype(jnp.int32),
            lyr.astype(jnp.int32), valid)


class WalkState(NamedTuple):
    """Per-candidate outcome of the positions-only Newton walk.

    Everything the global compaction needs (``ok``) plus everything the
    post-compaction finalize needs to build keypoints for the SURVIVORS
    only: the B/C planes (sub-pixel offsets + response) are deliberately
    NOT gathered here — at candidate capacity K that final gather would
    cost 3K scattered loads, while after compaction it costs 2*kcap.
    The accept bits (edge, contrast) ride the A value the walk already
    gathered at the convergence step, so ``ok`` is exact without
    touching B/C."""

    l: jnp.ndarray       # [K] i32 final DoG layer
    r: jnp.ndarray       # [K] i32 final row (octave coords)
    c: jnp.ndarray       # [K] i32 final col
    ok: jnp.ndarray      # [K] bool: converged & edge_ok & contrast_ok
    octv: jnp.ndarray    # [K] i32 octave index
    fi: jnp.ndarray      # [K] i32 plane-local flat index of the final
    #                      position (addresses A/B/C per-plane flats)


def walk_records_positions(recs: List[OctaveRecords], cands,
                           cfg: SiftConfig
                           ) -> Tuple[WalkState, jnp.ndarray]:
    """ALL octaves' candidates in ONE Newton walk over the concatenated
    packed record fields.  Each of the 5 steps gathers ONE element per
    candidate (the A plane).  cands: per-octave (cx, cy, clayer,
    cvalid).  Returns (WalkState, flat record array) — feed survivors
    to ``finalize_walk``.

    When the summed per-octave candidate capacity exceeds
    2 * num_features, candidates are first globally compacted to that
    bound, so walk cost scales with the configured feature budget, not
    the frame area (at 1920x1200 the raw capacity is ~20k; the final
    keypoint set is capped at num_features anyway, and the reference's
    own extrema buffer is capacity-truncating too,
    Detector.cu:108-109).
    Truncation drops trailing (highest-octave) candidates only on
    frames whose RAW extrema count exceeds twice the requested feature
    count."""
    d = recs[0].values.shape[1] + 2          # DoG layer count
    border = SIFT_IMG_BORDER
    bases, hs, ws, hqs, wps = [], [], [], [], []
    row = 0
    for rr in recs:
        _, nrec, hq, wp = rr.values.shape
        bases.append(row)
        hs.append(rr.h)
        ws.append(rr.w)
        hqs.append(hq)
        wps.append(wp)
        row += nrec * hq * wp                # per-PLANE octave stride
    # Flattening the record field is a physical relayout copy; the walk
    # reads only the A plane and finalize only B/C.  Splitting into
    # per-plane flats lets the A flat die at walk end.  XLA buffer
    # assignment is sensitive to the co-live set, so re-measure with
    # scripts/mem_analysis.py when the pipeline's big buffers change.
    flat_a = jnp.concatenate([rr.values[0].reshape(-1)
                              for rr in recs])
    flat_b = jnp.concatenate([rr.values[1].reshape(-1)
                              for rr in recs])
    flat_c = jnp.concatenate([rr.values[2].reshape(-1)
                              for rr in recs])

    octv = jnp.concatenate([
        jnp.full(cc[0].shape, o, jnp.int32) for o, cc in enumerate(cands)])
    cat = lambda i: jnp.concatenate([jnp.asarray(cc[i]) for cc in cands])
    cx, cy, clayer, cvalid = cat(0), cat(1), cat(2), cat(3)

    gcap = 2 * cfg.num_features
    if octv.shape[0] > gcap:
        # Global candidate compaction (octave-major order preserved):
        # ONE packed row-gather, same pattern as the detector's
        # WalkState gather.
        gidx, gval = stream_compact(cvalid, gcap)
        cm = jnp.stack([cx.astype(jnp.int32), cy.astype(jnp.int32),
                        clayer.astype(jnp.int32), octv,
                        cvalid.astype(jnp.int32)], axis=1)
        g = jnp.take(cm, gidx, axis=0)
        cx, cy, clayer, octv = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
        cvalid = (g[:, 4] > 0) & gval

    def sel(vals):
        """Per-candidate int from a per-octave table via one-hot
        selects."""
        out = jnp.zeros(octv.shape, jnp.int32)
        for o, vv in enumerate(vals):
            out = jnp.where(octv == o, jnp.int32(vv), out)
        return out

    base, h, w = sel(bases), sel(hs), sel(ws)
    hqwp = sel([hq * wp for hq, wp in zip(hqs, wps)])
    wp = sel(wps)

    def pos_idx(l, r, c):
        """PLANE-LOCAL index (the same position addresses A, B or C
        in their per-plane flats)."""
        return (base + (jnp.clip(l, 1, d - 2) - 1) * hqwp
                + jnp.clip(r, 0, h - 1) * wp + jnp.clip(c, 0, w - 1))

    c = cx.astype(jnp.int32)
    r = cy.astype(jnp.int32)
    l = clayer.astype(jnp.int32)
    alive = cvalid
    converged = jnp.zeros_like(alive)
    edge = jnp.zeros_like(alive)
    cok = jnp.zeros_like(alive)

    for _ in range(int(SIFT_MAX_INTERP_STEPS)):
        active = alive & ~converged
        a = jnp.take(flat_a, pos_idx(l, r, c))
        conv_now, diverged, (sx, sy, sl) = decode_steps(a)
        # A converged candidate's position never changes again, so the
        # A value at the convergence step IS the final-position A:
        # capture its accept bits here and the finalize never re-reads A.
        first = active & conv_now
        edge = jnp.where(first, _bit(a, 2), edge)
        cok = jnp.where(first, _bit(a, 4), cok)
        step = active & ~conv_now & ~diverged
        nl = l - sl
        nr = r - sy
        nc = c - sx
        oob = ((nl < 1) | (nl > d - 2)
               | (nr < border) | (nr >= h - border)
               | (nc < border) | (nc >= w - border))
        l = jnp.where(step, jnp.clip(nl, 0, d - 1), l)
        r = jnp.where(step, jnp.clip(nr, 0, h - 1), r)
        c = jnp.where(step, jnp.clip(nc, 0, w - 1), c)
        alive = alive & ~(active & (diverged | (step & oob)))
        converged = converged | (active & conv_now)

    ok = alive & converged & edge & cok
    return WalkState(l=l, r=r, c=c, ok=ok, octv=octv,
                     fi=pos_idx(l, r, c)), (flat_b, flat_c)


def finalize_walk(flat, st: WalkState, valid: jnp.ndarray,
                  cfg: SiftConfig
                  ) -> Tuple[RefinedKeypoints, jnp.ndarray]:
    """Keypoints from walk survivors.  ``st``: WalkState rows already
    gathered down to the surviving set (e.g. jax.tree.map(take, state));
    ``valid``: the compaction's validity mask for those rows; ``flat``:
    the (flat_b, flat_c) pair from walk_records_positions.  Gathers
    B/C (2 elements per survivor) and builds coordinates/size/response.
    Returns (RefinedKeypoints, octave [K'])."""
    flat_b, flat_c = flat
    safe = jnp.where(valid, st.fi, 0)
    b = jnp.take(flat_b, safe)
    cc = jnp.take(flat_c, safe)
    x0 = jnp.mod(b, 2048.0) * (1.0 / _XSCALE) - 0.5
    x1 = jnp.floor(b * (1.0 / 2048.0)) * (1.0 / _XSCALE) - 0.5
    x2 = jnp.mod(cc, 1024.0) * (1.0 / _SSCALE) - 0.5
    resp = jnp.floor(cc * (1.0 / 1024.0)) * (1.0 / _CSCALE)

    scale = jnp.exp2(st.octv.astype(jnp.float32))
    if cfg.subpixel:
        fx = (st.c.astype(jnp.float32) - x0) * scale
        fy = (st.r.astype(jnp.float32) - x1) * scale
    else:
        fx = st.c.astype(jnp.float32) * scale
        fy = st.r.astype(jnp.float32) * scale
    xi = -x2
    size = (cfg.sigma * jnp.power(2.0, (st.l.astype(jnp.float32) + xi)
                                  / cfg.num_octave_layers) * scale * 2.0)
    ref = RefinedKeypoints(x=fx, y=fy, layer=st.l, xi=xi, size=size,
                           response=resp, valid=valid & st.ok)
    return ref, st.octv


def walk_records_all(recs: List[OctaveRecords], cands, cfg: SiftConfig
                     ) -> Tuple[RefinedKeypoints, jnp.ndarray]:
    """Un-compacted walk (parity/replay entry): positions walk +
    finalize over ALL candidates.  The pipeline instead compacts
    between the two stages (detector.py) so B/C are only gathered for
    survivors."""
    st, flat = walk_records_positions(recs, cands, cfg)
    return finalize_walk(flat, st, st.ok, cfg)
