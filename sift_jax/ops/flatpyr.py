"""Flattened-pyramid addressing: gather per-keypoint patches from any
octave/layer out of ONE concatenated buffer.

Replacement for the reference's per-octave kernel launches with
device-pointer tables (types/SiftData.cuh:14-21, the MemLocData indirection
that feeds its cross-octave gather).  Here the pyramid becomes a single
flat [N] array plus static per-octave (offset, height, width) tables;
keypoints from ALL octaves are processed by one batched gather, so
orientation/descriptor run once per frame instead of once per octave.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class PaddedPyramid(NamedTuple):
    """Uniform-shape pyramid: every octave's [D, H_o, W_o] block embedded
    at the top-left of a [D, Hp, Wp] slab, stacked to [O*D, Hp, Wp].

    The uniform shape is what unlocks fast patch access: a per-keypoint
    window becomes ONE vmapped ``dynamic_slice`` (XLA: gather with
    slice_sizes (1, s, s) — whole rows per read), instead of s*s scalar
    gathers.  Out-of-octave padding pixels are garbage by contract; every
    consumer already masks to [1, h_o-2] x [1, w_o-2].
    """

    values: jnp.ndarray   # [copies * O*D, Hp, Wp]
    height: jnp.ndarray   # [O] valid height per octave
    width: jnp.ndarray    # [O]
    layers: int           # D (static)
    copies: int = 1       # lane-shifted replicas (see shift_copies)

    def octave_geometry(self, octave: jnp.ndarray):
        """Per-keypoint (h, w) for octave indices [K]."""
        return jnp.take(self.height, octave), jnp.take(self.width, octave)


def pad_pyramid(blocks: List[jnp.ndarray]) -> PaddedPyramid:
    """blocks: per-octave [D, H_o, W_o], octave 0 largest.  Slab dims are
    rounded up to 8 rows x 128 lanes so that aligned window origins
    (window_origins) can always be clamped without losing edge
    coverage."""
    d, h0, w0 = blocks[0].shape
    hp = -(-max(h0, 8) // 8) * 8
    wp = -(-max(w0, 128) // 128) * 128
    slabs = []
    hs, ws = [], []
    for b in blocks:
        bd, h, w = b.shape
        slabs.append(jnp.pad(b, ((0, 0), (0, hp - h), (0, wp - w))))
        hs.append(h)
        ws.append(w)
    return PaddedPyramid(
        values=jnp.concatenate(slabs, axis=0),
        height=jnp.asarray(np.array(hs, np.int32)),
        width=jnp.asarray(np.array(ws, np.int32)),
        layers=d)


def shift_copies(p: PaddedPyramid, n: int = 4) -> PaddedPyramid:
    """Append lane-shifted replicas of the slab (shift = 32 lanes apart).

    Window origins are 128-lane aligned; with ``n`` 32-lane-shifted
    copies a keypoint can always pick a copy whose aligned 128-wide window
    contains its whole patch — windows shrink from 256 to 128 lanes,
    halving both gather traffic and all downstream per-pixel math.  Costs
    n x slab memory (bounded: slabs are one frame's gradient pyramid).
    """
    v = p.values
    step = 128 // n
    outs = [v]
    for c in range(1, n):
        s = step * c
        outs.append(jnp.pad(v[:, :, s:], ((0, 0), (0, 0), (0, s))))
    return p._replace(values=jnp.concatenate(outs, axis=0), copies=n)


SUBLANE = 8      # window row alignment
LANES = 256      # unshifted window width: 128-aligned origin + 128 slack


def window_rows(radius: int) -> int:
    """Rows needed for a patch of +-radius with a 1-px gradient halo and
    8-row alignment slack."""
    need = 2 * (radius + 1) + 1 + (SUBLANE - 1)
    return -(-need // SUBLANE) * SUBLANE


def window_origins(padded_shape, layer_index, cy, cx, rows: int,
                   radius: int):
    """Aligned, clamped window origins: the [ys0:ys0+rows, xs0:xs0+256]
    window lies inside the slab and contains the image-masked
    +-(radius+1) neighborhood of (cy, cx).

    Requires slab dims aligned to (8, 128) (pad_pyramid guarantees this);
    then the clamp bounds are themselves aligned and clamping never loses
    edge coverage.  Returns (lidx, ys0, xs0), ys0 % 8 == 0,
    xs0 % 128 == 0."""
    l, hp, wp = padded_shape
    hp = -(-max(hp, rows) // SUBLANE) * SUBLANE
    wp = -(-max(wp, LANES) // 128) * 128
    r = radius + 1
    ys0 = jnp.minimum((cy - r) // SUBLANE * SUBLANE, hp - rows)
    ys0 = jnp.maximum(ys0, 0).astype(jnp.int32)
    xs0 = jnp.minimum((cx - r) // 128 * 128, wp - LANES)
    xs0 = jnp.maximum(xs0, 0).astype(jnp.int32)
    lidx = jnp.clip(layer_index, 0, l - 1).astype(jnp.int32)
    return lidx, ys0, xs0


def _xla_windows(values, lidx, ys0, xs0, rows, lanes):
    def one(l, y, x):
        return jax.lax.dynamic_slice(values, (l, y, x), (1, rows, lanes))[0]

    return jax.vmap(one)(lidx, ys0, xs0)


def keypoint_window_packed(packed: PaddedPyramid, octave, layer, cy, cx,
                           radius: int):
    """Gather per-keypoint PACKED-gradient windows (ONE gather) and
    decode.  Returns (wm, wo, offy, offx) like keypoint_window_pair."""
    w, offy, offx = _keypoint_windows(packed, octave, layer, cy, cx,
                                      radius)
    m, o = unpack_gradients(w)
    return m, o, offy, offx


def _keypoint_windows(src: PaddedPyramid, octave, layer, cy, cx,
                      radius: int):
    """One pyramid's per-keypoint windows with aligned origins.

    Returns (win, offy, offx): windows [K, rows, lanes] and the true
    per-pixel offsets from the keypoint center, offy [K, rows] /
    offx [K, lanes] — the window is origin-shifted near edges, never
    clipped, so offsets are exact and consumer masks stay correct.
    With lane-shifted slab copies (shift_copies) lanes = 128, else 256.
    """
    rows = window_rows(radius)
    lrel = octave.astype(jnp.int32) * src.layers + layer.astype(jnp.int32)

    if src.copies > 1:
        # Pick the shifted copy whose aligned 128-lane window contains the
        # patch: absolute window start 32q with q = (cx - r - 1)//32 puts
        # cx at lane offset in [r+1, r+32] and the patch end at
        # <= 2(r+1)+31 <= 127 lanes for r <= 47.
        lanes = 128
        n_total = src.values.shape[0] // src.copies
        step = lanes // src.copies
        hp, wp = src.values.shape[-2:]
        m = radius + 1
        q = jnp.maximum((cx - m) // step, 0)
        copy = q % src.copies
        al = (q // src.copies) * lanes
        al = jnp.minimum(al, wp - lanes).astype(jnp.int32)
        li = copy * n_total + lrel
        ys0 = jnp.minimum((cy - m) // SUBLANE * SUBLANE,
                          -(-max(hp, rows) // SUBLANE) * SUBLANE - rows)
        ys0 = jnp.maximum(ys0, 0).astype(jnp.int32)
        xs_abs = al + copy * step
        xs0 = al
    else:
        lanes = 256
        li, ys0, xs0 = window_origins(src.values.shape, lrel, cy, cx,
                                      rows, radius)
        xs_abs = xs0

    v = src.values
    hp, wp = v.shape[-2:]
    ph, pw = max(0, rows - hp), max(0, lanes - wp)
    if ph or pw:
        v = jnp.pad(v, ((0, 0), (0, ph), (0, pw)))
    win = _xla_windows(v, li, ys0, xs0, rows, lanes)
    ry = jnp.arange(rows, dtype=jnp.int32)
    rx = jnp.arange(lanes, dtype=jnp.int32)
    offy = ys0[:, None] + ry[None, :] - cy[:, None]
    offx = xs_abs[:, None] + rx[None, :] - cx[:, None]
    return win, offy, offx


def keypoint_window_pair(mag: PaddedPyramid, ori: PaddedPyramid,
                         octave, layer, cy, cx, radius: int):
    """Two-pyramid variant (separate mag/ori slabs): two gathers with
    shared origins.  Prefer keypoint_window_packed (half the traffic)."""
    wm, offy, offx = _keypoint_windows(mag, octave, layer, cy, cx, radius)
    wo, _, _ = _keypoint_windows(ori, octave, layer, cy, cx, radius)
    return wm, wo, offy, offx


def dense_gradients_padded(p: PaddedPyramid):
    """Dense gradient magnitude/orientation on the padded stack (ONE fused
    elementwise pass; rim and padding pixels are garbage by contract)."""
    b = p.values
    dx = jnp.roll(b, -1, axis=-1) - jnp.roll(b, 1, axis=-1)
    dy = jnp.roll(b, 1, axis=-2) - jnp.roll(b, -1, axis=-2)
    mag = jnp.sqrt(dx * dx + dy * dy)
    ori = jnp.arctan2(dy, dx) * (180.0 / np.pi)
    ori = jnp.where(ori < 0, ori + 360.0, ori)
    return p._replace(values=mag), p._replace(values=ori)


# 10-bit magnitude + 14-bit orientation packed into one float32:
# packed = mag_q * 16384 + ori_q, an integer <= 2^24 - 1 (exact in f32).
# Orientation gets the finer grain (0.022 deg): histogram-bin decisions are
# sensitive to it, while magnitude only weights sums.  Max gradient
# magnitude for 0..255 images is 2*255*sqrt(2) ~ 721.2.
_PACK_BINS = 16384.0
_PACK_MAG_SCALE = 1023.0 / 722.0


def dense_gradients_packed(p: PaddedPyramid) -> PaddedPyramid:
    """Packed dense gradients: ONE slab instead of (mag, ori) — halves the
    per-keypoint window-gather traffic of the orientation/descriptor
    stages.  Quantization: mag to 0.18 absolute (of <= 722), ori to
    0.088 deg — both far inside the stages' tolerance gates."""
    b = p.values
    dx = jnp.roll(b, -1, axis=-1) - jnp.roll(b, 1, axis=-1)
    dy = jnp.roll(b, 1, axis=-2) - jnp.roll(b, -1, axis=-2)
    mag = jnp.sqrt(dx * dx + dy * dy)
    ori = jnp.arctan2(dy, dx) * (180.0 / np.pi)
    ori = jnp.where(ori < 0, ori + 360.0, ori)
    mq = jnp.clip(jnp.round(mag * _PACK_MAG_SCALE), 0.0, 1023.0)
    oq = jnp.round(ori * (_PACK_BINS / 360.0))
    oq = jnp.where(oq >= _PACK_BINS, oq - _PACK_BINS, oq)
    return p._replace(values=mq * _PACK_BINS + oq)


def unpack_gradients(packed: jnp.ndarray):
    """Inverse of the packing: (mag, ori_degrees)."""
    mq = jnp.floor(packed * (1.0 / _PACK_BINS))
    oq = packed - mq * _PACK_BINS
    return mq * (1.0 / _PACK_MAG_SCALE), oq * (360.0 / _PACK_BINS)


def dense_gradients(blocks: List[jnp.ndarray]):
    """Per-octave dense gradient magnitude and orientation (degrees,
    [0, 360)) of every layer, computed ONCE per frame (the reference
    recomputes gradients inside every per-keypoint window,
    SiftOps.cu:299-325,537-556 — here the transcendentals are dense and
    fused, and keypoint stages just gather).

    dx = I[y, x+1] - I[y, x-1];  dy = I[y-1, x] - I[y+1, x].
    Border pixels (the 1-px rim) hold garbage and must be masked by
    consumers — matching the reference's x/y in [1, size-2] guard.
    """
    mags, oris = [], []
    for b in blocks:
        dx = jnp.roll(b, -1, axis=-1) - jnp.roll(b, 1, axis=-1)
        dy = jnp.roll(b, 1, axis=-2) - jnp.roll(b, -1, axis=-2)
        mags.append(jnp.sqrt(dx * dx + dy * dy))
        ori = jnp.arctan2(dy, dx) * (180.0 / np.pi)
        oris.append(jnp.where(ori < 0, ori + 360.0, ori))
    return mags, oris
