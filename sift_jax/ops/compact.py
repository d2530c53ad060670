"""Fixed-capacity compaction — the replacement for the reference's
mask → CUB prefix-sum → scatter pipeline (``collectKpts``,
/root/reference/sift_cuda/sift_func/SiftOps.cu:210-235, and
``findPeaksBlockSecondPass``, image_func/MatOps.cu:149-181).

Without global atomic/scatter compactions, ``topk_compact`` and
``mask_compact`` use ``top_k`` over a score vector.  ``jax.lax.top_k``
breaks ties by lowest index, so top_k over a 0/1 validity mask IS stream
compaction (first-K valid elements in index order).  For large inputs a
two-stage tiled top-k bounds the cost: a batched small-k top-k per tile,
then one exact top-k over the tile winners.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Plain float, NOT jnp.float32: a module-level jnp value initializes the
# XLA backend at import time, which breaks jax.distributed.initialize
# (it must run before any backend touch — parallel/multihost.py).
NEG = -3.0e38


def stream_compact(valid: jnp.ndarray, cap: int, block: int = 0):
    """Sort-free stream compaction: indices of the first ``cap`` set bits of
    ``valid``, in index order — the exact semantics of the reference's
    prefix-sum + scatter (``collectKpts``, SiftOps.cu:210-235, capacity-capped
    in index order).

    Formulation with no scatter, no sort, no top_k, and no scalar
    gathers:
      1. per-128-block counts, rolled up into 2048-wide superblocks;
      2. for each output slot j, dense compare+reduce finds the owning
         superblock, a [cap, 16] row-gather of its block counts finds
         the block (jnp.searchsorted would lower to a per-element
         binary-search while loop);
      3. one [cap, 128] row-gather of the block masks, a 128-lane
         cumsum, equality + argmax -> position.
    Exclusive offsets at both levels come from masked reduces over the
    compare matrices (excl[b] == sum of counts where incl <= j for
    nondecreasing incl), never from scalar gathers.  Work: O(n) reduce
    + O(cap * (n/2048 + 144)) dense ops; compiles to O(1) ops.
    ``block`` is accepted for API compatibility and ignored.

    Returns (indices [cap] int32, out_valid [cap] bool).
    """
    del block
    BLK, SB = 128, 16                    # 128-lane blocks, 2048-superblocks
    n = valid.shape[0]
    j = jnp.arange(cap, dtype=jnp.int32)
    if n <= BLK:
        c = jnp.cumsum(valid.astype(jnp.int32))
        hit = (c[None, :] == (j[:, None] + 1)) & valid[None, :]
        idx = jnp.argmax(hit, axis=1).astype(jnp.int32)
        return idx, j < c[-1]

    pad = (-n) % (BLK * SB)
    v = jnp.concatenate([valid, jnp.zeros((pad,), valid.dtype)]) if pad \
        else valid
    nb = v.shape[0] // BLK
    nsb = nb // SB
    m = v.reshape(nb, BLK)
    b2 = jnp.sum(m.astype(jnp.int32), axis=1).reshape(nsb, SB)
    sc2 = jnp.sum(b2, axis=1)                            # [nsb]
    incl2 = jnp.cumsum(sc2)
    total = incl2[-1]

    le2 = incl2[None, :] <= j[:, None]                   # [cap, nsb]
    sb = jnp.clip(jnp.sum(le2.astype(jnp.int32), axis=1), 0, nsb - 1)
    rank_sb = j - jnp.sum(jnp.where(le2, sc2[None, :], 0), axis=1)

    row16 = jnp.take(b2, sb, axis=0)                     # [cap, SB]
    incl1 = jnp.cumsum(row16, axis=1)
    le1 = incl1 <= rank_sb[:, None]
    bloc = jnp.clip(jnp.sum(le1.astype(jnp.int32), axis=1), 0, SB - 1)
    rank1 = rank_sb - jnp.sum(jnp.where(le1, row16, 0), axis=1)
    b = sb * SB + bloc

    rows = jnp.take(m, b, axis=0)                        # [cap, BLK]
    # 128-lane inclusive cumsum as ONE matmul against a constant
    # lower-triangular matrix (jnp.cumsum lowers to reduce_window).
    # Operands are 0/1 and sums <= 128, exact at any matmul precision
    # (TF32 and bf16 included).
    tri = (jnp.arange(BLK)[:, None] >= jnp.arange(BLK)[None, :]) \
        .astype(jnp.float32)                             # [BLK, BLK] lower
    rc = jax.lax.dot_general(rows.astype(jnp.float32), tri,
                             (((1,), (1,)), ((), ())),
                             preferred_element_type=jnp.float32)
    hit = (rc == (rank1[:, None] + 1).astype(jnp.float32)) \
        & rows.astype(bool)
    within = jnp.argmax(hit, axis=1).astype(jnp.int32)
    return b * BLK + within, j < total


def topk_compact(score: jnp.ndarray, valid: jnp.ndarray, cap: int,
                 tile: int = 1024, per_tile: int = 32):
    """Select up to ``cap`` valid entries with the highest scores.

    score: [N] float32; valid: [N] bool.  Returns (indices [cap] int32,
    out_valid [cap] bool).  Entries are ordered by descending score.
    When N is small the top-k is exact; otherwise entries are first reduced
    per tile (exact as long as no single tile holds more than ``per_tile``
    valid entries — calibrate ``tile``/``per_tile`` to the workload).
    """
    n = score.shape[0]
    s = jnp.where(valid, score, NEG)

    if n <= max(4 * tile, 4 * cap):
        k = min(cap, n)
        top_s, top_i = jax.lax.top_k(s, k)
        out_i = jnp.zeros((cap,), jnp.int32).at[:k].set(top_i.astype(jnp.int32))
        out_v = jnp.zeros((cap,), bool).at[:k].set(top_s > NEG)
        return out_i, out_v

    pad = (-n) % tile
    if pad:
        s = jnp.concatenate([s, jnp.full((pad,), NEG, s.dtype)])
    nt = s.shape[0] // tile
    st = s.reshape(nt, tile)
    t_s, t_i = jax.lax.top_k(st, min(per_tile, tile))      # [nt, per_tile]
    base = (jnp.arange(nt, dtype=jnp.int32) * tile)[:, None]
    cand_i = (t_i.astype(jnp.int32) + base).reshape(-1)
    cand_s = t_s.reshape(-1)
    k = min(cap, cand_s.shape[0])
    top_s, top_j = jax.lax.top_k(cand_s, k)
    out_i = jnp.zeros((cap,), jnp.int32).at[:k].set(
        jnp.take(cand_i, top_j).astype(jnp.int32))
    out_v = jnp.zeros((cap,), bool).at[:k].set(top_s > NEG)
    return out_i, out_v


def mask_compact(valid: jnp.ndarray, cap: int):
    """Compaction by index order only (reference ``collectKpts`` semantics:
    first-come order, capacity-capped).  Returns (indices, out_valid)."""
    # top_k over the mask: ties broken by lowest index == stable compaction.
    score = valid.astype(jnp.float32)
    k = min(cap, score.shape[0])
    top_s, top_i = jax.lax.top_k(score, k)
    out_i = jnp.zeros((cap,), jnp.int32).at[:k].set(top_i.astype(jnp.int32))
    out_v = jnp.zeros((cap,), bool).at[:k].set(top_s > 0.5)
    return out_i, out_v


def gather_keypoint_fields(tree, idx, valid):
    """Gather every leaf of a keypoint pytree at ``idx``; AND valid masks."""
    gathered = jax.tree_util.tree_map(lambda a: jnp.take(a, idx, axis=0), tree)
    return gathered, valid
