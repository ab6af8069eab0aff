"""Batched two-phase locate.

Phase 1 (ranges) is :func:`sview_fmindex_tpu.ops.search.pos_ranges`.
Phase 2 expands the [lo, hi) ranges into a flat row buffer of static
capacity (the batched analog of ``P::as_vec_in_range``,
``locate/mod.rs:19``).
Phase 3 resolves every row to a text location: ONE gather when the full
(r=1) SA is device-resident, else a lockstep LF-walk — LF-step until the
row index is a multiple of the sampling ratio, with the sentinel-row
short-circuit emitting ``offset`` (``locate/mod.rs:21-35``); a
``while_loop`` with done-masks handles the data-dependent trip counts.

Expansion layout: slot ``p < B`` holds the FIRST occurrence row of
pattern ``p`` (valid iff count >= 1) — a pure elementwise move, no
gathers; slots ``B..capacity`` hold the overflow (2nd+ occurrences),
compacted with a searchsorted over the overflow prefix sums.  For the
common workload (most counts <= 1 — e.g. 20 bp patterns on a 1 Gbp text
have ~1.001 mean occurrences) the overflow region is tiny, so the
O(cap * log B) searchsorted of a dense-packed expand nearly vanishes.
Output order is unspecified (the reference also returns unsorted
locations, ``README.md:77``); consumers key on ``pat_ids``/``valid``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .rank import U32, pre_rank_and_symidx


def expand_capacity(counts, base: int | None = None) -> int:
    """Host-side capacity sizing for :func:`expand_ranges`: ``B`` base slots
    plus the overflow rounded up to a power of two (bounding recompiles)."""
    import numpy as np

    counts = np.asarray(counts)
    B = base if base is not None else counts.shape[0]
    extra = int((counts - (counts >= 1)).sum())
    return B + max(1 << max(extra - 1, 1).bit_length(), 64)


_SAT_CAP = U32(0x7FFFFFFF)


def _sat_cumsum(x: jax.Array) -> jax.Array:
    """Saturating uint32 prefix sum, capped at 2^31-1.

    A plain uint32 cumsum can WRAP when a few lanes carry huge counts
    (e.g. shard-padding lanes are length-1 patterns whose true counts are
    ~text_len/sigma), turning the array non-monotonic and corrupting the
    searchsorted in :func:`expand_ranges`.  Clamping every element to the
    cap keeps each combine < 2^32 and min(a+b, cap) is associative on
    [0, cap], so the scan is exact below the cap and pins at the cap above
    it — monotonicity is guaranteed either way.
    """
    xc = jnp.minimum(x, _SAT_CAP)
    return jax.lax.associative_scan(lambda a, b: jnp.minimum(a + b, _SAT_CAP), xc)


def expand_ranges(lo: jax.Array, hi: jax.Array, capacity: int):
    """[B] ranges -> (rows uint32 [capacity], pat_ids int32, valid bool,
    dropped uint32 [1]).

    Slot p < B: row ``lo[p]`` (pattern p's first occurrence).  Slots B..:
    overflow rows ``lo[p]+1 .. hi[p])`` in pattern order; overflow beyond
    ``capacity - B`` is dropped — ``dropped`` counts those rows (0 when the
    budget sufficed; callers size capacity via :func:`expand_capacity`, and
    anyone passing an explicit ``capacity`` should check ``dropped`` before
    trusting completeness).  Requires ``capacity >= B``.

    Caveat: per-lane extras go through a SATURATING prefix sum capped at
    2^31-1 (see :func:`_sat_cumsum`).  Once any lane's cumulative extras
    reach the cap, ``dropped`` becomes a saturated LOWER BOUND rather than
    an exact count, and overflow-slot attribution past the saturation
    point is approximate.  ``dropped == 0`` remains exact (nothing was
    dropped); the cap only blurs HOW MANY were dropped when ~2^31 rows
    already did not fit.
    """
    B = lo.shape[0]
    if capacity < B:
        raise ValueError(f"capacity {capacity} < batch {B}: the expand "
                         "layout needs one base slot per pattern")
    counts = hi - lo
    base_valid = counts >= U32(1)
    O = capacity - B
    extra = counts - base_valid.astype(U32)
    ecum = _sat_cumsum(extra)
    etotal = ecum[-1]
    dropped = (etotal - jnp.minimum(etotal, U32(O))).reshape(1)
    if O == 0:
        return (jnp.where(base_valid, lo, U32(0)),
                jnp.arange(B, dtype=jnp.int32), base_valid, dropped)
    j = jnp.arange(O, dtype=U32)
    epat = jnp.searchsorted(ecum, j, side="right").astype(jnp.int32)
    epat_c = jnp.clip(epat, 0, B - 1)
    prev = jnp.where(epat_c == 0, U32(0), jnp.take(ecum, jnp.maximum(epat_c - 1, 0)))
    erows = jnp.take(lo, epat_c) + U32(1) + (j - prev)
    evalid = j < etotal
    rows = jnp.concatenate([jnp.where(base_valid, lo, U32(0)),
                            jnp.where(evalid, erows, U32(0))])
    pids = jnp.concatenate([jnp.arange(B, dtype=jnp.int32), epat_c])
    valid = jnp.concatenate([base_valid, evalid])
    return rows, pids, valid, dropped


def walk_rows(meta, fused, count_arr, sa, sentinel, rows, valid):
    """Resolve BWT rows to text locations.  Returns uint32 [capacity].

    The LF-walk trip count is data-dependent (expected < r, tail ~geometric)
    so stragglers pay the while_loop's per-iteration overhead only as long
    as any lane still walks.
    """
    r = meta.sampling_ratio

    def needs_step(pos, done):
        return (pos % U32(r) != 0) & ~done & valid

    def cond(carry):
        pos, offset, loc, done = carry
        return jnp.any(needs_step(pos, done))

    def body(carry):
        pos, offset, loc, done = carry
        need = needs_step(pos, done)
        pos_q = jnp.where(need, pos, U32(0))  # masked lanes hit block 0
        rank, symidx, is_sent = pre_rank_and_symidx(meta, fused, sentinel, pos_q)
        pre = jnp.take(count_arr, symidx)
        is_sent = is_sent & need
        hit = need & is_sent
        loc = jnp.where(hit, offset, loc)
        done = done | hit
        step = need & ~is_sent
        npos = pre + rank
        pos = jnp.where(step, npos, pos)
        offset = jnp.where(step, offset + 1, offset)
        return pos, offset, loc, done

    pos = rows
    offset = jnp.zeros_like(rows)
    loc = jnp.zeros_like(rows)
    # derive from `valid` so the carry is typed as device-varying under
    # shard_map (a plain constant would fail the while_loop vma check)
    done = valid & False
    if r > 1:
        pos, offset, loc, done = jax.lax.while_loop(cond, body, (pos, offset, loc, done))
    # indices stay uint32: an int32 cast overflows for text_len in [2^31, 2^32)
    sampled = jnp.take(sa, pos // U32(r))
    return jnp.where(done, loc, sampled + offset)


def locate_rows(meta, fused, count_arr, sa, sentinel, lo, hi, capacity: int):
    rows, pat_ids, valid, dropped = expand_ranges(lo, hi, capacity)
    if getattr(meta, "has_sa_full", False):
        # full (r=1) SA resident on device: one gather resolves every row,
        # including the sentinel-walk case (SA value 0 at the sentinel row
        # equals the offset the reference walk would emit, locate/mod.rs:27-30)
        # rows stay uint32: an int32 cast overflows for text_len in [2^31, 2^32)
        locs = jnp.where(valid, jnp.take(sa, rows), U32(0))
        return locs, pat_ids, valid, dropped
    locs = walk_rows(meta, fused, count_arr, sa, sentinel, rows, valid)
    return locs, pat_ids, valid, dropped
