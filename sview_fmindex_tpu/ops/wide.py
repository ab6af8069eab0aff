"""Wide-position (u64) device engine: texts >= 2^32.

The reference treats u64 a first-class ``Position``
(``src/text_length.rs:87-129``).  Here every position-sized VALUE (rank
checkpoints, suffix-array entries, k-mer table entries, count array,
sentinel, query positions) is carried as a pair of uint32 lanes (hi, lo),
which keeps the whole engine in 32-bit integer arithmetic without the
process-wide ``jax_enable_x64`` switch.  Crucially, block INDICES stay
uint32: ``n / block_len < 2^32`` holds up to 2^38 bp (256 Gbp), so every
gather keeps its narrow index type and only the arithmetic widens.

Wide device layout (``meta.wide_pos``):

- ``fused``    uint32 [n_blocks, 2*sigma + planes*lanes] — checkpoint HI
  words, then checkpoint LO words, then the usual MSB-first plane lanes,
- ``kmer_tbl``/``count_arr``/``sa``: uint32 [2, ...] (row 0 = hi),
- ``sentinel``: uint32 [2].

Batches are served by the row-gather engine.  Remaining restrictions
(documented, validated at upload): no ``sa_full`` resolve, dense seeds are
host-built only, and ``sampling_ratio`` must be 1..2^15
(``p_divmod_const`` — any ratio, not just powers of two).

The math mirrors ``ops/rank.py`` / ``ops/search.py`` / ``ops/locate.py``
exactly — same sentinel +1 shift (``bwm/mod.rs:202-204``), same k-mer
subtree seeding (``count_array.rs:203-223``), same walk short-circuit
(``locate/mod.rs:27-35``) — with two-lane adds/compares.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .rank import U32, _lane_masks
from .locate import _sat_cumsum
from .search import take_small

# ---------------------------------------------------------------------------
# two-lane uint32 arithmetic
# ---------------------------------------------------------------------------


def p_add_u32(h, l, x):
    nl = l + x
    return h + (nl < l).astype(U32), nl


def p_add(h1, l1, h2, l2):
    nl = l1 + l2
    return h1 + h2 + (nl < l1).astype(U32), nl


def p_sub(h1, l1, h2, l2):
    """(h1,l1) - (h2,l2); caller guarantees a non-negative result."""
    return h1 - h2 - (l1 < l2).astype(U32), l1 - l2


def p_lt(h1, l1, h2, l2):
    return (h1 < h2) | ((h1 == h2) & (l1 < l2))


def p_where(c, h1, l1, h2, l2):
    return jnp.where(c, h1, h2), jnp.where(c, l1, l2)


def p_divmod_const(h, l, r: int):
    """(q, mod) of the two-lane value v = h*2^32 + l by the STATIC divisor
    ``r``, exact for v < r * 2^32 (the wide upload envelope, which implies
    h < r) and r <= 2^15.

    Decompose 2^32 = A*r + Bm: v = (h*A)*r + h*Bm + l, so
    q = h*A + (h*Bm + l)//r.  h*A <= v/r < 2^32 fits u32 exactly;
    h*Bm < 2^30, so the inner sum wraps at most once, and the wrapped
    remainder (< 2^30) plus Bm cannot wrap again.  Lifts the wide locate
    walk's former power-of-two-only restriction (the reference allows any
    ratio >= 2, ``suffix_array_config.rs:4-33``).
    """
    if r == 1:
        # envelope: r=1 => v < 2^32 => h == 0
        return l, jnp.zeros_like(l)
    if r & (r - 1) == 0:
        k = r.bit_length() - 1
        return (h << U32(32 - k)) | (l >> U32(k)), l & U32(r - 1)
    assert r <= (1 << 15), r
    A = U32((1 << 32) // r)
    Bm = U32((1 << 32) % r)
    q = h * A
    s = h * Bm + l
    w1 = (s < l).astype(U32)  # inner sum wrapped past 2^32
    q = q + w1 * A
    s = s + w1 * Bm  # wrapped remainder < 2^30, + Bm < 2^15: no second wrap
    return q + s // U32(r), s % U32(r)


def combine64(h, l):
    """Host-side: pair -> numpy uint64."""
    import numpy as np

    return (np.asarray(h).astype(np.uint64) << np.uint64(32)) | np.asarray(
        l).astype(np.uint64)


# ---------------------------------------------------------------------------
# rank / decode on the wide fused table
# ---------------------------------------------------------------------------


def _split_pos_wide(meta, sent, ph, pl):
    """Sentinel shift + block/rem split.  Returns (q uint32 block index,
    rem uint32)."""
    shift = p_lt(ph, pl, sent[0], sent[1]).astype(U32)
    ph, pl = p_add_u32(ph, pl, shift)
    s = meta.block_len.bit_length() - 1
    q = (ph << U32(32 - s)) | (pl >> U32(s))
    rem = pl & U32(meta.block_len - 1)
    return q, rem


def _plane_lanes_wide(meta, rows):
    return rows[..., 2 * meta.sigma :].reshape(
        *rows.shape[:-1], meta.num_planes, meta.num_lanes)


def _combine_planes(meta, planes, symidx):
    bits = (symidx[..., None] >> jnp.arange(meta.num_planes, dtype=jnp.int32)) & 1
    sel = jnp.where(bits[..., None].astype(bool), planes, ~planes)
    out = sel[..., 0, :]
    for j in range(1, meta.num_planes):
        out = out & sel[..., j, :]
    return out


def rank_from_rows_wide(meta, rows, rem, symidx):
    """Rank math on already-gathered wide fused rows (the range-sharded
    layer gathers rows collectively)."""
    ck_h = jnp.take_along_axis(rows, symidx[..., None], axis=-1)[..., 0]
    ck_l = jnp.take_along_axis(
        rows, symidx[..., None] + meta.sigma, axis=-1)[..., 0]
    planes = _plane_lanes_wide(meta, rows)
    cnt = jax.lax.population_count(
        _combine_planes(meta, planes, symidx) & _lane_masks(meta, rem))
    return p_add_u32(ck_h, ck_l, jnp.sum(cnt, axis=-1, dtype=U32))


def rank_next_wide(meta, fused, sent, ph, pl, symidx):
    """Two-lane ``get_next_rank``: returns (hi, lo)."""
    q, rem = _split_pos_wide(meta, sent, ph, pl)
    rows = jnp.take(fused, q, axis=0)
    return rank_from_rows_wide(meta, rows, rem, symidx)


def pre_rank_and_symidx_from_rows_wide(meta, rows, rem):
    planes = _plane_lanes_wide(meta, rows)
    lane = (rem >> U32(5)).astype(jnp.int32)
    bit = U32(31) - (rem & U32(31))
    lane_vals = jnp.take_along_axis(
        planes, lane[..., None, None].repeat(meta.num_planes, axis=-2), axis=-1
    )[..., 0]
    plane_bits = (lane_vals >> bit[..., None]) & U32(1)
    symidx = jnp.sum(
        plane_bits.astype(jnp.int32)
        << jnp.arange(meta.num_planes, dtype=jnp.int32), axis=-1)
    ck_h = jnp.take_along_axis(rows, symidx[..., None], axis=-1)[..., 0]
    ck_l = jnp.take_along_axis(
        rows, symidx[..., None] + meta.sigma, axis=-1)[..., 0]
    cnt = jax.lax.population_count(
        _combine_planes(meta, planes, symidx) & _lane_masks(meta, rem))
    rh, rl = p_add_u32(ck_h, ck_l, jnp.sum(cnt, axis=-1, dtype=U32))
    return rh, rl, symidx


def pre_rank_and_symidx_wide(meta, fused, sent, ph, pl):
    """Two-lane ``get_pre_rank_and_symidx``: (rank_hi, rank_lo, symidx,
    is_sentinel)."""
    sm1h, sm1l = p_sub(sent[0], sent[1], U32(0), U32(1))
    is_sent = (ph == sm1h) & (pl == sm1l)
    q, rem = _split_pos_wide(meta, sent, ph, pl)
    rows = jnp.take(fused, q, axis=0)
    rh, rl, symidx = pre_rank_and_symidx_from_rows_wide(meta, rows, rem)
    return rh, rl, symidx, is_sent


# ---------------------------------------------------------------------------
# backward search
# ---------------------------------------------------------------------------


def initial_range_wide(meta, kmer_tbl, sym, lens, dense_lo=None,
                       dense_hi=None):
    """k-mer LUT seeding with two-lane table values (count_array.rs:203-223
    incl. the short-pattern subtree range).  When the wide dense seed
    tables are resident (``meta.dense_k``, uint32 [2, sigma**dk] lane
    pairs), lanes of length >= dense_k seed their last dense_k symbols in
    one gather — same memoization as the narrow engine."""
    k = meta.kmer_size
    base = meta.sigma + 1
    Lmax = sym.shape[-1]
    m = jnp.minimum(lens, k)
    start = jnp.zeros(sym.shape[:-1], dtype=jnp.int32)
    for i in range(k):
        j = jnp.clip(lens - m + i, 0, max(Lmax - 1, 0))
        digit = jnp.take_along_axis(sym, j[..., None], axis=-1)[..., 0] + 1
        start = start + jnp.where(i < m, digit * (base ** (k - 1 - i)), 0)
    powers = jnp.asarray([base**e for e in range(k + 1)], dtype=jnp.int32)
    gap = jnp.take(powers, k - m) - 1
    lo_h = jnp.take(kmer_tbl[0], start - 1)
    lo_l = jnp.take(kmer_tbl[1], start - 1)
    hi_h = jnp.take(kmer_tbl[0], start + gap)
    hi_l = jnp.take(kmer_tbl[1], start + gap)
    rem_steps = jnp.maximum(lens - k, 0)
    seed_len = jnp.full_like(lens, k)
    if meta.dense_k and dense_lo is not None:
        dk = meta.dense_k
        idx = jnp.zeros(sym.shape[:-1], dtype=jnp.int32)
        for i in range(dk):
            j = jnp.clip(lens - dk + i, 0, max(Lmax - 1, 0))
            digit = jnp.take_along_axis(sym, j[..., None], axis=-1)[..., 0]
            idx = idx * meta.sigma + digit
        use = lens >= dk
        idx = jnp.where(use, idx, 0)
        lo_h = jnp.where(use, jnp.take(dense_lo[0], idx), lo_h)
        lo_l = jnp.where(use, jnp.take(dense_lo[1], idx), lo_l)
        hi_h = jnp.where(use, jnp.take(dense_hi[0], idx), hi_h)
        hi_l = jnp.where(use, jnp.take(dense_hi[1], idx), hi_l)
        rem_steps = jnp.where(use, lens - dk, rem_steps)
        seed_len = jnp.where(use, dk, seed_len)
    return lo_h, lo_l, hi_h, hi_l, rem_steps, seed_len


def pos_ranges_wide(meta, fused, kmer_tbl, count_arr, sent, sym, lens,
                    steps: int, dense_lo=None, dense_hi=None):
    """Backward search, two-lane bounds (the row-gather engine)."""
    lo_h, lo_l, hi_h, hi_l, rem, seed_len = initial_range_wide(
        meta, kmer_tbl, sym, lens, dense_lo, dense_hi)
    Lmax = sym.shape[-1]
    if steps == 0:
        return lo_h, lo_l, hi_h, hi_l

    def body(t, carry):
        lo_h, lo_l, hi_h, hi_l = carry
        active = (t < rem) & p_lt(lo_h, lo_l, hi_h, hi_l)
        j = jnp.clip(lens - seed_len - 1 - t, 0, Lmax - 1)
        s = jnp.take_along_axis(sym, j[..., None], axis=-1)[..., 0]
        eh = jnp.stack([jnp.where(active, lo_h, U32(0)),
                        jnp.where(active, hi_h, U32(0))])
        el = jnp.stack([jnp.where(active, lo_l, U32(0)),
                        jnp.where(active, hi_l, U32(0))])
        rh, rl = rank_next_wide(meta, fused, sent, eh, el,
                                jnp.broadcast_to(s, eh.shape))
        pre_h = take_small(count_arr[0], s, meta.sigma + 1)
        pre_l = take_small(count_arr[1], s, meta.sigma + 1)
        nlo = p_add(pre_h, pre_l, rh[0], rl[0])
        nhi = p_add(pre_h, pre_l, rh[1], rl[1])
        lo_h, lo_l = p_where(active, nlo[0], nlo[1], lo_h, lo_l)
        hi_h, hi_l = p_where(active, nhi[0], nhi[1], hi_h, hi_l)
        return lo_h, lo_l, hi_h, hi_l

    return jax.lax.fori_loop(0, steps, body, (lo_h, lo_l, hi_h, hi_l))


# ---------------------------------------------------------------------------
# locate: expand + walk
# ---------------------------------------------------------------------------


def expand_ranges_wide(lo_h, lo_l, hi_h, hi_l, capacity: int):
    """Level-layout expansion with two-lane rows (see ops/locate.py).

    Per-pattern overflow is clamped into the saturating uint32 scan — the
    dropped count saturates at 2^31-1 (signal, not exact, beyond that).
    """
    B = lo_h.shape[0]
    if capacity < B:
        raise ValueError(f"capacity {capacity} < batch {B}")
    ch, cl = p_sub(hi_h, hi_l, lo_h, lo_l)
    base_valid = (ch | cl) != U32(0)
    O = capacity - B
    # extras clamp to 2^31-1 (hi lane nonzero -> saturate)
    extra = jnp.where(ch != 0, U32(0x7FFFFFFF),
                      cl - base_valid.astype(U32))
    ecum = _sat_cumsum(extra)
    etotal = ecum[-1]
    dropped = (etotal - jnp.minimum(etotal, U32(O))).reshape(1)
    pids0 = jnp.arange(B, dtype=jnp.int32)
    if O == 0:
        return (jnp.where(base_valid, lo_h, U32(0)),
                jnp.where(base_valid, lo_l, U32(0)),
                pids0, base_valid, dropped)
    j = jnp.arange(O, dtype=U32)
    epat = jnp.searchsorted(ecum, j, side="right").astype(jnp.int32)
    epat_c = jnp.clip(epat, 0, B - 1)
    prev = jnp.where(epat_c == 0, U32(0),
                     jnp.take(ecum, jnp.maximum(epat_c - 1, 0)))
    erh, erl = p_add_u32(jnp.take(lo_h, epat_c), jnp.take(lo_l, epat_c),
                         U32(1) + (j - prev))
    evalid = j < etotal
    rows_h = jnp.concatenate([jnp.where(base_valid, lo_h, U32(0)),
                              jnp.where(evalid, erh, U32(0))])
    rows_l = jnp.concatenate([jnp.where(base_valid, lo_l, U32(0)),
                              jnp.where(evalid, erl, U32(0))])
    pids = jnp.concatenate([pids0, epat_c])
    valid = jnp.concatenate([base_valid, evalid])
    return rows_h, rows_l, pids, valid, dropped


def walk_rows_wide(meta, fused, count_arr, sa, sent, rows_h, rows_l, valid):
    """Two-lane LF walk to a sampled row (locate/mod.rs:21-35).  Any
    sampling ratio 1..2^15 (``p_divmod_const``)."""
    r = meta.sampling_ratio

    def needs_step(ph_, pl_, done):
        return (p_divmod_const(ph_, pl_, r)[1] != 0) & ~done & valid

    def cond(carry):
        ph, pl, off, lh, ll, done = carry
        return jnp.any(needs_step(ph, pl, done))

    def body(carry):
        ph, pl, off, lh, ll, done = carry
        need = needs_step(ph, pl, done)
        qh = jnp.where(need, ph, U32(0))
        ql = jnp.where(need, pl, U32(0))
        rh, rl, symidx, is_sent = pre_rank_and_symidx_wide(
            meta, fused, sent, qh, ql)
        pre_h = take_small(count_arr[0], symidx, meta.sigma + 1)
        pre_l = take_small(count_arr[1], symidx, meta.sigma + 1)
        hit = need & is_sent
        lh, ll = p_where(hit, U32(0), off, lh, ll)
        done = done | hit
        step = need & ~is_sent
        nh, nl = p_add(pre_h, pre_l, rh, rl)
        ph, pl = p_where(step, nh, nl, ph, pl)
        off = off + step.astype(U32)
        return ph, pl, off, lh, ll, done

    off = jnp.zeros_like(rows_l)
    lh = jnp.zeros_like(rows_l)
    ll = jnp.zeros_like(rows_l)
    done = valid & False
    ph, pl = rows_h, rows_l
    ph, pl, off, lh, ll, done = jax.lax.while_loop(
        cond, body, (ph, pl, off, lh, ll, done))
    # upload-validated envelope: the SA index v/r fits one uint32
    idx = p_divmod_const(ph, pl, r)[0]
    sh = jnp.take(sa[0], idx)
    sl = jnp.take(sa[1], idx)
    sh, sl = p_add_u32(sh, sl, off)
    return p_where(done, lh, ll, sh, sl)


def locate_rows_wide(meta, fused, count_arr, sa, sent, lo_h, lo_l,
                     hi_h, hi_l, capacity: int):
    rows_h, rows_l, pids, valid, dropped = expand_ranges_wide(
        lo_h, lo_l, hi_h, hi_l, capacity)
    lh, ll = walk_rows_wide(meta, fused, count_arr, sa, sent,
                            rows_h, rows_l, valid)
    return lh, ll, pids, valid, dropped
