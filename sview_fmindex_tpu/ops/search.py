"""Batched lockstep backward search (count).

The reference's per-pattern recursion (``locate/with_slice.rs:21-33``) becomes
one jitted program over a [B, Lmax] pattern batch: a k-mer table seeds every
lane's range in O(1) (``count_array.rs:203-223``, incl. the short-pattern
subtree range), then a ``fori_loop`` advances all lanes one LF step per
iteration with done-masks.  Both range endpoints of all lanes are ranked in a
single fused-table gather per step.

Two seed tables exist:

- the blob's base-``sigma+1`` k-mer table (reference semantics, also serves
  patterns shorter than k via the subtree range), and
- an optional DENSE device table over all ``sigma**dense_k`` symbol strings
  (``build/dense_lut.py``) which seeds the last ``dense_k`` symbols of any
  pattern of length >= dense_k in one gather — memoized backward search,
  bit-identical results, roughly half the LF steps for 20 bp queries.

The LF-loop trip count ``steps`` is a static argument so an all-20bp batch
with dense_k=10 compiles a 10-iteration loop, not Lmax-k.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .rank import U32, rank_next


def encode_patterns(enc_table: jax.Array, patterns: jax.Array,
                    meta=None) -> jax.Array:
    """raw pattern bytes [B, L] -> symbol indices int32 [B, L].

    When ``meta`` carries the table's static content (``enc_pairs``: the few
    bytes that do NOT map to the wildcard/default symbol,
    ``encoding_table.rs:17-24``), the encode is a handful of elementwise
    compare-selects that fuse into the search program instead of a
    256-entry table gather.
    """
    if meta is not None and getattr(meta, "enc_identity", False):
        return patterns.astype(jnp.int32)
    pairs = getattr(meta, "enc_pairs", None) if meta is not None else None
    if pairs is not None and len(pairs) <= 128:
        out = jnp.full(patterns.shape, meta.enc_default, jnp.int32)
        for v, s in pairs:
            out = jnp.where(patterns == jnp.uint8(v), jnp.int32(s), out)
        return out
    return jnp.take(enc_table, patterns.astype(jnp.int32), axis=0).astype(jnp.int32)


def blob_initial_range(meta, kmer_tbl: jax.Array, sym: jax.Array, lens: jax.Array):
    """Blob k-mer LUT seeding.  sym int32 [B, L], lens int32 [B].

    Returns (lo, hi) uint32 [B] and rem_steps int32 [B] (LF steps left).
    """
    k = meta.kmer_size
    base = meta.sigma + 1
    Lmax = sym.shape[-1]
    m = jnp.minimum(lens, k)
    start = jnp.zeros(sym.shape[:-1], dtype=jnp.int32)
    for i in range(k):
        j = jnp.clip(lens - m + i, 0, max(Lmax - 1, 0))
        digit = jnp.take_along_axis(sym, j[..., None], axis=-1)[..., 0] + 1
        start = start + jnp.where(i < m, digit * (base ** (k - 1 - i)), 0)
    # gap covers the unsearched low digits for short patterns
    # (count_array.rs:209-215); 0 when len >= k.
    powers = jnp.asarray([base**e for e in range(k + 1)], dtype=jnp.int32)
    gap = jnp.take(powers, k - m) - 1
    lo = jnp.take(kmer_tbl, start - 1)
    hi = jnp.take(kmer_tbl, start + gap)
    rem_steps = jnp.maximum(lens - k, 0)
    return lo, hi, rem_steps


def initial_range(meta, kmer_tbl, dense_lo, dense_hi, sym, lens,
                  all_dense: bool = False, fixed_len: int | None = None):
    """Seed every lane: dense table when len >= dense_k, blob table else.

    Returns (lo, hi) uint32 [B], rem_steps int32 [B], seed_len int32 [B].

    ``all_dense`` (static, host-derived): every lane's length >= dense_k, so
    the blob-table seed is skipped entirely.  ``fixed_len`` (static): all
    lanes share this length, so digit extraction is static slicing instead of
    take_along_axis.
    """
    if all_dense and meta.dense_k:
        dk = meta.dense_k
        idx = jnp.zeros(sym.shape[:-1], dtype=jnp.int32)
        for i in range(dk):
            if fixed_len is not None:
                digit = sym[..., fixed_len - dk + i]
            else:
                j = jnp.clip(lens - dk + i, 0, max(sym.shape[-1] - 1, 0))
                digit = jnp.take_along_axis(sym, j[..., None], axis=-1)[..., 0]
            idx = idx * meta.sigma + digit
        lo = jnp.take(dense_lo, idx)
        hi = jnp.take(dense_hi, idx)
        rem = lens - dk
        seed_len = jnp.full_like(lens, dk)
        return lo, hi, rem, seed_len
    lo, hi, rem = blob_initial_range(meta, kmer_tbl, sym, lens)
    seed_len = jnp.full_like(lens, meta.kmer_size)
    if meta.dense_k:
        dk = meta.dense_k
        Lmax = sym.shape[-1]
        idx = jnp.zeros(sym.shape[:-1], dtype=jnp.int32)
        for i in range(dk):
            j = jnp.clip(lens - dk + i, 0, max(Lmax - 1, 0))
            digit = jnp.take_along_axis(sym, j[..., None], axis=-1)[..., 0]
            idx = idx * meta.sigma + digit
        use = lens >= dk
        idx = jnp.where(use, idx, 0)
        lo = jnp.where(use, jnp.take(dense_lo, idx), lo)
        hi = jnp.where(use, jnp.take(dense_hi, idx), hi)
        rem = jnp.where(use, lens - dk, rem)
        seed_len = jnp.where(use, dk, seed_len)
    return lo, hi, rem, seed_len


def max_steps_needed(meta, lens, Lmax: int) -> int:
    """Host-side static trip count for the LF loop.  Exact for uniform-length
    batches (every step is ~ms at Gbp scale); rounded up to 2 otherwise to
    bound executable proliferation."""
    lens = np.asarray(lens)
    if lens.size == 0:
        return 0
    if meta.dense_k:
        per = np.where(
            lens >= meta.dense_k,
            lens - meta.dense_k,
            np.maximum(lens - meta.kmer_size, 0),
        )
    else:
        per = np.maximum(lens - meta.kmer_size, 0)
    s = int(per.max())
    if not (lens == lens[0]).all():
        s = -(-s // 2) * 2
    cap = max(Lmax - meta.kmer_size, 0)
    return min(s, cap)


def take_small(table: jax.Array, idx: jax.Array, size: int) -> jax.Array:
    """Gather-free lookup in a tiny table (unrolled compare-select that
    fuses with its elementwise neighbours)."""
    out = jnp.zeros_like(idx, dtype=table.dtype) + table[0] * (idx == 0)
    for s in range(1, size):
        out = jnp.where(idx == s, table[s], out)
    return out


def pos_ranges(meta, fused, kmer_tbl, dense_lo, dense_hi, count_arr, sentinel,
               sym, lens, steps: int, all_dense: bool = False,
               fixed_len: int | None = None):
    """Full backward search: (lo, hi) uint32 [B] for every pattern lane.

    ``steps`` must be >= every lane's rem_steps (see max_steps_needed).
    Each LF step ranks both range endpoints of every lane with one fused-row
    gather (``ops.rank.rank_next``).  ``all_dense``/``fixed_len`` are static
    host-derived batch facts (see ``initial_range``) that strip gathers from
    the seed and symbol fetches.
    """
    lo, hi, rem_steps, seed_len = initial_range(
        meta, kmer_tbl, dense_lo, dense_hi, sym, lens,
        all_dense=all_dense, fixed_len=fixed_len,
    )
    Lmax = sym.shape[-1]
    if steps == 0:
        return lo, hi
    static_seed = meta.dense_k if (all_dense and meta.dense_k) else None

    def sym_at(back):
        """Symbol ``back`` steps from the seed (back=0 is the first LF
        symbol); the clip keeps dead lanes in range."""
        if static_seed is not None and fixed_len is not None:
            # uniform-length all-dense batch: the symbol index is static
            j0 = fixed_len - static_seed - 1
            s = jax.lax.dynamic_slice_in_dim(sym, 0, max(j0 + 1, 1), axis=-1)
            return jax.lax.dynamic_index_in_dim(
                s, jnp.maximum(j0 - back, 0), axis=-1, keepdims=False)
        j = jnp.clip(lens - seed_len - 1 - back, 0, Lmax - 1)
        return jnp.take_along_axis(sym, j[..., None], axis=-1)[..., 0]

    def body(t, carry):
        lo, hi = carry
        active = (t < rem_steps) & (lo < hi)
        s = sym_at(t)
        # inactive lanes gather block 0 (hot row) instead of a random one
        ends = jnp.stack([lo, hi])  # [2, B]
        ends_q = jnp.where(active[None, :], ends, U32(0))
        pre = jnp.take(count_arr, s)
        ranks = rank_next(meta, fused, sentinel, ends_q,
                          jnp.broadcast_to(s, ends.shape))
        return (jnp.where(active, pre + ranks[0], lo),
                jnp.where(active, pre + ranks[1], hi))

    return jax.lax.fori_loop(0, steps, body, (lo, hi))


def count_batch(meta, fused, kmer_tbl, dense_lo, dense_hi, count_arr, sentinel,
                enc_table, patterns, lens, steps: int,
                all_dense: bool = False, fixed_len: int | None = None):
    """counts uint32 [B] for raw byte patterns [B, Lmax] with lengths [B]."""
    sym = encode_patterns(enc_table, patterns, meta)
    lo, hi = pos_ranges(
        meta, fused, kmer_tbl, dense_lo, dense_hi, count_arr, sentinel,
        sym, lens.astype(jnp.int32), steps,
        all_dense=all_dense, fixed_len=fixed_len,
    )
    return hi - lo
