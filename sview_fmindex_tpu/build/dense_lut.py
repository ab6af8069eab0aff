"""Dense device-side k-mer seed table ("LUT densification").

The blob's k-mer table (reference ``count_array.rs:111-145``) is built from
the text with base ``sigma+1`` digits so it can also serve short patterns.
For the device engine we additionally precompute, at upload time, the
backward-search range of EVERY length-``dk`` symbol string (``dk >= k``): a pattern of
length >= dk then seeds with ONE table gather covering its last dk symbols,
cutting the LF-step loop (2 rank gathers per step) roughly in half for the
benchmark's 20 bp patterns.

This is pure memoization of the search recursion — results are bit-identical
to seeding with the blob table and LF-stepping (config-invariance semantics,
``tests/config_invariance``).  The first levels are computed HOST-side with
vectorized numpy (np.bitwise_count); deeper levels extend on device
(:func:`extend_dense_lut_device`).
"""
from __future__ import annotations

import numpy as np

# mask[t] selects the t most-significant bits of a uint32 lane
_TAKE_MASK = np.array(
    [0] + [(0xFFFFFFFF << (32 - t)) & 0xFFFFFFFF for t in range(1, 33)],
    dtype=np.uint32,
)


def rank_next_batch(fm, pos: np.ndarray, symidx: np.ndarray) -> np.ndarray:
    """Vectorized ``BwmView::get_next_rank`` (bwm/mod.rs:197-215).

    pos int64 [M], symidx int64 [M] -> int64 [M].
    """
    L = fm.block.block_len
    shift = L.bit_length() - 1
    p = pos + (pos < fm.sentinel_index)
    q = p >> shift
    rem = p & (L - 1)

    ckpt = fm.rank_checkpoints[q, symidx].astype(np.int64)

    planes = fm.lanes[q]  # [M, num_planes, num_lanes] uint32 (view ok)
    bits = (symidx[:, None] >> np.arange(fm.block.num_planes)) & 1
    sel = np.where(bits[..., None].astype(bool), planes, ~planes)
    combined = sel[:, 0, :]
    for j in range(1, fm.block.num_planes):
        combined = combined & sel[:, j, :]

    lanes32 = np.arange(fm.block.num_lanes, dtype=np.int64) * 32
    take = np.clip(rem[:, None] - lanes32, 0, 32)
    cnt = np.bitwise_count(combined & _TAKE_MASK[take]).sum(axis=1, dtype=np.int64)
    return ckpt + cnt


def dense_lut(fm, dk: int, chunk: int = 1 << 24,
              wide: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) uint32 [sigma**dk] — the backward-search range of every
    length-``dk`` symbol string, indexed big-endian (first symbol of the
    string is the most-significant base-sigma digit).  Chunked so peak
    memory stays bounded at dk >= 13 (4**13 = 67M entries).

    ``wide=True`` returns uint64 arrays (u64-position indexes: range
    bounds can exceed 2^32; the internal math is int64 either way)."""
    sigma = fm.symbol_count
    k = fm.kmer_size
    if dk < k:
        raise ValueError(f"dense k {dk} must be >= blob k-mer size {k}")
    M = sigma**dk
    dt = np.uint64 if wide else np.uint32
    out_lo = np.empty(M, dtype=dt)
    out_hi = np.empty(M, dtype=dt)
    count_array = fm.count_array.astype(np.int64)
    tbl = fm.kmer_count_table
    for c0 in range(0, M, chunk):
        c1 = min(c0 + chunk, M)
        idx = np.arange(c0, c1, dtype=np.int64)
        # digit j of the string (j=0 leftmost)
        digits = [(idx // (sigma ** (dk - 1 - j))) % sigma for j in range(dk)]

        # seed with the blob k-mer table on the LAST k digits
        # (count_array.rs:203-223, full-length case)
        tbl_idx = np.zeros(c1 - c0, dtype=np.int64)
        for i in range(k):
            tbl_idx += (digits[dk - k + i] + 1) * (sigma + 1) ** (k - 1 - i)
        lo = tbl[tbl_idx - 1].astype(np.int64)
        hi = tbl[tbl_idx].astype(np.int64)

        # LF steps for the remaining digits, right to left
        for step in range(dk - k):
            s = digits[dk - k - 1 - step]
            active = lo < hi
            pre = count_array[s]
            nlo = pre + rank_next_batch(fm, lo, s)
            nhi = pre + rank_next_batch(fm, hi, s)
            lo = np.where(active, nlo, lo)
            hi = np.where(active, nhi, hi)
        out_lo[c0:c1] = lo.astype(dt)
        out_hi[c0:c1] = hi.astype(dt)
    return out_lo, out_hi


def auto_dense_k(sigma: int, blob_k: int, max_entries: int,
                 text_len: int | None = None) -> int:
    """Largest dk with sigma**dk <= max_entries; 0 disables densification
    (when it would not beat the blob table).  ``text_len`` additionally caps
    dk at sigma**dk <= 4*text_len — beyond that nearly every entry is an
    empty range and the table is wasted memory."""
    dk = 1
    while sigma ** (dk + 1) <= max_entries:
        dk += 1
    if text_len is not None:
        while dk > 1 and sigma**dk > 4 * text_len:
            dk -= 1
    return dk if dk > blob_k else 0


def extend_dense_lut_device(meta, fused, count_arr, sentinel, d_lo, d_hi,
                            levels: int, chunk: int = 1 << 23):
    """Extend a device-resident dense table by ``levels`` symbols ON DEVICE.

    The dk+1 table's entry for string c.w (symbol c prepended to the
    length-dk string w) is one LF step with c over the dk entry of w:
    ``new[c * M + i] = C[c] + rank_c(old[i])`` — so each level costs
    2*sigma*M batched rank queries on the device instead of a
    multi-minute host pass.  Entries whose source range
    is empty map to an equal (lo == hi) pair, which seeds the search
    identically to the host-built table (count 0) even though the raw
    values may differ — results are bit-identical (config invariance).
    """
    import jax
    import jax.numpy as jnp

    from ..ops.rank import rank_next

    sigma = meta.sigma

    # ONE compiled shape: symbol and C[symbol] are traced scalars, chunks
    # are padded to a fixed size on an accelerator
    @jax.jit
    def _step(fused, sentinel, ends, pre, c):
        sym = jnp.broadcast_to(c, ends.shape).astype(jnp.int32)
        return pre + rank_next(meta, fused, sentinel, ends, sym)

    on_accelerator = jax.default_backend() != "cpu"
    for _ in range(levels):
        M = d_lo.shape[0]
        # accelerator: ONE fixed compiled shape (padding waste on small
        # levels is cheap next to one more compile).  CPU (tests):
        # shape-fit chunks — compiles are cheap, padding isn't.
        csz = chunk if on_accelerator else min(
            chunk, max(1 << 12, 1 << (M - 1).bit_length()))
        n_chunks = -(-M // csz)
        pad = n_chunks * csz - M
        if pad:
            d_lo = jnp.concatenate([d_lo, jnp.zeros(pad, jnp.uint32)])
            d_hi = jnp.concatenate([d_hi, jnp.zeros(pad, jnp.uint32)])
        lo_parts, hi_parts = [], []
        for c in range(sigma):
            pre = jnp.uint32(count_arr[c])
            cj = jnp.int32(c)
            clo, chi = [], []
            for c0 in range(0, n_chunks * csz, csz):
                clo.append(_step(fused, sentinel, d_lo[c0:c0 + csz], pre, cj))
                chi.append(_step(fused, sentinel, d_hi[c0:c0 + csz], pre, cj))
            lo_parts.append(jnp.concatenate(clo)[:M] if len(clo) > 1 else clo[0][:M])
            hi_parts.append(jnp.concatenate(chi)[:M] if len(chi) > 1 else chi[0][:M])
        d_lo = jnp.concatenate(lo_parts)
        d_hi = jnp.concatenate(hi_parts)
    return d_lo, d_hi
