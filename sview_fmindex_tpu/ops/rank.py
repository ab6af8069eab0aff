"""Batched rank/occ primitives on the fused device table.

The device index packs, per block, the rank checkpoint row and the bit-plane
lanes into ONE uint32 row:

    fused[b] = [ ckpt[b,0..sigma) | plane0_lane0..plane0_laneL | plane1... ]

so a rank query is a single row gather + elementwise integer ops.  Lane layout is
MSB-first: lane l covers block positions [32l, 32l+32), position i maps to
bit (31 - i%32) — the direct 32-bit-lane decomposition of the reference's
shift-in-from-the-right vectors (``blocks/block2.rs:18-33``).

Semantics reproduced exactly:
- ``get_next_rank`` (``bwm/mod.rs:197-215``): +1 position shift below the
  sentinel row; checkpoint + popcount of the top-``rem`` positions.
- ``get_pre_rank_and_symidx`` (``bwm/mod.rs:217-236``): also decodes the
  symbol at the position; the sentinel row itself is signalled by a mask.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

U32 = jnp.uint32


def _shift_amount(meta) -> int:
    return meta.block_len.bit_length() - 1


def _split_pos(meta, sentinel: jax.Array, pos: jax.Array):
    """sentinel shift + block/rem split.  pos uint32 [...]."""
    p = pos + (pos < sentinel).astype(U32)
    q = (p >> _shift_amount(meta)).astype(jnp.int32)
    rem = p & U32(meta.block_len - 1)
    return q, rem


def _lane_masks(meta, rem: jax.Array) -> jax.Array:
    """Per-lane bitmask selecting positions < rem.  rem uint32 [...] ->
    uint32 [..., num_lanes]."""
    lanes32 = jnp.arange(meta.num_lanes, dtype=jnp.int32) * 32
    take = jnp.clip(rem.astype(jnp.int32)[..., None] - lanes32, 0, 32)
    shift = jnp.minimum(32 - take, 31).astype(U32)
    full = U32(0xFFFFFFFF)
    mask = (full << shift).astype(U32)
    return jnp.where(take == 0, U32(0), mask)


def _plane_lanes(meta, rows: jax.Array) -> jax.Array:
    """fused rows [..., W] -> plane lanes [..., num_planes, num_lanes]."""
    return rows[..., meta.sigma :].reshape(
        *rows.shape[:-1], meta.num_planes, meta.num_lanes
    )


def _combine_planes(meta, planes: jax.Array, symidx: jax.Array) -> jax.Array:
    """AND/NOT-combine the plane lanes to isolate one symbol.

    planes [..., num_planes, num_lanes], symidx int32 [...] ->
    uint32 [..., num_lanes] with a 1 bit where the block symbol == symidx.
    """
    bits = (symidx[..., None] >> jnp.arange(meta.num_planes, dtype=jnp.int32)) & 1
    sel = jnp.where(bits[..., None].astype(bool), planes, ~planes)
    out = sel[..., 0, :]
    for j in range(1, meta.num_planes):
        out = out & sel[..., j, :]
    return out


def derive_fused_device(meta, planes: jax.Array, text_len: int) -> jax.Array:
    """Device-derive the full fused rank table from the plane columns alone.

    ``planes``: uint32 ``[n_blocks, num_planes*num_lanes]`` — exactly the
    fused table's plane columns (``fused[:, sigma:]``).  Returns the fused
    table ``[n_blocks, sigma + num_planes*num_lanes]`` with
    ``checkpoint[b, s]`` = count of symbol s in the BWT before block b
    (``bwm/mod.rs:126-134``) computed as an exclusive cumsum of per-block
    popcounts; the final partial block's MSB-first zero padding
    (``bwm/mod.rs:97-104``) is masked out so it cannot count as symbol 0.

    Only the planes cross the host->device link (half the fused bytes);
    the checkpoint columns are a popcount + cumsum pass on device.
    Bit-identical to the host-assembled fused table (tested).
    """
    return _derive_fused_jit(meta, planes, int(text_len))


@functools.partial(jax.jit, static_argnums=(0, 2))
def _derive_fused_jit(meta, planes, text_len: int):
    n_blocks = planes.shape[0]
    pl = planes.reshape(n_blocks, meta.num_planes, meta.num_lanes)
    start = jnp.arange(n_blocks, dtype=U32) * U32(meta.block_len)
    n_u = U32(text_len)
    valid = jnp.where(start >= n_u, U32(0),
                      jnp.minimum(n_u - start, U32(meta.block_len)))
    lmask = _lane_masks(meta, valid)
    per_block = []
    for s in range(meta.sigma):
        comb = None
        for j in range(meta.num_planes):
            x = pl[:, j, :] if (s >> j) & 1 else ~pl[:, j, :]
            comb = x if comb is None else comb & x
        per_block.append(jnp.sum(jax.lax.population_count(comb & lmask),
                                 axis=-1, dtype=U32))
    cnt = jnp.stack(per_block, axis=1)
    ckpt = jnp.concatenate(
        [jnp.zeros((1, meta.sigma), U32),
         jnp.cumsum(cnt[:-1], axis=0, dtype=U32)], axis=0)
    return jnp.concatenate([ckpt, planes], axis=1)


def rank_from_rows(meta, rows: jax.Array, rem: jax.Array, symidx: jax.Array) -> jax.Array:
    """Rank math given already-gathered fused rows [..., W] (used by the
    range-sharded layer, where the row gather is a collective)."""
    ckpt = jnp.take_along_axis(rows, symidx[..., None], axis=-1)[..., 0]
    planes = _plane_lanes(meta, rows)
    combined = _combine_planes(meta, planes, symidx)
    cnt = jax.lax.population_count(combined & _lane_masks(meta, rem))
    return ckpt + jnp.sum(cnt, axis=-1, dtype=U32)


def rank_next(meta, fused: jax.Array, sentinel: jax.Array, pos: jax.Array, symidx: jax.Array) -> jax.Array:
    """Batched ``get_next_rank(pos, symidx)``: occurrences of symidx in the
    BWT strictly before (shifted) pos.  pos uint32 [...], symidx int32 [...]."""
    q, rem = _split_pos(meta, sentinel, pos)
    rows = jnp.take(fused, q, axis=0)
    return rank_from_rows(meta, rows, rem, symidx)


def pre_rank_and_symidx(meta, fused: jax.Array, sentinel: jax.Array, pos: jax.Array):
    """Batched ``get_pre_rank_and_symidx(pos)``.

    Returns (rank uint32, symidx int32, is_sentinel bool); rank/symidx are
    garbage where is_sentinel (the caller must mask), matching the
    reference's ``None`` at ``pos == sentinel_index - 1``.
    """
    is_sentinel = pos == (sentinel - U32(1))
    q, rem = _split_pos(meta, sentinel, pos)
    rows = jnp.take(fused, q, axis=0)
    rank, symidx = pre_rank_and_symidx_from_rows(meta, rows, rem)
    return rank, symidx, is_sentinel


def pre_rank_and_symidx_from_rows(meta, rows: jax.Array, rem: jax.Array):
    """Decode + rank math given already-gathered fused rows (range-sharded
    layer variant)."""
    planes = _plane_lanes(meta, rows)

    lane = (rem >> U32(5)).astype(jnp.int32)
    bit = U32(31) - (rem & U32(31))
    lane_vals = jnp.take_along_axis(
        planes, lane[..., None, None].repeat(meta.num_planes, axis=-2), axis=-1
    )[..., 0]
    plane_bits = (lane_vals >> bit[..., None]) & U32(1)
    symidx = jnp.sum(
        plane_bits.astype(jnp.int32) << jnp.arange(meta.num_planes, dtype=jnp.int32),
        axis=-1,
    )

    ckpt = jnp.take_along_axis(rows, symidx[..., None], axis=-1)[..., 0]
    combined = _combine_planes(meta, planes, symidx)
    cnt = jax.lax.population_count(combined & _lane_masks(meta, rem))
    rank = ckpt + jnp.sum(cnt, axis=-1, dtype=U32)
    return rank, symidx
