"""Range-sharded index: the big tables split across devices by block range.

Pattern-DP (``parallel/query.py``) replicates the whole index per device —
the right call while it fits in device memory.  When it does NOT fit (at
1 Gbp the fused table + dense LUT + full SA already take ~6.5 GB; a text
tens of times larger cannot replicate), this layer shards the two
text-length-proportional tables along their block/position dimension:

- ``fused``   [n_blocks, W]  -> [n_blocks/D, W] per device
- ``sa``      [n_sa]         -> [n_sa/D] per device (sampled or full)

while the O(sigma^k) tables (k-mer LUT, dense seeds, count array, encoder)
stay replicated.  A rank query's row gather becomes a collective:

    every device gathers the rows it owns (masked local ``take``) and a
    ``psum`` over the shard axis assembles the full row on every device
    (each global row has exactly one owner, so the sum IS a select).

The query batch is REPLICATED across the shard axis (each device runs the
same lockstep search over its table slice) — compute duplicates D-fold but
memory scales 1/D, which is the point of range sharding; compose with
pattern-DP on a 2-D mesh to buy back compute.  The reference has no analog
(single-process, SURVEY.md §2); this is the "optional: range-shard the
occ/SA arrays" row of the parallelism inventory.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import locate as locate_ops
from ..ops import search as search_ops
from ..ops.rank import (
    U32,
    _split_pos,
    pre_rank_and_symidx_from_rows,
    rank_from_rows,
)
from .mesh import make_mesh

RS_AXIS = "rs"


def _owned_gather(axis: str, table_shard: jax.Array, idx: jax.Array) -> jax.Array:
    """Collective row gather from a dim-0-sharded table.

    ``idx`` (replicated, global row ids, uint32) -> rows, identical on
    every device: mask-gather the locally owned rows, psum across the
    axis (each row has exactly one owner, so the sum is a select).
    All ownership math stays uint32 — safe for global ids >= 2^31.
    """
    n_local = U32(table_shard.shape[0])
    shard = jax.lax.axis_index(axis).astype(jnp.uint32)
    start = shard * n_local
    idx = idx.astype(jnp.uint32)
    mine = (idx >= start) & (idx - start < n_local)
    local_c = jnp.where(mine, idx - start, U32(0))
    vals = jnp.take(table_shard, local_c, axis=0)
    mask = mine if vals.ndim == idx.ndim else mine[..., None]
    vals = jnp.where(mask, vals, 0)
    return jax.lax.psum(vals, axis)


class RangeShardedFmIndex:
    """A device-mesh FM-index whose fused/SA tables are range-sharded.

    ``dp_axis``: optional second mesh axis for pattern data-parallelism —
    tables shard over ``axis`` (and replicate across ``dp_axis``), pattern
    batches shard over ``dp_axis``; a 2-D (rs, dp) mesh buys back the
    compute that pure range-sharding duplicates.
    """

    def __init__(self, fm, mesh=None, axis: str = RS_AXIS,
                 dp_axis: str | None = None,
                 sa_full: "np.ndarray | str | None" = None,
                 force_wide: bool = False,
                 dense_entries: int = 1 << 20):
        self.mesh = mesh if mesh is not None else make_mesh(axis=axis)
        self.axis = axis
        self.dp_axis = dp_axis
        if dp_axis is not None:
            assert axis in self.mesh.axis_names and dp_axis in self.mesh.axis_names, \
                (self.mesh.axis_names, axis, dp_axis)
        D = self.mesh.shape[axis] if dp_axis is not None else self.mesh.devices.size

        # PER-SHARD staging: each device's table slice is built host-side
        # on demand (make_array_from_callback) straight from the blob's
        # zero-copy views — the full fused table / SA is NEVER
        # materialized on host or on any single device (routing the whole
        # index through a single-device DeviceFmIndex would run that
        # device out of memory in the exact case this layer exists for).
        from ..build.dense_lut import auto_dense_k, dense_lut
        from ..models import device_index as DI

        wide = force_wide or fm.text_len >= 2**32
        if wide:
            DI.validate_wide(fm)
            assert sa_full is None, "sa_full is a narrow-path option"
        sigma = fm.symbol_count
        kind = fm.block
        planes_eff = DI.planes_effective(fm)
        enc_table, enc_identity, enc_default, enc_pairs = DI._enc_static(fm)
        # dense seeds are a host pass of random rank gathers over the
        # blob views — minutes of mmap page-faults at multi-Gbp scale;
        # ``dense_entries=0`` skips it when staging time matters more
        # than per-query LF steps (e.g. acceptance checks)
        dk = auto_dense_k(sigma, fm.kmer_size, dense_entries or 0,
                          text_len=fm.text_len)
        if isinstance(sa_full, str):
            sa_full = np.memmap(sa_full, dtype="<u4", mode="r")
        self.meta = DI.IndexMeta(
            sigma=sigma, kmer_size=fm.kmer_size,
            sampling_ratio=fm.sampling_ratio, block_len=kind.block_len,
            num_planes=planes_eff, num_lanes=kind.num_lanes, dense_k=dk,
            wide_pos=wide, enc_identity=enc_identity, enc_pairs=enc_pairs,
            enc_default=enc_default, has_sa_full=sa_full is not None)

        nb = fm.rank_checkpoints.shape[0]
        nb_pad = -(-nb // D) * D
        width = (2 * sigma if wide else sigma) + planes_eff * kind.num_lanes
        rows_fn = DI.wide_fused_rows if wide else DI.narrow_fused_rows

        def _bounds(sl, limit):
            a0 = sl.start if sl.start is not None else 0
            a1 = sl.stop if sl.stop is not None else limit
            return a0, a1

        def fused_cb(idx):
            b0, b1 = _bounds(idx[0], nb_pad)
            hi = min(b1, nb)
            chunk = (rows_fn(fm, planes_eff, b0, hi) if hi > b0
                     else np.zeros((0, width), np.uint32))
            if b1 > hi:
                chunk = np.concatenate(
                    [chunk, np.zeros((b1 - hi, width), np.uint32)])
            return chunk

        shard_spec = NamedSharding(self.mesh, P(axis, None))
        repl = NamedSharding(self.mesh, P())
        self.fused = jax.make_array_from_callback(
            (nb_pad, width), shard_spec, fused_cb)

        sa_src = sa_full if sa_full is not None else fm.suffix_array
        m = sa_src.shape[0]
        m_pad = -(-m // D) * D
        if wide:
            # wide SA shards row-major [m, 2] (hi, lo) so _owned_gather's
            # dim-0 ownership math applies unchanged
            def sa_cb(idx):
                a0, a1 = _bounds(idx[0], m_pad)
                hi = min(a1, m)
                out = np.zeros((a1 - a0, 2), np.uint32)
                piece = np.asarray(sa_src[a0:hi], dtype=np.uint64)
                out[: hi - a0, 0] = (piece >> np.uint64(32)).astype(np.uint32)
                out[: hi - a0, 1] = (piece & np.uint64(0xFFFFFFFF)).astype(
                    np.uint32)
                return out

            self.sa = jax.make_array_from_callback(
                (m_pad, 2), shard_spec, sa_cb)
        else:
            def sa_cb(idx):
                a0, a1 = _bounds(idx[0], m_pad)
                hi = min(a1, m)
                out = np.zeros(a1 - a0, np.uint32)
                out[: hi - a0] = np.asarray(sa_src[a0:hi]).astype(
                    np.uint32, copy=False)
                return out

            self.sa = jax.make_array_from_callback(
                (m_pad,), NamedSharding(self.mesh, P(axis)), sa_cb)

        put = jax.device_put
        if wide:
            self.kmer_tbl = put(DI.split2(fm.kmer_count_table), repl)
            self.count_arr = put(DI.split2(fm.count_array), repl)
            self.sentinel = put(
                DI.split2(np.array([fm.sentinel_index]))[:, 0], repl)
            if dk:
                d_lo, d_hi = dense_lut(fm, dk, wide=True)
                d_lo, d_hi = DI.split2(d_lo), DI.split2(d_hi)
            else:
                d_lo = d_hi = np.zeros((2, 1), np.uint32)
        else:
            self.kmer_tbl = put(
                fm.kmer_count_table.astype(np.uint32, copy=False), repl)
            self.count_arr = put(fm.count_array.astype(np.uint32), repl)
            self.sentinel = put(np.uint32(fm.sentinel_index), repl)
            if dk:
                d_lo, d_hi = dense_lut(fm, dk)
            else:
                d_lo = d_hi = np.zeros(1, np.uint32)
        self.dense_lo = put(d_lo, repl)
        self.dense_hi = put(d_hi, repl)
        self.enc_table = put(enc_table, repl)

    @property
    def n_devices(self) -> int:
        return self.mesh.devices.size

    @property
    def dp_size(self) -> int:
        return self.mesh.shape[self.dp_axis] if self.dp_axis else 1

    # ------------------------------------------------------------------
    def _args(self, patterns, lens):
        patterns = np.asarray(patterns, dtype=np.uint8)
        if patterns.ndim == 1:
            patterns = patterns[None]
        if lens is None:
            lens = np.full(patterns.shape[0], patterns.shape[1], np.int32)
        lens = np.asarray(lens, dtype=np.int32)
        b = patterns.shape[0]
        pad = (-b) % self.dp_size
        if pad:  # padding lanes get length 1, excluded by callers via b
            patterns = np.concatenate(
                [patterns, np.zeros((pad, patterns.shape[1]), np.uint8)])
            lens = np.concatenate([lens, np.ones(pad, np.int32)])
        steps = search_ops.max_steps_needed(self.meta, lens, patterns.shape[1])
        return patterns, lens, steps, b

    def count(self, patterns, lens=None):
        """counts[:b] — numpy uint64 for wide (u64-position) indexes."""
        patterns, lens, steps, b = self._args(patterns, lens)
        out = _rs_ranges(self, patterns, lens, steps)
        if self.meta.wide_pos:
            from ..ops.wide import combine64

            lo_h, lo_l, hi_h, hi_l = out
            return (combine64(hi_h, hi_l) - combine64(lo_h, lo_l))[:b]
        lo, hi = out
        return (hi - lo)[:b]

    def pos_ranges(self, patterns, lens=None):
        patterns, lens, steps, b = self._args(patterns, lens)
        out = _rs_ranges(self, patterns, lens, steps)
        return tuple(x[:b] for x in out)

    def locate(self, patterns, lens=None, capacity: int | None = None):
        """(locs, pids, valid, dropped); with dp_axis, ``capacity`` is PER dp
        shard and pids are global batch indices (padding excluded via valid).
        ``dropped`` counts per-dp-shard overflow beyond ``capacity`` (all
        zero when capacity was auto-sized).  Wide indexes return locs as
        numpy uint64."""
        patterns, lens, steps, b = self._args(patterns, lens)
        out = _rs_ranges(self, patterns, lens, steps)
        if self.meta.wide_pos:
            from ..ops.wide import combine64

            lo_h, lo_l, hi_h, hi_l = out
            counts = combine64(hi_h, hi_l) - combine64(lo_h, lo_l)
        else:
            lo, hi = out
            counts = np.asarray(hi).astype(np.int64) - np.asarray(lo)
        if capacity is None:
            counts = counts.copy()
            counts[b:] = 0
            per = patterns.shape[0] // self.dp_size
            capacity = max(
                locate_ops.expand_capacity(c, base=per)
                for c in counts.reshape(self.dp_size, per))
        if self.meta.wide_pos:
            lh, ll, pids, valid, dropped = _rs_resolve(self, out, capacity)
            from ..ops.wide import combine64 as _c64

            locs = _c64(lh, ll)
        else:
            locs, pids, valid, dropped = _rs_resolve(self, out, capacity)
            locs = np.asarray(locs)
        valid = np.asarray(valid) & (np.asarray(pids) < b)
        return locs, np.asarray(pids), valid, np.asarray(dropped)


def _rs_tree(idx: RangeShardedFmIndex):
    return (idx.fused, idx.sa, idx.kmer_tbl, idx.dense_lo, idx.dense_hi,
            idx.count_arr, idx.sentinel, idx.enc_table)


@functools.partial(jax.jit, static_argnums=(0, 1, 4))
def _rs_ranges_jit(meta, mesh_axis, tree, inputs, steps):
    mesh, axis, dp = mesh_axis
    fused, sa, kmer_tbl, dense_lo, dense_hi, count_arr, sentinel, enc_table = tree
    patterns, lens = inputs

    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(axis, None), P(), P(), P(), P(), P(), P(),
                  P(dp, None), P(dp)),
        out_specs=(((P(dp),) * 4) if meta.wide_pos else (P(dp), P(dp))),
    )
    def run(fused, kmer_tbl, dense_lo, dense_hi, count_arr, sentinel,
            enc_table, patterns, lens):
        sym = search_ops.encode_patterns(enc_table, patterns, meta)
        Lmax = sym.shape[-1]

        if meta.wide_pos:
            from ..ops import wide as W

            lo_h, lo_l, hi_h, hi_l, rem, seed_len = W.initial_range_wide(
                meta, kmer_tbl, sym, lens, dense_lo, dense_hi)

            def wbody(t, carry):
                lo_h, lo_l, hi_h, hi_l = carry
                active = (t < rem) & W.p_lt(lo_h, lo_l, hi_h, hi_l)
                j = jnp.clip(lens - seed_len - 1 - t, 0, Lmax - 1)
                s = jnp.take_along_axis(sym, j[..., None], axis=-1)[..., 0]
                eh = jnp.stack([jnp.where(active, lo_h, U32(0)),
                                jnp.where(active, hi_h, U32(0))])
                el = jnp.stack([jnp.where(active, lo_l, U32(0)),
                                jnp.where(active, hi_l, U32(0))])
                q, rm = W._split_pos_wide(meta, sentinel, eh, el)
                rows = _owned_gather(axis, fused, q.reshape(-1)).reshape(
                    *q.shape, fused.shape[-1])
                s2 = jnp.broadcast_to(s, eh.shape)
                rh, rl = W.rank_from_rows_wide(meta, rows, rm, s2)
                from ..ops.search import take_small

                pre_h = take_small(count_arr[0], s, meta.sigma + 1)
                pre_l = take_small(count_arr[1], s, meta.sigma + 1)
                nlo = W.p_add(pre_h, pre_l, rh[0], rl[0])
                nhi = W.p_add(pre_h, pre_l, rh[1], rl[1])
                lo_h, lo_l = W.p_where(active, nlo[0], nlo[1], lo_h, lo_l)
                hi_h, hi_l = W.p_where(active, nhi[0], nhi[1], hi_h, hi_l)
                return lo_h, lo_l, hi_h, hi_l

            if steps:
                lo_h, lo_l, hi_h, hi_l = jax.lax.fori_loop(
                    0, steps, wbody, (lo_h, lo_l, hi_h, hi_l))
            return lo_h, lo_l, hi_h, hi_l

        lo, hi, rem_steps, seed_len = search_ops.initial_range(
            meta, kmer_tbl, dense_lo, dense_hi, sym, lens)

        def body(t, carry):
            lo, hi = carry
            active = (t < rem_steps) & (lo < hi)
            j = jnp.clip(lens - seed_len - 1 - t, 0, Lmax - 1)
            s = jnp.take_along_axis(sym, j[..., None], axis=-1)[..., 0]
            ends = jnp.stack([lo, hi])
            ends_q = jnp.where(active[None, :], ends, U32(0))
            q, rm = _split_pos(meta, sentinel, ends_q)
            rows = _owned_gather(axis, fused, q.reshape(-1)).reshape(
                *q.shape, fused.shape[-1])
            s2 = jnp.broadcast_to(s, ends.shape)
            ranks = rank_from_rows(meta, rows, rm, s2)
            pre = jnp.take(count_arr, s)
            nlo = pre + ranks[0]
            nhi = pre + ranks[1]
            return jnp.where(active, nlo, lo), jnp.where(active, nhi, hi)

        if steps:
            lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
        return lo, hi

    return run(fused, kmer_tbl, dense_lo, dense_hi, count_arr, sentinel,
               enc_table, patterns, lens)


def _rs_ranges(idx, patterns, lens, steps):
    return _rs_ranges_jit(idx.meta, (idx.mesh, idx.axis, idx.dp_axis),
                          _rs_tree(idx),
                          (jnp.asarray(patterns), jnp.asarray(lens)), steps)


@functools.partial(jax.jit, static_argnums=(0, 1, 4))
def _rs_resolve_jit(meta, mesh_axis, tree, inputs, capacity):
    mesh, axis, dp = mesh_axis
    fused, sa, kmer_tbl, dense_lo, dense_hi, count_arr, sentinel, enc_table = tree

    if meta.wide_pos:
        lo_h, lo_l, hi_h, hi_l = inputs

        @functools.partial(
            shard_map, mesh=mesh, check_vma=False,
            in_specs=(P(axis, None), P(axis), P(), P(),
                      P(dp), P(dp), P(dp), P(dp)),
            out_specs=(P(dp),) * 5,
        )
        def wrun(fused, sa, count_arr, sentinel, lo_h, lo_l, hi_h, hi_l):
            from ..ops import wide as W
            from ..ops.search import take_small

            rows_h, rows_l, pids, valid, dropped = W.expand_ranges_wide(
                lo_h, lo_l, hi_h, hi_l, capacity)
            if dp is not None:
                pids = pids + jax.lax.axis_index(dp).astype(jnp.int32) \
                    * lo_h.shape[0]
            r = meta.sampling_ratio

            def needs_step(ph_, pl_, done):
                return (W.p_divmod_const(ph_, pl_, r)[1] != 0) & ~done & valid

            def cond(carry):
                ph, pl, off, lh, ll, done = carry
                return jnp.any(needs_step(ph, pl, done))

            def body(carry):
                ph, pl, off, lh, ll, done = carry
                need = needs_step(ph, pl, done)
                qh = jnp.where(need, ph, U32(0))
                ql = jnp.where(need, pl, U32(0))
                sm1h, sm1l = W.p_sub(sentinel[0], sentinel[1], U32(0), U32(1))
                is_sent = (qh == sm1h) & (ql == sm1l) & need
                q, rm = W._split_pos_wide(meta, sentinel, qh, ql)
                frows = _owned_gather(axis, fused, q)
                rh, rl, symidx = W.pre_rank_and_symidx_from_rows_wide(
                    meta, frows, rm)
                pre_h = take_small(count_arr[0], symidx, meta.sigma + 1)
                pre_l = take_small(count_arr[1], symidx, meta.sigma + 1)
                hit = need & is_sent
                lh, ll = W.p_where(hit, U32(0), off, lh, ll)
                done = done | hit
                step = need & ~is_sent
                nh, nl = W.p_add(pre_h, pre_l, rh, rl)
                ph, pl = W.p_where(step, nh, nl, ph, pl)
                off = off + step.astype(U32)
                return ph, pl, off, lh, ll, done

            zero = jnp.zeros_like(rows_l)
            ph, pl, off, lh, ll, done = jax.lax.while_loop(
                cond, body,
                (rows_h, rows_l, zero, zero, zero, valid & False))
            idx = W.p_divmod_const(ph, pl, r)[0]
            srow = _owned_gather(axis, sa, idx)  # [cap, 2] (hi, lo)
            sh, sl = W.p_add_u32(srow[..., 0], srow[..., 1], off)
            lh, ll = W.p_where(done, lh, ll, sh, sl)
            lh = jnp.where(valid, lh, U32(0))
            ll = jnp.where(valid, ll, U32(0))
            return lh, ll, pids, valid, dropped

        return wrun(fused, sa, count_arr, sentinel, lo_h, lo_l, hi_h, hi_l)

    lo, hi = inputs

    @functools.partial(
        shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(axis, None), P(axis), P(), P(), P(dp), P(dp)),
        out_specs=(P(dp), P(dp), P(dp), P(dp)),
    )
    def run(fused, sa, count_arr, sentinel, lo, hi):
        rows, pids, valid, dropped = locate_ops.expand_ranges(lo, hi, capacity)
        if dp is not None:  # lift local pattern ids to global batch indices
            pids = pids + jax.lax.axis_index(dp).astype(jnp.int32) * lo.shape[0]
        r = meta.sampling_ratio
        if meta.has_sa_full:
            locs = jnp.where(valid, _owned_gather(axis, sa, rows), U32(0))
            return locs, pids, valid, dropped

        # LF-walk with collective gathers (locate/mod.rs:21-35 semantics)
        def needs_step(pos, done):
            return (pos % U32(r) != 0) & ~done & valid

        def cond(carry):
            pos, offset, loc, done = carry
            return jnp.any(needs_step(pos, done))

        def body(carry):
            pos, offset, loc, done = carry
            need = needs_step(pos, done)
            pos_q = jnp.where(need, pos, U32(0))
            q, rm = _split_pos(meta, sentinel, pos_q)
            frows = _owned_gather(axis, fused, q)
            rank, symidx = pre_rank_and_symidx_from_rows(meta, frows, rm)
            is_sent = (pos_q == sentinel - U32(1)) & need
            pre = jnp.take(count_arr, symidx)
            hit = need & is_sent
            loc = jnp.where(hit, offset, loc)
            done = done | hit
            step = need & ~is_sent
            pos = jnp.where(step, pre + rank, pos)
            offset = jnp.where(step, offset + 1, offset)
            return pos, offset, loc, done

        pos, offset, loc, done = rows, jnp.zeros_like(rows), jnp.zeros_like(rows), valid & False
        if r > 1:
            pos, offset, loc, done = jax.lax.while_loop(
                cond, body, (pos, offset, loc, done))
        sampled = _owned_gather(axis, sa, pos // U32(r))
        locs = jnp.where(done, loc, sampled + offset)
        return jnp.where(valid, locs, U32(0)), pids, valid, dropped

    return run(fused, sa, count_arr, sentinel, lo, hi)


def _rs_resolve(idx, bounds, capacity):
    """``bounds``: (lo, hi) for narrow indexes, the two-lane 4-tuple for
    wide ones."""
    return _rs_resolve_jit(idx.meta, (idx.mesh, idx.axis, idx.dp_axis),
                           _rs_tree(idx), tuple(bounds), capacity)
