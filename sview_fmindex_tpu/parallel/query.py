"""Sharded batched queries: pattern-DP over a device mesh.

The scale-out model (SURVEY.md §2, BASELINE.json north star):

- the packed index (a :class:`DeviceFmIndex` pytree) is REPLICATED on every
  device of the mesh,
- pattern batches are sharded along the batch axis (``dp``),
- each shard runs the identical lockstep backward search locally
  (zero communication on the hot path),
- locate results come back batch-sharded; the concatenation at the
  ``out_specs`` boundary is the all-gather result merge.

This replaces the reference's sequential per-pattern loop
(``locate/with_slice.rs:21-33``) — there is no reference analog to cite for
the collectives because the reference has none (SURVEY.md §5).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..models.device_index import DeviceFmIndex
from ..ops import locate as locate_ops
from ..ops import search as search_ops
from .mesh import DP_AXIS, make_mesh


class ShardedFmIndex:
    """A DeviceFmIndex replicated over a mesh, queried pattern-data-parallel."""

    def __init__(self, index: DeviceFmIndex, mesh=None, axis: str = DP_AXIS):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis
        replicated = NamedSharding(self.mesh, P())
        self.index = jax.tree.map(lambda x: jax.device_put(x, replicated), index)

    @property
    def n_devices(self) -> int:
        return self.mesh.devices.size

    # ------------------------------------------------------------------
    def _pad(self, patterns, lens):
        patterns = np.asarray(patterns, dtype=np.uint8)
        lens = np.asarray(lens, dtype=np.int32)
        b = patterns.shape[0]
        n = self.n_devices
        pad = (-b) % n
        if pad:
            patterns = np.concatenate([patterns, np.zeros((pad, patterns.shape[1]), np.uint8)])
            # padded lanes get length 1 (a real LF-able value) but are sliced off
            lens = np.concatenate([lens, np.ones(pad, np.int32)])
        return patterns, lens, b

    def _steps(self, patterns, lens) -> int:
        from ..ops.search import max_steps_needed

        return max_steps_needed(self.index.meta, lens, patterns.shape[1])

    def _facts(self, lens) -> tuple:
        """Static host-side batch facts (see device_index._as_batch).
        Padding lanes get length 1, so all_dense only holds unpadded."""
        meta = self.index.meta
        all_dense = bool(meta.dense_k) and lens.size > 0 and bool(
            (lens >= meta.dense_k).all())
        fixed_len = int(lens[0]) if (
            lens.size > 0 and (lens == lens[0]).all()) else None
        return (all_dense, fixed_len)

    def count(self, patterns, lens):
        """counts[:b]; numpy uint64 for wide (u64-position) indexes."""
        patterns, lens, b = self._pad(patterns, lens)
        if self.index.meta.wide_pos:
            from ..ops.wide import combine64

            lo_h, lo_l, hi_h, hi_l = _wide_ranges_sharded(
                self.index, patterns, lens, self.mesh, self.axis,
                self._steps(patterns, lens))
            return (combine64(hi_h, hi_l) - combine64(lo_h, lo_l))[:b]
        counts = _count_sharded(
            self.index, patterns, lens, self.mesh, self.axis,
            self._steps(patterns, lens), self._facts(lens),
        )
        return counts[:b]

    def pos_ranges(self, patterns, lens):
        patterns, lens, b = self._pad(patterns, lens)
        if self.index.meta.wide_pos:
            out = _wide_ranges_sharded(
                self.index, patterns, lens, self.mesh, self.axis,
                self._steps(patterns, lens))
            return tuple(x[:b] for x in out)
        lo, hi = _ranges_sharded(
            self.index, patterns, lens, self.mesh, self.axis,
            self._steps(patterns, lens), self._facts(lens),
        )
        return lo[:b], hi[:b]

    def locate(self, patterns, lens, capacity_per_shard: int | None = None):
        """Returns (locations, pattern_ids, valid, dropped) concatenated over
        shards; pattern_ids are GLOBAL batch indices (padding lanes excluded
        via valid); ``dropped`` uint32 [n_shards] counts per-shard overflow
        occurrences beyond ``capacity_per_shard`` (all zero when capacity
        was auto-sized).

        The backward search runs ONCE (``_ranges_sharded``); when
        ``capacity_per_shard`` is None the shard capacity is sized from the
        resulting counts and only the expand+walk phase runs as the second
        executable — the search is never duplicated.
        """
        patterns, lens, b = self._pad(patterns, lens)
        steps = self._steps(patterns, lens)
        per_shard = patterns.shape[0] // self.n_devices
        if self.index.meta.wide_pos:
            from ..ops.wide import combine64

            bounds = _wide_ranges_sharded(
                self.index, patterns, lens, self.mesh, self.axis, steps)
            if capacity_per_shard is None:
                lo_h, lo_l, hi_h, hi_l = map(np.asarray, bounds)
                counts = combine64(hi_h, hi_l) - combine64(lo_h, lo_l)
                counts[b:] = 0
                capacity_per_shard = max(
                    locate_ops.expand_capacity(c, base=per_shard)
                    for c in counts.reshape(self.n_devices, per_shard))
            lh, ll, pids, valid, dropped = _wide_resolve_sharded(
                self.index, bounds, self.mesh, self.axis, capacity_per_shard)
            valid = np.asarray(valid) & (np.asarray(pids) < b)
            return (combine64(np.asarray(lh), np.asarray(ll)),
                    np.asarray(pids), valid, np.asarray(dropped))
        lo, hi = _ranges_sharded(
            self.index, patterns, lens, self.mesh, self.axis, steps,
            self._facts(lens),
        )
        if capacity_per_shard is None:
            counts = np.asarray(hi) - np.asarray(lo)
            counts[b:] = 0  # padding lanes contribute nothing
            capacity_per_shard = max(
                locate_ops.expand_capacity(c, base=per_shard)
                for c in counts.reshape(self.n_devices, per_shard))
        locs, pids, valid, dropped = _walk_sharded(
            self.index, lo, hi, self.mesh, self.axis, capacity_per_shard
        )
        valid = np.asarray(valid) & (np.asarray(pids) < b)
        return np.asarray(locs), np.asarray(pids), valid, np.asarray(dropped)


# ----------------------------------------------------------------------
@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _count_sharded(idx, patterns, lens, mesh, axis, steps,
                   facts=(False, None)):
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis)),
        out_specs=P(axis),
    )
    def run(idx, patterns, lens):
        return search_ops.count_batch(
            idx.meta, idx.fused, idx.kmer_tbl, idx.dense_lo, idx.dense_hi,
            idx.count_arr, idx.sentinel, idx.enc_table, patterns, lens, steps,
            all_dense=facts[0], fixed_len=facts[1],
        )

    return run(idx, patterns, lens)


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _ranges_sharded(idx, patterns, lens, mesh, axis, steps,
                    facts=(False, None)):
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis)),
        out_specs=(P(axis), P(axis)),
    )
    def run(idx, patterns, lens):
        sym = search_ops.encode_patterns(idx.enc_table, patterns, idx.meta)
        return search_ops.pos_ranges(
            idx.meta, idx.fused, idx.kmer_tbl, idx.dense_lo, idx.dense_hi,
            idx.count_arr, idx.sentinel, sym, lens, steps,
            all_dense=facts[0], fixed_len=facts[1],
        )

    return run(idx, patterns, lens)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _walk_sharded(idx, lo, hi, mesh, axis, capacity_per_shard):
    """Expand the (already computed) shard-local ranges and walk them."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )
    def run(idx, lo, hi):
        locs, pids, valid, dropped = locate_ops.locate_rows(
            idx.meta, idx.fused, idx.count_arr, idx.sa, idx.sentinel,
            lo, hi, capacity_per_shard,
        )
        # lift local pattern ids to global batch indices
        shard = jax.lax.axis_index(axis).astype(jnp.int32)
        pids = pids + shard * lo.shape[0]
        return locs, pids, valid, dropped

    return run(idx, lo, hi)


# ----------------------------------------------------------------------
# wide (u64-position) pattern-DP: the replicated-index shard_map shape is
# identical; per-shard search/walk run the two-lane engine (ops/wide.py).
# ShardedFmIndex routes here when meta.wide_pos.

@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _wide_ranges_sharded(idx, patterns, lens, mesh, axis, steps):
    from ..ops import wide as wide_ops

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis)),
        out_specs=(P(axis),) * 4,
    )
    def run(idx, patterns, lens):
        sym = search_ops.encode_patterns(idx.enc_table, patterns, idx.meta)
        return wide_ops.pos_ranges_wide(
            idx.meta, idx.fused, idx.kmer_tbl, idx.count_arr, idx.sentinel,
            sym, lens, steps, dense_lo=idx.dense_lo, dense_hi=idx.dense_hi)

    return run(idx, patterns, lens)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _wide_resolve_sharded(idx, bounds, mesh, axis, capacity_per_shard):
    from ..ops import wide as wide_ops

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(),) + (P(axis),) * 4,
        out_specs=(P(axis),) * 5,
    )
    def run(idx, lo_h, lo_l, hi_h, hi_l):
        lh, ll, pids, valid, dropped = wide_ops.locate_rows_wide(
            idx.meta, idx.fused, idx.count_arr, idx.sa, idx.sentinel,
            lo_h, lo_l, hi_h, hi_l, capacity_per_shard)
        shard = jax.lax.axis_index(axis).astype(jnp.int32)
        pids = pids + shard * lo_h.shape[0]
        return lh, ll, pids, valid, dropped

    return run(idx, *bounds)
