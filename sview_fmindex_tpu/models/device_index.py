"""DeviceFmIndex: the FM-index as a pytree of device arrays.

This is the accelerator execution form of the blob (SURVEY.md §7): the
blob's sections become packed device arrays —

- ``fused``     uint32 [n_blocks, sigma + planes*lanes]: rank checkpoints and
  bit-plane lanes interleaved per block so one rank query = one row gather,
- ``kmer_tbl``  uint32 [(sigma+1)^k], ``count_arr`` uint32 [sigma+1],
- ``sa``        uint32 [ceil(n/r)], ``sentinel`` uint32 scalar,
- ``enc_table`` int32 [256] (identity for PassThrough).

Queries are batched and jitted; see ``sview_fmindex_tpu.ops``.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BuildError
from ..encoders import EncodingTable
from ..ops import locate as locate_ops
from ..ops import search as search_ops


def _enc_static(fm):
    """(enc_table int32 [256], identity, default, pairs) — the encoder's
    static content for compare-select encoding (see IndexMeta)."""
    if isinstance(fm.encoder, EncodingTable):
        enc_table = fm.encoder.table.astype(np.int32)
        enc_default = int(np.bincount(enc_table, minlength=1).argmax())
        enc_pairs = tuple(
            (int(v), int(enc_table[v]))
            for v in range(256) if enc_table[v] != enc_default)
        return enc_table, False, enc_default, enc_pairs
    return np.arange(256, dtype=np.int32), True, 0, ()


def planes_effective(fm) -> int:
    """ceil(log2 sigma) device planes (upper blob planes are all-zero for
    symbols < 2**p) — the plane-reduction rule shared by every upload."""
    return min(fm.block.num_planes, max(1, (fm.symbol_count - 1).bit_length()))


def narrow_fused_rows(fm, planes_eff: int, b0: int, b1: int) -> np.ndarray:
    """Fused gather-table rows for blocks [b0, b1) — buildable per SLICE so
    range-sharded staging never materializes the full table (host peak ~=
    one shard)."""
    sigma = fm.symbol_count
    width = sigma + planes_eff * fm.block.num_lanes
    out = np.empty((b1 - b0, width), dtype=np.uint32)
    out[:, :sigma] = fm.rank_checkpoints[b0:b1].astype(np.uint32)
    out[:, sigma:] = np.ascontiguousarray(
        fm.lanes[b0:b1, :planes_eff, :]).reshape(b1 - b0, -1)
    return out


def wide_fused_rows(fm, planes_eff: int, b0: int, b1: int) -> np.ndarray:
    """Wide fused rows (hi ckpts | lo ckpts | plane lanes) for a block
    slice."""
    sigma = fm.symbol_count
    width = 2 * sigma + planes_eff * fm.block.num_lanes
    out = np.empty((b1 - b0, width), dtype=np.uint32)
    ck = fm.rank_checkpoints[b0:b1].astype(np.uint64)
    out[:, :sigma] = (ck >> np.uint64(32)).astype(np.uint32)
    out[:, sigma : 2 * sigma] = (ck & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 2 * sigma :] = np.ascontiguousarray(
        fm.lanes[b0:b1, :planes_eff, :]).reshape(b1 - b0, -1)
    return out


def split2(a) -> np.ndarray:
    """uint64-ish values -> uint32 [2, ...] (hi, lo) lane pair."""
    a = np.asarray(a, dtype=np.uint64)
    return np.stack([(a >> np.uint64(32)).astype(np.uint32),
                     (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)])


def validate_wide(fm) -> None:
    """The wide-path envelope checks (shared by single-device upload and
    range-shard staging)."""
    kind = fm.block
    if fm.text_len >= 2**38:
        raise BuildError("wide device path requires text_len < 2^38 "
                         "(block indices must fit uint32)")
    if len(fm.kmer_count_table) >= 2**31:
        raise BuildError("kmer table too large for int32 device indexing")
    r = fm.sampling_ratio
    if r < 1 or r > (1 << 15):
        raise BuildError(
            "wide device path requires 1 <= sampling_ratio <= 2^15 "
            "(p_divmod_const envelope)")
    # the locate walk's SA fold and _split_pos_wide's block fold pack the
    # two-lane position into ONE uint32 index (ops/wide.py); both wrap
    # unless n/r and n/block_len fit uint32
    bound = min(r, kind.block_len) << 32
    if fm.text_len >= bound:
        raise BuildError(
            f"wide device path requires text_len < min(sampling_ratio,"
            f" block_len) * 2^32 = {bound} (the SA and block index "
            f"folds are uint32); got text_len {fm.text_len}")


@dataclasses.dataclass(frozen=True)
class IndexMeta:
    """Static (hashable) shape parameters; the jit specialization key."""

    sigma: int
    kmer_size: int
    sampling_ratio: int
    block_len: int
    num_planes: int
    num_lanes: int
    dense_k: int = 0  # device-side dense seed-table k (0 = disabled)
    wide_pos: bool = False  # two-lane u32 positions (texts >= 2^32)
    # static encoder content (compare-select encode instead of a 256-entry
    # table gather, see ops.search.encode_patterns):
    enc_identity: bool = False  # PassThrough: bytes ARE symbol indices
    enc_pairs: tuple = ()  # ((byte, sym), ...) for bytes != enc_default
    enc_default: int = 0  # what every other byte maps to (the wildcard)
    has_sa_full: bool = False  # full (r=1) SA resident on device


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["fused", "kmer_tbl", "dense_lo", "dense_hi", "count_arr",
                 "sa", "sentinel", "enc_table"],
    meta_fields=["meta"],
)
@dataclasses.dataclass(frozen=True)
class DeviceFmIndex:
    fused: jax.Array
    kmer_tbl: jax.Array
    dense_lo: jax.Array
    dense_hi: jax.Array
    count_arr: jax.Array
    sa: jax.Array
    sentinel: jax.Array
    enc_table: jax.Array
    meta: IndexMeta

    # ------------------------------------------------------------------
    @classmethod
    def from_host(cls, fm, device=None, dense_lut_entries: int | None = 1 << 26,
                  dense_lut_cache: str | None = None,
                  dense_host_entries: int = 1 << 20,
                  sa_fill_ratio: int = 4,
                  sa_full: "np.ndarray | str | None" = None,
                  force_wide: bool = False,
                  ckpt_derive: bool = False,
                  derived_cache_dir: str | None = None) -> "DeviceFmIndex":
        """Upload a host ``FmIndex`` (the blob's zero-copy views) to device.

        ``dense_lut_entries`` bounds the optional dense seed table
        (``build/dense_lut.py``); None or 0 disables densification.
        ``dense_lut_cache`` (a .npz path) persists the computed table so
        repeated loads of the same blob skip the host-side build pass.
        ``dense_host_entries`` caps the HOST-built part: when
        ``dense_lut_entries`` allows a deeper table, the remaining levels
        extend ON DEVICE with batched LF steps over the uploaded index
        (``extend_dense_lut_device``).
        ``sa_full``: optional full (r=1) suffix array — uint32 array or path
        to a raw little-endian uint32 file written by
        ``FmIndexBuilder.build(sa_full_path=...)``.  When present it replaces
        the sampled SA on device and locate resolves rows with ONE gather
        instead of the LF walk (results are bit-identical; this is the same
        memoization move as the dense LUT — config invariance semantics).
        ``sa_full="device"`` reconstructs the full SA on device from the
        blob's sampled SA strided to ``sa_fill_ratio`` (uploading
        1/sa_fill_ratio of the sampled array; see ``build/sa_fill.py``).

        ``derived_cache_dir``: directory for raw .npy caches of the derived
        fused gather table so repeated uploads of the same blob skip the
        host-side assembly pass.  Cache keys embed a content digest of the
        blob's SA/count sections — a cache from a different text can never
        be served.

        ``ckpt_derive``: upload only the bit-plane columns and derive the
        checkpoint columns ON DEVICE (``ops.rank.derive_fused_device`` —
        popcount + exclusive cumsum, bit-identical, tested).  Off by
        default: over PCIe the host-assembled table uploads directly.
        """
        kind = fm.block
        if force_wide or fm.text_len >= 2**32:
            # two-lane u32 position engine (ops/wide.py): host-level dense
            # seeds, no sa_full
            return cls._from_host_wide(
                fm, device=device,
                dense_host_entries=(dense_host_entries
                                    if dense_lut_entries else 0))
        if len(fm.kmer_count_table) >= 2**31:
            raise BuildError("kmer table too large for int32 device indexing")

        sa_device_fill = isinstance(sa_full, str) and sa_full == "device"
        if sa_device_fill:
            sa_full = None

        if isinstance(sa_full, str):
            # memmap, not fromfile: device_put DMAs straight from the page
            # cache instead of staging a second 4 GB copy in RAM
            sa_full = np.memmap(sa_full, dtype="<u4", mode="r")
        if sa_full is not None:
            if sa_full.shape[0] != fm.text_len:
                raise BuildError(
                    f"sa_full length {sa_full.shape[0]} != text_len {fm.text_len}")
            # guard against a stale cache from a DIFFERENT text of the same
            # length: sa_full[::r] must equal the blob's sampled SA.  A
            # deterministic 64k-probe sample gives the same protection as
            # the full compare (a stale SA differs almost everywhere)
            # without paging in the whole multi-GB memmap.
            n_sa = fm.suffix_array.shape[0]
            probes = np.unique(np.linspace(0, n_sa - 1, min(n_sa, 65536),
                                           dtype=np.int64))
            if not np.array_equal(
                    np.asarray(sa_full[probes * fm.sampling_ratio]),
                    fm.suffix_array[probes].astype(np.uint32)):
                raise BuildError(
                    "sa_full does not match the blob's sampled suffix array "
                    "(stale or mismatched sa_full cache)")

        # content digest guarding EVERY derived cache (a stale cache from a
        # different text of the same shape must never be served)
        import hashlib

        h = hashlib.sha1()
        h.update(np.ascontiguousarray(fm.suffix_array[:65536]).tobytes())
        h.update(np.ascontiguousarray(fm.count_array).tobytes())
        h.update(str((fm.text_len, fm.sentinel_index, kind.num_planes,
                      kind.num_lanes, fm.sampling_ratio)).encode())
        content_digest = h.hexdigest()[:16]
        digest = None
        if derived_cache_dir is not None:
            os.makedirs(derived_cache_dir, exist_ok=True)
            digest = content_digest

        def _cached(name: str, builder_fn):
            if digest is None:
                return builder_fn()
            path = os.path.join(derived_cache_dir, f"{name}_{digest}.npy")
            if os.path.exists(path):
                return np.load(path, mmap_mode="r")
            arr = builder_fn()
            # atomic publish: a crash or a concurrent second process
            # mid-write must never leave a truncated cache at the final
            # digest-keyed name (it would poison every later upload)
            tmp = os.path.join(derived_cache_dir,
                               f"{name}_{digest}.tmp{os.getpid()}.npy")
            try:
                np.save(tmp, arr)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            return arr

        n_blocks = fm.rank_checkpoints.shape[0]
        sigma = fm.symbol_count
        # plane reduction: only ceil(log2 sigma) planes carry information —
        # a Block3<u64> index over ACGT needs 2 device planes, not 3 (the
        # upper blob planes are all-zero for symbols < 2^p).  Shrinks the
        # fused table (and every rank gather) by (P-p)/(sigma/lanes+P).
        planes_eff = planes_effective(fm)
        enc_table, enc_identity, enc_default, enc_pairs = _enc_static(fm)

        from ..build.dense_lut import auto_dense_k, dense_lut

        dk = auto_dense_k(sigma, fm.kmer_size, dense_lut_entries or 0,
                          text_len=fm.text_len)
        dk_host = min(dk, max(auto_dense_k(sigma, fm.kmer_size,
                                           dense_host_entries,
                                           text_len=fm.text_len),
                              fm.kmer_size + 1)) if dk else 0
        if dk:
            d_lo = d_hi = None
            if dense_lut_cache is not None:
                try:
                    with np.load(dense_lut_cache) as z:
                        # dk AND content digest must match: a cache from a
                        # different text would silently mis-seed every query
                        if int(z["dk"]) == dk_host and "digest" in z.files \
                                and str(z["digest"]) == content_digest:
                            d_lo, d_hi = z["lo"], z["hi"]
                except (OSError, KeyError):
                    pass
            if d_lo is None:
                d_lo, d_hi = dense_lut(fm, dk_host)
                if dense_lut_cache is not None:
                    np.savez(dense_lut_cache, dk=dk_host, lo=d_lo, hi=d_hi,
                             digest=content_digest)
        else:
            d_lo = d_hi = np.zeros(1, dtype=np.uint32)

        meta = IndexMeta(
            sigma=sigma,
            kmer_size=fm.kmer_size,
            sampling_ratio=fm.sampling_ratio,
            block_len=kind.block_len,
            num_planes=planes_eff,
            num_lanes=kind.num_lanes,
            dense_k=dk,
            enc_identity=enc_identity,
            enc_pairs=enc_pairs,
            enc_default=enc_default,
            has_sa_full=(sa_full is not None) or sa_device_fill,
        )

        put = functools.partial(jax.device_put, device=device)
        import sys
        import time as _time

        trace = os.environ.get("SVIEW_UPLOAD_TRACE") == "1"
        t_tr = [_time.time()]

        def _tr(label, *arrs):
            if not trace:
                return
            for a in arrs:
                jax.block_until_ready(a)
            now = _time.time()
            print(f"[upload] {label}: {now - t_tr[0]:.1f}s",
                  file=sys.stderr, flush=True)
            t_tr[0] = now

        if ckpt_derive:
            from ..ops.rank import derive_fused_device

            planes_host = np.ascontiguousarray(
                fm.lanes[:, :planes_eff, :]).reshape(n_blocks, -1)
            fused_dev = derive_fused_device(meta, put(planes_host),
                                            fm.text_len)
        else:
            fused_dev = put(_cached(
                f"fused{planes_eff}",
                lambda: narrow_fused_rows(fm, planes_eff, 0, n_blocks)))
        count_dev = put(fm.count_array.astype(np.uint32))
        sent_dev = put(np.uint32(fm.sentinel_index))
        _tr("fused+small put", fused_dev, count_dev)
        # issue every remaining host->device transfer now: device_put is
        # async, so the copies overlap the SA fill and the dense extension
        kmer_dev = put(fm.kmer_count_table.astype(np.uint32, copy=False))
        enc_dev = put(enc_table)
        dlo_dev, dhi_dev = put(d_lo), put(d_hi)
        sa_up = sa_dev = None
        if sa_device_fill:
            ratio = max(int(sa_fill_ratio), 1)
            sa_up = put(np.ascontiguousarray(
                fm.suffix_array[::ratio]).astype(np.uint32))
        elif sa_full is not None:
            sa_dev = put(sa_full.astype(np.uint32, copy=False))
        else:
            # copy=False: for u32-position blobs the view is already
            # uint32 — the default astype copy costs ~2 GB of RAM traffic
            # for nothing
            sa_dev = put(fm.suffix_array.astype(np.uint32, copy=False))

        # SA fill runs BEFORE the dense extension: the fill's 4 GB output
        # buffer plus its transients are the peak device-memory moment of
        # the cold path, and the extension would add ~2 GB of dense tables
        # to the resident set during it.
        if sa_device_fill:
            from ..build.sa_fill import fill_sa_full_device

            ratio = max(int(sa_fill_ratio), 1)
            sa_dev = fill_sa_full_device(
                meta, fused_dev, count_dev, sent_dev, sa_up,
                fm.text_len, fm.sampling_ratio * ratio)
            sa_up = None  # free the strided upload before the dense tables
        _tr("sa fill", sa_dev)

        if dk and dk > dk_host:
            from ..build.dense_lut import extend_dense_lut_device

            dlo_dev, dhi_dev = extend_dense_lut_device(
                meta, fused_dev, np.asarray(fm.count_array, dtype=np.uint32),
                sent_dev, dlo_dev, dhi_dev, dk - dk_host)
        _tr("dense extension", dlo_dev)
        return cls(
            fused=fused_dev,
            kmer_tbl=kmer_dev,
            dense_lo=dlo_dev,
            dense_hi=dhi_dev,
            count_arr=count_dev,
            sa=sa_dev,
            sentinel=sent_dev,
            enc_table=enc_dev,
            meta=meta,
        )

    # ------------------------------------------------------------------
    @classmethod
    def _from_host_wide(cls, fm, device=None,
                        dense_host_entries: int = 1 << 20
                        ) -> "DeviceFmIndex":
        """Upload with two-lane u32 position values (texts >= 2^32).

        The reference's u64 ``Position`` (``text_length.rs:87-129``) as
        (hi, lo) uint32 lane pairs: value arrays split into lanes, block
        indices stay uint32 (valid to 2^38 bp).  Any sampling ratio 1..2^15
        is supported (``ops.wide.p_divmod_const``); batches are served by
        the wide gather engine (``ops/wide.py``).
        """
        validate_wide(fm)
        n_blocks = fm.rank_checkpoints.shape[0]
        sigma = fm.symbol_count
        planes_eff = planes_effective(fm)
        put = functools.partial(jax.device_put, device=device)
        all_lo = fm.text_len <= 0xFFFFFFFF  # every position value < 2^32

        def put2(a):
            """2-lane upload; when every value fits the low lane (a
            force_wide run on a < 4 Gbp text) the hi lane is built on
            device instead of copying GBs of zeros."""
            if not all_lo:
                return put(split2(a))
            lo = put(np.asarray(a).astype(np.uint32))
            return jnp.concatenate([jnp.zeros_like(lo)[None], lo[None]])

        enc_table, enc_identity, enc_default, enc_pairs = _enc_static(fm)

        from ..build.dense_lut import auto_dense_k, dense_lut

        # dense seeds: HOST-built only (the on-device extension pass is a
        # narrow-engine program)
        dk = auto_dense_k(sigma, fm.kmer_size, dense_host_entries or 0,
                          text_len=fm.text_len)
        meta = IndexMeta(
            sigma=sigma, kmer_size=fm.kmer_size,
            sampling_ratio=fm.sampling_ratio,
            block_len=fm.block.block_len, num_planes=planes_eff,
            num_lanes=fm.block.num_lanes, wide_pos=True, dense_k=dk,
            enc_identity=enc_identity, enc_pairs=enc_pairs,
            enc_default=enc_default,
        )
        fused_dev = put(wide_fused_rows(fm, planes_eff, 0, n_blocks))
        if dk:
            d_lo, d_hi = dense_lut(fm, dk, wide=True)
            dlo_dev, dhi_dev = put2(d_lo), put2(d_hi)
        else:
            dlo_dev = put(np.zeros((2, 1), np.uint32))
            dhi_dev = put(np.zeros((2, 1), np.uint32))
        return cls(
            fused=fused_dev,
            kmer_tbl=put2(fm.kmer_count_table),
            dense_lo=dlo_dev,
            dense_hi=dhi_dev,
            count_arr=put2(fm.count_array),
            sa=put2(fm.suffix_array),
            sentinel=put(split2(np.array([fm.sentinel_index]))[:, 0]),
            enc_table=put(enc_table),
            meta=meta,
        )

    # ------------------------------------------------------------------
    # Two jit programs serve the search of every query: _ranges_jit
    # (backward search -> [lo, hi), counts = hi - lo; shared by count and
    # locate); locate then resolves the ranges in small dispatches
    # (_resolve_jit: expand, then sa-gather or LF walk).

    def engine_for(self, B: int) -> str:
        """The engine a batch of ``B`` lanes is served by: ``'gather'``
        (u32 positions) or ``'wide-gather'`` (two-lane positions).  Every
        batch size takes the XLA row-gather engine; ``B`` is kept so
        callers can log the choice per batch."""
        del B
        return "wide-gather" if self.meta.wide_pos else "gather"

    def count(self, patterns, lens=None) -> jax.Array:
        """counts uint32 [B] for a [B, Lmax] uint8 batch (raw bytes for
        EncodingTable indexes, symbol indices for PassThrough).

        Wide (u64-position) indexes return uint32 [2, B] — (hi, lo) lanes;
        combine with ``ops.wide.combine64``."""
        patterns, lens, steps, facts = _as_batch(self.meta, patterns, lens)
        if self.meta.wide_pos:
            return _wide_counts_from_bounds(_wide_ranges_jit(
                self, patterns, lens, steps))
        lo, hi = _ranges_jit(self, patterns, lens, steps, facts)
        return hi - lo

    def pos_ranges(self, patterns, lens=None):
        """(lo, hi) uint32 [B]; wide indexes return the two-lane 4-tuple
        (lo_hi, lo_lo, hi_hi, hi_lo)."""
        patterns, lens, steps, facts = _as_batch(self.meta, patterns, lens)
        if self.meta.wide_pos:
            return _wide_ranges_jit(self, patterns, lens, steps)
        return _ranges_jit(self, patterns, lens, steps, facts)

    def locate(self, patterns, lens=None, capacity: int | None = None):
        """Returns (locations uint32 [capacity], pattern_ids int32,
        valid bool, dropped uint32 [1]).

        Slot ``p < B`` is pattern p's first occurrence; slots ``B..`` hold
        the overflow (see ``ops.locate.expand_ranges``).  ``capacity`` is
        the static output budget (must be >= B); when None it is sized from
        the counts (overflow rounded to a power of two to bound recompiles).
        ``dropped`` counts overflow occurrences that did not fit the budget
        — callers passing an explicit ``capacity`` must check it is 0
        before treating the result as complete (no silent caps).
        """
        locs, pids, valid, _, dropped = self.locate_with_counts(
            patterns, lens, capacity)
        return locs, pids, valid, dropped

    def locate_with_counts(self, patterns, lens=None,
                           capacity: int | None = None):
        """(locs, pids, valid, counts, dropped) — two dispatches, zero host
        sync when ``capacity`` is given (``dropped`` stays on device).
        Wide indexes return locs/counts as uint32 [2, ...] lane pairs."""
        patterns, lens, steps, facts = _as_batch(self.meta, patterns, lens)
        if self.meta.wide_pos:
            from ..ops import wide as wide_ops

            bounds = _wide_ranges_jit(self, patterns, lens, steps)
            counts = _wide_counts_from_bounds(bounds)
            if capacity is None:
                capacity = locate_ops.expand_capacity(
                    wide_ops.combine64(counts[0], counts[1]))
            locs_h, locs_l, pids, valid, dropped = _wide_resolve_jit(
                self, bounds, capacity)
            return (jnp.stack([locs_h, locs_l]), pids, valid, counts,
                    dropped)
        lo, hi = _ranges_jit(self, patterns, lens, steps, facts)
        if capacity is None:
            capacity = locate_ops.expand_capacity(np.asarray(hi - lo))
        locs, pids, valid, dropped = _resolve_jit(self, lo, hi, capacity)
        return locs, pids, valid, hi - lo, dropped

    def resolve_rows(self, lo, hi, capacity: int):
        """Expand [lo, hi) ranges and resolve rows to locations (the second
        locate phase, exposed for phase benchmarking).  Returns
        (locs, pids, valid, dropped)."""
        return _resolve_jit(self, lo, hi, capacity)


def _as_batch(meta, patterns, lens):
    """Normalize the batch and derive STATIC facts about it host-side:
    ``(all_dense, fixed_len)`` — every lane long enough for the dense seed,
    and a single shared length — which strip per-element gathers from the
    compiled program (see ``ops.search``)."""
    if lens is None:
        np_pat = np.asarray(patterns, dtype=np.uint8)
        lens_host = np.full(
            np_pat.shape[0] if np_pat.ndim > 1 else 1, np_pat.shape[-1], np.int32
        )
    else:
        lens_host = np.asarray(lens, dtype=np.int32)
    patterns = jnp.asarray(patterns, dtype=jnp.uint8)
    if patterns.ndim == 1:
        patterns = patterns[None, :]
    steps = search_ops.max_steps_needed(meta, lens_host, patterns.shape[1])
    all_dense = bool(meta.dense_k) and lens_host.size > 0 and bool(
        (lens_host >= meta.dense_k).all())
    fixed_len = int(lens_host[0]) if (
        lens_host.size > 0 and (lens_host == lens_host[0]).all()) else None
    return patterns, jnp.asarray(lens_host), steps, (all_dense, fixed_len)


@functools.partial(jax.jit, static_argnums=(3,))
def _wide_ranges_jit(idx: DeviceFmIndex, patterns, lens, steps: int):
    from ..ops import wide as wide_ops

    sym = search_ops.encode_patterns(idx.enc_table, patterns, idx.meta)
    return wide_ops.pos_ranges_wide(
        idx.meta, idx.fused, idx.kmer_tbl, idx.count_arr, idx.sentinel,
        sym, lens, steps, dense_lo=idx.dense_lo, dense_hi=idx.dense_hi)


@jax.jit
def _wide_counts_from_bounds(bounds):
    from ..ops import wide as wide_ops

    lo_h, lo_l, hi_h, hi_l = bounds
    return jnp.stack(wide_ops.p_sub(hi_h, hi_l, lo_h, lo_l))


@functools.partial(jax.jit, static_argnums=(2,))
def _wide_resolve_jit(idx: DeviceFmIndex, bounds, capacity: int):
    from ..ops import wide as wide_ops

    lo_h, lo_l, hi_h, hi_l = bounds
    return wide_ops.locate_rows_wide(
        idx.meta, idx.fused, idx.count_arr, idx.sa, idx.sentinel,
        lo_h, lo_l, hi_h, hi_l, capacity)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _ranges_jit(idx: DeviceFmIndex, patterns, lens, steps: int,
                facts=(False, None)):
    all_dense, fixed_len = facts
    sym = search_ops.encode_patterns(idx.enc_table, patterns, idx.meta)
    return search_ops.pos_ranges(
        idx.meta, idx.fused, idx.kmer_tbl, idx.dense_lo, idx.dense_hi,
        idx.count_arr, idx.sentinel, sym, lens, steps,
        all_dense=all_dense, fixed_len=fixed_len,
    )


@functools.partial(jax.jit, static_argnums=(2,))
def _expand_jit(lo, hi, capacity: int):
    return locate_ops.expand_ranges(lo, hi, capacity)


@jax.jit
def _sa_gather_jit(sa, rows, valid):
    # rows stay uint32 (int32 would overflow for text_len in [2^31, 2^32))
    return jnp.where(valid, jnp.take(sa, rows), jnp.uint32(0))


@functools.partial(jax.jit, static_argnums=(0,))
def _walk_jit(meta, fused, count_arr, sa, sentinel, rows, valid):
    return locate_ops.walk_rows(meta, fused, count_arr, sa, sentinel, rows,
                                valid)


def _resolve_jit(idx: DeviceFmIndex, lo, hi, capacity: int):
    """Locate's resolution phase as small dispatches (expand, then
    sa-gather or LF-walk).  The static meta for the walk is stripped of
    seed-table fields it never reads (dense_k) so a different dense depth
    still hits the same compiled program.
    """
    rows, pids, valid, dropped = _expand_jit(lo, hi, capacity)
    if idx.meta.has_sa_full:
        locs = _sa_gather_jit(idx.sa, rows, valid)
    else:
        meta = dataclasses.replace(idx.meta, dense_k=0)
        locs = _walk_jit(meta, idx.fused, idx.count_arr, idx.sa,
                         idx.sentinel, rows, valid)
    return locs, pids, valid, dropped
