"""Wide (u64) position device engine (ops/wide.py).

The reference's u64 ``Position`` (``text_length.rs:87-129``) on device:
two-lane uint32 values, uint32 block indices.  ``force_wide=True`` runs
the exact wide code path on small texts so every lane-carry/compare/shift
is validated bit-exactly against the host oracle; the >=2^32 scale run is
a separate tool (``tools/wide_scale_check.py``) against a real 4.5 Gbp
u64 build.
"""
import numpy as np
import pytest

import sview_fmindex_tpu as fmx
from sview_fmindex_tpu.models.device_index import DeviceFmIndex
from sview_fmindex_tpu.ops.wide import combine64


def _build(n, pos_t, seed, r=2, k=3):
    rng = np.random.default_rng(seed)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    enc = fmx.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = fmx.FmIndexBuilder(
        n, enc.symbol_count(), enc, position=pos_t, block=fmx.BLOCK3_U64,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(r),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(k))
    blob = b.build(text)
    return text, fmx.FmIndex.load(np.frombuffer(blob, np.uint8),
                                  position=pos_t, block=fmx.BLOCK3_U64,
                                  encoder_kind="table")


@pytest.mark.parametrize("n,pos_t", [(3001, "u32"), (917, "u64"), (64, "u64")])
def test_wide_engine_matches_oracle(n, pos_t):
    rng = np.random.default_rng(n)
    text, fm = _build(n, pos_t, seed=n)
    dev = DeviceFmIndex.from_host(fm, force_wide=True)
    assert dev.meta.wide_pos
    plen = min(12, n // 2)
    starts = rng.integers(0, n - plen, size=48)
    pats = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(plen)]
    lens = rng.integers(1, plen + 1, size=48).astype(np.int32)
    c = combine64(*np.asarray(dev.count(pats, lens)))
    for i in range(48):
        assert int(c[i]) == fm.count(pats[i, : lens[i]].tobytes()), i
    locs, pids, valid, dropped = dev.locate(pats, lens)
    assert int(np.asarray(dropped)[0]) == 0
    lv = combine64(np.asarray(locs)[0], np.asarray(locs)[1])
    by = {}
    for l, p, v in zip(lv, np.asarray(pids), np.asarray(valid)):
        if v:
            by.setdefault(int(p), []).append(int(l))
    for i in range(48):
        assert sorted(by.get(i, [])) == sorted(
            fm.locate(pats[i, : lens[i]].tobytes())), i


def test_wide_accepts_any_small_ratio():
    """r=3 (non-power-of-two) now works on the wide path — the divmod is
    p_divmod_const, not a lane shift (reference allows any ratio >= 2,
    suffix_array_config.rs:4-33)."""
    text, fm = _build(500, "u64", seed=5, r=3)
    dev = DeviceFmIndex.from_host(fm, force_wide=True)
    rng = np.random.default_rng(5)
    starts = rng.integers(0, 490, size=24)
    pats = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(8)]
    c = combine64(*np.asarray(dev.count(pats)))
    for i in range(24):
        assert int(c[i]) == fm.count(pats[i].tobytes()), i
    locs, pids, valid, dropped = dev.locate(pats)
    assert int(np.asarray(dropped)[0]) == 0
    lv = combine64(np.asarray(locs)[0], np.asarray(locs)[1])
    by = {}
    for l, p, v in zip(lv, np.asarray(pids), np.asarray(valid)):
        if v:
            by.setdefault(int(p), []).append(int(l))
    for i in range(24):
        assert sorted(by.get(i, [])) == sorted(fm.locate(pats[i].tobytes())), i


def test_wide_ratio_out_of_envelope_rejected():
    _, fm = _build(300, "u64", seed=6, r=2)

    class _FakeR:
        def __init__(self, fm, r):
            self._fm, self._r = fm, r

        def __getattr__(self, k):
            if k == "sampling_ratio":
                return self._r
            return getattr(self._fm, k)

    with pytest.raises(fmx.BuildError, match="2\\^15"):
        DeviceFmIndex.from_host(_FakeR(fm, 1 << 16), force_wide=True)


def test_p_divmod_const_matches_uint64():
    """Property check of the two-lane constant divmod over its envelope
    v < r * 2^32, r in 1..2^15 incl. non-powers of two."""
    import jax.numpy as jnp
    from sview_fmindex_tpu.ops.wide import p_divmod_const

    rng = np.random.default_rng(123)
    for r in (1, 2, 3, 5, 6, 7, 8, 12, 100, 1000, 32767, 32768):
        hi_max = min(r, 1 << 15)
        h = rng.integers(0, hi_max, size=256, dtype=np.uint32)
        l = rng.integers(0, 1 << 32, size=256, dtype=np.uint64).astype(np.uint32)
        # bias some lanes toward the wrap boundary
        l[:32] = (np.uint32(0xFFFFFFFF) - rng.integers(
            0, 2 ** 15, size=32, dtype=np.uint32))
        q, m = p_divmod_const(jnp.asarray(h), jnp.asarray(l), r)
        v = h.astype(np.uint64) << np.uint64(32) | l.astype(np.uint64)
        ok = v < np.uint64(r) << np.uint64(32)
        np.testing.assert_array_equal(np.asarray(q)[ok],
                                      (v // r).astype(np.uint32)[ok], err_msg=str(r))
        np.testing.assert_array_equal(np.asarray(m)[ok],
                                      (v % r).astype(np.uint32)[ok], err_msg=str(r))


@pytest.mark.parametrize("dense", [0, 1 << 12])
def test_wide_uniform_batch_with_absent_lane_matches_oracle(dense):
    """A uniform-length wide batch with an absent lane — plen 11 takes eight
    LF steps after the blob k=3 seed and five after the dk=6 dense seed:
    two-lane gather search, expand and walk must equal the host oracle."""
    rng = np.random.default_rng(31)
    text, fm = _build(4000, "u64", seed=31, r=2)
    dev = DeviceFmIndex.from_host(fm, force_wide=True,
                                  dense_host_entries=dense)
    assert dev.meta.dense_k == (6 if dense else 0)
    plen = 11
    starts = rng.integers(0, 4000 - plen, size=80)
    pats = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(plen)].copy()
    pats[5] = np.frombuffer(b"G" * plen, np.uint8)  # likely absent
    c = combine64(*np.asarray(dev.count(pats)))
    for i in range(80):
        assert int(c[i]) == fm.count(pats[i].tobytes()), i
    locs, pids, valid, dropped = dev.locate(pats)
    assert int(np.asarray(dropped)[0]) == 0
    lv = combine64(np.asarray(locs)[0], np.asarray(locs)[1])
    by = {}
    for l, p, v in zip(lv, np.asarray(pids), np.asarray(valid)):
        if v:
            by.setdefault(int(p), []).append(int(l))
    for i in range(80):
        assert sorted(by.get(i, [])) == sorted(fm.locate(pats[i].tobytes())), i


@pytest.mark.parametrize("dp", [False, True])
def test_wide_range_sharded_matches_oracle(dp):
    """The wide engine on the range-sharded virtual mesh: this is the
    configuration that serves >4 Gbp indexes (tables split across chips,
    two-lane values, collective row gathers)."""
    import jax
    from jax.sharding import Mesh
    from sview_fmindex_tpu.parallel.range_shard import RangeShardedFmIndex
    from sview_fmindex_tpu.parallel.mesh import make_mesh

    n_dev = len(jax.devices())
    if n_dev < 2:
        pytest.skip("needs a multi-device (virtual) mesh")
    rng = np.random.default_rng(77)
    text, fm = _build(5000, "u64", seed=77)
    if dp:
        if n_dev % 2:
            pytest.skip("needs an even device count for rs x dp")
        devs = np.array(jax.devices()).reshape(n_dev // 2, 2)
        mesh = Mesh(devs, ("rs", "dp"))
        rs = RangeShardedFmIndex(fm, mesh=mesh, dp_axis="dp",
                                 force_wide=True)
    else:
        rs = RangeShardedFmIndex(fm, mesh=make_mesh(axis="rs"),
                                 force_wide=True)
    assert rs.meta.wide_pos
    plen = 10
    starts = rng.integers(0, 5000 - plen, size=24)
    pats = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(plen)]
    lens = np.full(24, plen, np.int32)
    c = rs.count(pats, lens)
    assert c.dtype == np.uint64
    for i in range(24):
        assert int(c[i]) == fm.count(pats[i].tobytes()), i
    locs, pids, valid, dropped = rs.locate(pats, lens)
    assert int(np.asarray(dropped).sum()) == 0
    by = {}
    for l, p, v in zip(locs, pids, valid):
        if v:
            by.setdefault(int(p), []).append(int(l))
    for i in range(24):
        assert sorted(by.get(i, [])) == sorted(fm.locate(pats[i].tobytes())), i


def test_wide_envelope_rejects_fold_overflow():
    """The SA/block index folds are uint32: text_len must stay below
    min(sampling_ratio, block_len) * 2^32 (ADVICE r4: an r=2 text >= 2^33
    would silently wrap inside the old 2^38 gate)."""
    _, fm = _build(700, "u64", seed=9, r=2)

    class _FakeLen:
        """Delegate everything to the real index but lie about text_len
        (building a real >=2^33 bp text in a unit test is not feasible)."""

        def __init__(self, fm, text_len):
            self._fm = fm
            self._text_len = text_len

        def __getattr__(self, k):
            if k == "text_len":
                return self._text_len
            return getattr(self._fm, k)

    import sview_fmindex_tpu as fmx

    with pytest.raises(fmx.BuildError, match="min.sampling_ratio"):
        DeviceFmIndex.from_host(_FakeLen(fm, 2 ** 33), force_wide=True)
    with pytest.raises(fmx.BuildError, match="2\\^38|min.sampling_ratio"):
        DeviceFmIndex.from_host(_FakeLen(fm, 2 ** 38), force_wide=True)


@pytest.mark.parametrize("dense", [True, False])
def test_wide_pattern_dp_on_mesh(dense):
    """Wide index replicated over the virtual mesh, pattern batches
    sharded (pattern-DP): the per-shard two-lane gather engine, with and
    without host-built dense seeds, must merge to the host oracle's
    answers."""
    import jax
    from sview_fmindex_tpu.parallel.query import ShardedFmIndex
    from sview_fmindex_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device (virtual) mesh")
    rng = np.random.default_rng(41)
    text, fm = _build(3000, "u64", seed=41)
    dev = DeviceFmIndex.from_host(fm, force_wide=True,
                                  dense_host_entries=(1 << 12) if dense else 0)
    assert bool(dev.meta.dense_k) == dense
    sharded = ShardedFmIndex(dev, make_mesh())
    plen = 10
    B = 64
    starts = rng.integers(0, 3000 - plen, size=B)
    pats = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(plen)]
    lens = np.full(B, plen, np.int32)
    c = np.asarray(sharded.count(pats, lens))
    assert c.dtype == np.uint64
    for i in range(B):
        assert int(c[i]) == fm.count(pats[i].tobytes()), i
    locs, pids, valid, dropped = sharded.locate(pats, lens)
    assert int(np.asarray(dropped).sum()) == 0
    by = {}
    for l, p, v in zip(locs, pids, valid):
        if v:
            by.setdefault(int(p), []).append(int(l))
    for i in range(B):
        assert sorted(by.get(i, [])) == sorted(fm.locate(pats[i].tobytes())), i
