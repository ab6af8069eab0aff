"""The query executables compiled for an NVIDIA card, against the host
oracle.  These skip unless JAX's first device is a GPU; run them on a card
with ``SVIEW_TEST_GPU=1 python -m pytest tests/ -m gpu`` (README, "Tests").
"""
import numpy as np
import pytest

import sview_fmindex_tpu as fmx

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(3)
    n = 200_000
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n).tobytes()
    enc = fmx.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = fmx.FmIndexBuilder(
        n, enc.symbol_count(), enc, position="u32", block=fmx.BLOCK3_U64,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(2),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(3))
    fm = fmx.FmIndex.load(np.frombuffer(b.build(text), np.uint8),
                          position="u32", block=fmx.BLOCK3_U64,
                          encoder_kind="table")
    starts = rng.integers(0, n - 20, size=4096)
    pats = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(20)]
    return fm, pats


def _by_lane(locs, pids, valid):
    by = {}
    for l, p in zip(np.asarray(locs)[valid].tolist(),
                    np.asarray(pids)[valid].tolist()):
        by.setdefault(p, []).append(l)
    return by


@pytest.mark.parametrize("sa_full", [None, "device"])
def test_narrow_engine_on_card(small, sa_full):
    import jax

    fm, pats = small
    dev = fm.to_device(dense_lut_entries=1 << 16, sa_full=sa_full)
    assert dev.fused.devices() == {jax.devices()[0]}
    assert dev.engine_for(pats.shape[0]) == "gather"
    counts = np.asarray(dev.count(pats))
    locs, pids, valid, dropped = map(np.asarray, dev.locate(pats))
    assert int(dropped[0]) == 0
    by = _by_lane(locs, pids, valid)
    for i in range(0, pats.shape[0], 16):
        assert counts[i] == fm.count(pats[i].tobytes()), i
        assert sorted(by.get(i, [])) == sorted(fm.locate(pats[i].tobytes()))


def test_wide_engine_on_card(small):
    from sview_fmindex_tpu.models.device_index import DeviceFmIndex
    from sview_fmindex_tpu.ops.wide import combine64

    fm, pats = small
    dev = DeviceFmIndex.from_host(fm, force_wide=True)
    counts = combine64(*np.asarray(dev.count(pats)))
    locs, pids, valid, dropped = map(np.asarray, dev.locate(pats))
    assert int(dropped[0]) == 0
    by = _by_lane(combine64(locs[0], locs[1]), pids, valid)
    for i in range(0, pats.shape[0], 16):
        assert int(counts[i]) == fm.count(pats[i].tobytes()), i
        assert sorted(by.get(i, [])) == sorted(fm.locate(pats[i].tobytes()))


def test_pattern_dp_over_all_cards(small):
    from sview_fmindex_tpu.parallel.mesh import make_mesh
    from sview_fmindex_tpu.parallel.query import ShardedFmIndex

    fm, pats = small
    lens = np.full(pats.shape[0], pats.shape[1], np.int32)
    dev = fm.to_device(dense_lut_entries=1 << 16)
    sharded = ShardedFmIndex(dev, make_mesh())
    np.testing.assert_array_equal(np.asarray(sharded.count(pats, lens)),
                                  np.asarray(dev.count(pats, lens)))
