"""Device (batched JAX) engine vs host oracle — must agree bit-exactly.

Runs on the virtual CPU backend (conftest.py); the same code path runs on
the GPU.
"""
import random

import numpy as np
import pytest

from sview_fmindex_tpu import (
    BlockKind,
    EncodingTable,
    FmIndex,
    FmIndexBuilder,
    LookupTableConfig,
    PassThrough,
    SuffixArrayConfig,
)
from sview_fmindex_tpu.utils.patterns import pack_patterns

from oracle import brute_force_locate, gen_rand_pattern, gen_rand_symbols, gen_rand_text


def _build(text, symbols, block, r, k, position="u32"):
    enc = EncodingTable.from_symbols(symbols)
    builder = FmIndexBuilder(
        len(text), enc.symbol_count(), enc, position=position, block=block,
        suffix_array_config=SuffixArrayConfig.compressed(r) if r > 1 else None,
        lookup_table_config=LookupTableConfig.kmer_size(k) if k > 1 else None,
    )
    blob = builder.build(text)
    return FmIndex.load(blob, position=position, block=block, encoder_kind="table")


@pytest.mark.parametrize("block,r,k", [
    (BlockKind(2, 64), 2, 3),
    (BlockKind(2, 32), 1, 1),
    (BlockKind(3, 64), 3, 2),
    (BlockKind(3, 128), 2, 3),
    (BlockKind(4, 64), 4, 4),
    (BlockKind(6, 64), 2, 2),
])
def test_device_matches_host(block, r, k):
    rng = random.Random(block.num_planes * 1000 + block.vector_bits + r * 7 + k)
    sym_count = rng.randint(2, min(block.max_symbol, 10))
    symbols = gen_rand_symbols(rng, sym_count)
    text = gen_rand_text(rng, symbols, 300, 600)
    fm = _build(text, symbols, block, r, k)
    dev = fm.to_device()

    patterns = [gen_rand_pattern(rng, text, 1, 12) for _ in range(40)]
    # include a pattern guaranteed absent (wildcard byte not at text end...)
    batch, lens = pack_patterns(patterns)

    counts = np.asarray(dev.count(batch, lens))
    for i, p in enumerate(patterns):
        assert counts[i] == fm.count(p), (i, p)

    locs, pat_ids, valid, _dropped = dev.locate(batch, lens)
    locs, pat_ids, valid = map(np.asarray, (locs, pat_ids, valid))
    by_pattern = {i: [] for i in range(len(patterns))}
    for loc, pid, ok in zip(locs, pat_ids, valid):
        if ok:
            by_pattern[int(pid)].append(int(loc))
    for i, p in enumerate(patterns):
        assert sorted(by_pattern[i]) == sorted(fm.locate(p)), (i, p)


def test_device_readme_example():
    symbols = [b"Aa", b"Cc", b"Gg", b"Tt"]
    text = b"CTCCGTACACCTGTTTCGTATCGGAXXYYZZ"
    fm = _build(text, symbols, BlockKind(2, 64), 1, 1)
    dev = fm.to_device()

    batch, lens = pack_patterns([b"TA", b"UNDEF", b"XXXXX"])
    counts = np.asarray(dev.count(batch, lens))
    assert counts.tolist() == [2, 2, 2]

    locs, pat_ids, valid, _dropped = map(np.asarray, dev.locate(batch, lens))
    got = {i: sorted(int(l) for l, p, v in zip(locs, pat_ids, valid) if v and p == i)
           for i in range(3)}
    assert got == {0: [5, 18], 1: [25, 26], 2: [25, 26]}


def test_device_mixed_lengths_and_short_patterns():
    """Lengths below/above/equal to k in one batch; empty ranges too."""
    rng = random.Random(99)
    symbols = gen_rand_symbols(rng, 4)
    text = gen_rand_text(rng, symbols, 400, 500)
    fm = _build(text, symbols, BlockKind(2, 64), 2, 4)
    dev = fm.to_device()
    enc = fm.encoder
    text_sym = enc.encode(np.frombuffer(text, np.uint8))

    patterns = [gen_rand_pattern(rng, text, l, l) for l in (1, 2, 3, 4, 5, 9, 1, 16)]
    batch, lens = pack_patterns(patterns)
    counts = np.asarray(dev.count(batch, lens))
    for i, p in enumerate(patterns):
        expected = brute_force_locate(text_sym, enc.encode(np.frombuffer(p, np.uint8)))
        assert counts[i] == len(expected)


def test_device_passthrough_encoder():
    rng = random.Random(5)
    symbols = gen_rand_symbols(rng, 3)
    enc = EncodingTable.from_symbols(symbols)
    text = gen_rand_text(rng, symbols, 200, 300)
    text_sym = enc.encode(np.frombuffer(text, np.uint8))
    builder = FmIndexBuilder(len(text), enc.symbol_count(), PassThrough(), block=BlockKind(2, 64),
                             suffix_array_config=SuffixArrayConfig.compressed(2))
    fm = FmIndex.load(builder.build(text_sym), block=BlockKind(2, 64), encoder_kind="pass")
    dev = fm.to_device()
    for _ in range(10):
        p = gen_rand_pattern(rng, text, 2, 8)
        ps = enc.encode(np.frombuffer(p, np.uint8))
        batch, lens = pack_patterns([ps])
        assert int(np.asarray(dev.count(batch, lens))[0]) == fm.count(ps)


def test_protein_alphabet_mixed_lengths():
    """BASELINE config 4: 20-symbol amino-acid alphabet (Block5<u64>),
    mixed-length 10-30 aa patterns, device == host, incl. dense-LUT seeding."""
    rng = random.Random(99)
    aa = b"ACDEFGHIKLMNPQRSTVWY"
    symbols = [bytes([c]) for c in aa]
    text = bytes(rng.choice(aa) for _ in range(4000))
    fm = _build(text, symbols, BlockKind(5, 64), 2, 2)
    dev = fm.to_device()
    assert dev.meta.dense_k >= 2  # densification active for sigma=20

    patterns = []
    for _ in range(50):
        plen = rng.randint(10, 30)
        s = rng.randint(0, len(text) - plen)
        patterns.append(text[s:s + plen])
    patterns.append(b"WWWWWWWWWWWW")  # likely absent
    batch, lens = pack_patterns(patterns)

    counts = np.asarray(dev.count(batch, lens))
    for i, p in enumerate(patterns):
        assert counts[i] == fm.count(p), (i, p)

    locs, pids, valid, _dropped = map(np.asarray, dev.locate(batch, lens))
    got = {}
    for l, pid, v in zip(locs, pids, valid):
        if v:
            got.setdefault(int(pid), []).append(int(l))
    for i, p in enumerate(patterns):
        assert sorted(got.get(i, [])) == sorted(fm.locate(p)), (i, p)


def test_dense_lut_toggle_invariance():
    """Dense seeding is pure memoization: identical results with it on/off."""
    rng = random.Random(5)
    symbols = [b"Aa", b"Cc", b"Gg", b"Tt"]
    text = gen_rand_text(rng, symbols, 2000, 3000)
    fm = _build(text, symbols, BlockKind(2, 64), 2, 3)
    dev_on = fm.to_device()
    dev_off = fm.to_device(dense_lut_entries=None)
    assert dev_on.meta.dense_k > 0 and dev_off.meta.dense_k == 0

    patterns = [gen_rand_pattern(rng, text, 1, 25) for _ in range(60)]
    batch, lens = pack_patterns(patterns)
    c_on = np.asarray(dev_on.count(batch, lens))
    c_off = np.asarray(dev_off.count(batch, lens))
    assert (c_on == c_off).all()

    def collect(dev):
        locs, pids, valid, _dropped = map(np.asarray, dev.locate(batch, lens))
        out = {}
        for l, p, v in zip(locs, pids, valid):
            if v:
                out.setdefault(int(p), []).append(int(l))
        return {k: sorted(v) for k, v in out.items()}
    assert collect(dev_on) == collect(dev_off)


def test_uniform_length_all_dense_fast_path():
    """A uniform-length batch with every lane >= dense_k takes the static
    seed/symbol fast path (all_dense + fixed_len) — results must be identical
    to the general path (forced by mixing one short pattern in)."""
    rng = random.Random(7)
    symbols = [b"A", b"C", b"G", b"T"]
    text = gen_rand_text(rng, symbols, 3000, 4000)
    fm = _build(text, symbols, BlockKind(3, 64), 2, 3)
    dev = fm.to_device()
    assert dev.meta.dense_k >= 4

    uniform = [gen_rand_pattern(rng, text, 12, 12) for _ in range(32)]
    batch_u, lens_u = pack_patterns(uniform)
    counts_u = np.asarray(dev.count(batch_u, lens_u))

    mixed = uniform + [gen_rand_pattern(rng, text, 2, 2)]
    batch_m, lens_m = pack_patterns(mixed)
    counts_m = np.asarray(dev.count(batch_m, lens_m))

    assert (counts_u == counts_m[:32]).all()
    for i, p in enumerate(uniform):
        assert counts_u[i] == fm.count(p), (i, p)

    locs, pids, valid, _dropped = map(np.asarray, dev.locate(batch_u, lens_u))
    got = {}
    for l, pid, v in zip(locs, pids, valid):
        if v:
            got.setdefault(int(pid), []).append(int(l))
    for i, p in enumerate(uniform):
        assert sorted(got.get(i, [])) == sorted(fm.locate(p)), (i, p)


def test_sa_full_locate_path(tmp_path):
    """Full (r=1) SA device cache: locate via ONE gather must equal the LF
    walk bit-exactly, including sentinel-row and short-pattern cases."""
    rng = random.Random(11)
    symbols = [b"Aa", b"Cc", b"Gg", b"Tt"]
    enc = EncodingTable.from_symbols(symbols)
    text = gen_rand_text(rng, symbols, 800, 1200)
    sa_path = str(tmp_path / "sa_full.u32")
    builder = FmIndexBuilder(
        len(text), enc.symbol_count(), enc, position="u32", block=BlockKind(2, 64),
        suffix_array_config=SuffixArrayConfig.compressed(3),
        lookup_table_config=LookupTableConfig.kmer_size(2),
    )
    blob = builder.build(text, sa_full_path=sa_path)
    fm = FmIndex.load(blob, position="u32", block=BlockKind(2, 64), encoder_kind="table")
    dev_walk = fm.to_device()
    dev_full = fm.to_device(sa_full=sa_path)
    assert dev_full.meta.has_sa_full and not dev_walk.meta.has_sa_full
    assert dev_full.sa.shape[0] == fm.text_len

    # pattern of length 1 hits the sentinel-walk short-circuit often
    patterns = [gen_rand_pattern(rng, text, 1, 10) for _ in range(50)]
    patterns.append(text[:1])
    batch, lens = pack_patterns(patterns)

    def collect(dev):
        locs, pids, valid, _dropped = map(np.asarray, dev.locate(batch, lens))
        out = {}
        for l, p, v in zip(locs, pids, valid):
            if v:
                out.setdefault(int(p), []).append(int(l))
        return {k: sorted(v) for k, v in out.items()}

    walk, full = collect(dev_walk), collect(dev_full)
    assert walk == full
    for i, p in enumerate(patterns):
        assert full.get(i, []) == sorted(fm.locate(p)), (i, p)


def test_device_u64_position_blob():
    """u64-position blobs upload and query fine while text_len < 2^32
    (positions are re-packed to uint32 device lanes; text_length.rs:87-129
    makes u64 a first-class Position in the reference)."""
    rng = random.Random(21)
    symbols = gen_rand_symbols(rng, 5)
    text = gen_rand_text(rng, symbols, 400, 700)
    fm = _build(text, symbols, BlockKind(3, 64), 2, 2, position="u64")
    dev = fm.to_device()

    patterns = [gen_rand_pattern(rng, text, 1, 10) for _ in range(30)]
    batch, lens = pack_patterns(patterns)
    counts = np.asarray(dev.count(batch, lens))
    for i, p in enumerate(patterns):
        assert counts[i] == fm.count(p), (i, p)
    locs, pids, valid, _dropped = map(np.asarray, dev.locate(batch, lens))
    got = {}
    for l, p, v in zip(locs, pids, valid):
        if v:
            got.setdefault(int(p), []).append(int(l))
    for i, p in enumerate(patterns):
        assert sorted(got.get(i, [])) == sorted(fm.locate(p)), (i, p)


def test_device_routes_text_ge_2_32_to_wide_engine():
    """Texts >= 2^32 route to the two-lane wide engine (ops/wide.py);
    the remaining hard gates are 2^38 (block indices must fit uint32) and
    non-power-of-two sampling ratios."""
    import copy

    from sview_fmindex_tpu.config import BuildError

    rng = random.Random(22)
    symbols = gen_rand_symbols(rng, 4)
    text = gen_rand_text(rng, symbols, 200, 300)
    fm = _build(text, symbols, BlockKind(2, 64), 2, 2, position="u64")
    fm_big = copy.copy(fm)
    fm_big.text_len = 2**32
    dev = fm_big.to_device()
    assert dev.meta.wide_pos
    fm_huge = copy.copy(fm)
    fm_huge.text_len = 2**38
    with pytest.raises(BuildError, match="2\\^38"):
        fm_huge.to_device()


def test_device_block6_wide_alphabet():
    """sigma > 32 (Block6 territory, 6 bit planes) on the device engine."""
    rng = random.Random(23)
    symbols = gen_rand_symbols(rng, 40)
    text = gen_rand_text(rng, symbols, 600, 900)
    fm = _build(text, symbols, BlockKind(6, 64), 2, 2)
    dev = fm.to_device()
    assert dev.meta.sigma == 40 and dev.meta.num_planes == 6

    patterns = [gen_rand_pattern(rng, text, 1, 8) for _ in range(30)]
    batch, lens = pack_patterns(patterns)
    counts = np.asarray(dev.count(batch, lens))
    for i, p in enumerate(patterns):
        assert counts[i] == fm.count(p), (i, p)
    locs, pids, valid, _dropped = map(np.asarray, dev.locate(batch, lens))
    got = {}
    for l, p, v in zip(locs, pids, valid):
        if v:
            got.setdefault(int(p), []).append(int(l))
    for i, p in enumerate(patterns):
        assert sorted(got.get(i, [])) == sorted(fm.locate(p)), (i, p)


def test_derived_cache_roundtrip_and_stale_guard(tmp_path):
    """derived_cache_dir: second upload reuses the cached tables; a
    DIFFERENT text of the same length gets its own digest, never a stale
    serve."""
    rng = random.Random(31)
    symbols = [b"Aa", b"Cc", b"Gg", b"Tt"]
    texts = [gen_rand_text(rng, symbols, 500, 500) for _ in range(2)]
    assert len(texts[0]) == len(texts[1]) and texts[0] != texts[1]
    cache = str(tmp_path)
    pats = None
    for text in texts:
        fm = _build(text, symbols, BlockKind(3, 64), 2, 2)
        # the HOST-assembled fused table is what the cache files hold
        dev1 = fm.to_device(derived_cache_dir=cache)
        dev2 = fm.to_device(derived_cache_dir=cache)
        np.testing.assert_array_equal(np.asarray(dev1.fused), np.asarray(dev2.fused))
        patterns = [gen_rand_pattern(rng, text, 2, 8) for _ in range(20)]
        batch, lens = pack_patterns(patterns)
        counts = np.asarray(dev2.count(batch, lens))
        for i, p in enumerate(patterns):
            assert counts[i] == fm.count(p), (i, p)
    # two texts -> two distinct fused caches on disk
    import os
    fused_files = [f for f in os.listdir(cache) if f.startswith("fused")]
    assert len(fused_files) == 2, fused_files


def test_dense_lut_device_extension_invariance():
    """Extending the dense seed table ON DEVICE (extra LF levels over the
    uploaded index) must give bit-identical query results to the host-built
    table of the same depth and to no densification at all."""
    from sview_fmindex_tpu.models.device_index import DeviceFmIndex

    rng = random.Random(41)
    symbols = [b"Aa", b"Cc", b"Gg", b"Tt"]
    text = gen_rand_text(rng, symbols, 2000, 2500)
    fm = _build(text, symbols, BlockKind(2, 64), 2, 2)
    sigma = 4
    dev_plain = DeviceFmIndex.from_host(fm, dense_lut_entries=0)
    dev_host5 = DeviceFmIndex.from_host(fm, dense_lut_entries=sigma**5)
    dev_ext = DeviceFmIndex.from_host(fm, dense_lut_entries=sigma**5,
                                      dense_host_entries=sigma**3)
    assert dev_host5.meta.dense_k == 5 and dev_ext.meta.dense_k == 5

    patterns = [gen_rand_pattern(rng, text, 1, 12) for _ in range(40)]
    patterns.append(b"zz\x01\x02zzz")  # absent -> exercises empty entries
    batch, lens = pack_patterns(patterns)
    c0 = np.asarray(dev_plain.count(batch, lens))
    c1 = np.asarray(dev_host5.count(batch, lens))
    c2 = np.asarray(dev_ext.count(batch, lens))
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_array_equal(c0, c2)

    l1 = dev_host5.locate(batch, lens, capacity=1024)
    l2 = dev_ext.locate(batch, lens, capacity=1024)
    for a, b in zip(l1, l2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dense_extension_multi_chunk_padding():
    """extend_dense_lut_device with a chunk smaller than the table: the
    pad/concat chunking path must match the single-chunk result exactly
    (this is the path the Gbp-scale dk13->14 extension takes)."""
    from sview_fmindex_tpu.build.dense_lut import extend_dense_lut_device
    from sview_fmindex_tpu.models.device_index import DeviceFmIndex

    rng = random.Random(51)
    symbols = [b"Aa", b"Cc", b"Gg", b"Tt"]
    text = gen_rand_text(rng, symbols, 1500, 2000)
    fm = _build(text, symbols, BlockKind(2, 64), 2, 2)
    dev = DeviceFmIndex.from_host(fm, dense_lut_entries=4**3)
    assert dev.meta.dense_k == 3
    count_arr = np.asarray(dev.count_arr)

    big = extend_dense_lut_device(dev.meta, dev.fused, count_arr,
                                  dev.sentinel, dev.dense_lo, dev.dense_hi,
                                  levels=2, chunk=1 << 22)
    small = extend_dense_lut_device(dev.meta, dev.fused, count_arr,
                                    dev.sentinel, dev.dense_lo, dev.dense_hi,
                                    levels=2, chunk=64)
    for a, b in zip(big, small):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert big[0].shape[0] == 4**5


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("B", [1, 1 << 20])
def test_engine_for_reports_gather(wide, B):
    """Every batch size is served by the row-gather engine; wide
    (two-lane) indexes report their own engine name."""
    rng = random.Random(99)
    symbols = gen_rand_symbols(rng, 4)
    text = gen_rand_text(rng, symbols, 400, 500)
    fm = _build(text, symbols, BlockKind(3, 64), 2, 2)
    dev = fm.to_device(force_wide=wide)
    assert dev.meta.wide_pos == wide
    assert dev.engine_for(B) == ("wide-gather" if wide else "gather")
