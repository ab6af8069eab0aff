"""Sharded (8 virtual CPU devices) vs single-device: results must be identical.

The multi-host determinism axis from SURVEY.md §4: single-host result ==
multi-host merged result, invariant to sharding.
"""
import random

import jax
import numpy as np
import pytest

from sview_fmindex_tpu import (
    BlockKind,
    EncodingTable,
    FmIndex,
    FmIndexBuilder,
    LookupTableConfig,
    SuffixArrayConfig,
)
from sview_fmindex_tpu.parallel.mesh import make_mesh
from sview_fmindex_tpu.parallel.query import ShardedFmIndex
from sview_fmindex_tpu.utils.patterns import pack_patterns

from oracle import gen_rand_pattern, gen_rand_symbols, gen_rand_text

pytestmark = pytest.mark.usefixtures("eight_devices")


@pytest.fixture(scope="module")
def fm():
    rng = random.Random(123)
    symbols = gen_rand_symbols(rng, 4)
    text = gen_rand_text(rng, symbols, 2000, 3000)
    enc = EncodingTable.from_symbols(symbols)
    builder = FmIndexBuilder(
        len(text), enc.symbol_count(), enc, block=BlockKind(2, 64),
        suffix_array_config=SuffixArrayConfig.compressed(2),
        lookup_table_config=LookupTableConfig.kmer_size(3),
    )
    fm = FmIndex.load(builder.build(text), block=BlockKind(2, 64))
    fm._test_text = text
    fm._test_rng = rng
    return fm


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_count_matches_host(fm):
    rng = fm._test_rng
    patterns = [gen_rand_pattern(rng, fm._test_text, 2, 10) for _ in range(101)]
    batch, lens = pack_patterns(patterns)
    sharded = ShardedFmIndex(fm.to_device(), make_mesh())
    counts = np.asarray(sharded.count(batch, lens))
    assert counts.shape == (101,)
    for i, p in enumerate(patterns):
        assert counts[i] == fm.count(p), (i, p)


def test_sharded_locate_matches_host(fm):
    rng = fm._test_rng
    patterns = [gen_rand_pattern(rng, fm._test_text, 2, 8) for _ in range(37)]
    batch, lens = pack_patterns(patterns)
    sharded = ShardedFmIndex(fm.to_device(), make_mesh())
    locs, pids, valid, _dropped = sharded.locate(batch, lens)
    by = {i: [] for i in range(len(patterns))}
    for l, p, v in zip(locs, pids, valid):
        if v:
            by[int(p)].append(int(l))
    for i, p in enumerate(patterns):
        assert sorted(by[i]) == sorted(fm.locate(p)), (i, p)


def test_sharding_invariance(fm):
    """Merged results identical for 1, 2, 4, 8 device meshes."""
    rng = fm._test_rng
    patterns = [gen_rand_pattern(rng, fm._test_text, 2, 8) for _ in range(16)]
    batch, lens = pack_patterns(patterns)
    results = []
    for n in (1, 2, 4, 8):
        sharded = ShardedFmIndex(fm.to_device(), make_mesh(n_devices=n))
        counts = np.asarray(sharded.count(batch, lens)).tolist()
        locs, pids, valid, _dropped = sharded.locate(batch, lens)
        merged = sorted(
            (int(p), int(l)) for l, p, v in zip(locs, pids, valid) if v
        )
        results.append((counts, merged))
    assert all(r == results[0] for r in results[1:])


def test_sharded_uniform_dense_batch_matches_host(fm):
    """Pattern-DP over a uniform-length batch whose every lane reaches the
    dense seed (the static all_dense + fixed_len search path) must match
    the host oracle per lane."""
    rng = fm._test_rng
    dev = fm.to_device()
    plen = dev.meta.dense_k + 3
    patterns = [gen_rand_pattern(rng, fm._test_text, plen, plen)
                for _ in range(40)]
    batch, lens = pack_patterns(patterns)
    sharded = ShardedFmIndex(dev, make_mesh(n_devices=4))
    counts = np.asarray(sharded.count(batch, lens))
    for i, p in enumerate(patterns):
        assert int(counts[i]) == fm.count(p), (i, p)
    locs, pids, valid, dropped = sharded.locate(batch, lens)
    assert int(np.asarray(dropped).sum()) == 0
    by = {i: [] for i in range(len(patterns))}
    for l, p, v in zip(locs, pids, valid):
        if v:
            by[int(p)].append(int(l))
    for i, p in enumerate(patterns):
        assert sorted(by[i]) == sorted(fm.locate(p)), (i, p)
