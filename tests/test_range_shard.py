"""Range-sharded index (fused/SA split by block range) vs the host oracle.

SURVEY.md §2 parallelism inventory, "index range sharding" row — no
reference analog exists; correctness contract is bit-exact agreement with
the host engine on every mesh size, with and without the full-SA resolve.
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
    SuffixArrayConfig,
)
from sview_fmindex_tpu.parallel.mesh import make_mesh
from sview_fmindex_tpu.parallel.range_shard import RangeShardedFmIndex
from sview_fmindex_tpu.utils.patterns import pack_patterns

from oracle import gen_rand_pattern, gen_rand_symbols, gen_rand_text

pytestmark = pytest.mark.usefixtures("eight_devices")


def _build(tmp_path, n=3000, seed=3, r=2, k=2, sa_full=False):
    rng = random.Random(seed)
    symbols = gen_rand_symbols(rng, 5)
    text = gen_rand_text(rng, symbols, n, n + 500)
    enc = EncodingTable.from_symbols(symbols)
    sa_path = str(tmp_path / "sa_full.u32") if sa_full else None
    builder = FmIndexBuilder(
        len(text), enc.symbol_count(), enc, block=BlockKind(3, 64),
        suffix_array_config=SuffixArrayConfig.compressed(r),
        lookup_table_config=LookupTableConfig.kmer_size(k),
    )
    blob = builder.build(text, sa_full_path=sa_path)
    fm = FmIndex.load(blob, block=BlockKind(3, 64), encoder_kind="table")
    return fm, text, rng, sa_path


@pytest.mark.parametrize("n_dev,sa_full", [(2, False), (8, False), (4, True)])
def test_range_sharded_matches_host(tmp_path, n_dev, sa_full):
    fm, text, rng, sa_path = _build(tmp_path, sa_full=sa_full)
    mesh = make_mesh(n_devices=n_dev, axis="rs")
    rs = RangeShardedFmIndex(fm, mesh=mesh, sa_full=sa_path)
    assert rs.meta.has_sa_full == sa_full
    # the point of range sharding: each shard holds 1/D of the big tables
    assert rs.fused.sharding.shard_shape(rs.fused.shape)[0] \
        == rs.fused.shape[0] // n_dev

    patterns = [gen_rand_pattern(rng, text, 1, 10) for _ in range(30)]
    patterns.append(b"\x00\x01zzqq")  # absent pattern -> empty range lanes
    batch, lens = pack_patterns(patterns)

    counts = np.asarray(rs.count(batch, lens))
    for i, p in enumerate(patterns):
        assert counts[i] == fm.count(p), (i, p)

    locs, pids, valid, _dropped = map(np.asarray, rs.locate(batch, lens))
    got = {}
    for l, p, v in zip(locs, pids, valid):
        if v:
            got.setdefault(int(p), []).append(int(l))
    for i, p in enumerate(patterns):
        assert sorted(got.get(i, [])) == sorted(fm.locate(p)), (i, p)


@pytest.mark.parametrize("rs,dp,sa_full", [(2, 4, False), (4, 2, True)])
def test_range_shard_with_pattern_dp_2d_mesh(tmp_path, rs, dp, sa_full):
    """2-D (rs x dp) mesh: tables range-shard over rs, pattern batches
    shard over dp — the composition that buys back the compute pure range
    sharding duplicates.  Must match the host oracle bit-exactly."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    fm, text, rng, sa_path = _build(tmp_path, sa_full=sa_full)
    devs = np.array(jax.devices()[: rs * dp]).reshape(rs, dp)
    mesh = Mesh(devs, ("rs", "dp"))
    rsh = RangeShardedFmIndex(fm, mesh=mesh, axis="rs", dp_axis="dp",
                              sa_full=sa_path)
    assert rsh.dp_size == dp
    assert rsh.fused.sharding.shard_shape(rsh.fused.shape)[0] \
        == rsh.fused.shape[0] // rs

    patterns = [gen_rand_pattern(rng, text, 1, 10) for _ in range(21)]
    patterns.append(b"\x00\x01zzqq")  # absent pattern
    batch, lens = pack_patterns(patterns)  # 22 lanes -> padded to dp multiple

    counts = np.asarray(rsh.count(batch, lens))
    assert counts.shape[0] == len(patterns)
    for i, p in enumerate(patterns):
        assert counts[i] == fm.count(p), (i, p)

    locs, pids, valid, _dropped = rsh.locate(batch, lens)
    got = {}
    for l, p, v in zip(locs, pids, valid):
        if v:
            got.setdefault(int(p), []).append(int(l))
    for i, p in enumerate(patterns):
        assert sorted(got.get(i, [])) == sorted(fm.locate(p)), (i, p)
