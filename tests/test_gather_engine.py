"""The XLA row-gather engine (ops/rank.py, ops/search.py, ops/locate.py)
against the host oracle, at the batch shapes the serving path sees:
uniform lengths with odd and even LF step counts, dense seeds, absent
patterns, mixed lengths and bytes outside the alphabet.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from sview_fmindex_tpu import (
    BLOCK2_U32,
    BLOCK3_U64,
    BLOCK3_U128,
    EncodingTable,
    FmIndex,
    FmIndexBuilder,
    LookupTableConfig,
    SuffixArrayConfig,
)
from sview_fmindex_tpu.models.device_index import _as_batch
from sview_fmindex_tpu.ops import rank as rank_ops


def _index(n=3000, seed=11, ratio=2, block=BLOCK3_U64):
    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n).tobytes()
    enc = EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    builder = FmIndexBuilder(
        len(text), enc.symbol_count(), enc, block=block,
        suffix_array_config=SuffixArrayConfig.compressed(ratio),
        lookup_table_config=LookupTableConfig.kmer_size(3),
        sa_backend="numpy",
    )
    fm = FmIndex.load(builder.build(text), block=block, encoder_kind="table")
    return fm, text, rng


def _check_against_oracle(fm, dev, batch, lens):
    counts = np.asarray(dev.count(batch, lens))
    locs, pids, valid, dropped = map(np.asarray, dev.locate(batch, lens))
    assert int(dropped[0]) == 0
    for i in range(batch.shape[0]):
        pat = batch[i, : lens[i]].tobytes()
        assert counts[i] == fm.count(pat), (i, pat)
        mine = sorted(locs[valid & (pids == i)].tolist())
        assert mine == sorted(fm.locate(pat)), (i, pat)
    return counts


@pytest.mark.parametrize("plen", [9, 10, 11, 12, 16])
def test_uniform_batches_match_host(plen):
    """Uniform-length batches after the blob k=3 seed take plen-3 LF steps
    (odd and even counts across the cases); an absent lane's empty range
    must stay empty through every step."""
    fm, text, rng = _index(n=2500)
    dev = fm.to_device(dense_lut_entries=0)
    B = 64
    starts = rng.integers(0, len(text) - plen, size=B)
    batch = np.frombuffer(text, np.uint8)[
        np.asarray(starts)[:, None] + np.arange(plen)].copy()
    batch[3] = np.frombuffer(b"T" * plen, np.uint8)  # absent
    lens = np.full(B, plen, np.int32)
    _, _, steps, facts = _as_batch(dev.meta, batch, lens)
    assert facts == (False, plen) and steps == plen - 3
    counts = _check_against_oracle(fm, dev, batch, lens)
    assert counts[3] == 0


@pytest.mark.parametrize("tail", [4, 5])
def test_dense_seed_tail_matches_host(tail):
    """All-dense uniform batches (the static seed/symbol path) with an even
    and an odd number of LF steps after the dense seed."""
    fm, text, rng = _index(n=4000)
    dev = fm.to_device(dense_lut_entries=1 << 20)
    assert dev.meta.dense_k > fm.kmer_size
    plen = dev.meta.dense_k + tail
    B = 48
    starts = rng.integers(0, len(text) - plen, size=B)
    batch = np.frombuffer(text, np.uint8)[
        np.asarray(starts)[:, None] + np.arange(plen)].copy()
    lens = np.full(B, plen, np.int32)
    _, _, steps, facts = _as_batch(dev.meta, batch, lens)
    assert facts == (True, plen) and steps == tail
    _check_against_oracle(fm, dev, batch, lens)


def test_mixed_lengths_absent_and_wildcard_bytes():
    """Lengths 1..20 in one batch (below k, below dense_k, above both),
    absent patterns, and bytes outside ACGT (wildcard: they encode as the
    last symbol, exactly like the host encoder)."""
    fm, text, rng = _index(n=4000)
    dev = fm.to_device(dense_lut_entries=1 << 12)
    B, L = 60, 20
    lens = rng.integers(1, L + 1, size=B).astype(np.int32)
    batch = np.zeros((B, L), np.uint8)
    for i in range(B):
        s = int(rng.integers(0, len(text) - lens[i]))
        batch[i, : lens[i]] = np.frombuffer(text[s : s + lens[i]], np.uint8)
    batch[0, : lens[0]] = ord("N")
    batch[1, :3] = np.frombuffer(b"AxT", np.uint8)
    lens[1] = 3
    batch[2] = np.frombuffer(b"ACGTTGCAACGTTGCAACGT", np.uint8)[::-1]
    lens[2] = L
    counts = np.asarray(dev.count(batch, lens))
    for i in range(B):
        assert counts[i] == fm.count(batch[i, : lens[i]].tobytes()), i
    long_lanes = lens >= 8  # short lanes hit too often to locate cheaply
    sub, sub_lens = batch[long_lanes], lens[long_lanes]
    _check_against_oracle(fm, dev, sub, sub_lens)


@pytest.mark.parametrize("block", [BLOCK3_U64, BLOCK2_U32, BLOCK3_U128])
def test_rank_primitives_match_host(block):
    """rank_next / pre_rank_and_symidx on the fused table equal the host
    oracle's get_next_rank / get_pre_rank_and_symidx at random positions,
    including the sentinel row."""
    fm, _, rng = _index(n=3000, block=block)
    dev = fm.to_device(dense_lut_entries=0)
    B = 500
    pos = rng.integers(0, fm.text_len, size=B).astype(np.uint32)
    pos[0] = fm.sentinel_index - 1
    sym = rng.integers(0, fm.symbol_count, size=B).astype(np.int32)
    got = np.asarray(rank_ops.rank_next(
        dev.meta, dev.fused, dev.sentinel, jnp.asarray(pos), jnp.asarray(sym)))
    for i in range(B):
        assert got[i] == fm._rank_next(int(pos[i]), int(sym[i])), i
    rank, symidx, is_sent = map(np.asarray, rank_ops.pre_rank_and_symidx(
        dev.meta, dev.fused, dev.sentinel, jnp.asarray(pos)))
    for i in range(B):
        want = fm._pre_rank_and_symidx(int(pos[i]))
        assert bool(is_sent[i]) == (want is None), i
        if want is not None:
            assert (int(rank[i]), int(symidx[i])) == want, i


@pytest.mark.parametrize("n,plen,dense", [
    (3001, 12, 4 ** 5),  # dense seed, mixed lengths on both sides of dk
    (777, 9, 0),         # blob k=3 seed, mixed odd/even step counts
    (100, 5, 0),         # tiny text: sentinel-heavy ranges
])
def test_random_length_batches_match_oracle(n, plen, dense):
    fm, text, rng = _index(n=n, seed=n)
    dev = fm.to_device(dense_lut_entries=dense)
    starts = rng.integers(0, n - plen, size=64)
    batch = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(plen)]
    lens = rng.integers(1, plen + 1, size=64).astype(np.int32)
    counts = np.asarray(dev.count(batch, lens))
    for i in range(64):
        assert counts[i] == fm.count(batch[i, : lens[i]].tobytes()), i


def test_locate_explicit_capacity_matches_auto():
    """An explicit, sufficient capacity returns the same slots as the
    auto-sized call; locate_with_counts' counts equal count()."""
    fm, text, rng = _index(n=2048, seed=7)
    dev = fm.to_device(dense_lut_entries=0)
    starts = rng.integers(0, 2048 - 10, size=32)
    batch = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(10)]
    auto = dev.locate(batch)
    cap = auto[0].shape[0]
    locs, pids, valid, counts, dropped = dev.locate_with_counts(
        batch, capacity=cap)
    for a, b in zip(auto, (locs, pids, valid, dropped)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(counts),
                                  np.asarray(dev.count(batch)))
