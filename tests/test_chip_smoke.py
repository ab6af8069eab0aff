"""chip_smoke.py's own checks: the device check and the comparisons with
the host oracle and the text must catch what they are there to catch."""
import os
import sys
import types

import numpy as np
import pytest

import sview_fmindex_tpu as fmx

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def located():
    """A small index and one located batch: (fm, text, pats, lens, counts,
    locs, pids, valid)."""
    rng = np.random.default_rng(8)
    n = 3000
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    enc = fmx.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    b = fmx.FmIndexBuilder(
        n, enc.symbol_count(), enc, position="u32", block=fmx.BLOCK3_U64,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(2),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(3))
    fm = fmx.FmIndex.load(np.frombuffer(b.build(text), np.uint8),
                          position="u32", block=fmx.BLOCK3_U64,
                          encoder_kind="table")
    pats = chip_smoke.text_patterns(rng, text, 64, 8)
    lens = np.full(64, 8, np.int32)
    locs, pids, valid, counts, dropped = map(
        np.asarray, fm.to_device(dense_lut_entries=0).locate_with_counts(
            pats, lens))
    assert int(dropped[0]) == 0
    return fm, text, pats, lens, counts, locs, pids, valid


def test_oracle_comparison_passes_on_true_answers(located):
    fm, text, pats, lens, counts, locs, pids, valid = located
    lanes = np.arange(64)
    assert chip_smoke.compare_with_oracle(
        fm, pats, lens, counts, lanes, locs, pids, valid) == 64
    assert chip_smoke.check_against_text(
        fm, text, pats, lens, locs, pids, valid) == int(valid.sum())


def test_oracle_comparison_catches_a_wrong_count(located):
    fm, text, pats, lens, counts, locs, pids, valid = located
    bad = counts.copy()
    bad[17] += 1
    with pytest.raises(chip_smoke.Mismatch, match="lane 17"):
        chip_smoke.compare_with_oracle(fm, pats, lens, bad, np.arange(64))


def test_oracle_comparison_catches_a_wrong_location(located):
    fm, text, pats, lens, counts, locs, pids, valid = located
    bad = locs.copy()
    slot = int(np.nonzero(valid & (pids == 5))[0][0])
    bad[slot] += 1
    with pytest.raises(chip_smoke.Mismatch, match="lane 5"):
        chip_smoke.compare_with_oracle(fm, pats, lens, counts, np.arange(64),
                                       bad, pids, valid)


def test_text_check_catches_a_wrong_location(located):
    fm, text, pats, lens, counts, locs, pids, valid = located
    bad = locs.copy()
    slot = int(np.nonzero(valid)[0][0])
    bad[slot] = (bad[slot] + 1) % (len(text) - 8)
    with pytest.raises(chip_smoke.Mismatch, match=f"slot {slot}"):
        chip_smoke.check_against_text(fm, text, pats, lens, bad, pids, valid)


def test_device_check_refuses_the_cpu():
    import jax

    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.check_gpu(jax.devices())


def test_device_check_reports_a_gpu():
    gpu = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    assert chip_smoke.check_gpu([gpu] * 4) == {
        "platform": "gpu", "kind": "NVIDIA H100", "count": 4}
