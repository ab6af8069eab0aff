"""Device-derived upload paths: the on-device sa_full reconstruction
(build/sa_fill.py) and the device-derived checkpoint columns
(ops.rank.derive_fused_device).

Both derive on device what the host could also upload: the full suffix
array from the strided sampled SA, and the fused table's checkpoint
columns from its plane columns.  Both must be bit-identical to their
host-built equivalents.
"""
import os
import tempfile

import numpy as np
import pytest

import sview_fmindex_tpu as fmx


def _build(text, symbols, block, r=2, k=3, sa_full_path=None):
    enc = fmx.EncodingTable.from_symbols(symbols)
    b = fmx.FmIndexBuilder(
        len(text), enc.symbol_count(), enc, position="u32", block=block,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(r),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(k))
    blob = b.build(text, sa_full_path=sa_full_path)
    return fmx.FmIndex.load(np.frombuffer(blob, np.uint8), position="u32",
                            block=block, encoder_kind="table")


@pytest.mark.parametrize("n,ratio", [(10007, 4), (4096, 2), (733, 8),
                                     (20011, 16), (1500, 1)])
def test_sa_device_fill_matches_builder(n, ratio):
    rng = np.random.default_rng(n * 7 + ratio)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "sa.u32")
        fm = _build(text, [b"A", b"C", b"G", b"T"], fmx.BLOCK3_U64,
                    sa_full_path=p)
        sa_true = np.fromfile(p, dtype="<u4")
    dev = fm.to_device(sa_full="device", sa_fill_ratio=ratio,
                       dense_lut_entries=0)
    assert dev.meta.has_sa_full
    np.testing.assert_array_equal(np.asarray(dev.sa), sa_true)


def test_sa_device_fill_query_parity():
    """End-to-end: sa_full='device' locate == host oracle == walk locate."""
    rng = np.random.default_rng(99)
    n = 3001
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    fm = _build(text, [b"A", b"C", b"G", b"T"], fmx.BLOCK3_U64)
    dev_fill = fm.to_device(sa_full="device", dense_lut_entries=0)
    dev_walk = fm.to_device(dense_lut_entries=0)
    starts = rng.integers(0, n - 12, size=32)
    pats = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(12)]
    lens = np.full(32, 12, np.int32)
    c0 = np.asarray(dev_walk.count(pats, lens))
    c1 = np.asarray(dev_fill.count(pats, lens))
    np.testing.assert_array_equal(c0, c1)
    l0, p0, v0, d0 = map(np.asarray, dev_fill.locate(pats, lens))
    assert int(d0[0]) == 0
    by = {}
    for l, p, v in zip(l0, p0, v0):
        if v:
            by.setdefault(int(p), []).append(int(l))
    for i in range(32):
        assert sorted(by.get(i, [])) == sorted(fm.locate(pats[i].tobytes()))


def test_plane_reduced_fused_width():
    """sigma=4 over a Block3 blob keeps only 2 device planes."""
    rng = np.random.default_rng(5)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=600))
    fm = _build(text, [b"A", b"C", b"G", b"T"], fmx.BLOCK3_U64)
    dev = fm.to_device(dense_lut_entries=0)
    assert dev.meta.num_planes == 2
    assert dev.fused.shape[1] == 4 + 2 * 2  # sigma + planes_eff * lanes


@pytest.mark.parametrize("jump,floor", [(4, 64), (16, 256), (2, 4)])
def test_sa_fill_ladder_adoption_matches_builder(jump, floor):
    """The fused-compaction width ladder (adopting the push program's
    compacted state) must be bit-exact for any jump/floor — forced to
    ladder repeatedly on a small case via tiny floor/jump."""
    n, ratio = 20011, 4
    rng = np.random.default_rng(n)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "sa.u32")
        fm = _build(text, [b"A", b"C", b"G", b"T"], fmx.BLOCK3_U64,
                    sa_full_path=p)
        sa_true = np.fromfile(p, dtype="<u4")
    host = fm.to_device(dense_lut_entries=0)
    from sview_fmindex_tpu.build.sa_fill import fill_sa_full_device
    import jax.numpy as jnp

    R = fm.sampling_ratio * ratio
    sa_up = jnp.asarray(fm.suffix_array[::ratio].astype(np.uint32))
    got = fill_sa_full_device(
        host.meta, host.fused, host.count_arr, host.sentinel, sa_up,
        n, R, ladder_jump=jump, ladder_floor=floor)
    np.testing.assert_array_equal(np.asarray(got), sa_true)


@pytest.mark.parametrize("block,n", [
    (fmx.BLOCK3_U64, 5003),    # partial final block + plane reduction
    (fmx.BLOCK2_U32, 777),     # 32-position blocks
    (fmx.BLOCK3_U128, 4096),   # text divides evenly: zero-filled extra block
    (fmx.BLOCK3_U64, 64),      # exactly one full block
    (fmx.BLOCK3_U64, 63),      # single partial block
])
def test_ckpt_derive_fused_matches_host(block, n):
    """Device-derived checkpoint columns (ops.rank.derive_fused_device)
    must be bit-identical to the blob's host-assembled fused table —
    including the final partial block's zero padding, which must not count
    as symbol 0 (bwm/mod.rs:97-104,126-134)."""
    rng = np.random.default_rng(n)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    fm = _build(text, [b"A", b"C", b"G", b"T"], block)
    host = fm.to_device(dense_lut_entries=0, ckpt_derive=False)
    derived = fm.to_device(dense_lut_entries=0, ckpt_derive=True)
    np.testing.assert_array_equal(np.asarray(host.fused),
                                  np.asarray(derived.fused))
