"""Smoke run of the FM-index on NVIDIA GPUs, through the entry points a
user calls: ``FmIndexBuilder.build`` -> ``FmIndex.load`` ->
``fm.to_device()`` -> ``DeviceFmIndex.count`` / ``locate_with_counts``.

Configuration: the 1 Gbp benchmark index of ``bench.py`` and BASELINE.md
(seeded uniform ACGT text, u32 positions, Block3<u64>, SA sampling 2,
k-mer table k=3, native SA-IS), uploaded with ``bench.py``'s settings
(``dense_lut_entries=2**28``, ``sa_full="device"``).

One card (no arguments): build, upload, count + locate at B=100k and
B=1M with 20 bp patterns, a mixed batch (lengths 1-30, absent patterns,
bytes outside ACGT), and the wide (two-lane position) engine at B=100k.
``--four``: only the four-card path — ``ShardedFmIndex`` (pattern data
parallel, index replicated) count + locate at B=1M, and
``RangeShardedFmIndex`` count with the tables split four ways — compared
with the single-device results.

Every phase compares its answers EXACTLY with the host oracle
(``FmIndex.count`` / ``FmIndex.locate``) on >= 2000 sampled lanes and
>= 200 locations with the raw text, and requires ``dropped == 0``.  The
device engine is integer-only (uint32 ranks, popcounts, gathers), so no
float rounding, TF32 or reduction order can enter: equality is the bar.

Exits non-zero, printing no result, when JAX finds no GPU.  The last
stdout line is the JSON result; earlier lines carry the times, each with
the card's name and power limit.

    python chip_smoke.py [--four] [--text-size N]
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time

import numpy as np

SEED = 42
PATTERN_LEN = 20
ORACLE_LANES = 2000
TEXT_CHECKS = 200
UPLOAD = dict(dense_lut_entries=1 << 28, dense_host_entries=1 << 20,
              sa_full="device", sa_fill_ratio=4)


class Mismatch(Exception):
    """A device answer differs from the host oracle or the text."""


def check_gpu(devices) -> dict:
    """The device record of the result line; raises unless JAX's first
    device is an NVIDIA GPU."""
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs an NVIDIA GPU; JAX found {devices[0].platform}")
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def card() -> str:
    """``name, power limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def compare_with_oracle(fm, pats, lens, counts, lanes,
                        locs=None, pids=None, valid=None) -> int:
    """Compare device counts (and, when given, located slots) with the host
    oracle at ``lanes``; raises Mismatch at the first difference.  ``locs``
    are plain integers (two-lane results combined by the caller).  Returns
    the number of lanes compared."""
    by = None
    if locs is not None:
        keep = np.asarray(valid) & np.isin(pids, lanes)
        by = {int(i): [] for i in lanes}
        for p, l in zip(np.asarray(pids)[keep].tolist(),
                        np.asarray(locs)[keep].tolist()):
            by[p].append(l)
    for i in lanes:
        pat = pats[i, : lens[i]].tobytes()
        want = fm.count(pat)
        if int(counts[i]) != want:
            raise Mismatch(f"lane {i} {pat!r}: count {int(counts[i])}, "
                           f"oracle {want}")
        if by is not None:
            got, exp = sorted(by[int(i)]), sorted(fm.locate(pat))
            if got != exp:
                raise Mismatch(f"lane {i} {pat!r}: locations {got[:4]}..., "
                               f"oracle {exp[:4]}...")
    return len(lanes)


def check_against_text(fm, text, pats, lens, locs, pids, valid,
                       n: int = TEXT_CHECKS) -> int:
    """The text at each of ``n`` located slots must encode to its
    pattern (bytes outside the alphabet encode as the wildcard symbol, as
    in the index).  Raises Mismatch; returns the number checked."""
    slots = np.nonzero(np.asarray(valid))[0][:n]
    for s in slots:
        loc, p = int(locs[s]), int(pids[s])
        want = fm.encoder.encode(pats[p, : lens[p]])
        got = fm.encoder.encode(np.asarray(text[loc : loc + lens[p]]))
        if got.shape != want.shape or not (got == want).all():
            raise Mismatch(f"slot {s}: text at {loc} does not match lane {p}")
    return len(slots)


def sample_lanes(rng, B: int, must=()) -> np.ndarray:
    lanes = rng.choice(B, size=min(B, ORACLE_LANES), replace=False)
    return np.unique(np.concatenate([lanes, np.asarray(must, np.int64)]))


def text_patterns(rng, text, B: int, L: int) -> np.ndarray:
    starts = rng.integers(0, len(text) - L, size=B)
    return np.asarray(text)[starts[:, None] + np.arange(L)]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def build_index(text_size: int):
    """(text, fm, build_s): the benchmark index built with native SA-IS."""
    import sview_fmindex_tpu as fmx
    from sview_fmindex_tpu.native import loader

    from bench import make_text

    if not loader.available():
        raise RuntimeError("the native SA-IS library did not build "
                           "(python -m sview_fmindex_tpu.native.build_native)")
    text = make_text(text_size, SEED)
    enc = fmx.EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    builder = fmx.FmIndexBuilder(
        text_size, enc.symbol_count(), enc, position="u32",
        block=fmx.BLOCK3_U64,
        suffix_array_config=fmx.SuffixArrayConfig.compressed(2),
        lookup_table_config=fmx.LookupTableConfig.kmer_size(3),
        sa_backend="native")
    t0 = time.perf_counter()
    blob = builder.build(text, np.empty(builder.blob_size(), np.uint8))
    build_s = time.perf_counter() - t0
    fm = fmx.FmIndex.load(blob, position="u32", block=fmx.BLOCK3_U64,
                          encoder_kind="table")
    return text, fm, build_s


def upload(fm, device=None):
    import jax

    t0 = time.perf_counter()
    dev = fm.to_device(device=device, **UPLOAD)
    jax.block_until_ready(dev)
    return dev, time.perf_counter() - t0


def median_time(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def peak(device) -> str:
    stats = device.memory_stats()  # None where the backend keeps none
    if not stats:
        return "not reported"
    return f"{stats['peak_bytes_in_use'] / 2**30:.2f} GiB"


def exe_memory(jitted, *args) -> str:
    """Compiled memory footprint of one query executable (MiB)."""
    ma = jitted.lower(*args).compile().memory_analysis()
    mib = lambda b: f"{b / 2**20:.1f}"  # noqa: E731
    return (f"args {mib(ma.argument_size_in_bytes)} out "
            f"{mib(ma.output_size_in_bytes)} temp "
            f"{mib(ma.temp_size_in_bytes)} MiB")


def narrow_batch(dev, fm, text, rng, B: int, tag: str) -> dict:
    """count + locate of B 20 bp text patterns, checked; returns the
    results the four-card phase compares against."""
    import jax

    pats = text_patterns(rng, text, B, PATTERN_LEN)
    lens = np.full(B, PATTERN_LEN, np.int32)
    t0 = time.perf_counter()
    counts = np.asarray(dev.count(pats, lens))
    locs, pids, valid, counts2, dropped = jax.device_get(
        dev.locate_with_counts(pats, lens))
    first_s = time.perf_counter() - t0
    if int(dropped[0]) != 0:
        raise Mismatch(f"B={B}: dropped {int(dropped[0])}")
    if not (counts == counts2).all():
        raise Mismatch(f"B={B}: count() and locate_with_counts() disagree")
    if int(valid.sum()) != int(counts.sum()):
        raise Mismatch(f"B={B}: {int(valid.sum())} located slots for "
                       f"{int(counts.sum())} hits")
    n = compare_with_oracle(fm, pats, lens, counts, sample_lanes(rng, B),
                            locs, pids, valid)
    m = check_against_text(fm, text, pats, lens, locs, pids, valid)
    say(f"{tag} B={B} engine={dev.engine_for(B)}: count+locate first call "
        f"{first_s:.2f} s (compile included), {int(counts.sum())} hits; "
        f"{n} lanes == host oracle, {m} locations == text")
    return dict(pats=pats, lens=lens, counts=counts, locs=locs, pids=pids,
                valid=valid)


def gather_vs_sort(dev, pats, lens, card_name: str) -> None:
    """(a) the gather engine's backward search and (b) the floor of ONE
    sort-join pass — a lax.sort of (u32 key, i32 payload) over 2B lanes."""
    import jax
    import jax.numpy as jnp

    from sview_fmindex_tpu.models.device_index import _as_batch, _ranges_jit

    B = pats.shape[0]
    p, l, steps, facts = _as_batch(dev.meta, pats, lens)
    t_a = median_time(lambda: _ranges_jit(dev, p, l, steps, facts))
    key = jnp.asarray(np.random.default_rng(B).integers(
        0, 1 << 32, 2 * B, dtype=np.uint32))
    payload = jnp.arange(2 * B, dtype=jnp.int32)
    sort = jax.jit(lambda k, v: jax.lax.sort((k, v), num_keys=1))
    t_b = median_time(sort, key, payload)
    say(f"(a) gather pos_ranges B={B} ({steps} LF steps): {t_a*1e3:.3f} ms; "
        f"(b) lax.sort over 2B={2*B} lanes: {t_b*1e3:.3f} ms "
        f"(median of 5) [{card_name}]")


def mixed_batches(dev, fm, text, rng) -> None:
    """Count over lengths 1-30 (below k=3 and below dense_k, absent lanes,
    bytes outside ACGT); count + locate over lengths 12-30 with the same
    kinds of lanes (short lanes hit too often to locate all of them)."""
    import jax

    for lo_len, B, locate in ((1, 100_000, False), (12, 100_000, True)):
        L = 30
        lens = rng.integers(lo_len, L + 1, size=B).astype(np.int32)
        pats = text_patterns(rng, text, B, L)
        absent = np.arange(0, 200)
        pats[absent] = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                  size=(len(absent), L))
        lens[absent] = L  # 30 random bases: absent from 1 Gbp w.p. ~1
        wild = np.arange(200, 400)
        pats[wild, rng.integers(0, lo_len, size=len(wild))] = ord("N")
        pats[400] = ord("x")
        short = np.arange(401, 421)  # the shortest lengths of the range
        lens[short] = np.arange(len(short)) % 3 + lo_len
        pats[np.arange(L)[None, :] >= lens[:, None]] = 0  # padding
        must = np.arange(0, 421)
        counts = np.asarray(dev.count(pats, lens))
        lanes = sample_lanes(rng, B, must)
        if locate:
            locs, pids, valid, counts2, dropped = jax.device_get(
                dev.locate_with_counts(pats, lens))
            if int(dropped[0]) != 0:
                raise Mismatch(f"mixed batch: dropped {int(dropped[0])}")
            if not (counts == counts2).all():
                raise Mismatch("mixed batch: count/locate disagree")
            n = compare_with_oracle(fm, pats, lens, counts, lanes,
                                    locs, pids, valid)
            m = check_against_text(fm, text, pats, lens, locs, pids, valid)
            say(f"mixed count+locate B={B}, lengths {lo_len}-{L}: "
                f"{int(counts.sum())} hits; {n} lanes == host oracle, "
                f"{m} locations == text")
        else:
            n = compare_with_oracle(fm, pats, lens, counts, lanes)
            say(f"mixed count B={B}, lengths {lo_len}-{L}: {n} lanes == "
                f"host oracle (incl. {len(must)} absent/wildcard/short lanes)")


def wide_phase(fm, text, rng, card_name: str) -> None:
    import jax

    from sview_fmindex_tpu.models.device_index import DeviceFmIndex
    from sview_fmindex_tpu.ops.wide import combine64

    t0 = time.perf_counter()
    dev = DeviceFmIndex.from_host(fm, force_wide=True)
    jax.block_until_ready(dev)
    up_s = time.perf_counter() - t0
    B = 100_000
    pats = text_patterns(rng, text, B, PATTERN_LEN)
    lens = np.full(B, PATTERN_LEN, np.int32)
    t0 = time.perf_counter()
    c2 = np.asarray(dev.count(pats, lens))
    locs2, pids, valid, _, dropped = jax.device_get(
        dev.locate_with_counts(pats, lens))
    first_s = time.perf_counter() - t0
    counts, locs = combine64(c2[0], c2[1]), combine64(locs2[0], locs2[1])
    if int(dropped[0]) != 0:
        raise Mismatch(f"wide: dropped {int(dropped[0])}")
    n = compare_with_oracle(fm, pats, lens, counts, sample_lanes(rng, B),
                            locs, pids, valid)
    m = check_against_text(fm, text, pats, lens, locs, pids, valid)
    say(f"wide upload {up_s:.1f} s; B={B} engine={dev.engine_for(B)}: "
        f"count+locate first call {first_s:.2f} s; {n} lanes == host "
        f"oracle, {m} locations == text [{card_name}]")


def run_single(text_size: int, card_name: str) -> None:
    import jax

    from sview_fmindex_tpu.models.device_index import (
        _expand_jit, _ranges_jit, _as_batch)

    text, fm, build_s = build_index(text_size)
    say(f"build_s {build_s:.1f} (text {text_size} bp, native SA-IS) "
        f"[{card_name}]")
    dev, upload_s = upload(fm)
    d0 = jax.devices()[0]
    say(f"upload_s {upload_s:.1f} (dense_k={dev.meta.dense_k}, "
        f"sa_full={dev.meta.has_sa_full}); resident "
        f"fused {dev.fused.nbytes/2**30:.2f} GiB, dense "
        f"{(dev.dense_lo.nbytes + dev.dense_hi.nbytes)/2**30:.2f} GiB, sa "
        f"{dev.sa.nbytes/2**30:.2f} GiB [{card_name}]")
    rng = np.random.default_rng(SEED + 1)
    for B in (100_000, 1_000_000):
        r = narrow_batch(dev, fm, text, rng, B, "narrow")
        pats, lens = r["pats"], r["lens"]
        p, l, steps, facts = _as_batch(dev.meta, pats, lens)
        lo, hi = dev.pos_ranges(pats, lens)
        say(f"memory_analysis B={B}: ranges "
            f"{exe_memory(_ranges_jit, dev, p, l, steps, facts)}; expand "
            f"{exe_memory(_expand_jit, lo, hi, B + 1024)}")
        gather_vs_sort(dev, pats, lens, card_name)
        del r, pats, lens, p, l, lo, hi
    mixed_batches(dev, fm, text, rng)
    say(f"peak_bytes_in_use {peak(d0)} after the narrow phases "
        f"[{card_name}]")
    del dev
    gc.collect()
    wide_phase(fm, text, rng, card_name)
    say(f"peak_bytes_in_use {peak(d0)} [{card_name}]")


def run_four(text_size: int, card_name: str) -> None:
    """Pattern-DP and range-sharded serving over a 1-D four-device mesh,
    compared with the single-device results and the host oracle."""
    import jax

    from sview_fmindex_tpu.parallel.mesh import make_mesh
    from sview_fmindex_tpu.parallel.query import ShardedFmIndex
    from sview_fmindex_tpu.parallel.range_shard import RangeShardedFmIndex

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(devices)}")
    text, fm, build_s = build_index(text_size)
    say(f"build_s {build_s:.1f} (text {text_size} bp) [{card_name}]")
    dev, upload_s = upload(fm, device=devices[0])
    say(f"single-device upload_s {upload_s:.1f} [{card_name}]")
    rng = np.random.default_rng(SEED + 1)
    B = 1_000_000
    ref = narrow_batch(dev, fm, text, rng, B, "single-device")
    pats, lens = ref["pats"], ref["lens"]

    def placed(arr, what):
        """Each shard of ``arr`` on its own card."""
        devs = [s.device for s in arr.addressable_shards]
        if len(set(devs)) != 4:
            raise Mismatch(f"{what}: shards on {sorted(map(str, devs))}")
        return ", ".join(f"{s.device.id}:{s.data.shape}"
                         for s in arr.addressable_shards)

    t0 = time.perf_counter()
    sharded = ShardedFmIndex(dev, make_mesh(n_devices=4))
    jax.block_until_ready(sharded.index)
    rep_s = time.perf_counter() - t0
    where = placed(sharded.index.fused, "replicated fused table")
    t0 = time.perf_counter()
    counts = np.asarray(sharded.count(pats, lens))
    locs, pids, valid, dropped = sharded.locate(pats, lens)
    first_s = time.perf_counter() - t0
    if int(np.asarray(dropped).sum()) != 0:
        raise Mismatch(f"pattern-DP: dropped {np.asarray(dropped)}")
    if not (counts == ref["counts"]).all():
        raise Mismatch("pattern-DP counts differ from the single device")
    def canonical(pids, locs, valid):
        p, l = pids[valid].astype(np.int64), locs[valid].astype(np.int64)
        order = np.lexsort((l, p))
        return p[order], l[order]

    got = canonical(pids, locs, valid)
    want = canonical(ref["pids"], ref["locs"], ref["valid"])
    if not all(a.shape == b.shape and (a == b).all()
               for a, b in zip(got, want)):
        raise Mismatch("pattern-DP locations differ from the single device")
    n = compare_with_oracle(fm, pats, lens, counts, sample_lanes(rng, B),
                            locs, pids, valid)
    m = check_against_text(fm, text, pats, lens, locs, pids, valid)
    say(f"ShardedFmIndex 4-way B={B}: replicate {rep_s:.1f} s, count+locate "
        f"first call {first_s:.2f} s; == single device on all {B} lanes, "
        f"{n} lanes == host oracle, {m} locations == text; index on "
        f"devices {where} [{card_name}]")
    del sharded, dev
    gc.collect()

    t0 = time.perf_counter()
    rs = RangeShardedFmIndex(fm, mesh=make_mesh(n_devices=4, axis="rs"))
    jax.block_until_ready(rs.fused)
    stage_s = time.perf_counter() - t0
    where = placed(rs.fused, "range-sharded fused table")
    t0 = time.perf_counter()
    rcounts = np.asarray(rs.count(pats, lens))
    first_s = time.perf_counter() - t0
    if not (rcounts == ref["counts"]).all():
        raise Mismatch("range-sharded counts differ from the single device")
    n = compare_with_oracle(fm, pats, lens, rcounts, sample_lanes(rng, B))
    say(f"RangeShardedFmIndex 4-way B={B}: staging {stage_s:.1f} s, count "
        f"first call {first_s:.2f} s; == single device on all {B} lanes, "
        f"{n} lanes == host oracle; fused shards {where} [{card_name}]")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--text-size", type=float, default=1e9,
                    help="text length in bp (default: the 1 Gbp benchmark)")
    args = ap.parse_args(argv)

    import jax

    device = check_gpu(jax.devices())
    card_name = card()
    say(f"card (nvidia-smi name, power.limit): {card_name}")
    say(f"jax {jax.__version__}: {device['count']} x {device['kind']}")
    from sview_fmindex_tpu.utils.compile_cache import use_compile_cache

    say(f"compile cache: {use_compile_cache()}")
    text_size = int(args.text_size)
    if text_size != int(1e9):
        say(f"text cut to {text_size} bp (benchmark: 1000000000 bp)")
    t0 = time.perf_counter()
    (run_four if args.four else run_single)(text_size, card_name)
    say(f"total {time.perf_counter() - t0:.1f} s [{card_name}]")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
