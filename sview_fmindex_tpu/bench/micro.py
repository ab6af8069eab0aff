"""Microbenchmark suite — the criterion-analog benches, committed and
re-runnable.

Mirrors the reference's criterion groups (``sview-fmindex/benches/
benchmark.rs:39-48``) with the batched-device equivalents:

- ``rank``    (= ``counting_bit``): ns/query of the row-gather rank
  (``ops.rank``) over a batch-size sweep.
- ``sort``    (= ``sorting``): ``lax.sort`` of (u32 key, i32 payload)
  pairs over 2B lanes — the floor of one sort-join pass at that batch.
- ``search``  count throughput per batch size.
- ``locate``  (= ``locate_vs_buffer``): phase breakdown — ranges / resolve
  / full pipeline — per batch size.
- ``build``   (= ``memory_vs_disk_mmap``): host build and device upload.

Run: ``python -m sview_fmindex_tpu.bench.micro --text-size 1e7``
Writes one JSON with every row; prints an aligned table.  Sizes default
smaller on the CPU backend.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


from .timing import force as _force, timeit


def build_index(text_size: int, seed: int, cache_dir: str | None):
    import os

    from sview_fmindex_tpu import (
        BLOCK3_U64,
        EncodingTable,
        FmIndex,
        FmIndexBuilder,
        LookupTableConfig,
        SuffixArrayConfig,
    )

    rng = np.random.default_rng(seed)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=text_size)]
    enc = EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    builder = FmIndexBuilder(
        text_size, enc.symbol_count(), enc, position="u32", block=BLOCK3_U64,
        suffix_array_config=SuffixArrayConfig.compressed(2),
        lookup_table_config=LookupTableConfig.kmer_size(3),
    )
    blob_path = sa_path = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        blob_path = os.path.join(cache_dir, f"micro_{text_size}_{seed}.blob")
        sa_path = os.path.join(cache_dir, f"micro_{text_size}_{seed}.sa.u32")
    t0 = time.perf_counter()
    if blob_path and os.path.exists(blob_path) and os.path.exists(sa_path):
        blob = np.fromfile(blob_path, np.uint8)
        build_s = 0.0
    else:
        blob = np.frombuffer(
            bytes(builder.build(text.tobytes(), sa_full_path=sa_path)), np.uint8)
        build_s = time.perf_counter() - t0
        if blob_path:
            blob.tofile(blob_path)
    fm = FmIndex.load(blob, position="u32", block=BLOCK3_U64,
                      encoder_kind="table")
    sa_full = np.fromfile(sa_path, "<u4") if sa_path else None
    return text, fm, sa_full, build_s


def make_patterns(text: np.ndarray, n: int, length: int, seed: int):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(text) - length, size=n)
    return text[starts[:, None] + np.arange(length)]


def main(argv=None) -> None:
    import jax
    import jax.numpy as jnp

    ap = argparse.ArgumentParser(prog="micro")
    ap.add_argument("--text-size", type=float, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--batches", default=None,
                    help="comma-separated batch sizes (default per-backend)")
    ap.add_argument("--groups", default="rank,sort,search,locate,build")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--out", default=None, help="write rows as JSON")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--profile-dir", default=None,
                    help="capture a jax.profiler trace of the locate group")
    args = ap.parse_args(argv)

    on_accelerator = jax.default_backend() != "cpu"
    text_size = int(args.text_size or (1e8 if on_accelerator else 1e6))
    batches = [int(float(b)) for b in (
        args.batches.split(",") if args.batches
        else (["100000", "1000000"] if on_accelerator else ["20000"]))]
    groups = set(args.groups.split(","))
    rows: list[dict] = []

    def row(group, name, B, steady_s, warm_s, unit="ns/q", n=None):
        n = n if n is not None else B
        val = steady_s / max(n, 1) * 1e9 if unit == "ns/q" else steady_s
        r = dict(group=group, name=name, B=B, value=round(val, 2), unit=unit,
                 steady_ms=round(steady_s * 1e3, 3), warm_s=round(warm_s, 2))
        rows.append(r)
        log(f"  {group:7s} {name:34s} B={B:<9d} {val:10.2f} {unit:6s} "
            f"(steady {steady_s*1e3:8.2f} ms, warm {warm_s:5.1f} s)")

    log(f"[micro] backend={jax.default_backend()} text_size={text_size}")
    t0 = time.perf_counter()
    text, fm, sa_full, build_s = build_index(text_size, args.seed, args.cache_dir)
    log(f"[micro] host build: {build_s:.1f}s (+load {time.perf_counter()-t0-build_s:.1f}s)")

    t0 = time.perf_counter()
    # deep seed table, shallow host part: the dk>10 levels extend ON DEVICE
    # (extend_dense_lut_device) — seconds instead of a ~20 min host pass
    dev = fm.to_device(dense_lut_entries=1 << 26 if on_accelerator else 1 << 16,
                       dense_host_entries=1 << 20,
                       sa_full=sa_full)
    upload_s = time.perf_counter() - t0
    log(f"[micro] device upload: {upload_s:.1f}s (dense_k={dev.meta.dense_k})")
    if "build" in groups:
        rows.append(dict(group="build", name="host_build", B=text_size,
                         value=round(build_s, 2), unit="s"))
        rows.append(dict(group="build", name="device_upload", B=text_size,
                         value=round(upload_s, 2), unit="s"))

    from sview_fmindex_tpu.ops import rank as rank_ops

    rng = np.random.default_rng(args.seed + 7)

    if "rank" in groups:
        log("[micro] group rank")
        @functools.partial(jax.jit, static_argnames=("meta",))
        def f_gather(fused, sentinel, pos, sym, meta):
            return rank_ops.rank_next(meta, fused, sentinel, pos, sym)

        for B in batches:
            N = 2 * B  # a search step ranks both range endpoints
            pos = jnp.asarray(rng.integers(0, fm.text_len, N, np.uint32))
            sym = jnp.asarray(rng.integers(0, 4, N).astype(np.int32))
            warm, dt = timeit(f_gather, dev.fused, dev.sentinel, pos, sym,
                              dev.meta, reps=args.reps)
            row("rank", "gather", B, dt, warm, n=N)

    if "sort" in groups:
        log("[micro] group sort")
        f_sort = jax.jit(lambda p, m: jax.lax.sort((p, m), num_keys=1))
        for B in batches:
            N = 2 * B
            pos = jnp.asarray(rng.integers(0, fm.text_len, N, np.uint32))
            payload = jnp.asarray(np.arange(N, dtype=np.int32))
            warm, dt = timeit(f_sort, pos, payload, reps=args.reps)
            row("sort", "sort_u32_pair", B, dt, warm, n=N)

    pats = {B: jnp.asarray(make_patterns(text, B, 20, args.seed + 1))
            for B in batches}
    lens = {B: np.full(B, 20, np.int32) for B in batches}

    if "search" in groups:
        log("[micro] group search")
        for B in batches:
            warm, dt = timeit(lambda p, B=B: dev.count(p, lens[B]),
                              pats[B], reps=args.reps)
            row("search", "count", B, dt, warm)

    if "locate" in groups:
        log("[micro] group locate")
        from sview_fmindex_tpu.ops.locate import expand_capacity

        for B in batches:
            cap = expand_capacity(np.asarray(dev.count(pats[B], lens[B])))
            warm, dt = timeit(lambda p, B=B: dev.pos_ranges(p, lens[B]),
                              pats[B], reps=args.reps)
            row("locate", "ranges", B, dt, warm)
            lo, hi = dev.pos_ranges(pats[B], lens[B])
            warm, dt = timeit(lambda l, h: dev.resolve_rows(l, h, cap), lo, hi,
                              reps=args.reps)
            row("locate", f"resolve[cap={cap}]", B, dt, warm)
            warm, dt = timeit(
                lambda p, B=B: dev.locate_with_counts(p, lens[B], capacity=cap),
                pats[B], reps=args.reps)
            row("locate", f"locate[cap={cap}]", B, dt, warm)
        if args.profile_dir:
            # trace captured OUTSIDE the timed loops (profiling adds
            # per-dispatch overhead that would distort the rows above)
            B = batches[-1]
            cap = expand_capacity(np.asarray(dev.count(pats[B], lens[B])))
            with jax.profiler.trace(args.profile_dir):
                _force(dev.locate_with_counts(pats[B], lens[B], capacity=cap))
            log(f"[micro] trace written to {args.profile_dir}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(backend=jax.default_backend(), text_size=text_size,
                           rows=rows), f, indent=1)
        log(f"[micro] wrote {args.out}")
    print(json.dumps(dict(metric="micro_rows", value=len(rows), unit="rows")))


if __name__ == "__main__":
    main()
