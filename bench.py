"""Headline benchmark: locate queries/sec/chip on the README benchmark config.

Mirrors the reference's methodology (``bench/run_benchmark.sh``, README
tables, BASELINE.md): 1 Gbp random nucleotide text (seed 42), 20 bp patterns
extracted from the text, cold=100% (all unique), index = u32 positions /
Block3<u64> / SA sampling 2 / k-mer LUT 3.

Baseline anchor (BASELINE.md): ~2.3e5 locate/s single Xeon core, in-memory.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.

Methodology notes:
- Runs on an NVIDIA GPU only: any other backend is an error, never a
  fallback.  The engine is the one ``DeviceFmIndex.engine_for`` reports.
- Before the result is printed, 200 locations are re-verified against the
  raw text and a sample of counts against the host oracle (the bench
  aborts on any mismatch).
- Steady state is pipelined: all reps are enqueued, then every result is
  waited for with ``jax.block_until_ready``.
- Both B=100k (the reference's largest pattern count) and B=1M (throughput
  scale) are measured and reported; the headline is the best sustained
  locate rate, with every per-B number in the JSON.  ``first_query_s``
  records process-start -> first locate result computed.

Env knobs:
  BENCH_TEXT_SIZE      text length (default 1e9)
  BENCH_PATTERN_COUNT  headline pattern count (default 100_000)
  BENCH_BIG_BATCH      large batch size (default 1_000_000; 0 disables)
  BENCH_CACHE_DIR      blob cache dir (default ./bench_cache)
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

T_START = time.time()

TEXT_SIZE = int(float(os.environ.get("BENCH_TEXT_SIZE", "1e9")))
PATTERN_COUNT = int(float(os.environ.get("BENCH_PATTERN_COUNT", "1e5")))
BIG_BATCH = int(float(os.environ.get("BENCH_BIG_BATCH", "1e6")))
PATTERN_LEN = 20
SEED = 42
BASELINE_LOCATE_QPS = 2.3e5  # BASELINE.md derived anchor

CACHE_DIR = os.environ.get("BENCH_CACHE_DIR", os.path.join(os.path.dirname(__file__), "bench_cache"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def get_text() -> np.ndarray:
    """uint8 [TEXT_SIZE] — memmapped on cache hit: only the pattern windows
    and the 200 re-verified locations ever page in, vs ~10 s for a full
    1 GB read+copy on the cold path."""
    path = os.path.join(CACHE_DIR, f"text_{TEXT_SIZE}_{SEED}.bin")
    if not os.path.exists(path):
        os.makedirs(CACHE_DIR, exist_ok=True)
        make_text(TEXT_SIZE, SEED).tofile(path)
    return np.memmap(path, dtype=np.uint8, mode="r")


def make_text(size: int, seed: int) -> np.ndarray:
    """uint8 [size] uniform random ACGT — bit-identical to
    ``rng.choice(ACGT, size=...)``, ~2x faster at Gbp scale."""
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=size)]


def get_blob(text: np.ndarray):
    from sview_fmindex_tpu import (
        BLOCK3_U64,
        EncodingTable,
        FmIndex,
        FmIndexBuilder,
        LookupTableConfig,
        SuffixArrayConfig,
    )

    path = os.path.join(CACHE_DIR, f"index_{TEXT_SIZE}_{SEED}_b3u64_r2_k3.blob")
    build_s = 0.0
    if not os.path.exists(path):
        enc = EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
        builder = FmIndexBuilder(
            len(text), enc.symbol_count(), enc, position="u32", block=BLOCK3_U64,
            suffix_array_config=SuffixArrayConfig.compressed(2),
            lookup_table_config=LookupTableConfig.kmer_size(3),
        )
        t0 = time.time()
        os.makedirs(CACHE_DIR, exist_ok=True)
        blob = builder.build(text)
        build_s = time.time() - t0
        log(f"[bench] built index for {TEXT_SIZE} bp in {build_s:.1f}s "
            f"({len(blob)/2**20:.0f} MiB); caching")
        with open(path, "wb") as f:
            f.write(blob)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    return FmIndex.load(mm, position="u32", block=BLOCK3_U64,
                        encoder_kind="table"), build_s


from sview_fmindex_tpu.bench.timing import force  # noqa: E402
from sview_fmindex_tpu.utils.compile_cache import use_compile_cache  # noqa: E402


def device_info() -> dict:
    """The device the run measures; raises unless it is an NVIDIA GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"this benchmark measures a GPU; JAX found {devices[0].platform}")
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def main() -> None:
    import jax
    import jax.numpy as jnp

    device = device_info()
    use_compile_cache()
    log(f"[bench] devices: {jax.devices()}")

    text = get_text()
    t0 = time.time()
    fm, build_s = get_blob(text)
    log(f"[bench] blob load: {time.time()-t0:.2f}s (build_s={build_s:.1f})")

    t0 = time.time()
    # the full SA is filled ON DEVICE from the sampled SA strided by 4
    # (fill_sa_full_device); the dk=14 seed table is dk10 host-built and
    # extended 4 levels ON DEVICE (extend_dense_lut_device)
    dev = fm.to_device(dense_lut_entries=1 << 28, dense_host_entries=1 << 20,
                       sa_full="device", sa_fill_ratio=4,
                       derived_cache_dir=CACHE_DIR)
    force(dev)
    upload_s = time.time() - t0
    log(f"[bench] device upload (dense_k={dev.meta.dense_k}, "
        f"sa_full={dev.meta.has_sa_full}): {upload_s:.2f}s")

    rng = np.random.default_rng(SEED + 1)
    text_arr = text

    def make_batch(B):
        starts = rng.integers(0, TEXT_SIZE - PATTERN_LEN, size=B)
        pats_np = text_arr[starts[:, None] + np.arange(PATTERN_LEN)]
        return jnp.asarray(pats_np), np.full(B, PATTERN_LEN, dtype=np.int32), pats_np

    from sview_fmindex_tpu.ops.locate import expand_capacity

    results = {}
    first_query_s = None
    batches = [PATTERN_COUNT] + ([BIG_BATCH] if BIG_BATCH else [])
    for B in batches:
        REPS = max(8, min(32, int(4e6 // B)))
        patterns, lens, patterns_np = make_batch(B)
        r = {}

        # ---- locate warmup (count shares the ranges executable) ----
        t0 = time.time()
        counts = np.asarray(dev.count(patterns, lens))
        capacity = expand_capacity(counts)
        force(dev.locate_with_counts(patterns, lens, capacity=capacity))
        r["warmup_s"] = round(time.time() - t0, 1)
        if first_query_s is None:
            first_query_s = round(time.time() - T_START, 1)
        assert (counts >= 1).all()
        total = int(counts.sum())

        # ---- steady state: best of 5 windows (criterion-style: the max
        # is the sustained-rate estimator) ----
        def measure(run_one):
            best = 0.0
            for _ in range(5):
                t0 = time.time()
                force([run_one() for _ in range(REPS)])
                best = max(best, REPS * B / (time.time() - t0))
            return round(best, 1)

        r["engine"] = dev.engine_for(B)
        r["count_qps"] = measure(lambda: dev.count(patterns, lens))
        r["locate_qps"] = measure(
            lambda: dev.locate_with_counts(patterns, lens, capacity=capacity))
        r["hits"] = total
        r["capacity"] = capacity
        log(f"[bench] B={B} ({r['engine']}): "
            f"count {r['count_qps']/1e6:.3f} Mq/s, "
            f"locate {r['locate_qps']/1e6:.3f} Mq/s "
            f"({total} hits, cap {capacity}, warmup {r['warmup_s']}s)")

        # ---- correctness: every reported location matches its pattern ----
        locs, pids, valid, _, dropped = dev.locate_with_counts(
            patterns, lens, capacity=capacity)
        assert int(np.asarray(dropped)[0]) == 0, "capacity overflow dropped hits"
        locs_np, pids_np, valid_np = map(np.asarray, (locs, pids, valid))
        assert int(valid_np.sum()) == total
        idx = np.nonzero(valid_np)[0][:200]
        for i in idx:
            l, p = int(locs_np[i]), int(pids_np[i])
            assert bytes(text_arr[l:l + PATTERN_LEN]) == bytes(patterns_np[p]), (l, p)

        # ---- correctness: a sample of counts against the host oracle ----
        for i in rng.integers(0, B, size=64):
            assert int(counts[i]) == fm.count(patterns_np[i].tobytes()), i
        results[B] = r

    headline_B = max(results, key=lambda b: results[b]["locate_qps"])
    locate_qps = results[headline_B]["locate_qps"]
    print(json.dumps({
        "metric": "locate_queries_per_sec_per_chip",
        "device": device,
        "value": locate_qps,
        "unit": "queries/s",
        "vs_baseline": round(locate_qps / BASELINE_LOCATE_QPS, 2),
        "count_qps": results[headline_B]["count_qps"],
        "headline_batch": headline_B,
        "text_size": TEXT_SIZE,
        "batches": {str(b): r for b, r in results.items()},
        "build_s": round(build_s, 1),
        "upload_s": round(upload_s, 1),
        "first_query_s": first_query_s,
    }))


if __name__ == "__main__":
    main()
