"""Benchmark sweep driver — CSV parity with the reference's run_benchmark.sh.

Mirrors ``/root/reference/bench/run_benchmark.sh:37-139``: sweeps
{10, 1_000, 100_000} patterns x cold {1%, 10%, 100%} x algorithms, emitting
the reference CSV schema

    pattern_count,cold_ratio,algorithm,total_ns,load_percent,max_rss_kb

Algorithms (reference: lt-fm-index / sview-memory / sview-mmap):
- ``memory``  blob fully read into RAM (``fs::read`` analog), batched
  engine on the CPU backend (the in-memory production path)
- ``mmap``    np.memmap blob (page-fault on demand), zero-copy scalar
  engine straight over the blob views (the tiny-RSS disk-serving path)
- ``device``  blob + derived caches uploaded to the GPU, batched engine
  (the cell fails unless JAX's backend is ``gpu``)

Each cell runs in a FRESH subprocess (like each reference run; the parent
never imports JAX, so one process at a time holds the card) so
``max_rss_kb`` (``/usr/bin/time -v`` analog via resource.getrusage) and the
load/query split are per-cell honest.  ``total_ns`` is end-to-end inside the
cell: blob load (+ device upload/warmup for ``device``) + query + result
write, matching the reference's "Elapsed" column.  Page cache is dropped
before each mmap cell when permitted (``echo 3 > /proc/sys/vm/drop_caches``,
``run_benchmark.sh:92-97``); the driver records whether the drop succeeded.

Usage:
  python run_benchmark.py --text-size 1e9 --out RUNBENCH.csv
  python run_benchmark.py --algorithms device --patterns 100000 --colds 1.0
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE_DIR = os.environ.get("BENCH_CACHE_DIR", os.path.join(REPO, "bench_cache"))
SEED = 42
PATTERN_LEN = 20


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def text_path(text_size: int) -> str:
    return os.path.join(CACHE_DIR, f"text_{text_size}_{SEED}.bin")


def blob_path(text_size: int) -> str:
    return os.path.join(CACHE_DIR, f"index_{text_size}_{SEED}_b3u64_r2_k3.blob")


def ensure_inputs(text_size: int) -> None:
    os.environ["BENCH_TEXT_SIZE"] = str(text_size)
    sys.path.insert(0, REPO)
    import bench

    bench.TEXT_SIZE = text_size
    text = bench.get_text()
    bench.get_blob(text)


def gen_patterns(text_size: int, count: int, cold_ratio: float, seed: int):
    """Reference semantics (bench/src/generate.rs:56-144): cold = fresh
    substrings of the text, warm = cyclic repeats of the cold set."""
    text = np.memmap(text_path(text_size), dtype=np.uint8, mode="r")
    rng = np.random.default_rng(seed)
    # at least one cold pattern: warm patterns are repeats OF the cold set
    # (generate.rs:96-128), so cold_ratio=0 still needs a seed pattern
    cold_count = max(min(int(np.ceil(cold_ratio * count)), count), 1)
    starts = rng.integers(0, text_size - PATTERN_LEN + 1, size=cold_count)
    cold = text[np.asarray(starts)[:, None] + np.arange(PATTERN_LEN)]
    if count > cold_count:
        reps = -(-count // cold_count)
        pats = np.tile(cold, (reps, 1))[:count]
    else:
        pats = cold
    return pats


def drop_caches() -> bool:
    try:
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
        return True
    except OSError:
        return False


# ---------------------------------------------------------------------------
# cell runner (subprocess entry)
# ---------------------------------------------------------------------------

def run_cell(args) -> None:
    import resource

    text_size = int(float(args.text_size))
    pats = gen_patterns(text_size, int(args.patterns), float(args.cold), SEED + 1)
    out_path = os.path.join(CACHE_DIR, f"results_{args.algorithm}.txt")
    t_all = time.perf_counter_ns()

    if args.algorithm in ("device", "device-warm", "memory"):
        import jax

        from sview_fmindex_tpu.utils.compile_cache import use_compile_cache

        use_compile_cache()
        if args.algorithm == "memory":
            # the in-memory host path is the batched engine on the CPU backend
            jax.config.update("jax_platforms", "cpu")
        else:
            sys.path.insert(0, REPO)
            from bench import device_info

            device_info()  # raises unless the backend is a GPU

    from sview_fmindex_tpu import BLOCK3_U64, FmIndex

    phases = {}
    load_start = time.perf_counter_ns()
    if args.algorithm == "mmap":
        blob = np.memmap(blob_path(text_size), dtype=np.uint8, mode="r")
    else:
        blob = np.fromfile(blob_path(text_size), dtype=np.uint8)
    phases["blob_read_ns"] = time.perf_counter_ns() - load_start
    t_ph = time.perf_counter_ns()
    fm = FmIndex.load(blob, position="u32", block=BLOCK3_U64, encoder_kind="table")
    phases["view_load_ns"] = time.perf_counter_ns() - t_ph
    if args.algorithm in ("device", "device-warm", "memory"):
        from sview_fmindex_tpu.bench.timing import force
        from sview_fmindex_tpu.ops.locate import expand_capacity

        t_ph = time.perf_counter_ns()
        if args.algorithm.startswith("device"):
            # same config as bench.py: the full SA is filled on device
            dev = fm.to_device(
                dense_lut_entries=1 << 28, dense_host_entries=1 << 20,
                sa_full="device", sa_fill_ratio=4,
                derived_cache_dir=CACHE_DIR)
        else:
            # CPU-backend in-memory path: cap the dense seed table at the
            # HOST level (the on-CPU device-extension pass costs far more
            # than the LF steps it would save a one-shot batch); the .npz
            # cache makes later runs read it like a blob section
            dev = fm.to_device(dense_lut_entries=1 << 20,
                               dense_lut_cache=os.path.join(
                                   CACHE_DIR, "dense_cpu_memory.npz"),
                               derived_cache_dir=CACHE_DIR)
        phases["upload_ns"] = time.perf_counter_ns() - t_ph
        # warm the REAL batch shapes so load_ns covers runtime init +
        # upload + executable compiles (the analog of blob load)
        t_ph = time.perf_counter_ns()
        counts_w = np.asarray(dev.count(pats))
        cap = expand_capacity(counts_w)
        force(dev.locate_with_counts(pats, capacity=cap))
        phases["warm_ns"] = time.perf_counter_ns() - t_ph
        load_ns = time.perf_counter_ns() - load_start
        q_start = time.perf_counter_ns()
        counts = np.asarray(dev.count(pats))
        locs, pids, valid, _, dropped = dev.locate_with_counts(
            pats, capacity=cap)
        assert int(np.asarray(dropped)[0]) == 0, "capacity overflow dropped hits"
        locs, pids, valid = map(np.asarray, (locs, pids, valid))
        with open(out_path, "w") as f:
            order = np.argsort(pids[valid], kind="stable")
            f.write("\n".join(map(str, locs[valid][order])))
        query_ns = time.perf_counter_ns() - q_start
        if args.algorithm == "device-warm":
            # resident-server mode: the index stays uploaded and serves
            # repeated batches; report the amortized per-batch latency
            # (query + result write) — the serving number the one-shot
            # cells cannot show (their total is ~99% load/compile)
            S = int(getattr(args, "serve_batches", 8) or 8)
            q_start = time.perf_counter_ns()
            for _ in range(S):
                locs, pids, valid, _, dropped = dev.locate_with_counts(
                    pats, capacity=cap)
                locs, pids, valid = map(np.asarray, (locs, pids, valid))
                with open(out_path, "w") as f:
                    order = np.argsort(pids[valid], kind="stable")
                    f.write("\n".join(map(str, locs[valid][order])))
            query_ns = (time.perf_counter_ns() - q_start) // S
            load_ns = 0  # amortized away in a resident server
    else:
        load_ns = time.perf_counter_ns() - load_start
        q_start = time.perf_counter_ns()
        with open(out_path, "w") as f:
            for p in pats:
                f.write(",".join(map(str, fm.locate(p.tobytes()))) + "\n")
        query_ns = time.perf_counter_ns() - q_start

    amortized = args.algorithm == "device-warm"
    if amortized:
        # amortized serving latency is the cell's headline (the one-shot
        # wall time is the plain "device" row's job)
        total_ns = query_ns
    else:
        total_ns = time.perf_counter_ns() - t_all
    rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    cell = {"total_ns": total_ns, "load_ns": load_ns,
            "query_ns": query_ns, "max_rss_kb": rss_kb,
            "phases": phases}
    if amortized:
        # device-warm total_ns is a PER-BATCH amortized latency, not a
        # cold-start wall time — mark it so downstream tooling comparing
        # total_ns across algorithm rows cannot conflate the two semantics
        cell["amortized"] = True
        cell["serve_batches"] = S
    print(json.dumps(cell))


# ---------------------------------------------------------------------------
# resident-server grid: ONE upload serves every cell (the serving shape —
# a resident server amortizes load by definition, so running the 9-cell
# reference grid in one process is the honest device-warm measurement and
# 9x cheaper than a fresh upload per cell)
# ---------------------------------------------------------------------------

def run_serve_grid(args) -> list:
    from sview_fmindex_tpu.utils.compile_cache import use_compile_cache

    sys.path.insert(0, REPO)
    from bench import device_info

    device_info()  # raises unless the backend is a GPU
    use_compile_cache()
    from sview_fmindex_tpu import BLOCK3_U64, FmIndex
    from sview_fmindex_tpu.ops.locate import expand_capacity

    text_size = int(float(args.text_size))
    blob = np.memmap(blob_path(text_size), dtype=np.uint8, mode="r")
    fm = FmIndex.load(blob, position="u32", block=BLOCK3_U64,
                      encoder_kind="table")
    t0 = time.time()
    dev = fm.to_device(dense_lut_entries=1 << 28, dense_host_entries=1 << 20,
                       sa_full="device", sa_fill_ratio=4,
                       derived_cache_dir=CACHE_DIR)
    log(f"[serve-grid] upload {time.time()-t0:.1f}s; serving cells")

    counts_list = [int(float(p))
                   for p in (args.patterns or "10,1000,100000").split(",")]
    colds = [float(c) for c in (args.colds or "0.01,0.1,1.0").split(",")]
    S = 8
    rows = []
    out_path = os.path.join(CACHE_DIR, "results_device-warm.txt")
    for count in counts_list:
        for cold in colds:
            pats = gen_patterns(text_size, count, cold, SEED + 1)
            counts_w = np.asarray(dev.count(pats))
            cap = expand_capacity(counts_w)
            # warm this exact shape, then serve S timed batches
            # (query + result write, amortized per batch)
            locs, pids, valid, _, dropped = dev.locate_with_counts(
                pats, capacity=cap)
            np.asarray(locs)
            t0 = time.perf_counter_ns()
            for _ in range(S):
                locs, pids, valid, _, dropped = dev.locate_with_counts(
                    pats, capacity=cap)
                locs, pids, valid = map(np.asarray, (locs, pids, valid))
                assert int(np.asarray(dropped)[0]) == 0
                with open(out_path, "w") as f:
                    order = np.argsort(pids[valid], kind="stable")
                    f.write("\n".join(map(str, locs[valid][order])))
            per_batch_ns = (time.perf_counter_ns() - t0) // S
            rows.append((count, cold, "device-warm", per_batch_ns, 0, 0))
            log(f"[serve-grid] {count:>7} cold={cold:<5} "
                f"{per_batch_ns/1e6:8.1f} ms/batch amortized "
                f"({count/(per_batch_ns/1e9)/1e6:.3f} Mq/s)")
    return rows


# ---------------------------------------------------------------------------
# sweep driver
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--text-size", default="1e9")
    ap.add_argument("--patterns", default=None,
                    help="comma list; default 10,1000,100000")
    ap.add_argument("--colds", default=None, help="comma list; default 0.01,0.1,1.0")
    ap.add_argument("--algorithms", default="memory,mmap,device")
    ap.add_argument("--out", default="RUNBENCH.csv")
    ap.add_argument("--no-drop-caches", action="store_true")
    ap.add_argument("--cell", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--cold", default="1.0", help=argparse.SUPPRESS)
    ap.add_argument("--algorithm", default="memory", help=argparse.SUPPRESS)
    ap.add_argument("--serve-grid", action="store_true",
                    help="resident-server mode: one upload serves the full "
                         "patterns x colds grid; rows are amortized "
                         "per-batch latencies (device-warm)")
    ap.add_argument("--merge-into", default=None,
                    help="merge produced rows into this existing CSV "
                         "(serve-grid: replacing device-warm rows; sweep: "
                         "replacing matching (count,cold,algo) rows) instead "
                         "of overwriting --out")
    ap.add_argument("--phases-out", default=None,
                    help="also write the per-cell JSON (incl. phase "
                         "breakdowns: blob read / view load / upload / warm) "
                         "to this path")
    args = ap.parse_args(argv)

    if args.cell:
        run_cell(args)
        return

    if args.serve_grid:
        rows = run_serve_grid(args)
        target = args.merge_into or args.out
        kept = []
        if args.merge_into and os.path.exists(target):
            with open(target) as f:
                header = f.readline()
                for line in f:
                    if line.split(",")[2] != "device-warm":
                        kept.append(line.rstrip("\n"))
        with open(target, "w") as f:
            f.write("pattern_count,cold_ratio,algorithm,total_ns,"
                    "load_percent,max_rss_kb\n")
            for line in kept:
                f.write(line + "\n")
            for r in rows:
                f.write(",".join(map(str, r)) + "\n")
        log(f"[serve-grid] wrote {len(rows)} device-warm rows to {target}")
        return

    text_size = int(float(args.text_size))
    patterns = [int(float(p)) for p in (args.patterns or "10,1000,100000").split(",")]
    colds = [float(c) for c in (args.colds or "0.01,0.1,1.0").split(",")]
    algorithms = args.algorithms.split(",")

    log(f"[sweep] ensuring text+blob for {text_size} bp")
    ensure_inputs(text_size)

    rows = []
    cells = []
    failed = []
    for count in patterns:
        for cold in colds:
            for algo in algorithms:
                dropped = False
                if algo == "mmap" and not args.no_drop_caches:
                    dropped = drop_caches()
                cmd = [sys.executable, os.path.abspath(__file__), "--cell",
                       "--text-size", str(text_size), "--patterns", str(count),
                       "--cold", str(cold), "--algorithm", algo]
                t0 = time.time()
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      cwd=REPO)
                if proc.returncode != 0:
                    log(f"[sweep] FAIL {count}/{cold}/{algo}: {proc.stderr[-500:]}")
                    failed.append((count, cold, algo))
                    continue
                cell = json.loads(proc.stdout.strip().splitlines()[-1])
                load_pct = 100 * cell["load_ns"] // max(cell["total_ns"], 1)
                rows.append((count, cold, algo, cell["total_ns"], load_pct,
                             cell["max_rss_kb"]))
                cells.append({"pattern_count": count, "cold_ratio": cold,
                              "algorithm": algo, **cell})
                ph = cell.get("phases") or {}
                ph_s = " ".join(f"{k[:-3]}={v/1e9:.2f}s"
                                for k, v in ph.items())
                log(f"[sweep] {count:>7} cold={cold:<5} {algo:<7} "
                    f"total={cell['total_ns']/1e9:8.2f}s load={load_pct:2d}% "
                    f"rss={cell['max_rss_kb']/1024:7.0f}MB "
                    f"(wall {time.time()-t0:.0f}s, dropped_caches={dropped}"
                    + (f"; {ph_s}" if ph_s else "") + ")")

    target = args.merge_into or args.out
    kept = []
    fresh = {(r[0], r[1], r[2]) for r in rows}
    if args.merge_into and os.path.exists(target):
        with open(target) as f:
            f.readline()
            for line in f:
                c, cr, algo = line.split(",")[:3]
                if (int(c), float(cr), algo) not in fresh:
                    kept.append(line.rstrip("\n"))
    with open(target, "w") as f:
        f.write("pattern_count,cold_ratio,algorithm,total_ns,load_percent,max_rss_kb\n")
        for line in kept:
            f.write(line + "\n")
        for r in rows:
            f.write(",".join(map(str, r)) + "\n")
    log(f"[sweep] wrote {target} ({len(rows)} fresh rows, {len(kept)} kept)")
    if args.phases_out:
        with open(args.phases_out, "w") as f:
            json.dump(cells, f, indent=1)
        log(f"[sweep] wrote per-cell phase breakdowns to {args.phases_out}")
    if failed:
        sys.exit(f"[sweep] {len(failed)} cell(s) failed: {failed}")


if __name__ == "__main__":
    main()
