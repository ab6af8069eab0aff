"""Scale acceptance for the wide (u64) device path: a real >2^32 bp index
served range-sharded on a virtual 8-device mesh, bit-exact vs the host
oracle.

Prereq: a u64 blob built by the library (e.g. 4.5 Gbp, native SA-IS int64
backend).  Run:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/wide_scale_check.py \
        --text bench_cache/text_4500000000_7.bin \
        --blob bench_cache/index_4500000000_7_u64_b3u64_r2_k3.blob \
        --out wide_scale.json

Writes a JSON artifact recording the config, the per-pattern agreement,
and at least one location above 2^32 (proving the high lane is live).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--text", required=True)
    ap.add_argument("--blob", required=True)
    ap.add_argument("--patterns", type=int, default=256)
    ap.add_argument("--plen", type=int, default=20)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--out", default="wide_scale.json")
    args = ap.parse_args()

    import jax

    import sview_fmindex_tpu as fmx
    from sview_fmindex_tpu.parallel.range_shard import RangeShardedFmIndex
    from sview_fmindex_tpu.parallel.mesh import make_mesh

    t0 = time.time()
    text = np.memmap(args.text, dtype=np.uint8, mode="r")
    n = text.shape[0]
    assert n >= 2**32, f"text must exceed 2^32 bp (got {n})"
    blob = np.memmap(args.blob, dtype=np.uint8, mode="r")
    fm = fmx.FmIndex.load(blob, position="u64", block=fmx.BLOCK3_U64,
                          encoder_kind="table")
    assert fm.text_len == n
    load_s = time.time() - t0
    print(f"[wide] blob mapped in {load_s:.1f}s; n={n}", flush=True)

    import resource

    devices = jax.devices()
    rss_before_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.time()
    rs = RangeShardedFmIndex(fm, mesh=make_mesh(axis="rs"),
                             dense_entries=0)
    assert rs.meta.wide_pos
    shard_s = time.time() - t0
    rss_after_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(f"[wide] sharded over {len(devices)} devices in {shard_s:.1f}s "
          f"(peak RSS {rss_before_kb/2**20:.1f} -> {rss_after_kb/2**20:.1f}"
          " GiB; staging builds each shard's slice on demand with no "
          "full-table intermediate — on this VIRTUAL mesh the device "
          "buffers themselves live in host RAM and mmap page cache "
          "counts toward RSS, so the figure bounds the shard buffers + "
          "paged-in blob, not a host-side copy)",
          flush=True)

    rng = np.random.default_rng(args.seed)
    B, L = args.patterns, args.plen
    # bias half the starts above 2^32 so located positions exercise the
    # high lane
    starts = np.concatenate([
        rng.integers(0, n - L, size=B // 2),
        rng.integers(2**32, n - L, size=B - B // 2),
    ])
    pats = np.asarray(text)[starts[:, None] + np.arange(L)]
    lens = np.full(B, L, np.int32)

    t0 = time.time()
    counts = rs.count(pats, lens)
    locs, pids, valid, dropped = rs.locate(pats, lens)
    query_s = time.time() - t0
    assert int(np.asarray(dropped).sum()) == 0

    by = {}
    for l, p, v in zip(locs, pids, valid):
        if v:
            by.setdefault(int(p), []).append(int(l))
    t0 = time.time()
    mismatches = 0
    checked_locs = 0
    for i in range(B):
        want_c = fm.count(pats[i].tobytes())
        want_l = sorted(fm.locate(pats[i].tobytes()))
        got_l = sorted(by.get(i, []))
        checked_locs += len(want_l)
        if int(counts[i]) != want_c or got_l != want_l:
            mismatches += 1
            print(f"MISMATCH pattern {i}: count {counts[i]} vs {want_c}; "
                  f"{got_l[:4]} vs {want_l[:4]}")
    oracle_s = time.time() - t0
    hi_hits = int((locs[valid] >= 2**32).sum())
    print(f"[wide] {B} patterns, {checked_locs} locations, "
          f"{hi_hits} above 2^32, {mismatches} mismatches", flush=True)

    out = {
        "text_len": int(n),
        "position": "u64",
        "devices": len(devices),
        "backend": jax.default_backend(),
        "patterns": B,
        "pattern_len": L,
        "locations_checked": checked_locs,
        "locations_above_2_32": hi_hits,
        "mismatches": mismatches,
        "ok": mismatches == 0 and hi_hits > 0,
        "shard_s": round(shard_s, 1),
        "shard_rss_before_kb": rss_before_kb,
        "shard_rss_after_kb": rss_after_kb,
        "query_s": round(query_s, 1),
        "oracle_s": round(oracle_s, 1),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    assert out["ok"], "wide scale check FAILED"


if __name__ == "__main__":
    main()
