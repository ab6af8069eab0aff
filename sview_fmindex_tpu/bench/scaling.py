"""Scaling-efficiency report: pattern-DP throughput over 1..N mesh devices.

BASELINE.json config 5: the index replicated across a device mesh, a pattern
batch sharded data-parallel (``parallel/query.py``), count/locate results
merged via the all-gather at the ``out_specs`` boundary; reports throughput
per mesh size and efficiency vs linear scaling from 1 device.

On several cards this measures pattern-DP scaling; on a virtual CPU mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``) it validates the
sharded program end-to-end and reports the (synthetic) numbers with a
``virtual: true`` marker.

Usage:  python -m sview_fmindex_tpu.bench scaling [-t TEXT_LEN] [-n PATTERNS]
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


def run_scaling(text_len: int, pattern_count: int, pattern_len: int = 20,
                seed: int = 42, mesh_sizes=None) -> dict:
    import jax

    from .. import (
        BLOCK3_U64,
        EncodingTable,
        FmIndex,
        FmIndexBuilder,
        LookupTableConfig,
        SuffixArrayConfig,
    )
    from ..parallel.mesh import make_mesh
    from ..parallel.query import ShardedFmIndex

    devices = jax.devices()
    n_dev = len(devices)
    if mesh_sizes is None:
        mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]

    rng = np.random.default_rng(seed)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=text_len)]
    enc = EncodingTable.from_symbols([b"A", b"C", b"G", b"T"])
    builder = FmIndexBuilder(
        text_len, enc.symbol_count(), enc, position="u32", block=BLOCK3_U64,
        suffix_array_config=SuffixArrayConfig.compressed(2),
        lookup_table_config=LookupTableConfig.kmer_size(3),
    )
    fm = FmIndex.load(builder.build(text.tobytes()), position="u32",
                      block=BLOCK3_U64, encoder_kind="table")
    dev = fm.to_device()

    starts = rng.integers(0, text_len - pattern_len, size=pattern_count)
    patterns = np.stack([text[s:s + pattern_len] for s in starts])
    lens = np.full(pattern_count, pattern_len, np.int32)

    rows = []
    base_qps = None
    for n in mesh_sizes:
        mesh = make_mesh(n_devices=n)
        sharded = ShardedFmIndex(dev, mesh=mesh)
        counts = np.asarray(sharded.count(patterns, lens))
        assert (counts >= 1).all()
        reps = 3
        t0 = time.time()
        for _ in range(reps):
            c = sharded.count(patterns, lens)
            float(np.asarray(c).sum())  # force materialization
        qps = reps * pattern_count / (time.time() - t0)
        if base_qps is None:
            base_qps = qps
        eff = qps / (base_qps * n)
        rows.append({"devices": n, "count_qps": round(qps, 1),
                     "speedup": round(qps / base_qps, 2),
                     "efficiency": round(eff, 3)})
        print(f"[scaling] {n} dev: {qps/1e6:.3f} Mq/s, "
              f"speedup {qps/base_qps:.2f}x, efficiency {eff:.1%}",
              file=sys.stderr, flush=True)

    platform = devices[0].platform
    return {
        "metric": "pattern_dp_count_scaling",
        "text_len": text_len,
        "pattern_count": pattern_count,
        "platform": platform,
        "virtual": platform == "cpu",
        "rows": rows,
    }


def main(args) -> None:
    report = run_scaling(args.text_length, args.pattern_count)
    print(json.dumps(report))
