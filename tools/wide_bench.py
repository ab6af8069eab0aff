"""Wide (u64-position) engine throughput on the GPU.

Measures the wide gather engine (``ops/wide.py``) at a serving batch size
on the 1 Gbp benchmark text with ``force_wide=True`` — the exact two-lane
code path that serves >= 2^32 bp texts, on an index that fits one card.

Prints one JSON line.
Run: ``python tools/wide_bench.py`` (uses the bench_cache blob).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TEXT_SIZE = int(float(os.environ.get("BENCH_TEXT_SIZE", "1e9")))
SEED = 42
PATTERN_LEN = 20
B = int(float(os.environ.get("WIDE_BENCH_BATCH", "100000")))


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    os.environ.setdefault("BENCH_TEXT_SIZE", str(TEXT_SIZE))
    import bench
    from sview_fmindex_tpu.utils.compile_cache import use_compile_cache

    device = bench.device_info()
    use_compile_cache()
    log(f"[wide-bench] devices: {jax.devices()}")

    text = bench.get_text()
    fm, _ = bench.get_blob(text)
    from sview_fmindex_tpu.models.device_index import DeviceFmIndex
    from sview_fmindex_tpu.ops.wide import combine64
    from sview_fmindex_tpu.ops.locate import expand_capacity
    from sview_fmindex_tpu.bench.timing import force

    t0 = time.time()
    dev = DeviceFmIndex.from_host(fm, force_wide=True)
    jax.block_until_ready(dev.sa)
    upload_s = round(time.time() - t0, 1)
    log(f"[wide-bench] wide upload: {upload_s}s")

    rng = np.random.default_rng(SEED + 1)
    text_arr = np.frombuffer(text, np.uint8)
    starts = rng.integers(0, TEXT_SIZE - PATTERN_LEN, size=B)
    pats_np = text_arr[starts[:, None] + np.arange(PATTERN_LEN)]
    patterns = jnp.asarray(pats_np)
    lens = np.full(B, PATTERN_LEN, np.int32)

    out = {"text_size": TEXT_SIZE, "batch": B, "upload_s": upload_s,
           "device": device, "engine": dev.engine_for(B)}

    # warm + capacity
    counts2 = np.asarray(dev.count(patterns, lens))
    counts = combine64(counts2[0], counts2[1])
    capacity = expand_capacity(counts)
    force(dev.locate(patterns, lens, capacity=capacity))

    REPS = max(8, min(32, int(4e6 // B)))

    def measure(run_one):
        best = 0.0
        for _ in range(3):
            t0 = time.time()
            force([run_one() for _ in range(REPS)])
            best = max(best, REPS * B / (time.time() - t0))
        return round(best, 1)

    out["count_qps"] = measure(lambda: dev.count(patterns, lens))
    out["locate_qps"] = measure(
        lambda: dev.locate(patterns, lens, capacity=capacity))
    log(f"[wide-bench] count {out['count_qps']/1e6:.3f} Mq/s, "
        f"locate {out['locate_qps']/1e6:.3f} Mq/s")

    # correctness: host oracle sample + raw-text recheck
    locs, pids, valid, dropped = dev.locate(patterns, lens, capacity=capacity)
    locs, pids, valid = map(np.asarray, (locs, pids, valid))
    assert int(np.asarray(dropped)[0]) == 0
    lv = combine64(locs[0], locs[1])
    ok = np.nonzero(valid)[0][:200]
    for i in ok:
        l, p = int(lv[i]), int(pids[i])
        assert bytes(text_arr[l:l + PATTERN_LEN]) == bytes(pats_np[p]), (l, p)
    for i in rng.integers(0, B, size=64):
        assert int(counts[i]) == fm.count(pats_np[i].tobytes()), i
    out["checked"] = "200 locations vs the text, 64 counts vs the host oracle"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
