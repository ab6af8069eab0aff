"""2-process multi-host dryrun on virtual CPU devices.

Proves the process-spanning code path (SURVEY.md §5 distributed-backend
row): 2 processes x 4 virtual CPU devices = one 8-device global mesh;
`jax.distributed.initialize` wires them, the index replicates onto every
device, pattern batches shard over the global ``dp`` axis, and each
process's merged locate output must equal the single-process host oracle.

Also times the one hot-path collective (the result all-gather at the
out_specs boundary) across the real process boundary, at the payload
sizes of a 1M-pattern count and locate batch.

Run: ``python tools/multihost_dryrun.py`` (the parent spawns the 2
children and prints one JSON line; exit code 1 if any child failed).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_PROCS = 2
DEVS_PER_PROC = 4
PORT = 12355


def child(proc_id: int) -> None:
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from sview_fmindex_tpu.parallel import distributed as dist

    dist.initialize(coordinator=f"127.0.0.1:{PORT}",
                    num_processes=NUM_PROCS, process_id=proc_id)
    assert jax.process_count() == NUM_PROCS
    assert len(jax.devices()) == NUM_PROCS * DEVS_PER_PROC

    from sview_fmindex_tpu import (
        BlockKind,
        EncodingTable,
        FmIndex,
        FmIndexBuilder,
        LookupTableConfig,
        SuffixArrayConfig,
    )
    from sview_fmindex_tpu.ops.locate import expand_capacity
    from sview_fmindex_tpu.parallel.query import (
        _count_sharded,
        _ranges_sharded,
        _walk_sharded,
    )
    from sview_fmindex_tpu.ops.search import max_steps_needed

    # identical deterministic build on every process
    rng = np.random.default_rng(42)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=20_000).tobytes()
    enc = EncodingTable.from_symbols([b"Aa", b"Cc", b"Gg", b"Tt"])
    builder = FmIndexBuilder(
        len(text), enc.symbol_count(), enc, block=BlockKind(3, 64),
        suffix_array_config=SuffixArrayConfig.compressed(2),
        lookup_table_config=LookupTableConfig.kmer_size(3),
        sa_backend="numpy",
    )
    fm = FmIndex.load(builder.build(text), block=BlockKind(3, 64),
                      encoder_kind="table")
    dev_local = fm.to_device()
    host_tree = jax.tree.map(np.asarray, dev_local)

    mesh = dist.global_mesh("dp")
    idx_g = dist.replicate(mesh, host_tree)

    B = 64
    tarr = np.frombuffer(text, np.uint8)
    starts = np.random.default_rng(7).integers(0, len(text) - 12, size=B)
    patterns = tarr[starts[:, None] + np.arange(12)]
    lens = np.full(B, 12, np.int32)
    pats_g = dist.shard_batch(mesh, patterns)
    lens_g = dist.shard_batch(mesh, lens)

    steps = max_steps_needed(dev_local.meta, lens, patterns.shape[1])
    facts = (bool(dev_local.meta.dense_k), 12)

    counts_g = _count_sharded(idx_g, pats_g, lens_g, mesh, "dp", steps, facts)
    counts = dist.allgather(counts_g)

    lo_g, hi_g = _ranges_sharded(idx_g, pats_g, lens_g, mesh, "dp", steps, facts)
    per_shard = B // (NUM_PROCS * DEVS_PER_PROC)
    cap = expand_capacity(counts, base=per_shard)
    locs_g, pids_g, valid_g, dropped_g = _walk_sharded(
        idx_g, lo_g, hi_g, mesh, "dp", cap)
    locs, pids, valid = map(dist.allgather, (locs_g, pids_g, valid_g))
    assert int(np.asarray(dist.allgather(dropped_g)).sum()) == 0

    # every process verifies the merged result against the host oracle
    got = {}
    for l, p, v in zip(locs, pids, valid):
        if v:
            got.setdefault(int(p), []).append(int(l))
    n_checked = 0
    for i in range(B):
        want = sorted(fm.locate(patterns[i].tobytes()))
        assert counts[i] == len(want), (i, counts[i], want)
        assert sorted(got.get(i, [])) == want, (i, got.get(i), want)
        n_checked += 1
    # ---- measured inter-process collective ----
    # The hot path's ONLY collective is the result all-gather at the
    # out_specs boundary.  Time it with the collective actually CROSSING
    # the process boundary (gRPC over localhost here — a real
    # serialize+transport+merge path; the output records the transport so
    # the number cannot be read as a network or NVLink measurement).
    from jax.sharding import NamedSharding, PartitionSpec as P

    to_repl = jax.jit(lambda x: x,
                      out_shardings=NamedSharding(mesh, P()))
    coll = {}
    for label, arr in (
            ("count_1m", np.zeros(1_000_000, np.uint32)),      # 4 B/pattern
            ("locate_1m", np.zeros((1_009_996 // 8 * 8, 3), np.uint32))):
        g = dist.shard_batch(mesh, arr)
        to_repl(g).block_until_ready()  # compile + first transport
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            to_repl(g).block_until_ready()
        dt = (time.perf_counter() - t0) / reps
        nbytes = arr.nbytes
        # each process must RECEIVE the other process's half
        cross_bytes = nbytes // NUM_PROCS
        coll[label] = {
            "payload_bytes": nbytes,
            "cross_process_bytes": cross_bytes,
            "mean_s": round(dt, 5),
            "effective_cross_GBps": round(cross_bytes / dt / 1e9, 3),
        }

    print(json.dumps({"proc": proc_id, "ok": True,
                      "devices": len(jax.devices()),
                      "processes": jax.process_count(),
                      "patterns_checked": n_checked,
                      "collective": coll,
                      "transport": "grpc-localhost (CPU backend)"}))


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(int(sys.argv[2]))
        return
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        f" --xla_force_host_platform_device_count={DEVS_PER_PROC}").strip()
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO) for i in range(NUM_PROCS)]
    results, ok = [], True
    for i, p in enumerate(procs):
        out, err = p.communicate(timeout=600)
        if p.returncode != 0:
            ok = False
            print(f"[proc {i}] FAILED:\n{err[-2000:]}", file=sys.stderr)
        else:
            results.append(json.loads(out.strip().splitlines()[-1]))
    artifact = {"ok": ok and len(results) == NUM_PROCS,
                "elapsed_s": round(time.time() - t0, 1),
                "procs": results}
    print(json.dumps(artifact))
    sys.exit(0 if artifact["ok"] else 1)


if __name__ == "__main__":
    main()
