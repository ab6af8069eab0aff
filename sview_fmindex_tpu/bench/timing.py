"""Shared device-timing helpers for every bench surface."""
from __future__ import annotations

import time


def force(x) -> None:
    """Wait until every device array in the pytree ``x`` is computed."""
    import jax

    jax.block_until_ready(x)


def timeit(fn, *args, reps: int = 8):
    """(warmup_s, steady_s): compile+first-run cost, then pipelined steady
    state — all reps enqueued back-to-back, every result waited for at the
    end (waiting per rep would serialize the pipeline)."""
    t0 = time.perf_counter()
    force(fn(*args))
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(reps)]
    force(outs)
    return warm, (time.perf_counter() - t0) / reps
