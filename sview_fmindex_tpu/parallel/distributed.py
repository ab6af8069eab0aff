"""Multi-host orchestration: process-spanning meshes over jax.distributed.

The reference is single-process (SURVEY.md §2 parallelism inventory); this
is the multi-host scale-out path demanded by the BASELINE north star
(>= 80% scaling efficiency to 2 hosts): each host runs the SAME program,
`jax.distributed.initialize` wires the processes into one runtime, the
index is replicated per host, and pattern batches shard over the global
``dp`` axis.  Result merge is the all-gather at the shard_map out_specs
boundary plus `process_allgather` for host-side consumption.

Entry points:
- :func:`initialize` — `jax.distributed.initialize` from args or the
  ``SVIEW_COORD`` / ``SVIEW_NUM_PROCS`` / ``SVIEW_PROC_ID`` env triplet.
- :func:`global_mesh` — 1-D mesh over ALL global devices (every process
  must call with the same axis name).
- :func:`shard_batch` — host-local full batch -> globally sharded device
  array (every process passes the SAME full batch; each materializes only
  its addressable shards).
- :func:`allgather` — fetch a fully-sharded result to every host.

Tested by ``tools/multihost_dryrun.py`` (2 processes x 4 virtual CPU
devices) — the committed MULTIHOST artifact.
"""
from __future__ import annotations

import os

import numpy as np


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Wire this process into the multi-host runtime.

    Pass the three arguments or set SVIEW_COORD / SVIEW_NUM_PROCS /
    SVIEW_PROC_ID; where a cluster environment describes the processes,
    JAX can infer them and they may be omitted.
    """
    import jax

    coordinator = coordinator or os.environ.get("SVIEW_COORD")
    if num_processes is None and "SVIEW_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["SVIEW_NUM_PROCS"])
    if process_id is None and "SVIEW_PROC_ID" in os.environ:
        process_id = int(os.environ["SVIEW_PROC_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "dp"):
    """1-D mesh over every device in the multi-host runtime."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def shard_batch(mesh, arr: np.ndarray, axis: str = "dp"):
    """Full host batch -> global device array sharded along dim 0.

    Every process passes the SAME full array (cheap for pattern batches);
    only the addressable shards are materialized locally.  The batch dim
    must divide the mesh size (pad first — ShardedFmIndex._pad does).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(axis, *([None] * (arr.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: np.ascontiguousarray(arr[idx]))


def replicate(mesh, tree):
    """Replicate a pytree (the device index) onto every device of the mesh."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda x: jax.make_array_from_callback(
            np.shape(x), sharding, lambda idx, x=x: np.asarray(x)[idx]),
        tree)


def allgather(x) -> np.ndarray:
    """Fetch a (possibly non-addressable) global array to every host."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
