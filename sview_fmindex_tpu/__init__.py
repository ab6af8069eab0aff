"""sview-fmindex-tpu: a batched FM-index engine in JAX/XLA.

A from-scratch re-design of the capabilities of the Rust crate
``baku4/sview-fmindex`` (mounted read-only at /root/reference): BWT + bit-
sliced rank blocks + k-mer lookup table + sampled suffix array, built into one
contiguous, byte-compatible blob, queried via ``count``/``locate``.

The execution model is accelerator-first: queries run as batched lockstep
backward search over device-resident packed arrays (``sview_fmindex_tpu.ops``),
scaled over device meshes with pattern data-parallelism
(``sview_fmindex_tpu.parallel``).  The host classes in ``models`` implement
the exact reference semantics and serve as the differential oracle.
"""

from .config import (
    ALL_BLOCK_KINDS,
    BLOCK2_U32,
    BLOCK2_U64,
    BLOCK2_U128,
    BLOCK3_U32,
    BLOCK3_U64,
    BLOCK3_U128,
    BLOCK4_U32,
    BLOCK4_U64,
    BLOCK5_U64,
    BLOCK6_U64,
    BlockKind,
    BuildError,
    LoadError,
    LookupTableConfig,
    SuffixArrayConfig,
)
from .encoders import EncodingTable, PassThrough
from .models.builder import FmIndexBuilder
from .models.index import FmIndex

__version__ = "0.1.0"

__all__ = [
    "FmIndexBuilder",
    "FmIndex",
    "EncodingTable",
    "PassThrough",
    "BlockKind",
    "BuildError",
    "LoadError",
    "LookupTableConfig",
    "SuffixArrayConfig",
    "ALL_BLOCK_KINDS",
    "BLOCK2_U32",
    "BLOCK2_U64",
    "BLOCK2_U128",
    "BLOCK3_U32",
    "BLOCK3_U64",
    "BLOCK3_U128",
    "BLOCK4_U32",
    "BLOCK4_U64",
    "BLOCK5_U64",
    "BLOCK6_U64",
]
