"""Static configuration for the FM-index.

The reference crate (`/root/reference/sview-fmindex`) encodes its configuration
as Rust type parameters ``<P: Position, B: Block, E: TextEncoder>``
(``src/builder/mod.rs:18-33``) plus two runtime builder configs
(``src/builder/build_config/*``).  Here the same axes become plain dataclasses:

- ``Position``       -> ``position``: 'u32' | 'u64'    (``src/text_length.rs:10-129``)
- ``Block2..Block6<V>`` -> :class:`BlockKind` (num_planes x vector bits)
  (``src/components/bwm/blocks/*``)
- ``SuffixArrayConfig`` / ``LookupTableConfig``
  (``src/builder/build_config/suffix_array_config.rs``, ``lookup_table_config.rs``)
"""
from __future__ import annotations

import dataclasses

import numpy as np


class BuildError(ValueError):
    """Mirror of the reference's ``BuildError`` (``src/builder/mod.rs:36-57``)."""


class LoadError(ValueError):
    """Mirror of the reference's ``LoadError`` (``src/load_from_blob.rs:15-24``)."""


_POSITION_DTYPES = {"u32": np.dtype("<u4"), "u64": np.dtype("<u8")}

# MAX_SYMBOL per plane count, from the reference block impls
# (block2.rs:15 =4, block3.rs:15 =8, block4.rs:15 =16, block5.rs:15 =32,
#  block6.rs:15 =64).
_MAX_SYMBOL_BY_PLANES = {2: 4, 3: 8, 4: 16, 5: 32, 6: 64}

# Vector alignment, from ``src/components/bwm/blocks/vector.rs:35-79``:
# u32 -> 8 ("support u64"), u64 -> 8, u128 -> 16.
_ALIGN_BY_BITS = {32: 8, 64: 8, 128: 16}


def position_dtype(position: str) -> np.dtype:
    try:
        return _POSITION_DTYPES[position]
    except KeyError:
        raise BuildError(f"position must be 'u32' or 'u64', got {position!r}")


@dataclasses.dataclass(frozen=True)
class BlockKind:
    """Analog of the reference's ``Block{2..6}<u32|u64|u128>`` type parameter.

    ``num_planes`` is the number of bit-planes per block (the N in BlockN);
    ``vector_bits`` is the bit width of one plane vector (BLOCK_LEN).
    """

    num_planes: int
    vector_bits: int

    def __post_init__(self):
        if self.num_planes not in _MAX_SYMBOL_BY_PLANES:
            raise BuildError(f"num_planes must be in 2..6, got {self.num_planes}")
        if self.vector_bits not in _ALIGN_BY_BITS:
            raise BuildError(f"vector_bits must be 32, 64 or 128, got {self.vector_bits}")

    @property
    def block_len(self) -> int:
        """Symbols per block == vector bit width (``vector.rs`` BLOCK_LEN)."""
        return self.vector_bits

    @property
    def max_symbol(self) -> int:
        return _MAX_SYMBOL_BY_PLANES[self.num_planes]

    @property
    def align_size(self) -> int:
        """Blob section alignment (``Aligned::ALIGN_SIZE``)."""
        return _ALIGN_BY_BITS[self.vector_bits]

    @property
    def num_lanes(self) -> int:
        """uint32 lanes per plane vector (device representation)."""
        return self.vector_bits // 32

    @property
    def block_bytes(self) -> int:
        return self.num_planes * self.vector_bits // 8

    def short_name(self) -> str:
        return f"Block{self.num_planes}u{self.vector_bits}"


# Common instantiations, mirroring the reference's exported type aliases.
BLOCK2_U32 = BlockKind(2, 32)
BLOCK2_U64 = BlockKind(2, 64)
BLOCK2_U128 = BlockKind(2, 128)
BLOCK3_U32 = BlockKind(3, 32)
BLOCK3_U64 = BlockKind(3, 64)
BLOCK3_U128 = BlockKind(3, 128)
BLOCK4_U32 = BlockKind(4, 32)
BLOCK4_U64 = BlockKind(4, 64)
BLOCK5_U64 = BlockKind(5, 64)
BLOCK6_U64 = BlockKind(6, 64)

ALL_BLOCK_KINDS = tuple(
    BlockKind(p, b) for p in (2, 3, 4, 5, 6) for b in (32, 64, 128)
)


@dataclasses.dataclass(frozen=True)
class SuffixArrayConfig:
    """``SuffixArrayConfig`` (``build_config/suffix_array_config.rs:4-41``).

    ``Uncompressed`` -> sampling ratio 1, ``Compressed(r)`` requires r >= 2.
    """

    _ratio: int = 1

    @classmethod
    def uncompressed(cls) -> "SuffixArrayConfig":
        return cls(1)

    @classmethod
    def compressed(cls, ratio: int) -> "SuffixArrayConfig":
        if ratio < 2:
            raise BuildError(
                "Sampling ratio for compressed suffix array must be at least 2"
            )
        return cls(int(ratio))

    def sampling_ratio(self) -> int:
        return self._ratio


@dataclasses.dataclass(frozen=True)
class LookupTableConfig:
    """``LookupTableConfig`` (``build_config/lookup_table_config.rs:5-52``).

    ``none()`` -> k=1; ``kmer_size(k)`` requires k >= 2; ``max_memory(bytes)``
    picks the largest k with ``(sigma+1)^k * sizeof(P) <= bytes`` (floor 1).
    """

    _mode: str = "none"
    _value: int = 0

    @classmethod
    def none(cls) -> "LookupTableConfig":
        return cls("none", 0)

    @classmethod
    def kmer_size(cls, k: int) -> "LookupTableConfig":
        if k < 2:
            raise BuildError("K-mer size must be at least 2")
        return cls("kmer", int(k))

    @classmethod
    def max_memory(cls, max_bytes: int) -> "LookupTableConfig":
        return cls("maxmem", int(max_bytes))

    def resolved_kmer_size(self, symbol_count: int, position: str) -> int:
        if self._mode == "none":
            return 1
        if self._mode == "kmer":
            return self._value
        # max_memory: largest k>=2 such that (sigma+1)^k * psize <= max, else 1
        # (lookup_table_config.rs:39-52)
        base = symbol_count + 1
        psize = position_dtype(position).itemsize
        k = 2
        while (base ** k) * psize <= self._value:
            k += 1
        return k - 1
