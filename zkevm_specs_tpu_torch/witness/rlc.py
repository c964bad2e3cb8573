"""Host-side random-linear-combination helpers (witness generation).

Mirrors reference RLC / linear_combine_bytes
(src/zkevm_specs/util/arithmetic.py:9-96) using Python ints mod Fr.
"""
from __future__ import annotations

from typing import Sequence, Union

from ..ops.fr import P


def linear_combine_bytes(seq: Sequence[int], base: int, range_check: bool = True) -> int:
    result = 0
    for limb in reversed(list(seq)):
        if range_check:
            assert 0 <= int(limb) < 256, "Each byte should fit in 8-bit"
        result = (result * base + int(limb)) % P
    return result


class RLC:
    """Binds int value <-> little-endian bytes <-> rlc commitment."""

    def __init__(self, value: Union[int, bytes], randomness: int = 0, n_bytes: int = 32):
        if isinstance(value, int):
            value = value.to_bytes(n_bytes, "little")
        if len(value) > n_bytes:
            raise ValueError(f"RLC expects to have {n_bytes} bytes, but got {len(value)} bytes")
        value = value.ljust(n_bytes, b"\x00")
        self.int_value = int.from_bytes(value, "little")
        self.rlc_value = linear_combine_bytes(value, randomness)
        self.le_bytes = value

    def expr(self) -> int:
        return self.rlc_value
