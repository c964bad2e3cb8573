"""Keccak-256 on the host (pure Python, from the Keccak specification).

Witness builders hash bytecode with it.  Only the host hash is ported so
far; the batched keccak-f lane kernel of the JAX package is not on this
package's path yet.
"""
from __future__ import annotations

import functools
from typing import List

# rotation offsets r[x][y] and round constants per Keccak spec
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_MASK64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def keccak_f(state: List[int]) -> List[int]:
    """One Keccak-f[1600] permutation over 25 u64 lanes (host ints)."""
    a = [[state[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _RC:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= rc
    return [a[x][y] for y in range(5) for x in range(5)]


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (the Ethereum hash; pad 0x01, NOT sha3's 0x06).  Digests
    are memoised: a witness hashes the same bytecode several times."""
    return _keccak256(bytes(data))


@functools.lru_cache(maxsize=256)
def _keccak256(data: bytes) -> bytes:
    rate = 136  # bytes, for capacity 512
    # pad10*1 with domain byte 0x01
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    state = [0] * 25
    for block_start in range(0, len(padded), rate):
        block = padded[block_start:block_start + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = keccak_f(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


EMPTY_HASH = int.from_bytes(keccak256(b""), "big")
