"""Keccak-256 (the Ethereum variant: pad byte 0x01) on Python ints, from
the Keccak reference (FIPS 202's permutation, the original padding)."""

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation of lane x + 5 y
_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56,
        14]
_M = (1 << 64) - 1
RATE = 136


def _rol(v: int, r: int) -> int:
    return ((v << r) | (v >> (64 - r))) & _M if r else v


def _permute(a):
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROT[x + 5 * y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
             for i in range(25)]
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    msg = bytearray(data)
    msg.append(0x01)
    while len(msg) % RATE:
        msg.append(0)
    msg[-1] |= 0x80
    a = [0] * 25
    for off in range(0, len(msg), RATE):
        block = msg[off:off + RATE]
        for i in range(RATE // 8):
            a[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        a = _permute(a)
    return b"".join(a[i].to_bytes(8, "little") for i in range(4))


def keccak_int(data: bytes) -> int:
    return int.from_bytes(keccak256(data), "big")
