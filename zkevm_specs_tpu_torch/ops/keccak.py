"""Keccak-256: the host hash, and the batched keccak-f[1600] sponge of the
keccak circuit.

Counterpart of ``zkevm_specs_tpu/ops/keccak.py``.  Three forms:

* ``keccak256`` (the native library, ``runtime/native.py``, where it
  loads, else pure Python from the Keccak specification): witness builders
  hash bytecode with it;
* ``keccak256_batch`` (the native library's batch, else numpy ``uint64``
  lanes): the same hash over many inputs at once, for witness builders
  that hash tens of thousands of preimages; host code, never on the device
  path;
* the lane form of the keccak circuit: 64-bit lanes as (lo, hi) 32-bit
  halves in int64 tensors, as the JAX package keeps them in u32 arrays
  (``keccak_round``, ``keccak_f_lanes``, ``keccak256_batch_fixed_blocks``),
  and the sponge over each row's own block count, kernel K7
  (``keccak_sponge``, ``csrc/keccak_sponge.cu``) with its plain version.

CPU torch has no shifts on uint32 or uint64, and ``>>`` on int64 is
arithmetic, so each 32-bit half lives in an int64 tensor with a value
below 2^32 and is masked after every ``<<``, ``~`` and rotate.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import limbs as L

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
RATE = 136          # bytes, for capacity 512
RATE_WORDS = RATE // 4
RATE_LANES = RATE // 8


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
    are memoised: a witness hashes the same bytecode several times; a miss
    is hashed by the native library where it loads (the JAX module's
    dispatch), else in Python."""
    return _keccak256(bytes(data))


def pad_blocks(preimages: Sequence[bytes]):
    """Every preimage padded by pad10*1 (domain byte 0x01, NOT sha3's 0x06)
    into 136-byte rate blocks, in one numpy pass: ``(raw [n, max_len]
    uint8, lengths [n] int64, padded [n, max_blocks * 136] uint8, n_blocks
    [n] int64)``; ``raw`` holds each preimage zero-filled to the longest
    (``max_len`` >= 1).  The one place that knows the padding rule."""
    n = len(preimages)
    lens = np.fromiter((len(d) for d in preimages), dtype=np.int64, count=n)
    max_len = max(int(lens.max()) if n else 0, 1)
    raw = np.zeros((n, max_len), dtype=np.uint8)
    flat = np.frombuffer(b"".join(bytes(d) for d in preimages), dtype=np.uint8)
    if flat.size:
        rows = np.repeat(np.arange(n), lens)
        starts = np.cumsum(lens) - lens
        raw[rows, np.arange(flat.size) - np.repeat(starts, lens)] = flat
    n_blocks = lens // RATE + 1            # the pad adds at least one byte
    max_blocks = int(n_blocks.max()) if n else 1
    padded = np.zeros((n, max_blocks * RATE), dtype=np.uint8)
    padded[:, :max_len] = raw
    padded[np.arange(n), lens] ^= 0x01
    padded[np.arange(n), n_blocks * RATE - 1] ^= 0x80   # one byte 0x81 when they meet
    return raw, lens, padded, n_blocks


@functools.lru_cache(maxsize=256)
def _keccak256(data: bytes) -> bytes:
    from ..runtime.native import keccak256_native

    native = keccak256_native(data)
    if native is not None:
        return native
    return _keccak256_py(data)


def _keccak256_py(data: bytes) -> bytes:
    lanes = pad_blocks([data])[2][0].view("<u8").reshape(-1, RATE_LANES)
    state = [0] * 25
    for block in lanes.tolist():
        for i in range(RATE_LANES):
            state[i] ^= block[i]
        state = keccak_f(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


EMPTY_HASH = int.from_bytes(keccak256(b""), "big")


# ---------------------------------------------------------------------------
# keccak256 over many inputs (host, numpy uint64 lanes)
# ---------------------------------------------------------------------------
#
# The lane order of the in-place rho+pi walk (st[PILN[i]] takes the previous
# lane rotated by ROTC[i], starting from lane 1), as K7 runs it.
_ROTC = (1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14, 27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44)
_PILN = (10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4, 15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1)


def _rotl_u64(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint64(n)) | (x >> np.uint64(64 - n))


def _keccak_f_u64(st: List[np.ndarray]) -> List[np.ndarray]:
    """keccak-f[1600] over 25 lanes, each a ``uint64`` array over the batch."""
    st = list(st)
    for rc in _RC:
        bc = [st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20] for i in range(5)]
        for i in range(5):
            t = bc[(i + 4) % 5] ^ _rotl_u64(bc[(i + 1) % 5], 1)
            for j in range(0, 25, 5):
                st[j + i] = st[j + i] ^ t
        t = st[1]
        for i in range(24):
            j = _PILN[i]
            st[j], t = _rotl_u64(t, _ROTC[i]), st[j]
        for j in range(0, 25, 5):
            b = st[j:j + 5]
            for i in range(5):
                st[j + i] = b[i] ^ (~b[(i + 1) % 5] & b[(i + 2) % 5])
        st[0] = st[0] ^ np.uint64(rc)
    return st


def keccak256_batch(preimages: Sequence[bytes]) -> List[bytes]:
    """``keccak256`` of every preimage, the permutation run over numpy
    ``uint64`` lanes of all rows at once (each row stops absorbing after its
    own block count); the native library's batch where it loads."""
    from ..runtime.native import keccak256_batch_native

    native = keccak256_batch_native([bytes(d) for d in preimages])
    if native is not None:
        return native
    return _keccak256_batch_py(preimages)


def _keccak256_batch_py(preimages: Sequence[bytes]) -> List[bytes]:
    n = len(preimages)
    if n == 0:
        return []
    _, _, padded, n_blocks = pad_blocks(preimages)
    lanes = padded.view("<u8").astype(np.uint64).reshape(n, -1, RATE_LANES)
    st = [np.zeros(n, dtype=np.uint64) for _ in range(25)]
    for blk in range(lanes.shape[1]):
        active = blk < n_blocks
        absorbed = [st[i] ^ lanes[:, blk, i] if i < RATE_LANES else st[i] for i in range(25)]
        permuted = _keccak_f_u64(absorbed)
        st = [np.where(active, p, s) for p, s in zip(permuted, st)]
    out = np.stack(st[:4], axis=-1).astype("<u8")
    return [row.tobytes() for row in out]


# ---------------------------------------------------------------------------
# The lane form: (lo, hi) 32-bit halves in int64 tensors (plain PyTorch)
# ---------------------------------------------------------------------------

MASK32 = 0xFFFF_FFFF

# rho+pi as one static lane permutation + per-lane rotation: lane s = x+5y
# rotates by _ROT[x][y] and lands at d = y + 5*((2x+3y) % 5)
_PI_SRC = np.zeros(25, dtype=np.int64)   # _PI_SRC[d] = s
_ROT_PER_DST = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _d = _y + 5 * ((2 * _x + 3 * _y) % 5)
        _PI_SRC[_d] = _x + 5 * _y
        _ROT_PER_DST[_d] = _ROT[_x][_y] % 64
_RC_LO = np.array([rc & MASK32 for rc in _RC], dtype=np.int64)
_RC_HI = np.array([rc >> 32 for rc in _RC], dtype=np.int64)

_CONSTS: Dict[tuple, torch.Tensor] = {}


def _const(name: str, arr: np.ndarray, device) -> torch.Tensor:
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t


def _rotl64_pairs(lo: torch.Tensor, hi: torch.Tensor, n, name: str):
    """Rotate-left 64-bit lanes stored as (lo, hi) 32-bit halves by per-lane
    static amounts ``n`` (an int array broadcastable to the lane axis); a
    rotation by 32 or more swaps the halves.  ``name`` keys the cached
    device copies of the shift amounts."""
    n = np.asarray(n) % 64
    swap = _const(name + "/swap", n >= 32, lo.device)
    m = _const(name + "/m", n % 32, lo.device)
    inv = _const(name + "/inv", (32 - n % 32) % 32, lo.device)
    # rotate each 32-bit pair by m (a shift by 32 is avoided by the m == 0 select)
    lo1 = torch.where(m == 0, lo, ((lo << m) & MASK32) | (hi >> inv))
    hi1 = torch.where(m == 0, hi, ((hi << m) & MASK32) | (lo >> inv))
    return torch.where(swap, hi1, lo1), torch.where(swap, lo1, hi1)


def keccak_round(lo: torch.Tensor, hi: torch.Tensor, rc_lo: int, rc_hi: int):
    """One keccak-f round over stacked ``[..., 25]`` lane halves
    (``zkevm_specs_tpu/ops/keccak.py:keccak_round``)."""
    shape = lo.shape[:-1]
    a_lo = lo.reshape(shape + (5, 5))   # [..., y, x]
    a_hi = hi.reshape(shape + (5, 5))
    # theta
    c_lo = a_lo[..., 0, :] ^ a_lo[..., 1, :] ^ a_lo[..., 2, :] ^ a_lo[..., 3, :] ^ a_lo[..., 4, :]
    c_hi = a_hi[..., 0, :] ^ a_hi[..., 1, :] ^ a_hi[..., 2, :] ^ a_hi[..., 3, :] ^ a_hi[..., 4, :]
    r_lo, r_hi = _rotl64_pairs(torch.roll(c_lo, -1, dims=-1), torch.roll(c_hi, -1, dims=-1),
                               np.ones(5, np.int64), "theta")
    d_lo = torch.roll(c_lo, 1, dims=-1) ^ r_lo
    d_hi = torch.roll(c_hi, 1, dims=-1) ^ r_hi
    lo = (a_lo ^ d_lo[..., None, :]).reshape(shape + (25,))
    hi = (a_hi ^ d_hi[..., None, :]).reshape(shape + (25,))
    # rho + pi (static gather + per-lane rotation)
    src = _const("pi_src", _PI_SRC, lo.device)
    b_lo, b_hi = _rotl64_pairs(lo[..., src], hi[..., src], _ROT_PER_DST, "rho")
    # chi: A[x][y] = B[x][y] ^ (~B[x+1][y] & B[x+2][y]) -- roll along x
    b_lo = b_lo.reshape(shape + (5, 5))
    b_hi = b_hi.reshape(shape + (5, 5))
    lo = b_lo ^ (~torch.roll(b_lo, -1, dims=-1) & torch.roll(b_lo, -2, dims=-1) & MASK32)
    hi = b_hi ^ (~torch.roll(b_hi, -1, dims=-1) & torch.roll(b_hi, -2, dims=-1) & MASK32)
    lo = lo.reshape(shape + (25,)).clone()
    hi = hi.reshape(shape + (25,)).clone()
    # iota
    lo[..., 0] ^= rc_lo
    hi[..., 0] ^= rc_hi
    return lo, hi


def keccak_f_lanes(lanes_lo: torch.Tensor, lanes_hi: torch.Tensor):
    """Batched keccak-f[1600] on ``[..., 25]`` int64 lane halves (each below
    2^32): the 24 rounds of ``keccak_round`` (the JAX package's
    ``keccak_f_lanes``, a ``lax.scan`` there, a loop here)."""
    lo, hi = lanes_lo, lanes_hi
    for r in range(24):
        lo, hi = keccak_round(lo, hi, int(_RC_LO[r]), int(_RC_HI[r]))
    return lo, hi


def _absorb(lo, hi, block):
    """XOR one ``[n, 34]`` block of 32-bit words into the first 17 lanes."""
    pad = (0, 25 - RATE_LANES)
    return (lo ^ torch.nn.functional.pad(block[:, 0::2], pad),
            hi ^ torch.nn.functional.pad(block[:, 1::2], pad))


def _digest_words(lo, hi):
    """The first four lanes as ``[n, 8]`` 32-bit words: lo0, hi0, lo1, ..."""
    return torch.stack([lo[:, :4], hi[:, :4]], dim=-1).reshape(lo.shape[0], 8)


def keccak256_batch_fixed_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Hash a batch of inputs that each fill every one of their ``n_blocks``
    rate blocks: ``blocks [B, n_blocks, 34]`` int64 32-bit words (the
    caller pads by pad10*1) -> ``[B, 8]`` digest words."""
    B = blocks.shape[0]
    lo = torch.zeros((B, 25), dtype=torch.int64, device=blocks.device)
    hi = torch.zeros_like(lo)
    for blk in range(blocks.shape[1]):
        lo, hi = keccak_f_lanes(*_absorb(lo, hi, blocks[:, blk, :]))
    return _digest_words(lo, hi)


# ---------------------------------------------------------------------------
# K7: the sponge over each row's own block count
# ---------------------------------------------------------------------------

def keccak_sponge_plain(blocks: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: every row absorbs blocks 0 .. n_blocks - 1 and
    keeps its state past them, as the JAX absorb loop masks it
    (``circuits/keccak.py:158-179``)."""
    n, max_blocks, _ = blocks.shape
    lo = torch.zeros((n, 25), dtype=torch.int64, device=blocks.device)
    hi = torch.zeros_like(lo)
    for blk in range(max_blocks):
        active = (blk < n_blocks)[:, None]
        p_lo, p_hi = keccak_f_lanes(*_absorb(lo, hi, blocks[:, blk, :]))
        lo = torch.where(active, p_lo, lo)
        hi = torch.where(active, p_hi, hi)
    return _digest_words(lo, hi)


def keccak_sponge(blocks: torch.Tensor, n_blocks: torch.Tensor) -> torch.Tensor:
    """K7 wrapper: the keccak-256 sponge of each row.

    ``blocks``: ``[n, max_blocks, 34]`` int64, the padded preimage as
    little-endian 32-bit words, contiguous; ``n_blocks``: ``[n]`` int32,
    the blocks each row absorbs (clamped to ``[0, max_blocks]``).  Returns
    the ``[n, 8]`` int64 digest words (lo, hi of lanes 0-3).  On the card
    a batch under ``csrc/keccak_sponge.cu``'s ``KECCAK_COOP_ROWS`` rows
    runs one warp a row (a row's lanes spread over the warp's threads),
    a larger one one thread a row; ``cuda_build.path_launches`` counts
    each path.

    Replaces ``zkevm_specs_tpu/ops/keccak.py:keccak_f_lanes`` (the
    ``lax.scan`` of ``keccak_round``) inside the absorb loop of
    ``circuits/keccak.py:check_keccak`` (:158-179)."""
    if blocks.dtype != torch.int64 or blocks.dim() != 3 or blocks.shape[2] != RATE_WORDS \
            or not blocks.is_contiguous():
        raise ValueError(f"keccak_sponge: blocks must be a contiguous [n, max_blocks, "
                         f"{RATE_WORDS}] int64 tensor, got {blocks.dtype} {tuple(blocks.shape)}")
    n = blocks.shape[0]
    if n_blocks.dtype != torch.int32 or n_blocks.shape != (n,) or not n_blocks.is_contiguous():
        raise ValueError(f"keccak_sponge: n_blocks must be a contiguous [{n}] int32 tensor")
    if L.on_cpu(blocks, n_blocks):
        return keccak_sponge_plain(blocks, n_blocks)
    from ..runtime import cuda_build

    out = torch.empty((n, 8), dtype=torch.int64, device=blocks.device)
    lib = cuda_build.library("keccak_sponge")
    err = lib.keccak_sponge_launch(blocks.data_ptr(), blocks.shape[1], n_blocks.data_ptr(),
                                   out.data_ptr(), n, L.cuda_stream())
    L.check_launch(err, "keccak_sponge")
    return out
