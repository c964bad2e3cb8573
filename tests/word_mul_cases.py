"""Seeded operand rows of kernel K11 (``ops/word_mul.py``), shared by the
CPU tests (against the JAX chain) and the card tests (against the plain
version).  A case is ``(rows, bits, wide)``: the ten (or eight) limb rows
a.lo, a.hi, b.lo, b.hi, c.lo, c.hi, d.lo, d.hi[, e.lo, e.hi] as int64
``[B|1, w]`` tensors on the CPU, with the static bound of each row."""
import numpy as np
import torch

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
U128 = (1 << 128) - 1
U256 = (1 << 256) - 1
WIDTHS = (1, 2, 4, 8, 16)

CASES = ("random_valid", "random_fields", "all_ones", "c_lo_max", "wrapping_subtract",
         "carry_past_72_bits", "constants", "widths", "one_lane")


def _row(vals, bits):
    """Canonical limbs of ``vals`` at the narrowest width that holds ``bits``."""
    w = next(w for w in WIDTHS if 16 * w >= min(bits, 256))
    buf = b"".join(int(v).to_bytes(2 * w, "little") for v in vals)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(vals), w).astype(np.int64)
    return torch.from_numpy(arr), bits


def _word(vals):
    return [_row([v & U128 for v in vals], 128), _row([v >> 128 for v in vals], 128)]


def _valid(a, b, c, wide):
    """d (and e) that make a*b + c == d (mod 2^256), or == d*2^256 + e."""
    full = [x * y + z for x, y, z in zip(a, b, c)]
    if wide:
        return [f >> 256 for f in full], [f & U256 for f in full]
    return [f & U256 for f in full], None


def words_case(a, b, c, d=None, e=None, wide=False):
    vd, ve = _valid(a, b, c, wide)
    d = vd if d is None else d
    e = ve if (e is None and wide) else e
    words = [a, b, c, d] + ([e] if wide else [])
    pairs = [p for w in words for p in _word(w)]
    return [r for r, _ in pairs], [b for _, b in pairs], wide


def make_case(name, wide, n=64, seed=0):
    rng = np.random.RandomState(seed)

    def rand_words(k):
        return [int.from_bytes(rng.bytes(32), "little") for _ in range(k)]

    if name == "random_valid":
        a, b, c = rand_words(n), rand_words(n), rand_words(n)
        rows = words_case(a, b, c, wide=wide)
        # one lane in four gets a wrong d (or e), off by one
        rows[0][6 if not wide else 8][::4, 0] ^= 1
        return rows
    if name == "random_fields":
        # every row an arbitrary canonical field value of its full width
        vals = [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
                for _ in range(10 if wide else 8)]
        pairs = [_row(v, 254) for v in vals]
        return [r for r, _ in pairs], [b for _, b in pairs], wide
    if name == "all_ones":
        m = [U256] * 4
        return words_case(m, m, [U256, 0, U256, 1], wide=wide)
    if name == "c_lo_max":
        a, b = rand_words(4), rand_words(4)
        return words_case(a, b, [U128] * 4, wide=wide)
    if name == "wrapping_subtract":
        # d_lo (or e_lo) above t0 + t1 * 2^64 + c_lo: the difference wraps
        # mod p and its carry is a 254-bit field value
        a, b, c = [1, 2, 3, 1 << 64], [1, 3, 5, 1], [0, 0, 7, 0]
        lo = [5, U128, 1 << 100, (1 << 64) + 1]
        if wide:
            return words_case(a, b, c, d=[0] * 4, e=lo, wide=True)
        return words_case(a, b, c, d=lo, wide=False)
    if name == "carry_past_72_bits":
        # c_lo a field value of 201 bits: carry_lo = 2^72 exactly fails the
        # 9-byte range check, 2^72 - 1 (c_lo = 2^200 - 2^128) passes
        rows, bits, _ = words_case([0] * 4, [0] * 4, [0] * 4, wide=wide)
        c_lo = [1 << 200, (1 << 200) - (1 << 128), (1 << 200) + 5, 3 << 199]
        rows[4], bits[4] = _row(c_lo, 202)
        return rows, bits, wide
    if name == "constants":
        # [1, w] constant rows, as word(0), the exp circuit's two and
        # Word.from_lo(r) give them: stride 0 on the card
        a = rand_words(n)
        rows, bits, _ = words_case([2] * n, a, [1] * n, wide=wide)
        rows[0], rows[1], rows[4], rows[5] = (torch.tensor([[2]]), torch.tensor([[0]]),
                                              torch.tensor([[1]]), torch.tensor([[0]]))
        bits[0], bits[1], bits[4], bits[5] = 2, 1, 1, 1
        return rows, bits, wide
    if name == "widths":
        # narrow rows (one to eight limbs), as small operands give them
        a = [int(v) for v in rng.randint(0, 1 << 16, size=n)]
        b = [int(v) << 40 for v in rng.randint(0, 1 << 20, size=n)]
        c = [int(v) for v in rng.randint(0, 1 << 30, size=n)]
        full = [x * y + z for x, y, z in zip(a, b, c)]
        words = [a, b, c, full if not wide else [0] * n] + ([full] if wide else [])
        pairs = []
        for w in words:
            pairs.append(_row([v & U128 for v in w], max(1, max(v & U128 for v in w).bit_length())))
            pairs.append(_row([v >> 128 for v in w], 1))
        return [r for r, _ in pairs], [b for _, b in pairs], wide
    if name == "one_lane":
        return words_case(rand_words(1), rand_words(1), rand_words(1), wide=wide)
    raise ValueError(name)


def ints_of(row):
    arr = row.numpy()
    return [sum(int(arr[i, k]) << (16 * k) for k in range(arr.shape[1])) for i in range(arr.shape[0])]
