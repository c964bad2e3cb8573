"""The design of K1, K11, K12 and K13 on the CPU, tolerance 0: the
32-bit-limb Montgomery arithmetic of ``csrc/fr_mont.cuh``, K1's two
product sequences (``csrc/fr_mul.cu``) on operands at and above p, K11's
word product and carry chain (``csrc/mul_add_words.cu``) against its plain
version, the window chain of ``csrc/fr_inv.cu`` and K2's normalise-and-reduce
entry (``csrc/limb_mul.cu:limb_reduce_kernel``: the ripple, hi * 2^256 mod p
by ``mont_to``, lo below p, one ``mont_add``), read from the sources and
walked on Python ints, and K13's plan (``tables/logup.py:logup_plan``).

The model below runs the header's functions instruction by instruction in
the header's carry order (one carry flag, as in PTX), and asserts that
every carry a chain drops is zero, so the bounds the header states are
checked on every value the tests feed it."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_specs_tpu_torch import workloads
from zkevm_specs_tpu_torch.ops import fr, word_mul
from zkevm_specs_tpu_torch.tables import logup

from word_mul_cases import CASES as WORD_MUL_CASES
from word_mul_cases import ints_of, make_case

torch.set_num_threads(1)

CSRC = Path(fr.__file__).resolve().parents[1] / "csrc"
P = fr.P
R = 1 << 256
M32 = (1 << 32) - 1


def _words(v):
    return [(v >> (32 * k)) & M32 for k in range(8)]


def _value(words):
    return sum(w << (32 * k) for k, w in enumerate(words))


def _c_array(source, name):
    """The integers of ``name[...] = {...}`` in a CUDA source."""
    m = re.search(re.escape(name) + r"\[[^\]]*\]\s*=\s*\{([^}]*)\}", source)
    assert m, f"{name} not found"
    return [int(t, 0) for t in m.group(1).replace("\n", " ").split(",") if t.strip()]


class Ptx:
    """The PTX integer instructions fr_mont.cuh uses, on one carry flag."""

    def __init__(self):
        self.cc = 0

    def _set(self, r, cc_out=True):
        if cc_out:
            self.cc = r >> 32
        else:
            assert r >> 32 == 0, "a chain dropped a nonzero carry"
        return r & M32

    def mad_lo_cc(self, a, b, c):
        return self._set(((a * b) & M32) + c)

    def madc_lo_cc(self, a, b, c):
        return self._set(((a * b) & M32) + c + self.cc)

    def mad_hi_cc(self, a, b, c):
        return self._set((a * b >> 32) + c)

    def madc_hi_cc(self, a, b, c):
        return self._set((a * b >> 32) + c + self.cc)

    def madc_hi(self, a, b, c):
        return self._set((a * b >> 32) + c + self.cc, cc_out=False)

    def add_cc(self, a, b):
        return self._set(a + b)

    def addc_cc(self, a, b):
        return self._set(a + b + self.cc)

    def addc(self, a, b):
        return self._set(a + b + self.cc, cc_out=False)

    def sub_cc(self, a, b):
        r = a - b
        self.cc = int(r < 0)
        return r & M32

    def subc_cc(self, a, b):
        r = a - b - self.cc
        self.cc = int(r < 0)
        return r & M32

    def subc(self, a, b):
        return (a - b - self.cc) & M32


HEADER = (CSRC / "fr_mont.cuh").read_text()
C_P = _c_array(HEADER, "c_mont_p")
C_R2 = _c_array(HEADER, "c_mont_r2")
C_ONE = _c_array(HEADER, "c_mont_one")
C_PINV = int(re.search(r"c_mont_pinv\s*=\s*(0x[0-9a-fA-F]+)", HEADER).group(1), 16)


def mont_merge(ptx, x, y):
    t = [0] * 16
    t[0] = x[0]
    t[1] = ptx.add_cc(x[1], y[1])
    for k in range(2, 15):
        t[k] = ptx.addc_cc(x[k], y[k])
    t[15] = ptx.addc(x[15], y[15])
    return t


def mont_wide_mul(ptx, a, b):
    x, y = [0] * 16, [0] * 16
    for j in range(8):
        x[j] = (a[j] * b[0]) & M32
        y[j + 1] = (a[j] * b[0]) >> 32
    for i in range(1, 8):
        x[i] = ptx.mad_lo_cc(a[0], b[i], x[i])
        for j in range(1, 8):
            x[i + j] = ptx.madc_lo_cc(a[j], b[i], x[i + j])
        assert x[i + 8] == 0
        x[i + 8] = ptx.addc(0, 0)
        y[i + 1] = ptx.mad_hi_cc(a[0], b[i], y[i + 1])
        if i < 7:
            for j in range(1, 8):
                y[i + j + 1] = ptx.madc_hi_cc(a[j], b[i], y[i + j + 1])
            assert y[i + 9] == 0
            y[i + 9] = ptx.addc(0, 0)
        else:
            for j in range(1, 7):
                y[i + j + 1] = ptx.madc_hi_cc(a[j], b[i], y[i + j + 1])
            y[15] = ptx.madc_hi(a[7], b[i], y[15])
    return mont_merge(ptx, x, y)


def mont_wide_sqr(ptx, a):
    x, y = [0] * 16, [0] * 16
    for j in range(1, 8):
        x[j] = (a[j] * a[0]) & M32
        y[j + 1] = (a[j] * a[0]) >> 32
    for i in range(1, 7):
        x[2 * i + 1] = ptx.mad_lo_cc(a[i + 1], a[i], x[2 * i + 1])
        for j in range(i + 2, 8):
            x[i + j] = ptx.madc_lo_cc(a[j], a[i], x[i + j])
        assert x[i + 8] == 0
        x[i + 8] = ptx.addc(0, 0)
        y[2 * i + 2] = ptx.mad_hi_cc(a[i + 1], a[i], y[2 * i + 2])
        for j in range(i + 2, 8):
            y[i + j + 1] = ptx.madc_hi_cc(a[j], a[i], y[i + j + 1])
        assert y[i + 9] == 0
        y[i + 9] = ptx.addc(0, 0)
    c = mont_merge(ptx, x, y)
    assert c[15] >> 31 == 0, "the cross products exceed 2^511"
    t = [(c[0] << 1) & M32] + [((c[k] << 1) | (c[k - 1] >> 31)) & M32 for k in range(1, 16)]
    t[0] = ptx.mad_lo_cc(a[0], a[0], t[0])
    t[1] = ptx.madc_hi_cc(a[0], a[0], t[1])
    for i in range(1, 7):
        t[2 * i] = ptx.madc_lo_cc(a[i], a[i], t[2 * i])
        t[2 * i + 1] = ptx.madc_hi_cc(a[i], a[i], t[2 * i + 1])
    t[14] = ptx.madc_lo_cc(a[7], a[7], t[14])
    t[15] = ptx.madc_hi(a[7], a[7], t[15])
    return t


def mont_reduce_once(ptx, r):
    d = [ptx.sub_cc(r[0], C_P[0])] + [0] * 7
    for k in range(1, 8):
        d[k] = ptx.subc_cc(r[k], C_P[k])
    borrow = ptx.subc(0, 0)
    return [r[k] if borrow else d[k] for k in range(8)]


def mont_reduce(ptx, t):
    u = list(t[:8]) + [0]
    for _ in range(8):
        m = (u[0] * C_PINV) & M32
        u[0] = ptx.mad_lo_cc(m, C_P[0], u[0])
        assert u[0] == 0
        for j in range(1, 8):
            u[j] = ptx.madc_lo_cc(m, C_P[j], u[j])
        u[8] = ptx.addc(0, 0)
        u[1] = ptx.mad_hi_cc(m, C_P[0], u[1])
        for j in range(1, 7):
            u[j + 1] = ptx.madc_hi_cc(m, C_P[j], u[j + 1])
        u[8] = ptx.madc_hi(m, C_P[7], u[8])
        u = u[1:] + [u[8]]
    assert _value(u[:8]) <= P
    r = [ptx.add_cc(u[0], t[8])] + [0] * 7
    for k in range(1, 7):
        r[k] = ptx.addc_cc(u[k], t[8 + k])
    r[7] = ptx.addc(u[7], t[15])
    return mont_reduce_once(ptx, r)


def mont_mul(a, b):
    ptx = Ptx()
    return mont_reduce(ptx, mont_wide_mul(ptx, a, b))


def mont_sqr(a):
    ptx = Ptx()
    return mont_reduce(ptx, mont_wide_sqr(ptx, a))


def mont_from(a):
    return mont_reduce(Ptx(), list(a) + [0] * 8)


def mont_add(a, b):
    ptx = Ptx()
    s = [ptx.add_cc(a[0], b[0])] + [0] * 7
    for k in range(1, 7):
        s[k] = ptx.addc_cc(a[k], b[k])
    s[7] = ptx.addc(a[7], b[7])
    return mont_reduce_once(ptx, s)


def mont_sub(a, b):
    ptx = Ptx()
    d = [ptx.sub_cc(a[0], b[0])] + [0] * 7
    for k in range(1, 8):
        d[k] = ptx.subc_cc(a[k], b[k])
    mask = ptx.subc(0, 0)
    out = [ptx.add_cc(d[0], C_P[0] & mask)] + [0] * 7
    for k in range(1, 7):
        out[k] = ptx.addc_cc(d[k], C_P[k] & mask)
    out[7] = (d[7] + (C_P[7] & mask) + ptx.cc) & M32
    return out


def _seeded(seed, n, below=P):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % below for _ in range(n)]


EDGES = [0, 1, 2, P - 1, P - 2, R % P, (R * R) % P, (1 << 253) + 7]


# -- the header's constants -------------------------------------------------------

def test_constants_match_python_ints():
    assert _value(C_P) == P
    assert _value(C_R2) == R * R % P
    assert _value(C_ONE) == R % P
    assert C_PINV == (-pow(P, -1, 1 << 32)) % (1 << 32)
    assert 4 * P < R   # the header's bounds rest on p < 2^254


# -- the product and the squaring, walked in the header's carry order -------------

RINV = pow(R, -1, P)
VALUES = EDGES + _seeded(1, 24)


@pytest.mark.parametrize("b", EDGES + _seeded(2, 6) + [R - 1, (1 << 64) - 1])
def test_mont_mul_model(b):
    """a * b * R^-1 mod p for every a < p and b < 2^256 (the multiplicities
    and R^2 mod p are such b)."""
    for a in VALUES:
        got = _value(mont_mul(_words(a), _words(b)))
        assert got == a * b * RINV % P, (a, b)


def test_mont_sqr_model():
    for a in VALUES + _seeded(3, 64):
        assert _value(mont_sqr(_words(a))) == a * a * RINV % P, a


def test_mont_conversions_and_add_sub_model():
    for a in VALUES:
        mont = mont_mul(C_R2, _words(a))                          # mont_to
        assert _value(mont) == a * R % P
        assert _value(mont_from(mont)) == a
        for b in EDGES:
            assert _value(mont_add(_words(a), _words(b))) == (a + b) % P
            assert _value(mont_sub(_words(a), _words(b))) == (a - b) % P


def test_mont_mul_by_plain_multiplicity_is_plain():
    """K13's partial sum: an inverse in Montgomery form times a plain m_i
    is the plain product, with no conversion back."""
    for x, m in zip(_seeded(4, 16), _seeded(5, 16, 1 << 64)):
        inv_mont = pow(x, P - 2, P) * R % P
        assert _value(mont_mul(_words(inv_mont), _words(m))) == pow(x, P - 2, P) * m % P


# -- K1's products on the Montgomery form ------------------------------------------

FRMUL_SOURCE = (CSRC / "fr_mul.cu").read_text()
K1_EDGES = [0, 1, P - 1, P, 2 * P - 1, (1 << 254) - 1, R - 1]


def k1_broadcast(a, b):
    """fr_mul_kernel<true>: bR = mont_to(b) once (R^2 mod p < p first, b <
    2^256), then each lane mont_mul(bR, a); every dropped carry checked."""
    b_r = mont_mul(C_R2, _words(b))
    assert _value(b_r) < P
    return _value(mont_mul(b_r, _words(a)))


def k1_varying(a, b):
    """fr_mul_kernel<false>: aR = mont_to(a), then mont_mul(aR, b)."""
    a_r = mont_mul(C_R2, _words(a))
    assert _value(a_r) < P
    return _value(mont_mul(a_r, _words(b)))


def test_k1_source_runs_the_modelled_sequence():
    """The lines k1_broadcast and k1_varying mirror, as fr_mul.cu writes
    them: no operand is reduced before its product."""
    assert "mont_pack16(g.b.p, g.b.n, w);\n      mont_to(w, w);" in FRMUL_SOURCE
    assert "mont_mul(y, x, x);" in FRMUL_SOURCE
    assert "mont_to(x, x);\n      mont_mul(x, y, x);" in FRMUL_SOURCE
    assert "if (sa == 0 && sb != 0) {  // the broadcast row as b" in FRMUL_SOURCE


@pytest.mark.parametrize("nb", [1, 2, 16])
@pytest.mark.parametrize("na", [1, 2, 16])
def test_k1_products_on_operands_at_and_above_p(na, nb):
    """a * b mod p for operands of na and nb limbs holding any value below
    2^(16 n): p, 2p - 1 and 2^256 - 1 included, on both kernels' sequences
    and on the plain version (Barrett)."""
    cut_a, cut_b = (1 << 16 * na) - 1, (1 << 16 * nb) - 1
    a_vals = [v & cut_a for v in K1_EDGES + _seeded(20 + na, 4, R)]
    b_vals = [v & cut_b for v in K1_EDGES + _seeded(30 + nb, 4, R)]
    for a in a_vals:
        for b in b_vals:
            assert k1_broadcast(a, b) == a * b % P, (a, b)
            assert k1_varying(a, b) == a * b % P, (a, b)
    a_t = fr.L.ints_to_limbs(a_vals, na)
    b_t = fr.L.ints_to_limbs(b_vals, nb)
    for b_row, b in zip(b_t, b_vals):
        got = fr.to_ints(fr.fr_mul_plain(a_t, b_row[None]))
        assert got == [a * b % P for a in a_vals]


# -- K12's window chain -----------------------------------------------------------

INV_SOURCE = (CSRC / "fr_inv.cu").read_text()


def _define(source, name):
    return int(re.search(r"#define\s+" + name + r"\s+(\d+)", source).group(1))


def test_fr_inv_schedule_is_the_generated_one():
    first, windows, tail = fr.sliding_window_schedule(P - 2, fr.INV_WINDOW)
    assert (first, windows, tail) == fr.INV_SCHEDULE
    assert tail == 0, "p - 2 is odd: the chain ends on a multiply"
    assert _define(INV_SOURCE, "FR_INV_TABLE") == 1 << (fr.INV_WINDOW - 1)
    assert _define(INV_SOURCE, "FR_INV_FIRST") == first // 2
    assert _define(INV_SOURCE, "FR_INV_WINDOWS") == len(windows)
    assert _c_array(INV_SOURCE, "c_inv_squares") == [s for s, _ in windows]
    assert _c_array(INV_SOURCE, "c_inv_index") == [v // 2 for _, v in windows]
    # 253 squarings (one for the table) and 56 multiplies (7 for it)
    assert 1 + sum(s for s, _ in windows) == 253
    assert (1 << (fr.INV_WINDOW - 1)) - 1 + len(windows) == 56


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 6])
def test_sliding_window_schedule_reproduces_pow(w):
    first, windows, tail = fr.sliding_window_schedule(P - 2, w)
    for a in [2, 3, P - 1] + _seeded(6 + w, 3):
        acc = pow(a, first, P)
        for squarings, v in windows:
            acc = pow(acc, 1 << squarings, P) * pow(a, v, P) % P
        assert pow(acc, 1 << tail, P) == pow(a, P - 2, P)


def test_fr_inv_chain_on_the_model():
    """The kernel's chain (fr_inv_mont) on the modelled Montgomery
    arithmetic: a^(p-2) with 0 mapped to 0."""
    first, windows, _ = fr.INV_SCHEDULE
    for a in [0, 1, P - 1, R % P] + _seeded(7, 3):
        m = mont_mul(C_R2, _words(a))
        a2 = mont_sqr(m)
        tab = [m]
        for _ in range(1, 8):
            tab.append(mont_mul(tab[-1], a2))
        acc = tab[first // 2]
        for squarings, v in windows:
            for _ in range(squarings):
                acc = mont_sqr(acc)
            acc = mont_mul(acc, tab[v // 2])
        assert _value(mont_from(acc)) == pow(a, P - 2, P)


def test_inv_plain_walks_the_chain():
    vals = [0, 1, P - 1] + _seeded(8, 3)
    got = fr.inv_plain(fr.from_ints(vals))
    assert fr.to_ints(got) == [pow(v, P - 2, P) for v in vals]


# -- K13's plan ---------------------------------------------------------------------

TILE = logup.LOGUP_THREADS * logup.LOGUP_RUN
LOGUP_SOURCE = (CSRC / "logup_sum.cu").read_text()


@pytest.mark.parametrize("n", [1, 2, TILE - 1, TILE, TILE + 1, TILE ** 2, TILE ** 2 + 1,
                               528401, 6160016])
def test_logup_plan_covers_every_element_once(n):
    plan = logup.logup_plan(n)
    assert plan.levels[0] == n and plan.levels[-1] == 1
    assert all(b == -(-a // TILE) for a, b in zip(plan.levels, plan.levels[1:]))
    for level, n_l in enumerate(plan.levels[:-1]):
        tiles = plan.levels[level + 1]
        if n_l > 4 * TILE:     # the first two tiles and the last two
            check = [0, 1, tiles - 2, tiles - 1]
            seen = [i for t in check for run in plan.tile_elements(level, t) for i in run]
            want = [i for t in check for i in range(t * TILE, min((t + 1) * TILE, n_l))]
        else:
            seen = [i for t in range(tiles) for run in plan.tile_elements(level, t) for i in run]
            want = list(range(n_l))
        assert sorted(seen) == want
    # the workspace: 8 words an element of every level below the top
    assert plan.words == 8 * sum(plan.levels[:-1]) == logup.logup_workspace_words(n)


def test_logup_plan_launches():
    """At most 8 device launches a call (K12 included) at every logUp
    side of both blocks: 2 levels at 528401 elements, 3 at 6160016."""
    assert logup.logup_plan(528401).depth == 2
    assert logup.logup_plan(6160016).depth == 3
    for side, n, _ in workloads.LOGUP_SIDES:
        up, down = logup.logup_plan(n).launches(sum_mode=True)
        assert up + 1 + down <= 8, side
    assert logup.logup_plan(TILE).launches(sum_mode=True) == (1, 1)
    assert logup.logup_plan(TILE + 1).launches(sum_mode=True) == (2, 3)
    assert logup.logup_plan(TILE + 1).launches(sum_mode=False) == (2, 2)


def test_logup_plan_matches_the_source():
    """The tile the wrapper plans with is the one the source is compiled
    with, and the source's limits hold it."""
    assert _define(LOGUP_SOURCE, "LOGUP_THREADS") == logup.LOGUP_THREADS
    assert _define(LOGUP_SOURCE, "LOGUP_RUN") == logup.LOGUP_RUN
    assert logup.LOGUP_THREADS & (logup.LOGUP_THREADS - 1) == 0
    assert logup.logup_plan(6160016).depth <= _define(LOGUP_SOURCE, "LOGUP_MAX_LEVELS")


# -- the Python-int reference K13 is held against on the card ------------------------

@pytest.mark.parametrize("zero_at", [None, 0, 3, 6])
def test_batch_inverse_ints(zero_at):
    vals = [1, 2, P - 1] + _seeded(4, 11)
    if zero_at is not None:
        vals[zero_at] = 0
    got = logup.batch_inverse_ints(vals)
    assert got == ([pow(v, P - 2, P) for v in vals] if zero_at is None else [0] * len(vals))
    assert got == fr.to_ints(logup.batch_inverse_plain(fr.from_ints(vals)))


@pytest.mark.parametrize("m_width", [None, 1, 4])
def test_logup_partial_sum_ints(m_width):
    fps, alpha = _seeded(12, 9), 0xA1FA
    rng = np.random.RandomState(13)
    m_t = (None if m_width is None else torch.from_numpy(
        rng.randint(0, 2 if m_width == 1 else 1 << 16, size=(9, m_width)).astype(np.int64)))
    m = None if m_t is None else fr.to_ints(m_t)
    want = sum((1 if m is None else m[i]) * pow(alpha - v, P - 2, P)
               for i, v in enumerate(fps)) % P
    assert logup.logup_partial_sum_ints(fps, alpha, m) == want
    plain = logup.logup_partial_sum_plain(fr.from_ints(fps), fr.from_ints([alpha]), m_t)
    assert fr.to_ints(plain[None])[0] == want


def test_logup_partial_sums_plain_equal_each_side():
    """The plain sums of several sides with one shared inverse equal each
    side's own plain sum and its Python-int sum: a side of one element,
    sides with m of one and four limbs, and a side holding alpha (its
    denominator 0 zeroes the side, not the others)."""
    rng = np.random.RandomState(14)
    alpha = 0xA1FA
    sides = []
    for n, m_width, fps in ((1, None, _seeded(15, 1)), (9, 1, _seeded(16, 9)),
                            (17, 4, _seeded(17, 17)), (5, None, _seeded(18, 4) + [alpha])):
        m = (None if m_width is None else torch.from_numpy(
            rng.randint(0, 2 if m_width == 1 else 1 << 16, size=(n, m_width)).astype(np.int64)))
        sides.append((fr.from_ints(fps), fr.from_ints([alpha]), m))
    got = logup.logup_partial_sums_plain(sides)
    assert len(got) == len(sides)
    for g, (fps, a, m) in zip(got, sides):
        assert torch.equal(g, logup.logup_partial_sum_plain(fps, a, m))
        want = logup.logup_partial_sum_ints(fr.to_ints(fps), alpha,
                                            None if m is None else fr.to_ints(m))
        assert fr.to_ints(g[None])[0] == want
    assert fr.to_ints(got[3][None])[0] == 0


# -- K11's chain on the 32-bit words (csrc/mul_add_words.cu) ------------------------

WORDMUL_SOURCE = (CSRC / "mul_add_words.cu").read_text()
C_POW128 = _c_array(WORDMUL_SOURCE, "c_wm_pow128")
Q128 = (1 << 128) - 1


def k11_mac64(ptx, a0, a1, b0, b1, t):
    """mac64: t += (a0, a1) * (b0, b1) in three carry chains."""
    t[0] = ptx.mad_lo_cc(a0, b0, t[0])
    t[1] = ptx.madc_hi_cc(a0, b0, t[1])
    t[2] = ptx.madc_lo_cc(a1, b1, t[2])
    t[3] = ptx.madc_hi_cc(a1, b1, t[3])
    t[4] = ptx.addc(t[4], 0)
    for x, y in ((a0, b1), (a1, b0)):
        t[1] = ptx.mad_lo_cc(x, y, t[1])
        t[2] = ptx.madc_hi_cc(x, y, t[2])
        t[3] = ptx.addc_cc(t[3], 0)
        t[4] = ptx.addc(t[4], 0)


def k11_pair_sum(lo, hi):
    ptx = Ptx()
    return [lo[0], lo[1], ptx.add_cc(lo[2], hi[0]), ptx.addc_cc(lo[3], hi[1]),
            ptx.addc_cc(lo[4], hi[2]), ptx.addc_cc(0, hi[3]), ptx.addc_cc(0, hi[4]),
            ptx.addc(0, 0)]


def k11_mul_inv128(x):
    """mul_inv128: the reduction of x moved up four words."""
    return mont_reduce(Ptx(), [0] * 4 + list(x) + [0] * 4)


def k11_half_carry(lhs, rhs):
    carry = k11_mul_inv128(mont_sub(lhs, rhs))
    back = mont_add(rhs, mont_mul(C_POW128, carry))
    return carry, lhs == back


def k11_below_2_72(v):
    return v[2] < 256 and all(w == 0 for w in v[3:])


def k11_lane(vals, wide):
    """One lane of mul_add_words_kernel on Python ints, in the kernel's
    order: the verdicts and, for the 256 variant, the overflow's value."""
    a_lo, a_hi, b_lo, b_hi, c_lo, c_hi, d_lo, d_hi = vals[:8]
    A = _words(a_lo & Q128)[:4] + _words(a_hi & Q128)[:4]
    B = _words(b_lo & Q128)[:4] + _words(b_hi & Q128)[:4]
    tk = [[0] * 5 for _ in range(7)]
    for i in range(4):
        for j in range(4):
            k11_mac64(Ptx(), A[2 * i], A[2 * i + 1], B[2 * j], B[2 * j + 1], tk[i + j])
    lo, hi = (vals[8], vals[9]) if wide else (d_lo, d_hi)
    lhs0 = mont_add(k11_pair_sum(tk[0], tk[1]), _words(c_lo))
    carry0, eq0 = k11_half_carry(lhs0, _words(lo))
    lhs1 = mont_add(mont_add(k11_pair_sum(tk[2], tk[3]), _words(c_hi)), carry0)
    carry1, eq1 = k11_half_carry(lhs1, _words(hi))
    if not wide:
        ptx = Ptx()
        s = [ptx.add_cc(tk[4][0], tk[5][0])]
        s += [ptx.addc_cc(tk[4][m], tk[5][m]) for m in range(1, 5)]
        s.append(ptx.addc(0, 0))
        s[0] = ptx.add_cc(s[0], tk[6][0])
        for m in range(1, 5):
            s[m] = ptx.addc_cc(s[m], tk[6][m])
        s[5] = ptx.addc(s[5], 0)
        over = mont_add(carry1, s + [0, 0])
        return [k11_below_2_72(carry0), k11_below_2_72(carry1), eq0, eq1], _value(over)
    lhs2 = mont_add(k11_pair_sum(tk[4], tk[5]), carry1)
    carry2, eq2 = k11_half_carry(lhs2, _words(d_lo))
    top = mont_add(tk[6] + [0, 0, 0], carry2)
    return [k11_below_2_72(carry0), k11_below_2_72(carry1), k11_below_2_72(carry2), eq0, eq1, eq2,
            top == _words(d_hi)], None


def test_k11_source_runs_the_modelled_chain():
    """The constant and the lines k11_lane mirrors, as mul_add_words.cu
    writes them."""
    assert _value(C_POW128) == (1 << 384) % P                  # 2^128 in Montgomery form
    for line in ("mac64(A[2 * i], A[2 * i + 1], B[2 * j], B[2 * j + 1], tk[i + j]);",
                 "for (int k = 0; k < 16; ++k) t[k] = (k >= 4 && k < 12) ? x[k - 4] : 0u;",
                 "mont_sub(lhs, rhs, diff);\n  mul_inv128(diff, carry);",
                 "mont_mul(pow128, carry, back);\n  mont_add(rhs, back, back);",
                 "mont_add(x, y, x);\n    mont_add(x, carry0, lhs);",
                 "mont_add(carry1, s, s);",
                 "mont_add(x, carry1, lhs);",
                 "bool ok = v[2] < 256u;"):
        assert line in WORDMUL_SOURCE, line


@pytest.mark.parametrize("wide", [False, True], ids=["256", "512"])
@pytest.mark.parametrize("case", WORD_MUL_CASES)
def test_k11_chain_equals_the_plain_version(case, wide):
    """The kernel's 32-bit chain on Python ints, every dropped carry
    checked, against ``mul_add_words_plain`` lane for lane on
    ``tests/word_mul_cases.py``'s cases."""
    rows, _, _ = make_case(case, wide)
    batch = max(r.shape[0] for r in rows)
    ints = [ints_of(r) for r in rows]
    want_ok, want_over = word_mul.mul_add_words_plain(rows, wide)
    want_ok = want_ok.expand(want_ok.shape[0], batch)
    for lane in range(batch):
        vals = [v[0] if len(v) == 1 else v[lane] for v in ints]
        ok, over = k11_lane(vals, wide)
        assert ok == [bool(b) for b in want_ok[:, lane]], (case, lane)
        if not wide:
            got = fr.L.ints_to_limbs([over], 16)[0]
            assert torch.equal(got, want_over.expand(batch, 16)[lane]), (case, lane)


def _ripple(ready):
    """Step each word of an 8-word carry chain is ready at, for operand
    words ready at ``ready``: word k a step after its operand and the
    carry out of word k - 1."""
    out, carry = [], 0
    for r in ready:
        carry = max(r, carry) + 1
        out.append(carry)
    return out


def test_k11_chain_bound_is_the_least_depth():
    """K11's chain bound (``runtime/bounds.py``) from its parts' least
    depths: an Fr add s = x + y then s - p a step behind and a select, an
    Fr subtract d = x - y then d + p a step behind and a select, each 10
    steps; the product by 2^-128 one product, four reduction rounds of
    three and an Fr add; composed in the order of the variants."""
    from zkevm_specs_tpu_torch.runtime import bounds

    first = _ripple([0] * 8)                  # x + y, or x - y
    second = _ripple(first)                   # s - p, or d + p
    fr_step = max(second[-1], first[-1]) + 1  # the select on the last carry or borrow
    assert bounds.CHAIN_ADD == bounds.CHAIN_SUB == fr_step == 10
    assert bounds.CHAIN_INV128 == 1 + 4 * 3 + fr_step
    half = bounds.CHAIN_ADD + bounds.CHAIN_SUB + bounds.CHAIN_INV128
    head = bounds.CHAIN_T + bounds.CHAIN_PAIR
    assert bounds.WORD_MUL_CHAIN == {False: head + 2 * half + bounds.CHAIN_ADD,
                                     True: head + 3 * half + bounds.CHAIN_ADD}
    assert bounds.WORD_MUL_CHAIN == {False: 107, True: 150}
    assert bounds.chain_bound(0.2, "bytes", 0.1) == (0.2, "bytes", "bytes")
    assert bounds.chain_bound(0.2, "bytes", 0.3) == (0.3, "operations", "chain")


# -- K2's normalise-and-reduce entry (csrc/limb_mul.cu:limb_reduce_kernel) -----------

LIMB_MUL_SOURCE = (CSRC / "limb_mul.cu").read_text()


def _p_multiples():
    m = re.search(r"c_p_multiples\[3\]\[MONT_LIMBS\]\s*=\s*\{(.*?)\};", LIMB_MUL_SOURCE, re.S)
    assert m, "c_p_multiples not found"
    words = [int(t, 16) for t in re.findall(r"0x[0-9a-fA-F]+", m.group(1))]
    return [words[8 * j:8 * j + 8] for j in range(3)]


P_MULTIPLES = _p_multiples()


def k2_sub_if_not_below(x, c):
    ptx = Ptx()
    d = [ptx.sub_cc(x[0], c[0])] + [0] * 7
    for k in range(1, 8):
        d[k] = ptx.subc_cc(x[k], c[k])
    borrow = ptx.subc(0, 0)
    return [x[k] if borrow else d[k] for k in range(8)]


def k2_reduce_row(cols, keep, reduce):
    """limb_reduce_kernel on one row of non-negative columns, in its order:
    the 64-bit ripple (every sum checked below 2^64), the limbs packed into
    16 words, lo below p by 4p, 2p, p, hi * 2^256 mod p by mont_to, one
    mont_add; returns the row's output limbs."""
    n = min(len(cols), keep)
    carry, limbs = 0, []
    for k in range(32 if reduce else keep):
        v = (cols[k] if k < n else 0) + carry
        assert v < 1 << 64, "a column sum wraps the 64-bit register"
        limbs.append(v & 0xFFFF if k < keep else 0)
        carry = v >> 16
    if not reduce:
        return limbs
    w = [limbs[2 * j] | limbs[2 * j + 1] << 16 for j in range(16)]
    lo, hi = w[:8], w[8:]
    y = mont_mul(C_R2, hi)
    assert _value(y) == _value(hi) * R % P
    for c in P_MULTIPLES:
        lo = k2_sub_if_not_below(lo, c)
    assert _value(lo) < P
    out = _value(mont_add(lo, y))
    return [(out >> (16 * k)) & 0xFFFF for k in range(16)]


def test_k2_reduce_source_runs_the_modelled_sequence():
    s = LIMB_MUL_SOURCE
    assert [sum(w << (32 * k) for k, w in enumerate(c)) for c in P_MULTIPLES] == [4 * P, 2 * P, P]
    assert 4 * P < R < 6 * P
    for line in ("const int cols = m < keep ? m : keep;",
                 "const uint64_t v = (k < cols ? (uint64_t)row[k] : 0ull) + carry;",
                 "const uint32_t limb = k < keep ? (uint32_t)(v & LIMB_MASK) : 0u;",
                 "if (k & 1) w[k >> 1] |= limb << LIMB_BITS;",
                 "mont_to(hi, y);  // hi * 2^256 mod p",
                 "for (int j = 0; j < 3; ++j) sub_if_not_below(lo, c_p_multiples[j]);",
                 "mont_add(lo, y, lo);",
                 "mont_unpack16(lo, out + r * 16);"):
        assert line in s, line


def _k2_cases(m, rows, seed):
    rng = np.random.default_rng(seed)
    fills = {"zero": 0, "limb": (1 << 16) - 1, "max": (1 << 32) - 1}
    out = [[v] * m for v in fills.values()]
    out += [[int(x) for x in rng.integers(0, 1 << 32, size=m)] for _ in range(rows)]
    return out


@pytest.mark.parametrize("keep", [17, 32])
@pytest.mark.parametrize("m", [1, 16, 17, 20, 32])
def test_k2_reduce_walk_equals_the_plain_version(m, keep):
    """The entry's walk, reduced and not, on rows of 32-bit columns and on
    values at p - 1, p, 2p, p^2 - 1, 2^272 - 1 and 2^512 - 1, equals
    carry_propagate_plain, normalize_reduce_plain and x' mod p."""
    rows = _k2_cases(m, 5, 100 * m + keep)
    for v in (P - 1, P, 2 * P, P * P - 1, (1 << 272) - 1, (1 << 512) - 1):
        rows.append([(v >> (16 * k)) & 0xFFFF for k in range(m)])
    x = torch.tensor(rows, dtype=torch.int64)
    flat = fr.L.carry_propagate_plain(x, keep)
    red = fr.normalize_reduce_plain(x, keep)
    for i, row in enumerate(rows):
        want = sum(c << (16 * k) for k, c in enumerate(row[:keep])) % (1 << (16 * keep))
        assert k2_reduce_row(row, keep, False) == flat[i].tolist()
        assert sum(c << (16 * k) for k, c in enumerate(flat[i].tolist())) == want
        got = k2_reduce_row(row, keep, True)
        assert got == red[i].tolist(), (m, keep, i)
        assert sum(c << (16 * k) for k, c in enumerate(got)) == want % P


def test_k2_reduce_walk_on_wide_columns():
    """Columns far above 2^32 (up to 2^62, where the plain version's int64
    sums stay exact): the kernel's walk equals the plain version."""
    rows = [[(1 << 62) + k for k in range(32)], [(1 << 62) - 1] * 32]
    x = torch.tensor(rows, dtype=torch.int64)
    for keep in (17, 32):
        flat = fr.L.carry_propagate_plain(x, keep)
        red = fr.normalize_reduce_plain(x, keep)
        for i, row in enumerate(rows):
            assert k2_reduce_row(row, keep, False) == flat[i].tolist()
            assert k2_reduce_row(row, keep, True) == red[i].tolist()


def test_k2_reduce_chain_bound_is_the_least_depth():
    """K2's normalise-and-reduce chain (``runtime/bounds.py:reduce_chain``)
    from its parts' least depths: the word-form ripple (a funnel shift,
    one chain over ceil(keep / 2) words, the top word's mask at an odd
    keep), then hi * 2^256 mod p (the products, one chain over 8 + h
    columns, eight reduction rounds of three, an Fr add) beside lo's three
    subtract-and-select steps, then an Fr add."""
    from zkevm_specs_tpu_torch.runtime import bounds

    fr_add = max(_ripple(_ripple([0] * 8))[-1], _ripple([0] * 8)[-1]) + 1
    assert bounds.CHAIN_ADD == fr_add
    sub_select = _ripple([0] * 8)[-1] + 1
    assert bounds.CHAIN_LO_BELOW_P == 3 * sub_select
    for keep, reduce in ((17, True), (32, True), (17, False), (32, False), (16, True)):
        words = -(-keep // 2)
        ripple = 1 + _ripple([0] * words)[-1] + keep % 2
        if not reduce:
            want = ripple
        elif words <= 8:
            want = ripple + 3 * sub_select
        else:
            h = words - 8
            product = 1 + _ripple([0] * (8 + h))[-1] + 8 * 3 + fr_add
            want = ripple + max(product, 3 * sub_select) + fr_add
        assert bounds.reduce_chain(keep, reduce) == want, (keep, reduce)
    assert bounds.reduce_chain(17, True) == 65 and bounds.reduce_chain(32, True) == 78
