"""The port's limb arithmetic (zkevm_specs_tpu_torch.ops.limbs) against the
JAX package's (zkevm_specs_tpu.ops.limbs under numpy), tolerance 0.

On the CPU the kernel wrappers (K2 limb_mul, K3 limb_addsub) run their
plain versions; the kernels themselves are held against those plain
versions on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

from zkevm_specs_tpu.ops import limbs as JL
from zkevm_specs_tpu_torch.ops import limbs as L

torch.set_num_threads(1)

P = L.P


def _values(n_limbs, count, seed):
    """Random values below 2^(16 n) plus the edge values: 0, 1, p-1,
    2^256-1 and the all-0xFFFF full carry chain, each where it fits."""
    rng = np.random.RandomState(seed)
    top = 1 << (16 * n_limbs)
    vals = [int.from_bytes(rng.bytes(2 * n_limbs), "little") for _ in range(count)]
    edges = [0, 1, top - 1, top >> 1, (top - 1) ^ 1]
    edges += [v for v in (P - 1, P, (1 << 256) - 1) if v < top]
    return [v % top for v in vals + edges]


def _pair(na, nb, seed, broadcast=None):
    va = _values(na, 40, seed)
    vb = _values(nb, 40, seed + 1)[:len(va)]
    vb += [0] * (len(va) - len(vb))
    vb = vb[::-1]
    a_np = JL.ints_to_limbs(va, na)
    b_np = JL.ints_to_limbs(vb, nb)
    if broadcast == "b":
        b_np = b_np[7:8]
    elif broadcast == "a":
        a_np = a_np[6:7]
    return a_np, b_np


def _t(arr):
    return torch.from_numpy(np.asarray(arr).astype(np.int64))


def _same(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).astype(np.int64))


# the K2 shapes on the path: the field product and Barrett's terms, the
# 16x8 product of mul_add_words, the 4x4 products of _mul_512_terms
MUL_SHAPES = [(16, 16, 32), (16, 8, 16), (17, 16, 17), (17, 17, 34), (4, 4, 8),
              (1, 1, 1), (2, 4, 4), (8, 8, 16), (16, 4, 16)]


BROADCAST = [None, "a", "b"]     # which operand is a [1, w] row


@pytest.mark.parametrize("broadcast", BROADCAST)
@pytest.mark.parametrize("na,nb,out_n", MUL_SHAPES)
def test_mul_matches_jax(na, nb, out_n, broadcast):
    a_np, b_np = _pair(na, nb, na * 100 + nb, broadcast)
    ref = JL.mul(np, a_np, b_np, out_n)
    _same(L.mul(_t(a_np), _t(b_np), out_n), ref)
    rows = max(a_np.shape[0], b_np.shape[0])
    a_int = JL.limbs_to_ints(np.broadcast_to(a_np, (rows, na)))
    b_int = JL.limbs_to_ints(np.broadcast_to(b_np, (rows, nb)))
    want = [(x * y) % (1 << (16 * out_n)) for x, y in zip(a_int, b_int)]
    assert L.limbs_to_ints(L.mul(_t(a_np), _t(b_np), out_n)) == want


# the add widths of the ADD and MUL replays (F.__add__ at width_for_bits,
# the 17-limb sums of the Fr modes), plus truncating and widening cases
ADD_SHAPES = [(1, 1, 1), (1, 1, 2), (1, 2, 2), (1, 2, 4), (2, 1, 4), (1, 4, 4), (4, 1, 8),
              (2, 2, 4), (4, 4, 4), (1, 8, 16), (8, 8, 8), (8, 8, 16), (8, 16, 16),
              (16, 8, 16), (16, 1, 16), (16, 16, 16), (16, 16, 17), (17, 17, 17)]


@pytest.mark.parametrize("broadcast", BROADCAST)
@pytest.mark.parametrize("na,nb,out_n", ADD_SHAPES)
def test_add_matches_jax(na, nb, out_n, broadcast):
    a_np, b_np = _pair(na, nb, na * 10 + nb, broadcast)
    _same(L.add(_t(a_np), _t(b_np), out_n), JL.add(np, a_np, b_np, out_n))


# the sub/lt widths of the replays (the constant-minus-flag fast path,
# compare_word's 8-limb halves, Barrett's 17-limb terms) and mixed widths
SUB_SHAPES = [(1, 1), (1, 8), (1, 16), (2, 4), (4, 2), (8, 8), (16, 16), (17, 17), (16, 17),
              (8, 16)]


@pytest.mark.parametrize("broadcast", BROADCAST)
@pytest.mark.parametrize("na,nb", SUB_SHAPES)
def test_sub_and_lt_match_jax(na, nb, broadcast):
    a_np, b_np = _pair(na, nb, na * 7 + nb, broadcast)
    d, borrow = L.sub(_t(a_np), _t(b_np))
    d_ref, borrow_ref = JL.sub(np, a_np, b_np)
    _same(d, d_ref)
    _same(borrow, borrow_ref)
    np.testing.assert_array_equal(L.lt(_t(a_np), _t(b_np)).numpy(), JL.lt(np, a_np, b_np))


@pytest.mark.parametrize("m,out_n", [(32, 32), (34, 17), (17, 34), (8, 8), (20, 16)])
def test_carry_propagate_matches_jax(m, out_n):
    rng = np.random.RandomState(m * 31 + out_n)
    cols = rng.randint(0, 1 << 31, size=(24, m)).astype(np.uint32)
    cols[0] = 0xFFFF                # a full carry chain
    cols[1] = 0x10000               # every column generates a carry
    cols[2, 0] = 0x10000
    cols[2, 1:] = 0xFFFF            # one carry rippling through the whole row
    _same(L.carry_propagate(_t(cols), out_n), JL.carry_propagate(np, cols, out_n))


@pytest.mark.parametrize("na,nb", [(16, 16), (8, 16), (1, 2), (17, 17)])
def test_eq_select_is_zero_match_jax(na, nb):
    a_np, b_np = _pair(na, nb, 5)
    b_np = b_np.copy()
    n = min(na, nb)
    b_np[::3, :n] = a_np[::3, :n]   # some lanes equal where widths allow
    if nb > na:
        b_np[::3, na:] = 0
    elif na > nb:
        a_np = a_np.copy()
        a_np[::3, nb:] = 0
    a, b = _t(a_np), _t(b_np)
    np.testing.assert_array_equal(L.eq(a, b).numpy(), JL.eq(np, a_np, b_np))
    np.testing.assert_array_equal(L.is_zero(a).numpy(), JL.is_zero(np, a_np))
    cond = (np.arange(a_np.shape[0]) % 2 == 0)
    _same(L.select(torch.from_numpy(cond), a, b), JL.select(np, cond, a_np, b_np))


@pytest.mark.parametrize("n,bits", [(16, 128), (8, 64), (16, 64), (16, 3), (8, 128), (1, 8),
                                    (16, 240), (4, 17), (2, 0)])
def test_divmod_pow2_matches_jax(n, bits):
    a_np = JL.ints_to_limbs(_values(n, 20, n + bits), n)
    q, r = L.divmod_pow2(_t(a_np), bits)
    q_ref, r_ref = JL.divmod_pow2(np, a_np, bits)
    _same(q, q_ref)
    _same(r, r_ref)


@pytest.mark.parametrize("k", [0, 1, 255, 65535])
def test_mul_small_matches_jax(k):
    a_np = JL.ints_to_limbs(_values(8, 20, k), 8)
    _same(L.mul_small(_t(a_np), k, 9), JL.mul_small(np, a_np, k, 9))


def test_host_conversions_match_jax():
    vals = _values(16, 10, 3) + [12345, 0]
    np.testing.assert_array_equal(L.ints_to_limbs(vals, 16).numpy(),
                                  JL.ints_to_limbs(vals, 16).astype(np.int64))
    np.testing.assert_array_equal(L.ints_to_limbs([5, 7], 2).numpy(),
                                  JL.ints_to_limbs([5, 7], 2).astype(np.int64))
    assert L.limbs_to_ints(L.ints_to_limbs(vals, 16)) == vals
    assert L.limbs_to_int(L.int_to_limbs(P - 1, 16)) == P - 1


def test_wrappers_refuse_a_non_cpu_non_cuda_tensor():
    """No fallback: a wrapper runs its plain version only for CPU tensors."""
    a = torch.zeros((4, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        L.mul(a, a, 8)
    with pytest.raises(ValueError):
        L.add(a, a, 4)
    with pytest.raises(ValueError):
        L.add(a, torch.zeros((4, 4), dtype=torch.int64), 4)


# -- K3 at the edges of its tiles (tests/limb_tile_cases.py) -------------------------

from zkevm_specs_tpu.ops import fr as JFR  # noqa: E402

from limb_tile_cases import ADDSUB_CASES, addsub_case  # noqa: E402


def _jax_addsub(name, a_np, b_np, mode, out_n):
    """The JAX package's function of a K3 case: limbs.add/sub, fr.add/sub,
    fr.reduce_once for a 17-limb FR_ADD, fr.neg for a zero FR_SUB minuend."""
    if mode == L.ADD:
        return JL.add(np, a_np, b_np, out_n)
    if mode == L.SUB:
        return JL.sub(np, a_np, b_np)
    if mode == L.FR_ADD:
        return JFR.reduce_once(np, a_np) if a_np.shape[1] == 17 else JFR.add(np, a_np, b_np)
    return JFR.neg(np, b_np) if name == "FR_SUB_neg" else JFR.sub(np, a_np, b_np)


@pytest.mark.parametrize("case", sorted(ADDSUB_CASES))
def test_addsub_tile_case_matches_jax(case):
    a, b, mode, out_n = addsub_case(case)
    got = L.limb_addsub(a, b, mode, out_n)
    want = _jax_addsub(case, a.numpy(), b.numpy(), mode, out_n)
    got, want = (got, want) if mode == L.SUB else ((got,), (want,))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("m,out_n", [(5, 8), (34, 34), (64, 64), (70, 70), (130, 124)])
def test_carry_chains_match_python_ints(m, out_n):
    """The plain carry and borrow resolution (``_normalize``, ``_sub_plain``)
    on columns up to the int64 limit, on 0xFFFF runs that one carry ripples
    through end to end, and past 62 limbs (two packed words of carry
    flags), against Python ints."""
    rng = np.random.RandomState(m)
    cols = torch.from_numpy(rng.randint(0, 1 << 62, size=(12, m), dtype=np.int64))
    cols[0] = (1 << 63) - 1
    cols[1] = L.LIMB_MASK
    cols[1, 0] += 1                      # one carry through every limb
    cols[2] = L.LIMB_MASK
    cols[3, ::2] = L.LIMB_MASK + 1
    got = L._normalize(cols, out_n)
    for r in range(cols.shape[0]):
        v = sum(int(c) << (16 * k) for k, c in enumerate(cols[r].tolist())) % (1 << (16 * out_n))
        assert got[r].tolist() == [(v >> (16 * k)) & L.LIMB_MASK for k in range(out_n)]
    a = cols & L.LIMB_MASK
    b = torch.flip(a, [0])
    b[1] = a[1]
    b[2, 0] = a[2, 0] + 1 if a[2, 0] < L.LIMB_MASK else 0
    diff, borrow = L._sub_plain(a, b, m)
    for r in range(a.shape[0]):
        va = sum(int(c) << (16 * k) for k, c in enumerate(a[r].tolist()))
        vb = sum(int(c) << (16 * k) for k, c in enumerate(b[r].tolist()))
        v = (va - vb) % (1 << (16 * m))
        assert diff[r].tolist() == [(v >> (16 * k)) & L.LIMB_MASK for k in range(m)]
        assert int(borrow[r]) == int(va < vb)
