"""The port's field arithmetic (zkevm_specs_tpu_torch.ops.fr) against the
JAX package's (zkevm_specs_tpu.ops.fr under numpy) and against Python ints
mod p, tolerance 0.  On the CPU, fr.mul (K1) and the Fr modes of K3 run
their plain versions."""
import numpy as np
import pytest
import torch

from zkevm_specs_tpu.ops import fr as JFR
from zkevm_specs_tpu.ops import limbs as JL
from zkevm_specs_tpu_torch.ops import fr

torch.set_num_threads(1)

P = fr.P


def _canonical(count, seed, bits=254):
    rng = np.random.RandomState(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % min(P, 1 << bits) for _ in range(count)]
    edges = [0, 1, P - 1, P - 2, (P - 1) // 2, 1 << 128, (1 << 253) + 12345]
    return vals + [e for e in edges if e < (1 << bits)]


def _limbs(vals, n):
    arr = JL.ints_to_limbs(vals, n)
    return arr, torch.from_numpy(arr.astype(np.int64))


def _same(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("na,nb,broadcast_b", [(16, 16, False), (16, 16, True), (4, 16, True),
                                               (8, 8, False), (16, 1, False), (2, 16, False)])
def test_mul_matches_jax_and_ints(na, nb, broadcast_b):
    va = _canonical(30, na, 16 * na)
    vb = _canonical(30, nb + 50, 16 * nb)[::-1][:len(va)]
    vb += [1] * (len(va) - len(vb))
    a_np, a = _limbs(va, na)
    b_np, b = _limbs(vb, nb)
    if broadcast_b:
        b_np, b, vb = b_np[2:3], b[2:3], [vb[2]] * len(va)
    out = fr.mul(a, b)
    _same(out, JFR.mul(np, a_np, b_np))
    assert fr.to_ints(out) == [(x * y) % P for x, y in zip(va, vb)]


def test_mul_at_p_minus_one():
    a_np, a = _limbs([P - 1] * 4, 16)
    _same(fr.mul(a, a), JFR.mul(np, a_np, a_np))
    assert fr.to_ints(fr.mul(a, a)) == [1] * 4


def test_reduce_wide_matches_jax():
    va, vb = _canonical(40, 1), _canonical(40, 2)
    prods = [x * y for x, y in zip(va, vb)]
    x_np, x = _limbs(prods, 32)
    _same(fr.reduce_wide(x), JFR.reduce_wide(np, x_np))
    assert fr.to_ints(fr.reduce_wide(x)) == [v % P for v in prods]


# K2's normalise-and-reduce entry: inputs of m columns below 2^32 (the JAX
# carry_propagate's max_entry_bits) at each fill, and values at the edges
K2_FILLS = {"zero": 0, "limb": (1 << 16) - 1, "max": (1 << 32) - 1}
K2_VALUES = [P - 1, P, 2 * P, P * P - 1, (1 << 272) - 1]


def _k2_columns(m, rows, fill, seed):
    rng = np.random.RandomState(seed)
    if fill == "random":
        return rng.randint(0, 1 << 32, size=(rows, m), dtype=np.uint64).astype(np.uint32)
    if fill == "values":
        vals = [K2_VALUES[i % len(K2_VALUES)] for i in range(rows)]
        return np.asarray([[(v >> (16 * k)) & 0xFFFF for k in range(m)] for v in vals],
                          dtype=np.uint32)
    return np.full((rows, m), K2_FILLS[fill], dtype=np.uint32)


@pytest.mark.parametrize("fill", ["zero", "limb", "max", "random", "values"])
@pytest.mark.parametrize("rows", [1, 2, 5])
@pytest.mark.parametrize("m", [1, 16, 17, 20, 32])
def test_normalize_reduce_plain_matches_jax(m, rows, fill):
    """K2's second entry's plain versions against the JAX functions they
    replace, tolerance 0: ``carry_propagate_plain`` against
    ``L.carry_propagate``, and ``normalize_reduce_plain`` against
    ``fr.reduce_wide(L.carry_propagate(x, keep))``, at keep 17 and 32; and
    the reduced value against x' mod p on Python ints."""
    cols = _k2_columns(m, rows, fill, 7 * m + rows)
    x = torch.from_numpy(cols.astype(np.int64))
    for keep in (17, 32):
        flat_ref = JL.carry_propagate(np, cols, keep)
        _same(fr.L.carry_propagate_plain(x, keep), flat_ref)
        _same(fr.L.carry_propagate(x, keep), flat_ref)
        red_ref = JFR.reduce_wide(np, flat_ref)
        _same(fr.normalize_reduce_plain(x, keep), red_ref)
        _same(fr.normalize_reduce(x, keep), red_ref)
        wide = [sum(int(c) << (16 * k) for k, c in enumerate(row[:keep])) % (1 << (16 * keep))
                for row in cols]
        assert fr.to_ints(fr.normalize_reduce(x, keep)) == [v % P for v in wide]


def test_reduce_wide_equals_the_entry_at_keep_32():
    """``reduce_wide`` is ``normalize_reduce`` at keep 32 (K2's entry on the
    card, the plain Barrett on the CPU): equal on canonical 32-limb
    products; the entry's launcher alone takes no CPU tensor."""
    va, vb = _canonical(20, 5), _canonical(20, 6)
    _, x = _limbs([a * b for a, b in zip(va, vb)], 32)
    assert torch.equal(fr.normalize_reduce(x, 32), fr.reduce_wide(x))
    with pytest.raises(ValueError, match="at most 32"):
        fr.reduce_wide(torch.zeros((1, 33), dtype=torch.int64))
    with pytest.raises(ValueError, match="out of range"):
        fr.normalize_reduce(x, 33)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fr.L.limb_reduce(x, 32, reduce=True)


@pytest.mark.parametrize("broadcast_b", [False, True])
def test_add_sub_neg_match_jax_and_ints(broadcast_b):
    va = _canonical(40, 3)
    vb = _canonical(40, 4)[::-1]
    a_np, a = _limbs(va, 16)
    b_np, b = _limbs(vb, 16)
    if broadcast_b:
        b_np, b, vb = b_np[1:2], b[1:2], [vb[1]] * len(va)
    _same(fr.add(a, b), JFR.add(np, a_np, b_np))
    _same(fr.sub(a, b), JFR.sub(np, a_np, b_np))
    _same(fr.neg(a), JFR.neg(np, a_np))
    assert fr.to_ints(fr.add(a, b)) == [(x + y) % P for x, y in zip(va, vb)]
    assert fr.to_ints(fr.sub(a, b)) == [(x - y) % P for x, y in zip(va, vb)]
    assert fr.to_ints(fr.neg(a)) == [(-x) % P for x in va]


def test_narrow_operands_of_fr_modes():
    """F pads narrower operands to 16 limbs; the Fr modes pad internally."""
    va = _canonical(20, 5, 64)
    vb = _canonical(20, 6)[:len(va)]
    a_np, a = _limbs(va, 4)
    b_np, b = _limbs(vb, 16)
    _same(fr.add(a, b), JFR.add(np, a_np, b_np))
    _same(fr.sub(a, b), JFR.sub(np, a_np, b_np))
    _same(fr.neg(a), JFR.neg(np, a_np))


@pytest.mark.parametrize("n", [16, 17])
def test_reduce_once_matches_jax(n):
    vals = [v + w for v, w in zip(_canonical(30, 7), _canonical(30, 8)[::-1])]
    vals = [v for v in vals if v < (1 << (16 * n))]
    x_np, x = _limbs(vals, n)
    _same(fr.reduce_once(x), JFR.reduce_once(np, x_np))
    assert fr.to_ints(fr.reduce_once(x)) == [v % P for v in vals]


def test_from_ints_to_ints_round_trip():
    vals = _canonical(10, 9) + [P + 5, 2 * P - 1]
    arr = fr.from_ints(vals)
    np.testing.assert_array_equal(arr.numpy(), JFR.from_ints(np, vals).astype(np.int64))
    assert fr.to_ints(arr) == [v % P for v in vals]
