"""Kernel K11's plain version (zkevm_specs_tpu_torch.ops.word_mul) and the
port's ``Instruction.mul_add_words`` / ``mul_add_words_512`` and exp-circuit
``_mul_add_words`` against the JAX package's F-operation chains
(``evm/instruction.py:812-862``, ``circuits/exp.py:19-42``) in spec mode,
and against Python ints, on the CPU, tolerance 0.

Cases (``word_mul_cases.py``): random valid words with one lane in four
corrupted, arbitrary field values in every row, a = b = 2^256 - 1,
c = 2^128 - 1, d_lo above t0 + t1 * 2^64 + c_lo (the wrapping subtract),
a carry exactly at and one below 2^72, ``[1, w]`` constant rows, narrow
rows and one lane.  Compared: every check bit in the chain's order, the
overflow limbs, and the failure messages."""
import numpy as np
import pytest
import torch

from zkevm_specs_tpu.circuits import exp as jexp
from zkevm_specs_tpu.dsl.cs import ConstraintSystem as JCS
from zkevm_specs_tpu.dsl.value import Ctx as JCtx
from zkevm_specs_tpu.dsl.value import F as JF
from zkevm_specs_tpu.dsl.value import Word as JWord
from zkevm_specs_tpu.evm.instruction import Instruction as JInstruction
from zkevm_specs_tpu_torch.circuits import exp as pexp
from zkevm_specs_tpu_torch.dsl.cs import ConstraintSystem
from zkevm_specs_tpu_torch.dsl.value import Ctx, F, Word
from zkevm_specs_tpu_torch.evm.instruction import Instruction
from zkevm_specs_tpu_torch.ops import limbs as L
from zkevm_specs_tpu_torch.ops import word_mul

from word_mul_cases import CASES, ints_of, make_case

torch.set_num_threads(1)


def _batch(rows):
    return max(r.shape[0] for r in rows)


def _jax_words(rows, bits):
    ctx = JCtx(np, _batch(rows), "eager")
    fs = [JF(ctx, r.numpy().astype(np.uint32), b) for r, b in zip(rows, bits)]
    return ctx, [JWord(fs[i], fs[i + 1]) for i in range(0, len(fs), 2)]


def _port_words(rows, bits):
    ctx = Ctx("cpu", _batch(rows), "eager")
    fs = [F(ctx, r, b) for r, b in zip(rows, bits)]
    return ctx, [Word(fs[i], fs[i + 1]) for i in range(0, len(fs), 2)]


def _instruction(cls, ctx, cs):
    inst = object.__new__(cls)
    inst.ctx, inst.cs = ctx, cs
    return inst


def _run(cls, cs_cls, words_of, rows, bits, wide):
    """(ok [n, B], overflow limbs or None, the failure messages of each
    check) of one package's Instruction method."""
    ctx, words = words_of(rows, bits)
    cs = cs_cls(ctx)
    inst = _instruction(cls, ctx, cs)
    overflow = (inst.mul_add_words_512 if wide else inst.mul_add_words)(*words)
    ok = np.stack([~np.broadcast_to(np.asarray(bad), (ctx.batch,)) for bad, _ in cs.records])
    msgs = [msg() if not o.all() else None for (_, msg), o in zip(cs.records, ok)]
    return ok, overflow, msgs


@pytest.mark.parametrize("wide", [False, True], ids=["256", "512"])
@pytest.mark.parametrize("case", CASES)
def test_plain_equals_jax_chain(case, wide):
    rows, bits, _ = make_case(case, wide)
    j_ok, j_over, j_msgs = _run(JInstruction, JCS, _jax_words, rows, bits, wide)
    p_ok, p_over, p_msgs = _run(Instruction, ConstraintSystem, _port_words, rows, bits, wide)
    assert p_ok.shape == j_ok.shape == (7 if wide else 4, _batch(rows))
    np.testing.assert_array_equal(p_ok, j_ok)
    assert p_msgs == j_msgs
    if not wide:
        assert p_over.bits == j_over.bits == 254
        np.testing.assert_array_equal(
            L.pad_limbs(p_over.limbs, 16).numpy(),
            np.broadcast_to(L.pad_limbs(torch.from_numpy(np.asarray(j_over.limbs).astype(np.int64)),
                                        16).numpy(), p_over.limbs.shape))
    # the plain version on its own gives the same bits
    ok, _ = word_mul.mul_add_words_plain(rows, wide)
    np.testing.assert_array_equal(np.broadcast_to(ok.numpy(), j_ok.shape), j_ok)


@pytest.mark.parametrize("case", CASES)
def test_exp_circuit_mul_add_words_equals_jax(case):
    rows, bits, _ = make_case(case, False)
    batch = _batch(rows)
    mask_np = np.arange(batch) % 3 != 1
    out = []
    for words_of, cs_cls, fn, mask in (
            (_jax_words, JCS, jexp._mul_add_words, mask_np),
            (_port_words, ConstraintSystem, pexp._mul_add_words, torch.from_numpy(mask_np))):
        ctx, (a, b, c, d) = words_of(rows, bits)
        cs = cs_cls(ctx)
        if fn is jexp._mul_add_words:
            fn(cs, ctx, a, b, c, d, mask, "m")
        else:
            fn(cs, a, b, c, d, mask, "m")
        out.append([(np.asarray(bad).tolist(), msg()) for bad, msg in cs.records])
    assert out[0] == out[1]


@pytest.mark.parametrize("case", ["random_valid", "all_ones", "c_lo_max", "widths"])
def test_plain_against_python_ints(case):
    """On a valid lane every check holds, the carries are the exact
    quotients, and the overflow is 0 exactly when a*b + c < 2^256; the
    512 variant holds exactly where a*b + c == d*2^256 + e."""
    for wide in (False, True):
        rows, _, _ = make_case(case, wide)
        a, b, c = [[lo + (hi << 128) for lo, hi in zip(ints_of(rows[i]), ints_of(rows[i + 1]))]
                   for i in (0, 2, 4)]
        d = [lo + (hi << 128) for lo, hi in zip(ints_of(rows[6]), ints_of(rows[7]))]
        v = word_mul.chain_values(rows, wide)
        if wide:
            e = [lo + (hi << 128) for lo, hi in zip(ints_of(rows[8]), ints_of(rows[9]))]
            valid = [x * y + z == dd * 2**256 + ee for x, y, z, dd, ee in zip(a, b, c, d, e)]
        else:
            valid = [(x * y + z - dd) % 2**256 == 0 for x, y, z, dd in zip(a, b, c, d)]
        ok = v["ok"].all(dim=0).tolist()
        assert ok == valid
        for lane, good in enumerate(valid):
            if not good:
                continue
            if not wide:
                over = L.limbs_to_int(v["overflow"][lane])
                assert (over == 0) == (a[lane] * b[lane] + c[lane] < 2**256)
                quarters = [(x >> (64 * k)) & (2**64 - 1) for x in (a[lane], b[lane]) for k in range(4)]
                qa, qb = quarters[:4], quarters[4:]
                t = [sum(qa[i] * qb[k - i] for i in range(4) if 0 <= k - i < 4) for k in range(7)]
                carry_lo = (t[0] + (t[1] << 64) + (c[lane] & (2**128 - 1))
                            - (d[lane] & (2**128 - 1))) >> 128
                assert L.limbs_to_int(v["carry0"][lane]) == carry_lo


def test_wrapping_subtract_carry_is_a_field_value():
    rows, _, _ = make_case("wrapping_subtract", False)
    v = word_mul.chain_values(rows, False)
    carries = [L.limbs_to_int(r) for r in v["carry0"]]
    assert all(c.bit_length() > 200 for c in carries)
    assert not v["ok"][0].any() and v["ok"][2:].all()


def test_carry_at_2_72_fails_the_range_check():
    rows, _, _ = make_case("carry_past_72_bits", False)
    v = word_mul.chain_values(rows, False)
    assert [L.limbs_to_int(r) for r in v["carry0"]][:2] == [1 << 72, (1 << 72) - 1]
    assert v["ok"][0].tolist() == [False, True, False, False]


def test_wrapper_shapes_and_refusals():
    rows, _, _ = make_case("constants", False)
    ok, overflow = word_mul.mul_add_words(rows)
    assert ok.shape == (4, 64) and ok.dtype == torch.bool and overflow.shape == (64, 16)
    with pytest.raises(ValueError):
        word_mul.mul_add_words(rows[:7])
    with pytest.raises(ValueError):
        word_mul.mul_add_words(rows, wide=True)
    with pytest.raises(ValueError):
        word_mul.mul_add_words([torch.zeros((3, 17), dtype=torch.int64)] * 8)
    with pytest.raises(ValueError):
        word_mul.mul_add_words([torch.zeros((3, 1), dtype=torch.int64)] * 7
                               + [torch.zeros((2, 1), dtype=torch.int64)])
    assert L.LAUNCHES["mul_add_words"] == 0     # the plain version launches nothing
