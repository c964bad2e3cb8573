"""The port's last eight ALU gadgets (zkevm_specs_tpu_torch.evm.execution:
comparator's LT/GT/EQ, slt_sgt, iszero, not_, bitwise, byte, signextend,
sar) against the JAX package in spec mode, on the CPU, tolerance 0.

Every vector of tests/evm/test_arith_family.py for these opcodes (the
``_nasty`` and ``_reference_vectors`` lattices included) is one lane of a
group that each package builds with its own classes and verifies with its
own ``_run_group``; the failure dicts must be equal key for key and
message for message, and hold exactly the negative lanes, and the port's
replay of the group (``CompiledGroupVerifier`` on the CPU) must fail
exactly those lanes (``test_torch_arith.check_both``).  The eight
groups of ``workloads.build_alu_group`` are held the
same way, clean and with their corrupted lane."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "evm"))

from zkevm_specs_tpu.evm import ExecutionState as JES  # noqa: E402
from zkevm_specs_tpu.evm import StepState as JStepState  # noqa: E402
from zkevm_specs_tpu.evm import Tables as JTables  # noqa: E402
from zkevm_specs_tpu.evm.main import _run_group as j_run_group  # noqa: E402
from zkevm_specs_tpu_torch import workloads  # noqa: E402
from zkevm_specs_tpu_torch.evm.main import _run_group as p_run_group  # noqa: E402
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier  # noqa: E402
from zkevm_specs_tpu_torch.tables.container import Tables as PTables  # noqa: E402

from common import rand_word  # noqa: E402
from test_arith_family import AB, MAX_NEG, MAX_POS, NEG_SIGN, U256M, to_signed, from_signed  # noqa: E402
from test_torch_arith import _with_bad, check_both  # noqa: E402

torch.set_num_threads(1)


# -- LT / GT / EQ ----------------------------------------------------------------------

CMP = {"LT": lambda a, b: int(a < b), "GT": lambda a, b: int(a > b),
       "EQ": lambda a, b: int(a == b)}


@pytest.mark.parametrize("op", sorted(CMP))
def test_cmp(op):
    """test_cmp's and test_cmp_nasty's vectors (AB holds both sets), and a
    wrong result."""
    vectors, bad = _with_bad([([a, b], [CMP[op](a, b)]) for a, b in AB],
                             [([3, 5], [1 - CMP[op](3, 5)]), ([7, 7], [2])])
    check_both("CMP", op, vectors, bad)


# -- SLT / SGT -------------------------------------------------------------------------

SCMP = {"SLT": lambda a, b: int(to_signed(a) < to_signed(b)),
        "SGT": lambda a, b: int(to_signed(a) > to_signed(b))}
_SCMP_EXTRA = [(MAX_NEG, MAX_NEG), (MAX_NEG, MAX_POS), (MAX_POS, MAX_NEG),
               (MAX_POS, MAX_POS), (MAX_NEG, 0), (0, MAX_NEG)]


@pytest.mark.parametrize("op", sorted(SCMP))
def test_scmp(op):
    """test_scmp's and test_scmp_nasty's vectors, and wrong results (one of
    them a result of 2^248, whose top byte the gadget requires zero)."""
    good = [([a, b], [SCMP[op](a, b)]) for a, b in AB + _SCMP_EXTRA]
    vectors, bad = _with_bad(good, [([MAX_NEG, 0], [1 - SCMP[op](MAX_NEG, 0)]),
                                    ([1, 2], [1 << 248])])
    check_both("SCMP", op, vectors, bad)


# -- ISZERO / NOT ----------------------------------------------------------------------

def test_iszero():
    vectors, bad = _with_bad([([a], [int(a == 0)]) for a in [0, 1, 5, U256M, rand_word()]],
                             [([0], [0]), ([9], [1])])
    check_both("ISZERO", "ISZERO", vectors, bad)


def test_not():
    vectors, bad = _with_bad([([a], [a ^ U256M]) for a in [0, 1, U256M, rand_word()]],
                             [([0], [U256M - 1]), ([1 << 200], [0])])
    check_both("NOT", "NOT", vectors, bad)


# -- AND / OR / XOR --------------------------------------------------------------------

BITWISE = {"AND": lambda a, b: a & b, "OR": lambda a, b: a | b, "XOR": lambda a, b: a ^ b}


@pytest.mark.parametrize("op", sorted(BITWISE))
def test_bitwise(op):
    """test_bitwise's and test_bitwise_nasty's vectors, and
    test_bitwise_bad's wrong result in each opcode."""
    vectors, bad = _with_bad([([a, b], [BITWISE[op](a, b)]) for a, b in AB],
                             [([6, 3], [BITWISE[op](6, 3) ^ 1])])
    check_both("BITWISE", op, vectors, bad)


def test_bitwise_bad():
    check_both("BITWISE", "AND", [([6, 3], [7])], (0,))


# -- BYTE ------------------------------------------------------------------------------

def _byte(a, b):
    return (b >> (8 * (31 - a))) & 0xFF if a < 32 else 0


def test_byte():
    """test_byte's and test_byte_nasty's vectors (AB), every index of one
    word, and wrong results."""
    w = rand_word()
    good = [([a, b], [_byte(a, b)]) for a, b in AB] + [([i, w], [_byte(i, w)]) for i in range(33)]
    vectors, bad = _with_bad(good, [([31, 0x1FF], [0xFE]), ([32, U256M], [1])])
    check_both("BYTE", "BYTE", vectors, bad)


# -- SAR -------------------------------------------------------------------------------

def _sar(shift, a):
    sa = to_signed(a)
    return from_signed(sa >> shift) if shift < 256 else (U256M if sa < 0 else 0)


_SAR = {
    "family": [(0, 1), (1, 2), (8, from_signed(-256)), (255, from_signed(-1)),
               (256, from_signed(-5)), (300, 12345), (7, rand_word()), (170, rand_word())],
    # test_sar_reference_vectors: reference test_sar.py and EIP-145
    "reference": [
        (8, 0x1234), (NEG_SIGN + 8, 0x1234), (17, 0x5678), (0, 0xABCD),
        (256, 0xFFFF), (265, 0x12345),
        (8, NEG_SIGN + 0x1234), (NEG_SIGN + 8, NEG_SIGN + 0x1234),
        (17, NEG_SIGN + 0x5678), (0, NEG_SIGN + 0xABCD),
        (256, NEG_SIGN + 0xFFFF), (265, NEG_SIGN + 0x12345),
        (8, MAX_NEG), (129, MAX_NEG), (300, MAX_NEG),
        (8, MAX_POS), (129, MAX_POS), (300, MAX_POS),
        (MAX_NEG, MAX_NEG), (MAX_NEG, MAX_POS), (MAX_POS, MAX_NEG), (MAX_POS, MAX_POS),
        (0, 1), (1, 1), (1, 0), (1, NEG_SIGN), (0xFF, NEG_SIGN),
        (0x100, NEG_SIGN), (0x101, NEG_SIGN),
        (0, MAX_NEG), (1, MAX_NEG), (0xFF, MAX_NEG), (0x100, MAX_NEG),
        (0xFE, 2**254), (0xF8, MAX_POS), (0xFE, MAX_POS),
    ],
}


@pytest.mark.parametrize("vectors", sorted(_SAR))
def test_sar(vectors):
    good = [([s, a], [_sar(s, a)]) for s, a in _SAR[vectors]]
    vectors, bad = _with_bad(good, [([4, NEG_SIGN], [_sar(4, NEG_SIGN) ^ 1]),
                                    ([300, MAX_NEG], [0])])
    check_both("SAR", "SAR", vectors, bad)


# -- SIGNEXTEND ------------------------------------------------------------------------

def _signextend(index, value):
    if index < 31:
        bit = 8 * index + 7
        if (value >> bit) & 1:
            return value | (U256M ^ ((1 << (bit + 1)) - 1))
        return value & ((1 << (bit + 1)) - 1)
    return value


_SIGNEXTEND = {
    "family": [(0, 0xFF), (0, 0x7F), (1, 0xFF80), (15, rand_word()), (31, rand_word()),
               (32, rand_word()), (300, rand_word())],
    # test_signextend_reference_vectors: reference test_signextend.py
    "reference": [(0, 0x12), (1, 0x1234), (16, 0x12345678 << 100), (31, U256M),
                  (NEG_SIGN, 0x1234), (NEG_SIGN + 5, NEG_SIGN + 0x1234),
                  (0, NEG_SIGN + 0xFF), (15, NEG_SIGN + (0x80 << 120))],
}


@pytest.mark.parametrize("vectors", sorted(_SIGNEXTEND))
def test_signextend(vectors):
    check_both("SIGNEXTEND", "SIGNEXTEND",
               [([i, v], [_signextend(i, v)]) for i, v in _SIGNEXTEND[vectors]])


@pytest.mark.parametrize("index,value,wrong", [
    (0, 0xFF, 0xFF),                  # the sign not extended
    (1, 0x7F80, U256M),               # extended from the wrong byte
    (0, 0x12, 0x13),                  # a wrong result byte
])
def test_signextend_unconstrained_byte(index, value, wrong):
    """The gadget keeps the reference's ``is_equal`` calls on the result
    bytes, which constrain nothing, so a wrong result passes in both
    packages, as long as the sign-byte lookup of the selected byte holds."""
    assert wrong != _signextend(index, value)
    check_both("SIGNEXTEND", "SIGNEXTEND", [([index, value], [wrong])])


# -- the eight groups of workloads.build_alu_group -------------------------------------

def _groups_both(name, n, corrupt_lane, monkeypatch):
    """``workloads.build_alu_group``'s witness rows as both packages'
    tables and steps."""
    monkeypatch.setattr(workloads, "Tables", lambda **kw: kw)
    rows, steps, nexts = workloads.build_alu_group(name, n, seed=2, corrupt_lane=corrupt_lane)
    monkeypatch.undo()

    def jstep(s):
        return JStepState(JES[s.execution_state.name], s.rw_counter, call_id=s.call_id,
                          is_root=s.is_root, code_hash=s.code_hash,
                          program_counter=s.program_counter, stack_pointer=s.stack_pointer,
                          gas_left=s.gas_left)

    jchain = [jstep(s) for pair in zip(steps, nexts) for s in pair]
    return (PTables(**rows), [s for pair in zip(steps, nexts) for s in pair],
            JTables(**rows), jchain)


@pytest.mark.parametrize("corrupt", [None, 6])
@pytest.mark.parametrize("name", sorted(workloads.ALU_GROUPS))
def test_alu_group_workload_matches_jax(name, corrupt, monkeypatch):
    """Each group at 16 lanes (``build_alu_group``): both packages' spec runs fail the
    same lanes with the same messages, only the corrupted lane, and the
    port's replay fails it alone too."""
    ptables, chain, jtables, jchain = _groups_both(name, 16, corrupt, monkeypatch)
    state = workloads.ALU_GROUPS[name][0]
    lanes = list(range(0, len(chain), 2))
    jout, pout = {}, {}
    j_run_group(jtables, jchain, JES[state.name], False, False, lanes, [], jout)
    p_run_group(ptables, chain, state, False, False, lanes, [], pout)
    assert pout == jout
    assert sorted(pout) == ([] if corrupt is None else [2 * corrupt])
    v = CompiledGroupVerifier(ptables, state, chain[0::2], chain[1::2], device="cpu")
    fail = v(*v.prepare_inputs(chain[0::2], chain[1::2]))
    assert torch.nonzero(fail).flatten().tolist() == ([] if corrupt is None else [corrupt])


def test_alu_group_operands_reach_both_sides_of_the_selectors():
    """The shaped operands: BYTE indexes past 31, SIGNEXTEND indexes of 31
    or more, SAR shifts of 256 or more, and ISZERO's zero operands all occur
    at 64 lanes, beside in-range ones."""
    def pops(name):
        _, op, operands_of, *_ = workloads.ALU_GROUPS[name]
        return [operands_of(i, a, b) for i, (a, b) in enumerate(workloads.random_word_pairs(64))]

    assert {a >= 32 for a, _ in pops("BYTE")} == {False, True}
    assert {a >= 31 for a, _ in pops("SIGNEXTEND")} == {False, True}
    assert {a >= 256 for a, _ in pops("SAR")} == {False, True}
    assert {b >> 255 for _, b in pops("SAR")} == {0, 1}
    assert {a == 0 for a, in pops("ISZERO")} == {False, True}


@pytest.mark.parametrize("name", ["SAR", "SIGNEXTEND"])
def test_replay_runs_the_hint_loop_once(name, monkeypatch):
    """The eager trace gives a gadget's host hint loop one int a lane; the
    replay gives it one placeholder, so the loop runs once a replay, not
    once a lane (at 131072 lanes the per-lane loop took most of SAR's
    replay), and the replay still fails exactly the corrupted lane."""
    from zkevm_specs_tpu_torch.evm.instruction import Instruction

    lengths = []
    ints_of = Instruction.ints_of

    def record(self, v):
        out = ints_of(self, v)
        lengths.append((self.ctx.mode, len(out)))
        return out

    monkeypatch.setattr(Instruction, "ints_of", record)
    tables, steps, nexts = workloads.build_alu_group(name, 32, corrupt_lane=9)
    v = CompiledGroupVerifier(tables, workloads.ALU_GROUPS[name][0], steps, nexts, device="cpu")
    traced = list(lengths)
    lengths.clear()
    fail = v(*v.prepare_inputs(steps, nexts))
    assert traced and {n for _, n in traced} == {32}
    assert lengths and set(lengths) == {("replay", 1)}
    assert torch.nonzero(fail).flatten().tolist() == [9]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(workloads.ALU_GROUPS))
def test_jax_hint_replay_agrees_with_spec_mode(name, monkeypatch):
    """The JAX package's jitted hint replay (its ``CompiledGroupVerifier``,
    an XLA compile a group) fails the same lanes as spec mode on each of
    the eight groups, clean and with one corrupted lane, so the port's
    replay is held to spec mode and to the JAX replay alike (unlike
    MULMOD's, which the JAX replay fails on every lane)."""
    from zkevm_specs_tpu.runtime.jit import CompiledGroupVerifier as JVerifier

    for corrupt in (None, 6):
        _, _, jtables, jchain = _groups_both(name, 16, corrupt, monkeypatch)
        v = JVerifier(jtables, JES[workloads.ALU_GROUPS[name][0].name], jchain[0::2],
                      jchain[1::2])
        fail = v(*v.prepare_inputs(jchain[0::2], jchain[1::2]))
        assert [int(i) for i in np.flatnonzero(np.asarray(fail))] == (
            [] if corrupt is None else [corrupt])
