"""The port's arithmetic gadgets (zkevm_specs_tpu_torch.evm.execution:
mul_div_mod's MUL/DIV/MOD lanes, sdiv_smod, addmod, mulmod, exp, shl_shr)
against the JAX package, on the CPU, tolerance 0.

Every vector of tests/evm/test_arith_family.py for these opcodes (and the
EXP vectors of tests/evm/test_copy_log_exp_extcode.py), positive and
negative, is one lane of a group built as the same witness with each
package's own classes (tests/evm/helpers.py:run_opcode's shape, a bytecode
and rw rows per lane) and verified by each package's ``_run_group`` in
spec mode: the failure dicts must be equal key for key and message for
message, and hold exactly the negative lanes.  The port's replay of the
group (``CompiledGroupVerifier`` on the CPU, where K11 runs its plain
version) must fail exactly those lanes too."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "evm"))

from zkevm_specs_tpu import evm as J  # noqa: E402
from zkevm_specs_tpu.evm.main import _run_group as j_run_group  # noqa: E402
from zkevm_specs_tpu.evm.opcode import constant_gas_cost as j_gas  # noqa: E402
from zkevm_specs_tpu.utils.param import GAS_COST_EXP_PER_BYTE  # noqa: E402
from zkevm_specs_tpu.witness import typing as JY  # noqa: E402
from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState  # noqa: E402
from zkevm_specs_tpu_torch.evm.main import _run_group as p_run_group  # noqa: E402
from zkevm_specs_tpu_torch.evm.opcode import Opcode  # noqa: E402
from zkevm_specs_tpu_torch.evm.step import StepState  # noqa: E402
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier  # noqa: E402
from zkevm_specs_tpu_torch.tables.container import Tables  # noqa: E402
from zkevm_specs_tpu_torch.witness import typing as PY  # noqa: E402

from common import rand_word  # noqa: E402
from test_arith_family import AB, MAX_NEG, MAX_POS, U256M, _SHIFT_VECTORS, to_signed, from_signed  # noqa: E402

torch.set_num_threads(1)


class _Port:
    """The port's classes under the names tests/evm/helpers.py uses."""
    Block, Bytecode, RWDictionary = PY.Block, PY.Bytecode, PY.RWDictionary
    StepState, Tables, ExecutionState = StepState, Tables, ExecutionState
    ExpCircuit, exp_circuit_to_table = PY.ExpCircuit, PY.exp_circuit_to_table

    @staticmethod
    def gas(op):
        from zkevm_specs_tpu_torch.evm.opcode import constant_gas_cost
        return constant_gas_cost(Opcode[op])


class _Jax:
    Block, Bytecode, RWDictionary = J.Block, J.Bytecode, J.RWDictionary
    StepState, Tables, ExecutionState = J.StepState, J.Tables, J.ExecutionState
    ExpCircuit, exp_circuit_to_table = JY.ExpCircuit, JY.exp_circuit_to_table

    @staticmethod
    def gas(op):
        return j_gas(J.Opcode[op])


def build(pkg, state, op, vectors, dynamic_gas=lambda pops: 0, exp_events=False):
    """``tests/evm/helpers.py:run_opcode``'s witness with ``pkg``'s classes,
    one lane per vector ``(pops, pushes)``, each with its own bytecode and
    rw rows: (tables, the chain step_0, next_0, step_1, ..., state)."""
    rw_rows, bc_rows, exp_table, chain = [], [], [], []
    es = getattr(pkg.ExecutionState, state)
    for lane, (pops, pushes) in enumerate(vectors):
        bytecode = getattr(pkg.Bytecode(), op.lower())(*pops).stop()
        h = bytecode.hash()
        n_pops, n_push = len(pops), len(pushes)
        rwc = 9 + 8 * lane
        sp0 = 1024 - n_pops
        rw = pkg.RWDictionary(rwc)
        for i, v in enumerate(pops):
            rw.stack_read(1, sp0 + i, v)
        sp1 = sp0 + n_pops - n_push
        for i, v in enumerate(pushes):
            rw.stack_write(1, sp1 + i, v)
        rw_rows += rw.rws
        bc_rows += bytecode.table_assignments()
        if exp_events and pops[1] > 1:
            # identifier: the lane's rw counter after 2 pops and 1 push
            exp_table += pkg.exp_circuit_to_table(pkg.ExpCircuit().add_event(*pops, rwc + 3))
        gas = pkg.gas(op) + dynamic_gas(pops)
        chain += [pkg.StepState(es, rwc, call_id=1, is_root=True, is_create=False, code_hash=h,
                                program_counter=33 * n_pops, stack_pointer=sp0, gas_left=gas),
                  pkg.StepState(pkg.ExecutionState.STOP, rwc + n_pops + n_push, call_id=1,
                                is_root=True, is_create=False, code_hash=h,
                                program_counter=33 * n_pops + 1, stack_pointer=sp1,
                                gas_left=0)]
    tables = pkg.Tables(block_table=pkg.Block().table_assignments(), bytecode_table=bc_rows,
                        rw_table=rw_rows, exp_table=exp_table)
    return tables, chain, es


def check_both(state, op, vectors, bad=(), **kw):
    """Both packages' spec runs over the lanes give the same failure dict,
    key for key and message for message, whose lanes are exactly ``bad``;
    the port's replay of the lanes (one ``CompiledGroupVerifier``) fails
    exactly those lanes too."""
    failures = []
    for pkg, run in ((_Jax, j_run_group), (_Port, p_run_group)):
        tables, chain, es = build(pkg, state, op, vectors, **kw)
        out = {}
        run(tables, chain, es, False, False, list(range(0, len(chain), 2)), [], out)
        failures.append(out)
    assert failures[1] == failures[0]
    assert sorted(failures[1]) == [2 * lane for lane in bad], failures[1]
    tables, chain, es = build(_Port, state, op, vectors, **kw)
    v = CompiledGroupVerifier(tables, es, chain[0::2], chain[1::2], device="cpu")
    fail = v(*v.prepare_inputs(chain[0::2], chain[1::2]))
    assert torch.nonzero(fail).flatten().tolist() == list(bad)


# -- MUL / DIV / MOD -----------------------------------------------------------------

def _with_bad(good, bad):
    """The vectors, then the negatives: (vectors, their lane indexes)."""
    return good + bad, tuple(range(len(good), len(good) + len(bad)))


@pytest.mark.parametrize("op", ["MUL", "DIV", "MOD"])
def test_mul_div_mod(op):
    fn = {"MUL": lambda a, b: (a * b) & U256M, "DIV": lambda a, b: a // b if b else 0,
          "MOD": lambda a, b: a % b if b else 0}[op]
    bad = {"MUL": [([3, 5], [16])], "DIV": [([17, 5], [4])], "MOD": [([17, 5], [3])]}[op]
    vectors, bad_lanes = _with_bad([([a, b], [fn(a, b)]) for a, b in AB], bad)
    check_both("MUL", op, vectors, bad_lanes)


# -- SDIV / SMOD ---------------------------------------------------------------------

def _sdiv(a, b):
    sa, sb = to_signed(a), to_signed(b)
    if sb == 0:
        return 0
    q = abs(sa) // abs(sb)
    return from_signed(-q if (sa < 0) != (sb < 0) else q)


def _smod(a, b):
    sa, sb = to_signed(a), to_signed(b)
    if sb == 0:
        return 0
    r = abs(sa) % abs(sb)
    return from_signed(-r if sa < 0 else r)


@pytest.mark.parametrize("op", ["SDIV", "SMOD"])
def test_sdiv_smod(op):
    fn = _sdiv if op == "SDIV" else _smod
    vectors, bad_lanes = _with_bad([([a, b], [fn(a, b)]) for a, b in AB],
                                   [([from_signed(-17), 5], [from_signed(-4 if op == "SDIV" else 2)])])
    check_both("SDIV_SMOD", op, vectors, bad_lanes)


# -- ADDMOD / MULMOD -----------------------------------------------------------------

MOD3 = [(0, 0, 0), (1, 2, 3), (7, 8, 9), (100, 200, 7),
        (U256M, U256M, U256M), (U256M - 1, U256M, 3), (rand_word(), rand_word(), rand_word()),
        (5, 6, 0),
        # the edge lattice of test_addmod_edge / test_mulmod_edge
        (U256M, U256M, 1), (U256M, 1, U256M), (1, U256M, U256M),
        (MAX_NEG, MAX_POS, 2), (MAX_POS, MAX_NEG, 3),
        (U256M, U256M, U256M - 1), (2, 3, U256M)]


@pytest.mark.parametrize("op", ["ADDMOD", "MULMOD"])
def test_addmod_mulmod(op):
    fn = (lambda a, b: a + b) if op == "ADDMOD" else (lambda a, b: a * b)
    # test_addmod_bad's vector, and a wrong result with a zero modulus
    vectors, bad_lanes = _with_bad([([a, b, n], [fn(a, b) % n if n else 0]) for a, b, n in MOD3],
                                   [([1, 2, 3], [1]), ([5, 6, 0], [11])])
    check_both(op, op, vectors, bad_lanes)


# -- SHL / SHR -----------------------------------------------------------------------

_SHIFTS = [(0, 1), (1, 1), (8, 0xFF), (255, 1), (256, 1), (300, U256M),
           (5, rand_word()), (130, rand_word())] + _SHIFT_VECTORS


@pytest.mark.parametrize("op", ["SHL", "SHR"])
def test_shl_shr(op):
    if op == "SHL":
        good = [([s, a], [(a << s) & U256M if s < 256 else 0]) for s, a in _SHIFTS]
        bad = [([4, 0xF0], [0xF01])]
    else:
        good = [([s, a], [a >> s if s < 256 else 0]) for s, a in _SHIFTS]
        bad = [([4, 0xF0], [0xF1])]          # test_shr_bad
    vectors, bad_lanes = _with_bad(good, bad)
    check_both("SHL_SHR", op, vectors, bad_lanes)


# -- EXP -----------------------------------------------------------------------------

def test_exp():
    """tests/evm/test_copy_log_exp_extcode.py's EXP vectors and its wrong
    result (the exp table holds the true event, the stack a result + 1)."""
    good = [(3, 0), (5, 1), (2, 2), (3, 7), (7, 2**15 + 1), (rand_word(), 5), (U256M, 255)]
    vectors, bad_lanes = _with_bad([([b, e], [pow(b, e, 1 << 256)]) for b, e in good],
                                   [([3, 7], [pow(3, 7, 1 << 256) + 1])])
    check_both("EXP", "EXP", vectors, bad_lanes, exp_events=True,
               dynamic_gas=lambda pops: GAS_COST_EXP_PER_BYTE * ((pops[1].bit_length() + 7) // 8))
