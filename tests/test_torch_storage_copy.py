"""The port's storage, memory and SHA3 gadgets (zkevm_specs_tpu_torch.evm.
execution: storage's SLOAD / SSTORE, memory's MLOAD / MSTORE / MSTORE8,
copy_family's SHA3) and its copy circuit (circuits/copy.py) against the
JAX package, on the CPU, tolerance 0.

The gadgets: every scenario of tests/evm/test_memory_storage.py and
tests/evm/test_storage_matrix.py for these opcodes (offsets across word
boundaries and deep, the SSTORE (value, value_prev, original) lattice warm
and cold, persistent and reverted, SLOAD warm and cold, SHA3 lengths with
a right and a wrong hash, and the wrong-gas, wrong-refund and wrong-value
negatives) is one lane of a signature-uniform group that each package
builds with its own classes (the rw rows, copy events and keccak rows of
the scenario, at the lane's own rw counters) and verifies with its own
``_run_group``: the failure dicts must be equal key for key and message
for message, and hold exactly the negative lanes; the port's replay of the
group (``CompiledGroupVerifier`` on the CPU) must fail exactly those lanes
(``test_torch_arith.check_both``'s three checks).

The copy circuit: tests/test_bytecode_copy_exp.py's memory-to-memory
copies, clean, with a bad value and with padding, and a SHA3 copy event
with an RlcAcc destination: ``copy_kernel`` on ``device="cpu"`` against
the JAX ``check_copy`` row for row, and both spec drivers' verdicts."""
import itertools
import random
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "evm"))

from zkevm_specs_tpu import evm as J  # noqa: E402
from zkevm_specs_tpu.circuits import copy as jcopy  # noqa: E402
from zkevm_specs_tpu.dsl.cs import ConstraintSystem as JCS  # noqa: E402
from zkevm_specs_tpu.dsl.value import Ctx as JCtx  # noqa: E402
from zkevm_specs_tpu.evm.main import _run_group as j_run_group  # noqa: E402
from zkevm_specs_tpu.evm.opcode import constant_gas_cost as j_gas  # noqa: E402
from zkevm_specs_tpu.witness import typing as JY  # noqa: E402
from zkevm_specs_tpu_torch.circuits import copy as pcopy  # noqa: E402
from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState  # noqa: E402
from zkevm_specs_tpu_torch.evm.main import _run_group as p_run_group  # noqa: E402
from zkevm_specs_tpu_torch.evm.opcode import Opcode, constant_gas_cost  # noqa: E402
from zkevm_specs_tpu_torch.evm.step import StepState  # noqa: E402
from zkevm_specs_tpu_torch.ops.keccak import keccak256  # noqa: E402
from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier  # noqa: E402
from zkevm_specs_tpu_torch.tables import schemas as ps  # noqa: E402
from zkevm_specs_tpu_torch.tables.container import Tables  # noqa: E402
from zkevm_specs_tpu_torch.utils.param import (  # noqa: E402
    COLD_SLOAD_COST,
    GAS_COST_COPY_SHA3,
    SLOAD_GAS,
    SSTORE_CLEARS_SCHEDULE,
    SSTORE_RESET_GAS,
    SSTORE_SET_GAS,
    WARM_STORAGE_READ_COST,
)
from zkevm_specs_tpu_torch.witness import typing as PY  # noqa: E402

from common import memory_expansion  # noqa: E402

torch.set_num_threads(1)

_rng = random.Random(14)
P_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def _word():
    return _rng.randrange(1 << 256)


_PORT = SimpleNamespace(Block=PY.Block, Bytecode=PY.Bytecode, RWDictionary=PY.RWDictionary,
                        StepState=StepState, Tables=Tables, ES=ExecutionState,
                        CC=ps.CallContextFieldTag, CopyCircuit=PY.CopyCircuit,
                        Tag=ps.CopyDataTypeTag, KeccakCircuit=PY.KeccakCircuit,
                        copy_circuit_to_table=PY.copy_circuit_to_table, run=p_run_group,
                        gas=lambda op: constant_gas_cost(Opcode[op]))
_JAX = SimpleNamespace(Block=J.Block, Bytecode=J.Bytecode, RWDictionary=J.RWDictionary,
                       StepState=J.StepState, Tables=J.Tables, ES=J.ExecutionState,
                       CC=J.CallContextFieldTag, CopyCircuit=JY.CopyCircuit,
                       Tag=J.CopyDataTypeTag, KeccakCircuit=JY.KeccakCircuit,
                       copy_circuit_to_table=JY.copy_circuit_to_table, run=j_run_group,
                       gas=lambda op: j_gas(J.Opcode[op]))

LANE_STRIDE = 4096   # rw counters a lane (SHA3's longest copy emits 1028 rows)
COPY_R = 0x1F2E3D4C5B6A79880123456789ABCDEF  # the copy events' randomness


# -- the scenarios: each emits one lane's rows at rw counter rwc ----------------------

def memory_scenario(op, offset, value):
    def emit(pkg, rwc, lane):
        is_mload, is_mstore8 = op == "MLOAD", op == "MSTORE8"
        bc = pkg.Bytecode()
        if is_mload:
            bc.push(offset, n_bytes=32).mload().stop()
        else:
            bc.push(value, n_bytes=32).push(offset, n_bytes=32)
            (bc.mstore8() if is_mstore8 else bc.mstore()).stop()
        rw = pkg.RWDictionary(rwc)
        rw.stack_read(1, 1022 if not is_mload else 1023, offset)
        if is_mload:
            rw.stack_write(1, 1023, value)
        else:
            rw.stack_read(1, 1023, value)
        value_bytes = value.to_bytes(32, "little")
        if is_mstore8:
            rw.memory_write(1, offset, value_bytes[0])
        else:
            for i in range(32):
                (rw.memory_read if is_mload else rw.memory_write)(1, offset + i,
                                                                    value_bytes[31 - i])
        next_mem, mem_gas = memory_expansion(0, offset + 1 + (0 if is_mstore8 else 31))
        pc = 33 if is_mload else 66
        return bc, rw, None, [], (
            dict(execution_state=pkg.ES.MEMORY, program_counter=pc,
                 stack_pointer=1023 if is_mload else 1022, gas_left=pkg.gas(op) + mem_gas),
            dict(program_counter=pc + 1, stack_pointer=1023 if is_mload else 1024,
                 memory_word_size=next_mem))
    return emit


def sload_scenario(warm, persistent, value, wrong_value=False):
    def emit(pkg, rwc, lane):
        addr, key = 0xCAFE, 0x1234_5678 + lane
        rev_end = rwc + 491
        bc = pkg.Bytecode().push(key, n_bytes=32).sload().stop()
        rw = (pkg.RWDictionary(rwc)
              .call_context_read(1, pkg.CC.TxId, 1)
              .call_context_read(1, pkg.CC.RwCounterEndOfReversion, 0 if persistent else rev_end)
              .call_context_read(1, pkg.CC.IsPersistent, int(persistent))
              .call_context_read(1, pkg.CC.CalleeAddress, addr)
              .stack_read(1, 1023, key)
              .account_storage_read(addr, key, value, 1, value)
              .stack_write(1, 1023, value + 1 if wrong_value else value)
              .tx_access_list_account_storage_write(
                  1, addr, key, True, warm,
                  rw_counter_of_reversion=None if persistent else rev_end))
        gas = pkg.gas("SLOAD") + (WARM_STORAGE_READ_COST if warm else COLD_SLOAD_COST)
        return bc, rw, None, [], (
            dict(execution_state=pkg.ES.SLOAD, program_counter=33, stack_pointer=1023,
                 gas_left=gas),
            dict(program_counter=34, stack_pointer=1023, reversible_write_counter=1))
    return emit


def _sstore_gas(value, value_prev, original, warm):
    if value == value_prev or value_prev != original:
        gas = SLOAD_GAS
    elif original == 0:
        gas = SSTORE_SET_GAS
    else:
        gas = SSTORE_RESET_GAS
    return gas if warm else gas + COLD_SLOAD_COST


def _sstore_refund(value, value_prev, original, refund_prev=10_000):
    refund = refund_prev
    if value != value_prev:
        if original == value_prev:
            if original != 0 and value == 0:
                refund += SSTORE_CLEARS_SCHEDULE
        else:
            if original != 0:
                if value_prev == 0:
                    refund -= SSTORE_CLEARS_SCHEDULE
                if value == 0:
                    refund += SSTORE_CLEARS_SCHEDULE
            if original == value:
                refund += (SSTORE_SET_GAS if original == 0 else SSTORE_RESET_GAS) - SLOAD_GAS
    return refund


def sstore_scenario(value, value_prev, original, warm, persistent, gas_delta=0,
                    refund_delta=0):
    def emit(pkg, rwc, lane):
        addr, key = 0xCAFE, 0x1234_5678 + lane
        rev_end = rwc + 491
        refund = _sstore_refund(value, value_prev, original) + refund_delta
        bc = pkg.Bytecode().push(value, n_bytes=32).push(key, n_bytes=32).sstore().stop()
        rev = (lambda k: None) if persistent else (lambda k: rev_end - k)
        rw = (pkg.RWDictionary(rwc)
              .call_context_read(1, pkg.CC.TxId, 1)
              .call_context_read(1, pkg.CC.IsStatic, 0)
              .call_context_read(1, pkg.CC.RwCounterEndOfReversion, 0 if persistent else rev_end)
              .call_context_read(1, pkg.CC.IsPersistent, int(persistent))
              .call_context_read(1, pkg.CC.CalleeAddress, addr)
              .stack_read(1, 1022, key)
              .stack_read(1, 1023, value)
              .account_storage_write(addr, key, value, value_prev, 1, original,
                                     rw_counter_of_reversion=rev(0))
              .tx_access_list_account_storage_write(1, addr, key, True, warm,
                                                    rw_counter_of_reversion=rev(1))
              .tx_refund_write(1, refund, 10_000, rw_counter_of_reversion=rev(2)))
        gas = pkg.gas("SSTORE") + _sstore_gas(value, value_prev, original, warm) + gas_delta
        return bc, rw, None, [], (
            dict(execution_state=pkg.ES.SSTORE, program_counter=66, stack_pointer=1022,
                 gas_left=gas),
            dict(program_counter=67, stack_pointer=1024, reversible_write_counter=3))
    return emit


def sha3_scenario(offset, length, corrupt_hash=False):
    def emit(pkg, rwc, lane):
        data = bytes((10 + i + lane) % 256 for i in range(length))
        out = int.from_bytes(keccak256(data), "big")
        if corrupt_hash:
            out = (out + 1) % (1 << 256)
        bc = pkg.Bytecode().push(length, n_bytes=32).push(offset, n_bytes=32).sha3().stop()
        rw = (pkg.RWDictionary(rwc).stack_read(1, 1022, offset).stack_read(1, 1023, length)
              .stack_write(1, 1023, out))
        cc = pkg.CopyCircuit()
        kc = pkg.KeccakCircuit()
        if length:
            cc.copy(COPY_R, rw, 1, pkg.Tag.Memory, 1, pkg.Tag.RlcAcc, offset, offset + length,
                    0, length, {offset + i: data[i] for i in range(length)})
        kc.add(data, COPY_R)
        next_mem, mem_gas = memory_expansion(0, offset + length if length else 0)
        gas = pkg.gas("SHA3") + mem_gas + GAS_COST_COPY_SHA3 * ((length + 31) // 32)
        return bc, rw, cc, kc.rows, (
            dict(execution_state=pkg.ES.SHA3, program_counter=66, stack_pointer=1022,
                 gas_left=gas),
            dict(program_counter=67, stack_pointer=1023, memory_word_size=next_mem))
    return emit


def build(pkg, scenarios):
    """One lane a scenario, at rw counters LANE_STRIDE apart: (tables,
    the chain step_0, next_0, step_1, ..., state)."""
    rw_rows, bc_rows, copy_rows, keccak_rows, chain = [], [], [], [], []
    for lane, emit in enumerate(scenarios):
        rwc = 9 + LANE_STRIDE * lane
        bc, rw, cc, kc, (curr, nxt) = emit(pkg, rwc, lane)
        h = bc.hash()
        rw_rows += rw.rws
        bc_rows += bc.table_assignments()
        if cc is not None:
            copy_rows += pkg.copy_circuit_to_table(cc)
        keccak_rows += kc
        n_rw = rw.rw_counter - rwc
        chain += [pkg.StepState(rw_counter=rwc, call_id=1, is_root=True, code_hash=h, **curr),
                  pkg.StepState(execution_state=pkg.ES.STOP, rw_counter=rwc + n_rw, call_id=1,
                                is_root=True, code_hash=h, gas_left=0, **nxt)]
    tables = pkg.Tables(block_table=pkg.Block().table_assignments(), bytecode_table=bc_rows,
                        rw_table=rw_rows, copy_table=copy_rows, keccak_table=keccak_rows)
    return tables, chain, chain[0].execution_state


def check_both(scenarios, bad=()):
    """Both packages' spec runs over the lanes give the same failure dict,
    key for key and message for message, whose lanes are exactly ``bad``;
    the port's replay of the lanes fails exactly those lanes too."""
    failures = []
    for pkg in (_JAX, _PORT):
        tables, chain, es = build(pkg, scenarios)
        out = {}
        pkg.run(tables, chain, es, False, False, list(range(0, len(chain), 2)), [], out)
        failures.append(out)
    assert failures[1] == failures[0]
    assert sorted(failures[1]) == [2 * lane for lane in bad], failures[1]
    tables, chain, es = build(_PORT, scenarios)
    v = CompiledGroupVerifier(tables, es, chain[0::2], chain[1::2], device="cpu")
    fail = v(*v.prepare_inputs(chain[0::2], chain[1::2]))
    assert torch.nonzero(fail).flatten().tolist() == list(bad)
    return v


# -- MLOAD / MSTORE / MSTORE8 ------------------------------------------------------------

MEMORY_VECTORS = {
    "MLOAD": [0, 100, 1, 31, 32, 0x1FE0],
    "MSTORE": [0, 77, 1, 31, 33, 0x3FFF],
    "MSTORE8": [5, 0, 31, 32, 3],
}
NASTY = [(1 << 256) - 1, 1 << 255, 0]


@pytest.mark.parametrize("op", sorted(MEMORY_VECTORS))
def test_memory(op):
    """test_memory's offsets (word-boundary crossings, deep offsets) with
    random and nasty values; MLOAD and MSTORE8 branch differently from
    MSTORE, so each opcode is its own group."""
    vectors = [(off, _word()) for off in MEMORY_VECTORS[op]] + [(0, v) for v in NASTY]
    check_both([memory_scenario(op, off, v) for off, v in vectors])


# -- SLOAD / SSTORE --------------------------------------------------------------------------

@pytest.mark.parametrize("persistent", [True, False])
def test_sload(persistent):
    """test_sload's and test_sload_matrix's warm/cold lanes (a narrow, a
    wide and a zero value), and a wrong pushed value."""
    vals = [0xDEAD_BEEF, (1 << 256) - 0x1234, 0, _word()]
    scenarios = [sload_scenario(w, persistent, v) for w in (True, False) for v in vals]
    check_both(scenarios + [sload_scenario(True, persistent, 5, wrong_value=True)],
               bad=(len(scenarios),))


LATTICE = sorted(set(itertools.product([0, 60, 200], repeat=3)))


@pytest.mark.parametrize("persistent", [True, False])
@pytest.mark.parametrize("warm", [True, False])
def test_sstore_lattice(warm, persistent):
    """test_sstore_matrix's (value, value_prev, original) lattice over
    {0, 60, 200}, and test_sstore's four cases with wide words."""
    wide = [(_word(), 0, 0), (0, _word(), 7), (100, 50, 0), (100, 100, 100)]
    scenarios = [sstore_scenario(v, vp, o, warm, persistent) for v, vp, o in LATTICE + wide]
    check_both(scenarios)


def test_sstore_wrong_gas_and_refund_rejected():
    good = [sstore_scenario(60, 0, 0, True, True), sstore_scenario(0, 60, 60, False, True)]
    check_both(good + [sstore_scenario(60, 0, 0, True, True, gas_delta=1),
                       sstore_scenario(0, 60, 60, False, True, refund_delta=1)], bad=(2, 3))


# -- SHA3 ---------------------------------------------------------------------------------

def test_sha3():
    """test_sha3's nonzero lengths (word-aligned, unaligned multi-word),
    each with a right and a wrong hash."""
    cases = [(0, 5), (0x20, 0x40), (0x101, 0x202)]
    scenarios = [sha3_scenario(o, n) for o, n in cases]
    check_both(scenarios + [sha3_scenario(o, n, corrupt_hash=True) for o, n in cases],
               bad=(3, 4, 5))


def test_sha3_zero_length():
    """test_sha3's zero lengths, at offset 0 and deep: no copy event, the
    keccak lookup of the empty input (its own branch of
    ``memory_offset_and_length``)."""
    check_both([sha3_scenario(0, 0), sha3_scenario(0x202, 0),
                sha3_scenario(0, 0, corrupt_hash=True)], bad=(2,))


def test_replay_runs_no_hint_loop():
    """``test_torch_alu_gadgets.test_replay_runs_the_hint_loop_once``'s
    pattern: none of the new gadgets has a per-lane host hint loop, so
    neither the trace nor the replay asks for a lane's ints, and the replay
    still fails exactly the corrupted lane."""
    from zkevm_specs_tpu_torch.evm.instruction import Instruction

    calls = []
    orig = Instruction.ints_of
    Instruction.ints_of = lambda self, v: calls.append(self.ctx.mode) or orig(self, v)
    try:
        v = check_both([sstore_scenario(60, 0, 0, True, True)] * 3
                       + [sstore_scenario(60, 0, 0, True, True, gas_delta=1)], bad=(3,))
        assert v.n_hints > 0
        check_both([sha3_scenario(0, 40)] * 2 + [sha3_scenario(0, 40, corrupt_hash=True)],
                   bad=(2,))
    finally:
        Instruction.ints_of = orig
    assert calls == []


def test_buffer_reader_hint_loop_runs_once_in_a_replay():
    """``evm/gadgets/memory_gadget.py``'s BufferReaderGadget: its distance
    hints are one int a lane in the eager pass, recorded, and replayed from
    the stream, where the loop runs once on one placeholder; its
    constraints hold on a good buffer and fail where a byte past the end
    is nonzero."""
    from zkevm_specs_tpu_torch.dsl.cs import ConstraintSystem
    from zkevm_specs_tpu_torch.dsl.value import Ctx, F
    from zkevm_specs_tpu_torch.evm.gadgets.memory_gadget import BufferReaderGadget
    from zkevm_specs_tpu_torch.evm.instruction import Instruction

    starts, ends, lefts = [0, 10, 7, 3], [4, 10, 40, 5], [4, 2, 8, 4]
    lengths = []
    orig = Instruction.ints_of

    def run(mode, record=None):
        ctx = Ctx("cpu", 4, mode)
        cs = ConstraintSystem(ctx)
        if record is None:
            cs.hint_record, cs.hint_bits = [], []
        else:
            cs.hint_replay, cs.hint_bits = record
        inst = Instruction(ctx, cs, Tables(), None, None, False, False)
        g = BufferReaderGadget(inst, 8, F.from_ints(ctx, starts, 64), F.from_ints(ctx, ends, 64),
                               F.from_ints(ctx, lefts, 64))
        for i in range(8):
            # lane 0 reads its 4 bytes, then a nonzero byte past the end
            g.constrain_byte(i, F.from_ints(ctx, [int(i <= 4), 0, 0, 0], 8))
        return cs, g

    Instruction.ints_of = lambda self, v: lengths.append((self.ctx.mode, len(orig(self, v))))\
        or orig(self, v)
    try:
        cs, g = run("eager")
        traced = list(lengths)
        lengths.clear()
        cs2, g2 = run("replay", (cs.hint_record, cs.hint_bits))
    finally:
        Instruction.ints_of = orig
    assert traced == [("eager", 4), ("eager", 4)]
    assert lengths == [("replay", 1), ("replay", 1)]
    assert cs.fail.tolist() == cs2.fail.tolist() == [True, False, False, False]
    assert g.num_bytes().to_ints() == [4, 2, 8, 4]
    assert torch.equal(g2.num_bytes().limbs, g.num_bytes().limbs)
    assert all(torch.equal(a.limbs, b.limbs) for a, b in zip(g2.bound_dist, g.bound_dist))


# -- the copy circuit -------------------------------------------------------------------

def _memory_copy(pkg, kind):
    """tests/test_bytecode_copy_exp.py's copies in ``pkg``'s classes:
    (copy circuit, tables, must fail)."""
    rw = pkg.RWDictionary(10)
    if kind == "padding":
        cc = pkg.CopyCircuit().copy(COPY_R, rw, 1, pkg.Tag.Memory, 2, pkg.Tag.Memory,
                                    0, 4, 0, 8, {i: 9 for i in range(4)})
    elif kind == "sha3":
        data = bytes(range(3, 43))
        cc = pkg.CopyCircuit().copy(COPY_R, rw, 1, pkg.Tag.Memory, 1, pkg.Tag.RlcAcc,
                                    0, 40, 0, 40, dict(enumerate(data)))
    else:
        cc = pkg.CopyCircuit().copy(COPY_R, rw, 1, pkg.Tag.Memory, 2, pkg.Tag.Memory,
                                    0, 8, 0, 8, {i: (i * 7 + 1) % 256 for i in range(8)})
    if kind == "bad_value":
        cc.rows[3]["value"] = (cc.rows[3]["value"] + 1) % 256
    if kind == "rlc_acc":
        cc = _memory_copy(pkg, "sha3")[0]
        for row in cc.rows:
            row["rlc_acc"] = (row["rlc_acc"] + 1) % P_FR
    tx_rows = (JY if pkg is _JAX else PY).Transaction().table_assignments()
    tables = pkg.Tables(block_table=pkg.Block().table_assignments(), tx_table=tx_rows,
                        rw_table=rw.rws)
    return cc, tables, kind in ("bad_value", "rlc_acc")


@pytest.mark.parametrize("kind", ["clean", "bad_value", "padding", "sha3", "rlc_acc"])
def test_copy_circuit_matches_jax(kind):
    jcc, jtables, must_fail = _memory_copy(_JAX, kind)
    pcc, ptables, _ = _memory_copy(_PORT, kind)
    assert pcc.rows == jcc.rows
    assert PY.copy_circuit_to_table(pcc) == JY.copy_circuit_to_table(jcc)
    rows = jcc.table()
    ctx = JCtx(np, len(rows), "eager")
    cs = JCS(ctx)
    jcopy.check_copy(ctx, cs, jcopy.build_copy_cols(ctx, rows),
                     {n: getattr(jtables.with_ctx(ctx), n) for n in jcopy._LOOKUP_TABLES},
                     {"r": COPY_R}, {})
    want = np.asarray(cs.fail)
    got = pcopy.copy_kernel(pcc, ptables, COPY_R, device="cpu")().numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() == must_fail
    for mod, cc, tables in ((jcopy, jcc, jtables), (pcopy, pcc, ptables)):
        mod.verify_copy_table(cc, tables, COPY_R, success=not must_fail)


def test_copy_kernel_searches_prebuilt_indexes():
    """The copy check's lookups come in the schemas' column order, so the
    device check searches the indexes built on the host and builds none."""
    from zkevm_specs_tpu_torch.tables import engine

    cc, tables, _ = _memory_copy(_PORT, "sha3")
    k = pcopy.copy_kernel(cc, tables, COPY_R, device="cpu")
    built = []
    orig = engine.lookup_fingerprint
    engine.lookup_fingerprint = lambda *a: built.append(a) or orig(*a)
    try:
        assert not k().any()
    finally:
        engine.lookup_fingerprint = orig
    assert built == []
    assert pcopy.copy_kernel(PY.CopyCircuit(), tables, COPY_R, device="cpu") is None
