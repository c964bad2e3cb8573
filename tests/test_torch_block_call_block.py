"""The call block and the mega conformance block through the port's tracer
and block verifier, against the JAX package, on the CPU, tolerance 0.

``workloads.build_call_block(4, 3)``: the call block at 4 txs x 3 rounds
(a router calling 0xC0DE with CALL, STATICCALL, DELEGATECALL and CALLCODE,
its return data copied into the next round's args; then a transfer to
0xC0DE, a 3-deep call through 0xB0B and a call to 0xDEAD, which writes and
reverts; the last tx reverting at its root), traced by both packages (equal
witnesses row for row) and verified by both (the JAX verifier's failure
dict in spec mode, key for key, on both of the port's device passes),
clean and with the two edits the card run makes at full size: the first
restored caller GasLeft + 1, failing at the CALL that saves it and the state
row of the halt that reads it back, and the value of the first tx's mirror
of 0xDEAD's SSTORE + 1, failing at that SSTORE step alone.

tests/test_block_conformance.py:test_block_conformance_mega runs as that
file's own test body through tests/test_torch_block_calls.py's
interception, and its block is ``workloads.build_conformance_mega_block``.
A call to a precompile is refused by the port's tracer, naming it."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from zkevm_specs_tpu.tables import schemas as js  # noqa: E402
from zkevm_specs_tpu.witness import tracer as JT  # noqa: E402
from zkevm_specs_tpu.witness import typing as JY  # noqa: E402
from zkevm_specs_tpu_torch import workloads  # noqa: E402
from zkevm_specs_tpu_torch.evm.execution_state import ExecutionState  # noqa: E402
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier  # noqa: E402
from zkevm_specs_tpu_torch.witness import tracer as PT  # noqa: E402
from zkevm_specs_tpu_torch.witness import typing as PY  # noqa: E402

import test_block_conformance  # noqa: E402
import test_torch_block_calls as C  # noqa: E402
from test_torch_block_flow import jax_txs  # noqa: E402
from test_torch_tracer import assert_same_witness  # noqa: E402

torch.set_num_threads(1)

SMALL_CALLS = (4, 3)


def test_conformance_mega_block_matches_jax(monkeypatch):
    it = C.run_body(test_block_conformance, "test_block_conformance_mega", monkeypatch)
    jw, pw, _ = it.traced[0]
    states = {s.execution_state for s in pw.steps}
    assert {ExecutionState.CALL_OP, ExecutionState.RETURN, ExecutionState.RETURNDATACOPY} <= states
    # the block the card holds against the CPU is this one
    mega = workloads.build_conformance_mega_block()
    assert_same_witness(jw, mega)
    bv = CompiledBlockVerifier(mega, device="cpu")
    assert bv.run_device_combined(bv.prepare()) == {}


def call_block_sides():
    ptxs = workloads.call_block_txs(*SMALL_CALLS)
    pw = workloads.build_call_block(*SMALL_CALLS)
    accounts = {a.address: JY.Account(address=a.address, balance=a.balance,
                                      code=JY.Bytecode(bytearray(bytes(a.code.code))))
                for a in workloads.call_accounts(SMALL_CALLS[0]).values()}
    jw = JT.trace_block(JY.Block(**workloads.FLOW_BLOCK_HEADER), jax_txs(ptxs),
                        accounts=accounts)
    return jw, pw


def _step_of(w, rw_counter, state):
    """The step of ``state`` whose rw rows hold ``rw_counter``."""
    return max(i for i, s in enumerate(w.steps)
               if s.execution_state.name == state and s.rw_counter <= rw_counter)


def restored_gas_left(w):
    """The first restored caller GasLeft row + 1: the first call-context
    write of a GasLeft, the one the first CALL saves and its callee's halt
    reads back (tests/test_block_calls.py:test_call_corrupt_restore_rejected).
    Returns the keys that must fail: that CALL step and the state row of
    the read."""
    CC, T = js.CallContextFieldTag, js.Target
    rows = w.rw.rws
    k = next(k for k, r in enumerate(rows) if r["key0"] == int(T.CallContext)
             and r["rw"] == 1 and r["address"] == int(CC.GasLeft))
    row = rows[k]
    row["value"] += 1
    read = next(r for r in rows[k + 1:] if r["key0"] == int(T.CallContext) and r["rw"] == 0
                and r["id"] == row["id"] and r["address"] == int(CC.GasLeft))
    return {_step_of(w, row["rw_counter"], "CALL_OP")}, read["rw_counter"]


def dead_sstore_mirror(w):
    """The value of the first tx's mirror of 0xDEAD's SSTORE (its write back
    to 0) + 1, as tests/test_block_revert.py:
    test_block_root_revert_corrupt_mirror_rejected edits a mirror.  Returns
    the keys that must fail: the SSTORE step that looks the mirror up."""
    rows = w.rw.rws
    mirror = next(r for r in rows if r["key0"] == int(js.Target.AccountStorage) and r["rw"] == 1
                  and r["address"] == workloads.CALL_REVERTING and r["value_prev"] == 1)
    write = next(r for r in rows if r["key0"] == mirror["key0"] and r["rw"] == 1
                 and r["id"] == mirror["id"] and r["address"] == mirror["address"]
                 and r["storage_key"] == mirror["storage_key"] and r["value"] == 1)
    mirror["value"] += 1
    return {_step_of(w, write["rw_counter"], "SSTORE")}, None


EDITS = {"restored_gas_left": restored_gas_left, "dead_sstore_mirror": dead_sstore_mirror}


@pytest.mark.parametrize("edit", [None, *EDITS])
def test_call_block_matches_jax(edit):
    jw, pw = call_block_sides()
    assert_same_witness(jw, pw)
    keys = None
    if edit is not None:
        keys, state_read = EDITS[edit](jw)
        assert EDITS[edit](pw) == (keys, state_read)
    want = C.verify_both(jw, pw)
    if edit is None:
        assert want == {}
        return
    if state_read is not None:
        bv = CompiledBlockVerifier(pw, device="cpu")
        keys |= {("state", k) for k, r in enumerate(bv._state_rows)
                 if r["rw_counter"] == state_read}
    assert set(want) == keys


def test_call_block_shape():
    """Every call opcode, a halt in each frame kind, the 3-deep call stack,
    the reverting callee and the root REVERT of the last tx."""
    w = workloads.build_call_block(*SMALL_CALLS)
    states = {s.execution_state for s in w.steps}
    assert {ExecutionState.CALL_OP, ExecutionState.RETURN, ExecutionState.RETURNDATACOPY,
            ExecutionState.CALLDATACOPY, ExecutionState.CALLDATALOAD,
            ExecutionState.SSTORE} <= states
    assert w.tx_success == [True] * (SMALL_CALLS[0] - 1) + [False]
    CC, T = js.CallContextFieldTag, js.Target
    depths = {r["value"] for r in w.rw.rws if r["key0"] == int(T.CallContext)
              and r["address"] == int(CC.Depth)}
    assert depths == {1, 2, 3}
    ops = {bytes(bc.code)[i] for bc in w.bytecodes for i in range(len(bc.code))
           if bc.is_code[i]}
    assert {0xF1, 0xF2, 0xF4, 0xFA, 0xF3, 0xFD} <= ops


def test_call_to_a_precompile_raises_naming_it():
    """A call to 0x04 (the identity precompile) is refused, as are the
    precompiles until they are ported."""
    bc = PY.Bytecode().push1(0).push1(0).push1(0).push1(0).push1(0).push1(4).push2(0xFFFF)
    bc = bc.call().pop().stop()
    tx = PY.Transaction(id=1, gas=100000, caller_address=0xFE, callee_address=0xFF)
    with pytest.raises(NotImplementedError, match="DATACOPY"):
        PT.trace_block(PY.Block(), [(tx, bc)])
