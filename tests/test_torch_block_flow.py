"""The root frame's flow, context, account, copy and log opcodes through the
port's tracer and block verifier, against the JAX package, on the CPU,
tolerance 0.

The blocks: tests/test_block_conformance.py's wide, flow and jumpi-taken
blocks (the wide one is ``workloads.build_conformance_block``, every
execution state a root frame runs), ``workloads.build_flow_block(2, 8)``
(the loop block at 2 txs x 8 rounds) clean, with one tx's LOG1 topic + 1,
with one mid-loop CALLDATALOAD's pushed word + 1 and with one CALLDATACOPY
byte + 1 in the copy circuit; and a zero-length RETURNDATACOPY, which the
JAX verifier rejects (its copy lookup is not masked by the size), so the
port must too.  Each is traced by both packages: the witnesses are equal
row for row (``test_torch_tracer.assert_same_witness``), and the port's
``CompiledBlockVerifier(w, device="cpu")`` is held to the JAX verifier in
spec mode by ``test_torch_block``'s checks (the group partition, every
group's lane bits, every circuit's rows, the failure dicts of both device
passes).  tests/test_torch_block_flow_sweeps.py runs the same checks on the
context, log and boundary sweeps' blocks.

Also the error halts of these opcodes: a JUMP to a byte that is not a
JUMPDEST, a LOG, a copy and a BALANCE without the gas for them and a
RETURNDATACOPY past the buffer, traced and verified as the JAX package
does, and a JUMPDEST byte inside PUSH data is no destination."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from zkevm_specs_tpu.tables import schemas as js  # noqa: E402
from zkevm_specs_tpu.witness import tracer as JT  # noqa: E402
from zkevm_specs_tpu.witness import typing as JY  # noqa: E402
from zkevm_specs_tpu_torch import workloads  # noqa: E402
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier  # noqa: E402
from zkevm_specs_tpu_torch.witness import tracer as PT  # noqa: E402
from zkevm_specs_tpu_torch.witness import typing as PY  # noqa: E402

import test_torch_block as B  # noqa: E402
from test_block_conformance import wide_program  # noqa: E402
from test_torch_block_calls import verify_both  # noqa: E402
from test_torch_tracer import assert_same_witness  # noqa: E402

torch.set_num_threads(1)

STEP_SETS = ("ADDRESS", "CALLER", "CALLVALUE", "CALLDATASIZE", "CODESIZE", "GASPRICE", "ORIGIN",
             "SELFBALANCE", "RETURNDATASIZE", "BlockCtx", "GAS", "PC", "MSIZE", "BLOCKHASH",
             "BALANCE", "EXTCODESIZE", "EXTCODEHASH", "EXTCODECOPY", "CALLDATACOPY", "CODECOPY",
             "JUMPDEST", "DUP", "SWAP", "JUMPI", "JUMP", "CALLDATALOAD", "LOG")


def jax_txs(ptxs):
    """The JAX package's classes carrying the port's txs (calldata and
    value included) and codes."""
    return [(JY.Transaction(id=t.id, gas=t.gas, gas_price=t.gas_price,
                            caller_address=t.caller_address, callee_address=t.callee_address,
                            value=t.value, call_data=bytes(t.call_data)),
             JY.Bytecode(bytearray(bytes(bc.code)))) for t, bc in ptxs]


def accounts_of(Y):
    acct = workloads.flow_accounts()[workloads.FLOW_EXT_ACCOUNT]
    return {acct.address: Y.Account(address=acct.address, balance=acct.balance,
                                    code=Y.Bytecode(bytearray(bytes(acct.code.code))))}


def tx_of(Y, i=1, **kw):
    return Y.Transaction(id=i, gas=kw.pop("gas", 100000), gas_price=int(2e9),
                         caller_address=0xFE, callee_address=0xFE + i, **kw)


# -- the blocks: each a function of a package's witness classes, returning
# (block, txs, accounts) -----------------------------------------------------------

def flow_small(Y):
    ptxs = workloads.flow_block_txs(2, 8)
    return (Y.Block(**workloads.FLOW_BLOCK_HEADER), ptxs if Y is PY else jax_txs(ptxs),
            accounts_of(Y))


def conformance_wide(Y):
    bc = workloads.conformance_code() if Y is PY else wide_program().stop()
    tx = Y.Transaction(id=1, gas=1000000, gas_price=int(2e9), caller_address=0xFE,
                       callee_address=0xFF, value=10, call_data=bytes(range(1, 33)))
    return Y.Block(**workloads.FLOW_BLOCK_HEADER), [(tx, bc)], accounts_of(Y)


def conformance_flow(Y):
    # JUMP forward to a JUMPDEST, then a JUMPI not taken falls through
    bc = Y.Bytecode().push1(4).jump().stop().jumpdest()
    bc.push1(0).push1(11).jumpi().push1(1).pop().stop()
    return Y.Block(base_fee=int(1e9)), [(tx_of(Y), bc)], None


def conformance_jumpi_taken(Y):
    bc = Y.Bytecode().push1(1).push1(6).jumpi().stop().jumpdest().stop()
    return Y.Block(base_fee=int(1e9)), [(tx_of(Y), bc)], None


def returndatacopy_zero(Y):
    bc = Y.Bytecode().push1(0).push1(0).push1(0).returndatacopy().stop()
    return Y.Block(base_fee=int(1e9)), [(tx_of(Y), bc)], None


def trace(build, Y, T):
    block, txs, accounts = build(Y)
    return T.trace_block(block, txs, accounts=accounts)


# -- the corruptions, the same edit on either package's witness ----------------------

def _row_at(w, rwc):
    return next(r for r in w.rw.rws if r["rw_counter"] == rwc)


def corrupt_log_topic(w):
    """The LOG1 topic of tx 3 (of the last tx, when the block has fewer) + 1."""
    tx_id = min(3, len(w.txs))
    row = next(r for r in w.rw.rws if r["key0"] == int(js.Target.TxLog) and r["id"] == tx_id
               and (r["address"] >> 32) & 0xFFFF == int(js.TxLogFieldTag.Topic))
    row["value"] = (row["value"] + 1) % (1 << 256)


def corrupt_calldataload_word(w):
    """The word pushed by the middle CALLDATALOAD step (its fourth rw row: the
    offset's pop, TxId, CallDataLength, the push) + 1."""
    steps = [s for s in w.steps if s.execution_state.name == "CALLDATALOAD"]
    row = _row_at(w, steps[len(steps) // 2].rw_counter + 3)
    assert row["key0"] == int(js.Target.Stack) and row["rw"] == int(js.RW.Write)
    row["value"] = (row["value"] + 1) % (1 << 256)


def corrupt_calldatacopy_byte(w):
    """The first CALLDATACOPY event's second write row (a memory byte) + 1, in
    the copy circuit and its memory row alike."""
    rows = w.copy_circuit.rows
    first = next(i for i, r in enumerate(rows)
                 if r["is_first"] and r["tag"] == int(js.CopyDataTypeTag.TxCalldata))
    row = rows[first + 3]
    assert row["q_step"] == 0 and row["is_memory"]
    row["value"] = (row["value"] + 1) % 256
    mem = _row_at(w, row["rw_counter"])
    assert mem["key0"] == int(js.Target.Memory)
    mem["value"] = row["value"]


CORRUPTIONS = {"log_topic": corrupt_log_topic, "calldataload_word": corrupt_calldataload_word,
               "calldatacopy_byte": corrupt_calldatacopy_byte}

BLOCKS = {   # kind: (block, corruption)
    "conformance_wide": (conformance_wide, None),
    "conformance_flow": (conformance_flow, None),
    "conformance_jumpi_taken": (conformance_jumpi_taken, None),
    "flow": (flow_small, None),
    "flow_log_topic": (flow_small, "log_topic"),
    "flow_calldataload_word": (flow_small, "calldataload_word"),
    "flow_calldatacopy_byte": (flow_small, "calldatacopy_byte"),
    "returndatacopy_zero": (returndatacopy_zero, None),
}
MUST_FAIL = {"flow_log_topic", "flow_calldataload_word", "flow_calldatacopy_byte",
             "returndatacopy_zero"}
# the keys each corruption of the small loop block fails at (chip_smoke.py
# holds the full-width block to the same keys, found the same way)
EXPECTED = {
    "flow_log_topic": lambda bv: {_step_of(bv, "LOG", min(3, len(bv.witness.txs)))},
    "flow_calldataload_word": lambda bv: {_step_of(bv, "CALLDATALOAD"),
                                          ("state", _state_row_reading(bv, "CALLDATALOAD"))},
}

_CACHE = {}


def _step_of(bv, name, tx_id=None):
    """The step index of ``name``'s step in tx ``tx_id`` (one such step a
    tx), or of the middle one when None."""
    idxs = [i for i, s in enumerate(bv.witness.steps) if s.execution_state.name == name]
    return idxs[len(idxs) // 2] if tx_id is None else idxs[tx_id - 1]


def _state_row_reading(bv, name):
    """The state-circuit row of the stack read right after the middle
    ``name`` step's push (the SWAP1 that reads the pushed word)."""
    step = bv.witness.steps[_step_of(bv, name)]
    rwc = step.rw_counter + 4
    return next(k for k, r in enumerate(bv._state_rows) if r["rw_counter"] == rwc)


def sides(kind, monkeypatch):
    if kind not in _CACHE:
        build, corruption = BLOCKS[kind]
        jw, pw = trace(build, JY, JT), trace(build, PY, PT)
        if corruption is not None:
            CORRUPTIONS[corruption](jw)
            CORRUPTIONS[corruption](pw)
        pbv = CompiledBlockVerifier(pw, device="cpu")
        jax_side = B.JaxSide(jw, monkeypatch)
        prepared = pbv.prepare()
        _CACHE[kind] = (jax_side, pbv, prepared, pbv._device_pass(prepared))
    return _CACHE[kind]


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_trace_matches_jax(kind):
    build, _ = BLOCKS[kind]
    assert_same_witness(trace(build, JY, JT), trace(build, PY, PT))


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_partition_matches_jax(kind, monkeypatch):
    jax_side, pbv, _, _ = sides(kind, monkeypatch)

    def key(g):
        return (g["state"].name, g["is_first"], g["is_last"], list(g["idxs"]),
                [bool(d) if isinstance(d, (bool, np.bool_)) else int(d) for d in g["signature"]])

    assert [key(g) for g in pbv.groups] == [key(g) for g in jax_side.bv.groups]


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_group_lane_bits_match_jax(kind, monkeypatch):
    jax_side, pbv, _, outs = sides(kind, monkeypatch)
    device_outs = iter(outs)
    for g, want in zip(pbv.groups, jax_side.lanes):
        n = len(g["idxs"])
        got = pbv._run_eager_group(g) if g["verifier"] is None else next(device_outs).numpy()
        np.testing.assert_array_equal(got[:n], want[:n])


@pytest.mark.parametrize("circuit", ("state",) + B.CIRCUITS)
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_circuit_rows_match_jax(kind, circuit, monkeypatch):
    jax_side, pbv, _, outs = sides(kind, monkeypatch)
    names = ["state"] + [name for name, _ in pbv.circuit_kernels]
    assert names == list(jax_side.rows)
    if circuit in names:
        got = outs[len(outs) - len(names) + names.index(circuit)]
        np.testing.assert_array_equal(got.numpy(), jax_side.rows[circuit])


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_failures_match_jax(kind, monkeypatch):
    jax_side, pbv, prepared, _ = sides(kind, monkeypatch)
    want = jax_side.failures()
    assert pbv.run_device(prepared) == want
    assert pbv.run_device_combined(prepared) == want
    assert bool(want) == (kind in MUST_FAIL), sorted(want, key=str)
    if kind in EXPECTED:
        assert set(want) == EXPECTED[kind](pbv)
    if want:
        with pytest.raises(AssertionError, match="block verification failed"):
            pbv.verify()
    else:
        pbv.verify()


def test_wide_block_covers_the_root_frame():
    """The conformance block runs at least 45 execution states, every state
    this slice adds among them (JUMP, JUMPI and RETURNDATACOPY run in the
    other blocks)."""
    w = workloads.build_conformance_block()
    names = {s.execution_state.name for s in w.steps}
    assert len(names) >= 45
    assert set(STEP_SETS) - {"JUMP", "JUMPI"} <= names


def test_flow_block_shape():
    """The loop block: 17 steps and 61 gas a round, the prologue's states
    once a tx, the LOG1's topic and the sum of the calldata words."""
    n_txs, rounds = 2, 8
    w = workloads.build_flow_block(n_txs, rounds)
    count = {}
    for s in w.steps:
        count[s.execution_state.name] = count.get(s.execution_state.name, 0) + 1
    for name, per_round in (("CALLDATALOAD", 1), ("SWAP", 3), ("JUMP", 1), ("ADD", 2)):
        assert count[name] == n_txs * rounds * per_round, name
    for name in ("JUMPDEST", "DUP", "CMP", "ISZERO", "JUMPI"):
        assert count[name] == n_txs * (rounds + 1) + (n_txs if name == "JUMPDEST" else 0), name
    assert count["BlockCtx"] == 7 * n_txs and count["LOG"] == n_txs
    assert set(STEP_SETS) <= set(count)
    gas = [workloads.receipt_gas_used(workloads.build_flow_block(1, r)) for r in (8, 9)]
    assert gas[1] - gas[0] == workloads.FLOW_ITERATION_GAS
    steps = [len(workloads.build_flow_block(1, r).steps) for r in (8, 9)]
    assert steps[1] - steps[0] == workloads.FLOW_ITERATION_STEPS
    data_rows = [r for r in w.rw.rws if r["key0"] == int(js.Target.TxLog)
                 and (r["address"] >> 32) & 0xFFFF == int(js.TxLogFieldTag.Data)]
    for i, tx in enumerate(w.txs):
        word = int.from_bytes(bytes(tx.call_data[4:36]), "little")
        got = bytes(r["value"] for r in data_rows if r["id"] == i + 1)
        assert int.from_bytes(got, "big") == rounds * word % (1 << 256)


def _jax_error_state(bc, gas=100000):
    tx = JY.Transaction(id=1, gas=gas, gas_price=int(2e9), caller_address=0xFE,
                        callee_address=0xFF)
    w = JT.trace_block(JY.Block(), [(tx, bc)], sign=False)
    return [s.execution_state.name for s in w.steps if s.execution_state.name.startswith("Error")]


@pytest.mark.parametrize("case,state", [
    ("jump_to_stop", "ErrorInvalidJump"),
    ("jump_into_push_data", "ErrorInvalidJump"),
    ("jumpi_taken_to_stop", "ErrorInvalidJump"),
    ("log_out_of_gas", "ErrorOutOfGasLOG"),
    ("copy_out_of_gas", "ErrorOutOfGasMemoryCopy"),
    ("balance_out_of_gas", "ErrorOutOfGasAccountAccess"),
    ("returndatacopy_out_of_bound", "ErrorReturnDataOutOfBound"),
])
def test_error_states_raise_where_jax_emits_them(case, state):
    def code(Y):
        return {
            "jump_to_stop": lambda: Y.Bytecode().push1(3).jump().stop(),
            # byte 4 is 0x5B, but PUSH1's data: no destination
            "jump_into_push_data": lambda: Y.Bytecode().push1(4).jump().push1(0x5B).stop(),
            "jumpi_taken_to_stop": lambda: Y.Bytecode().push1(1).push1(5).jumpi().stop(),
            "log_out_of_gas": lambda: Y.Bytecode().push2(64).push1(0).log0().stop(),
            "copy_out_of_gas": lambda: Y.Bytecode().push2(4096).push1(0).push1(0).codecopy(),
            "balance_out_of_gas": lambda: Y.Bytecode().push2(0xCAFE).balance().stop(),
            "returndatacopy_out_of_bound":
                lambda: Y.Bytecode().push1(1).push1(0).push1(0).returndatacopy().stop(),
        }[case]()

    gas = {"log_out_of_gas": 21000 + 6 + 375 + 8 * 64, "copy_out_of_gas": 21000 + 9 + 500,
           "balance_out_of_gas": 21000 + 3 + 2000}.get(case, 100000)
    assert _jax_error_state(code(JY), gas) == [state]

    def txs(Y):
        return [(Y.Transaction(id=1, gas=gas, gas_price=int(2e9), caller_address=0xFE,
                               callee_address=0xFF), code(Y))]

    jw = JT.trace_block(JY.Block(), txs(JY), sign=False)
    pw = PT.trace_block(PY.Block(), txs(PY), sign=False)
    assert_same_witness(jw, pw)
    assert [s.execution_state.name for s in pw.steps if s.execution_state.name == state]
    assert verify_both(jw, pw) == {}


def test_jumps_to_a_jumpdest_trace():
    """The same codes with the destination a JUMPDEST trace in both
    packages, row for row."""
    def txs(Y):
        bc = Y.Bytecode().push1(4).jump().stop().jumpdest().push1(1).push1(11).jumpi()
        bc.stop().jumpdest().stop()
        return [(Y.Transaction(id=1, gas=100000, caller_address=0xFE, callee_address=0xFF), bc)]

    assert_same_witness(JT.trace_block(JY.Block(), txs(JY), sign=False),
                        PT.trace_block(PY.Block(), txs(PY), sign=False))
