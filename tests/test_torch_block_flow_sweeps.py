"""The block-context, boundary and log sweeps through the port's tracer and
block verifier, against the JAX package, on the CPU, tolerance 0.

The blocks are those of tests/test_block_context_sweep.py (every block
context opcode, BLOCKHASH inside, past and before the 256-block window, a
corrupted TIMESTAMP push), tests/test_block_boundary_sweep.py (MSIZE after
expansions, CALLDATALOAD at every boundary class, CALLDATASIZE) and
tests/test_block_logs.py (LOG0-LOG4 with their data, several logs in one tx
and across txs, a log without data, a corrupted topic and a corrupted
receipt LogLength), each built with both packages' classes and traced by
both tracers: the witnesses are equal row for row, and the port's
``CompiledBlockVerifier(w, device="cpu")`` gives the JAX verifier's
failure dict in spec mode, key for key, on both device passes.  The log
blocks run in tests/test_torch_block_flow_logs.py (a file of its own, so
that a run spread by file puts them on another worker)."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from zkevm_specs_tpu.tables import schemas as js  # noqa: E402
from zkevm_specs_tpu.witness import tracer as JT  # noqa: E402
from zkevm_specs_tpu.witness import typing as JY  # noqa: E402
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier  # noqa: E402
from zkevm_specs_tpu_torch.witness import tracer as PT  # noqa: E402
from zkevm_specs_tpu_torch.witness import typing as PY  # noqa: E402

import test_torch_block as B  # noqa: E402
from test_block_boundary_sweep import CALL_DATA  # noqa: E402
from test_block_context_sweep import BLOCK, HASHES  # noqa: E402
from test_torch_tracer import assert_same_witness  # noqa: E402

torch.set_num_threads(1)


def _tx(Y, i=1, call_data=b""):
    return Y.Transaction(id=i, gas=1000000, gas_price=int(2e9), caller_address=0xFE,
                         callee_address=0xFF + (i - 1 if i > 1 else 0), call_data=call_data)


def _log_tx(Y, i):
    """tests/test_block_logs.py:_tx: callee 0xFF + i."""
    return Y.Transaction(id=i, gas=1000000, gas_price=int(2e9), caller_address=0xFE,
                         callee_address=0xFF + i)


def _emit_log(bc, topics, data_start, data_len):
    """tests/test_block_logs.py:_emit_log."""
    for t in reversed(topics):
        bc.push32(t)
    bc.push2(data_len).push2(data_start)
    getattr(bc, f"log{len(topics)}")()
    return bc


# -- the blocks: a function of a package's classes, returning (block, txs) -----------

def block_ctx(op):
    def build(Y):
        bc = getattr(Y.Bytecode(), op)().push1(0x07).sstore().stop()
        return Y.Block(**BLOCK), [(_tx(Y), bc)]
    return build


def blockhash(asked, **overrides):
    def build(Y):
        bc = Y.Bytecode().push32(asked).blockhash().push1(0x07).sstore().stop()
        return Y.Block(**{**BLOCK, **overrides}), [(_tx(Y), bc)]
    return build


def msize_expansion(Y):
    bc = Y.Bytecode()
    for offset, want_msize in ((0, 32), (31, 64), (95, 160)):
        bc = (bc.push1(1).push1(offset).mstore().msize().push1(want_msize).eq()
              .push1(0x10 + offset % 251).sstore())
    return Y.Block(base_fee=int(1e9)), [(_tx(Y), bc.stop())]


def calldataload_at(offset):
    def build(Y):
        bc = Y.Bytecode().push2(offset).calldataload().push1(0x07).sstore().stop()
        return Y.Block(base_fee=int(1e9)), [(_tx(Y, call_data=CALL_DATA), bc)]
    return build


def calldatasize(Y):
    bc = Y.Bytecode().calldatasize().push1(0x07).sstore().stop()
    return Y.Block(base_fee=int(1e9)), [(_tx(Y, call_data=CALL_DATA[:29]), bc)]


def single_log(topics, mstart, msize):
    def build(Y):
        bc = Y.Bytecode().push32(0xCAFEBABE_DEADBEEF).push1(0).mstore()
        bc = _emit_log(bc, topics, mstart, msize).stop()
        return Y.Block(base_fee=int(1e9)), [(_log_tx(Y, 1), bc)]
    return build


def reverted_log(Y):
    """tests/test_block_logs.py:test_reverted_log_not_counted: a LOG1 in a
    root frame that then reverts."""
    bc = Y.Bytecode().push32(0xAA).push1(0).mstore()
    bc = _emit_log(bc, [0x030201], 0, 4).push1(0).push1(0).revert()
    return Y.Block(base_fee=int(1e9)), [(_log_tx(Y, 1), bc)]


def multi_logs_one_tx(Y):
    bc = Y.Bytecode().push32(0x1122334455).push1(0).mstore()
    bc = _emit_log(bc, [], 10, 2)
    bc = _emit_log(bc, [0x030201], 20, 3)
    bc = _emit_log(bc, [0x030201, 0x0F0E0D], 0, 8).stop()
    return Y.Block(base_fee=int(1e9)), [(_log_tx(Y, 1), bc)]


def multi_logs_across_txs(Y):
    bc1 = Y.Bytecode().push32(0xAA).push1(0).mstore()
    bc1 = _emit_log(bc1, [0x030201, 0x0F0E0D, 0x0D8F01], 0, 16)
    bc1 = _emit_log(bc1, [0x030201], 20, 3).stop()
    bc2 = Y.Bytecode().push32(0xBB).push1(0).mstore()
    bc2 = _emit_log(bc2, [], 10, 2).stop()
    return Y.Block(base_fee=int(1e9)), [(_log_tx(Y, 1), bc1), (_log_tx(Y, 2), bc2)]


def two_topics_no_data(Y):
    bc = _emit_log(Y.Bytecode(), [0x030201, 0x0F0E0D], 0, 0).stop()
    return Y.Block(base_fee=int(1e9)), [(_log_tx(Y, 1), bc)]


def one_topic_no_data(Y):
    bc = _emit_log(Y.Bytecode(), [0x42], 0, 0).stop()
    return Y.Block(base_fee=int(1e9)), [(_log_tx(Y, 1), bc)]


# -- the corruptions ----------------------------------------------------------------

def corrupt_timestamp_push(w):
    """tests/test_block_context_sweep.py:test_block_ctx_corrupt_value_rejected."""
    for r in w.rw.rws:
        if (r["key0"] == int(js.Target.Stack) and r["rw"] == 1
                and r["value"] == BLOCK["timestamp"]):
            r["value"] += 1


def corrupt_topic(w):
    """tests/test_block_logs.py:test_corrupt_topic_rejected."""
    rows = [r for r in w.rw.rws if r["key0"] == int(js.Target.TxLog)
            and (r["address"] >> 32) & 0xFFFF == int(js.TxLogFieldTag.Topic)]
    rows[0]["value"] ^= 1


def corrupt_log_length(w):
    """tests/test_block_logs.py:test_corrupt_log_length_rejected."""
    for r in w.rw.rws:
        if (r["key0"] == int(js.Target.TxReceipt)
                and r["field_tag"] == int(js.TxReceiptFieldTag.LogLength)):
            r["value"] += 1


SWEEPS = {   # kind: (block, corruption)
    **{f"ctx_{op}": (block_ctx(op), None)
       for op in ("coinbase", "timestamp", "number", "gaslimit", "chainid", "basefee",
                  "prevrandao")},
    "blockhash_parent": (blockhash(BLOCK["number"] - 1), None),
    "blockhash_oldest": (blockhash(BLOCK["number"] - len(HASHES)), None),
    "blockhash_out_of_window": (blockhash(10, number=300, history_hashes=[]), None),
    "blockhash_future": (blockhash(BLOCK["number"] + 5), None),
    "ctx_corrupt_timestamp": (block_ctx("timestamp"), corrupt_timestamp_push),
    "msize_expansion": (msize_expansion, None),
    **{f"calldataload_{offset}": (calldataload_at(offset), None)
       for offset in (0, 1, 16, 31, 32, 33, 64)},
    "calldatasize": (calldatasize, None),
}
LOGS = {
    "log0": (single_log([], 10, 2), None),
    "log1": (single_log([0x030201], 20, 3), None),
    "log2": (single_log([0x030201, 0x0F0E0D], 100, 20), None),
    "log3": (single_log([0x030201, 0x0F0E0D, 0x0D8F01], 180, 50), None),
    "log4": (single_log([0x030201, 0x0F0E0D, 0x0D8F01, 0x0A0B0C], 0, 32), None),
    "multi_logs_one_tx": (multi_logs_one_tx, None),
    "multi_logs_across_txs": (multi_logs_across_txs, None),
    "log_zero_data_length": (one_topic_no_data, None),
    "corrupt_topic": (two_topics_no_data, corrupt_topic),
    "corrupt_log_length": (one_topic_no_data, corrupt_log_length),
}
# held by test_torch_block_flow_logs.py:test_reverted_log_is_not_traced
REVERTED_LOGS = {"reverted_log": (reverted_log, None)}
MUST_FAIL = {"ctx_corrupt_timestamp", "corrupt_topic", "corrupt_log_length"}


def traced(kind):
    build, corruption = {**SWEEPS, **LOGS, **REVERTED_LOGS}[kind]
    out = []
    for T, Y in ((JT, JY), (PT, PY)):
        block, txs = build(Y)
        w = T.trace_block(block, txs)
        out.append(w)
    return out, corruption


def check(kind, monkeypatch):
    (jw, pw), corruption = traced(kind)
    assert_same_witness(jw, pw)
    if corruption is not None:
        corruption(jw)
        corruption(pw)
    pbv = CompiledBlockVerifier(pw, device="cpu")
    want = B.JaxSide(jw, monkeypatch).failures()
    prepared = pbv.prepare()
    assert pbv.run_device(prepared) == want
    assert pbv.run_device_combined(prepared) == want
    assert bool(want) == (kind in MUST_FAIL), sorted(want, key=str)
    return pw


@pytest.mark.parametrize("kind", sorted(SWEEPS))
def test_context_and_boundary_blocks_match_jax(kind, monkeypatch):
    check(kind, monkeypatch)


def test_blockhash_in_window_unrecorded_raises():
    """tests/test_block_context_sweep.py's guard: an in-window block whose
    hash the Block witness does not record cannot be looked up."""
    bc = PY.Bytecode().push32(BLOCK["number"] - 9).blockhash().push1(0x07).sstore().stop()
    with pytest.raises(AssertionError, match="history"):
        PT.trace_block(PY.Block(**BLOCK), [(_tx(PY), bc)])
