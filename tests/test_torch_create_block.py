"""The create block through the port's tracer and block verifier, against
the JAX package, on the CPU, tolerance 0.

``workloads.build_create_block(2, 1)`` (the create block at 2 txs x 1
round) is traced by both packages and verified by both, clean and with the
two edits the card run makes at full size (the first CREATE2's pushed
address + 1; the caller's GasLeft the first sub-call error halt reads back
+ 1), each failing exactly at its predicted keys; the full-size block's
states and groups; and ``workloads.build_create_chain_block`` is
tests/test_block_create.py's chain test's block.  (A file of its own
beside tests/test_torch_create_blocks.py, so that a run spread by file
puts it on another worker.)"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from zkevm_specs_tpu.tables import schemas as js  # noqa: E402
from zkevm_specs_tpu.witness import tracer as JT  # noqa: E402
from zkevm_specs_tpu.witness import typing as JY  # noqa: E402
from zkevm_specs_tpu_torch import workloads  # noqa: E402
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier  # noqa: E402

import test_block_create  # noqa: E402
import test_torch_block_calls as C  # noqa: E402
from test_torch_block_flow import jax_txs  # noqa: E402
from test_torch_tracer import assert_same_witness  # noqa: E402

torch.set_num_threads(1)


def test_create_chain_block_is_the_test_body_block(monkeypatch):
    """``workloads.build_create_chain_block`` (a small block the card holds
    against the CPU) is test_block_create_then_call_then_create2_chain's
    block, row for row."""
    it = C.run_body(test_block_create, "test_block_create_then_call_then_create2_chain",
                    monkeypatch)
    assert_same_witness(it.traced[0][0], workloads.build_create_chain_block())


# -- the create block ----------------------------------------------------------------

SMALL_CREATE = (2, 1)


def create_block_sides(n_txs, rounds):
    ptxs = workloads.create_block_txs(n_txs, rounds)
    pw = workloads.build_create_block(n_txs, rounds)
    accounts = {a.address: JY.Account(address=a.address, balance=a.balance,
                                      code=JY.Bytecode(bytearray(bytes(a.code.code))))
                for a in workloads.create_accounts(n_txs).values()}
    jw = JT.trace_block(JY.Block(**workloads.FLOW_BLOCK_HEADER), jax_txs(ptxs),
                        accounts=accounts)
    return jw, pw


def create2_address(w):
    """The first CREATE2's pushed address + 1 (test_block_create.py:231's
    edit).  Returns the keys that must fail: that CREATE2 step, and the rw
    counter of the first read of its stack slot (the round's DUP6; the
    state circuit holds a read to the row before it, so the POP's later
    read of the same slot passes)."""
    bad = next(i for i, s in enumerate(w.steps) if s.execution_state.name == "CREATE2")
    rows = w.rw.rws
    k = next(k for k, r in enumerate(rows) if r["rw_counter"] >= w.steps[bad].rw_counter
             and r["key0"] == int(js.Target.Stack) and r["rw"] == 1)
    row = rows[k]
    read = next(r for r in rows[k + 1:] if r["key0"] == int(js.Target.Stack)
                and (r["id"], r["address"]) == (row["id"], row["address"]))
    assert read["rw"] == 0
    row["value"] += 1
    return {bad}, [read["rw_counter"]]


def error_restored_gas_left(w):
    """The caller's GasLeft that the first error halt in a sub-call reads
    back + 1.  Returns the keys that must fail: that halt's step, and the
    rw counter of the read (its state row)."""
    bad = next(i for i, s in enumerate(w.steps)
               if s.execution_state.name.startswith("Error") and not s.is_root)
    lo, hi = w.steps[bad].rw_counter, w.steps[bad + 1].rw_counter
    row = next(r for r in w.rw.rws if lo <= r["rw_counter"] < hi
               and r["key0"] == int(js.Target.CallContext) and r["rw"] == 0
               and r["address"] == int(js.CallContextFieldTag.GasLeft))
    row["value"] += 1
    return {bad}, [row["rw_counter"]]


EDITS = {"create2_address": create2_address, "error_restored_gas_left": error_restored_gas_left}


@pytest.mark.parametrize("edit", [None, *EDITS])
def test_create_block_matches_jax(edit):
    """``workloads.build_create_block(2, 1)``, traced by both packages and
    verified by both, clean and with each of the card run's two edits:
    exactly the predicted keys fail."""
    jw, pw = create_block_sides(*SMALL_CREATE)
    assert_same_witness(jw, pw)
    keys = set()
    if edit is not None:
        keys, reads = EDITS[edit](jw)
        assert EDITS[edit](pw) == (keys, reads) and reads
        bv = CompiledBlockVerifier(pw, device="cpu")
        keys |= {("state", k) for k, r in enumerate(bv._state_rows) if r["rw_counter"] in reads}
        assert len(keys) == 1 + len(reads)
    assert set(C.verify_both(jw, pw)) == keys


def test_create_block_shape():
    """The full-size block: every create and error state of the slice, the
    last tx failing at its root, and only the root error lane among the new
    states' host groups (each new state at least 8 lanes, a device group)."""
    w = workloads.build_create_block()
    names = [s.execution_state.name for s in w.steps]
    errors = {n for n in names if n.startswith("Error")}
    assert len(errors) == 12 and {"CREATE", "CREATE2"} <= set(names)
    assert w.tx_success == [True] * 7 + [False]
    assert names[-3] == "ErrorInvalidOpcode" and w.steps[-3].is_root
    bv = CompiledBlockVerifier(w, device="cpu")
    new = errors | {"CREATE", "CREATE2"}
    on_host = [(g["state"].name, len(g["idxs"])) for g in bv.groups if g["verifier"] is None]
    assert [g for g in on_host if g[0] in new] == [("ErrorInvalidOpcode", 1)]
    assert all(names.count(n) >= 8 for n in new)
