"""Sub-call frames through the port's tracer and block verifier, against the
JAX package, on the CPU, tolerance 0.

Every block of tests/test_block_calls.py (CALL into a STOP and a RETURN
callee, RETURNDATACOPY of the returned data, a value transfer, a warm then a
cold callee, STATICCALL, DELEGATECALL, CALLCODE, a call to an empty
account, nested calls, a callee reading its calldata from the caller's
memory, a corrupted restored GasLeft) runs as that file's own test body, with its ``trace_block`` and ``verify_super_circuit``
intercepted: ``trace_block`` traces the block with both tracers (the port's
on the same block, txs and accounts built with its own classes), whose
witnesses must be equal row for row; ``verify_super_circuit`` replays the
body's edits of the JAX witness (rw rows and steps) on the port's, then
holds the port's ``CompiledBlockVerifier(w, device="cpu")`` on both device
passes to the JAX verifier's failure dict in spec mode, key for key, and
raises as the JAX verifier would.  The blocks of tests/test_block_revert.py
run in tests/test_torch_block_revert.py, the mega block and the call block
in tests/test_torch_block_call_block.py (files of their own, so that a run
spread by file puts them on other workers)."""
import copy
import inspect
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from zkevm_specs_tpu.witness import tracer as JT  # noqa: E402
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier  # noqa: E402
from zkevm_specs_tpu_torch.witness import tracer as PT  # noqa: E402
from zkevm_specs_tpu_torch.witness import typing as PY  # noqa: E402

import test_block_calls  # noqa: E402
import test_torch_block as B  # noqa: E402
from test_torch_tracer import STEP_FIELDS, assert_same_witness  # noqa: E402

torch.set_num_threads(1)


# -- the JAX classes, rebuilt with the port's --------------------------------------

def _fields(obj, cls):
    return {k: getattr(obj, k) for k in inspect.signature(cls.__init__).parameters
            if k != "self" and hasattr(obj, k)}


def port_bytecode(bc):
    return PY.Bytecode(bytearray(bytes(bc.code)), list(bc.is_code))


def port_args(block, txs, accounts):
    """The port's Block, (Transaction, Bytecode) list and accounts carrying
    the JAX ones' values."""
    pblock = PY.Block(**{**_fields(block, PY.Block),
                         "history_hashes": list(block.history_hashes)})
    ptxs = [(PY.Transaction(**{**_fields(tx, PY.Transaction),
                               "call_data": bytes(tx.call_data)}), port_bytecode(bc))
            for tx, bc in txs]
    paccounts = None if accounts is None else {
        addr: PY.Account(address=a.address, nonce=a.nonce, balance=a.balance,
                         code=None if a.code is None else port_bytecode(a.code),
                         storage=dict(a.storage))
        for addr, a in accounts.items()}
    return pblock, ptxs, paccounts


# -- a test body of the JAX package's, with both tracers and verifiers -------------------

class Intercepted:
    """The ``trace_block`` and ``verify_super_circuit`` a JAX block test
    body calls, each doing both packages' work (a block the port's tracer
    refuses fails the test with its ``NotImplementedError``)."""

    def __init__(self):
        self.traced = []    # [jax witness, port witness, clean copy]

    def trace_block(self, block, txs, **kw):
        pblock, ptxs, paccounts = port_args(block, txs, kw.get("accounts"))
        jw = JT.trace_block(block, txs, **kw)
        pw = PT.trace_block(pblock, ptxs, **{**kw, "accounts": paccounts})
        assert_same_witness(jw, pw)
        self.traced.append((jw, pw, copy.deepcopy((jw.rw.rws, jw.steps))))
        return jw

    def verify_super_circuit(self, jw):
        _, pw, (rws, steps) = next(t for t in self.traced if t[0] is jw)
        # the body's edits of the JAX witness, made on the port's too
        assert len(jw.rw.rws) == len(rws) and len(jw.steps) == len(steps)
        for j, (now, was) in enumerate(zip(jw.rw.rws, rws)):
            if now != was:
                pw.rw.rws[j].update(now)
        for j, (now, was) in enumerate(zip(jw.steps, steps)):
            for f in STEP_FIELDS:
                if getattr(now, f) != getattr(was, f):
                    setattr(pw.steps[j], f, getattr(now, f))
        assert pw.rw.rws == jw.rw.rws
        want = verify_both(jw, pw)
        if want:
            raise AssertionError(f"{len(want)} failures, first {sorted(want, key=str)[:4]}")


def verify_both(jw, pw):
    """The JAX verifier's failure dict in spec mode, held equal to the
    port's on both device passes."""
    with pytest.MonkeyPatch.context() as mp:
        want = B.JaxSide(jw, mp).failures()
    pbv = CompiledBlockVerifier(pw, device="cpu")
    prepared = pbv.prepare()
    assert pbv.run_device(prepared) == want
    assert pbv.run_device_combined(prepared) == want
    return want


def run_body(module, name, monkeypatch, **kwargs):
    """Run the JAX block test ``module.name`` with both packages behind its
    ``trace_block`` and ``verify_super_circuit``; returns the interceptor."""
    it = Intercepted()
    monkeypatch.setattr(module, "trace_block", it.trace_block)
    monkeypatch.setattr(module, "verify_super_circuit", it.verify_super_circuit)
    getattr(module, name)(**kwargs)
    assert it.traced, "the test body traced nothing"
    return it


CALL_TESTS = sorted(n for n in vars(test_block_calls) if n.startswith("test_"))


@pytest.mark.parametrize("name", CALL_TESTS)
def test_call_blocks_match_jax(name, monkeypatch):
    it = run_body(test_block_calls, name, monkeypatch)
    assert any(not s.is_root for s in it.traced[0][1].steps), "no sub-call frame traced"


def test_call_tests_are_all_collected():
    assert len(CALL_TESTS) == 11
