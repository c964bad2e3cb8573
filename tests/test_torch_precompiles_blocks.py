"""Blocks that call the precompiles through the port's tracer, block
verifier and ``verify_super_circuit``, against the JAX package, on the CPU,
tolerance 0.

Every body of tests/test_block_precompiles.py (calls to ecRecover,
identity and the BN254 add, scalar-mul and pairing precompiles, a
corrupted sig row, identity over a disjoint input, the overlapping-regions
guard and a corrupted identity output; the identity length sweep runs in
tests/test_torch_precompiles_identity.py) runs as that file's own test body
with ``trace_block`` and ``verify_super_circuit`` intercepted
(``PrecompileIntercepted``): both tracers run, and raise the same error
where one refuses the block, else give equal witnesses row for row (their
ecc ops, sig rows, memory setups and steps' aux_data included); the body's
edits of the JAX witness (rw rows, steps, sig rows, ecc ops) are made on
the port's; the port's ``CompiledBlockVerifier(w, device="cpu")`` gives
the JAX verifier's failure dict in spec mode, key for key, and the port's
``verify_super_circuit`` raises exactly where the JAX verifier fails.  A
difference between the packages raises ``ParityError``, which no body's
``pytest.raises(AssertionError)`` takes for its verdict.  Also: what the
port's tracer still refuses, as the JAX tracer does (a call to 0x02, a
precompile call with value, one inside a reverting frame)."""
import copy
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from zkevm_specs_tpu.circuits import super_circuit as JSC  # noqa: E402
from zkevm_specs_tpu.witness import tracer as JT  # noqa: E402
from zkevm_specs_tpu.witness import typing as JY  # noqa: E402
from zkevm_specs_tpu_torch.circuits import ecc as PE  # noqa: E402
from zkevm_specs_tpu_torch.circuits import super_circuit as PSC  # noqa: E402
from zkevm_specs_tpu_torch.circuits import tx as PTX  # noqa: E402
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier  # noqa: E402
from zkevm_specs_tpu_torch.witness import tracer as PT  # noqa: E402
from zkevm_specs_tpu_torch.witness import typing as PY  # noqa: E402

import test_block_precompiles  # noqa: E402
import test_torch_block as B  # noqa: E402
import test_torch_block_calls as C  # noqa: E402
from test_torch_tracer import STEP_FIELDS, assert_same_witness  # noqa: E402

torch.set_num_threads(1)


class ParityError(Exception):
    """The packages differ (not an ``AssertionError``: a body's
    ``pytest.raises(AssertionError)`` must not take it for a verdict)."""


def _outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
        return None
    except AssertionError as e:
        return str(e) or "AssertionError"


def _ecc_ops(circuit):
    return None if circuit is None else copy.deepcopy(
        (circuit.add_ops, circuit.mul_ops, circuit.pairing_ops))


def _sig_fields(rows):
    return [dict(vars(r)) for r in rows]


class PrecompileIntercepted(C.Intercepted):
    """``test_torch_block_calls.Intercepted`` for blocks with precompile
    calls: a refused block must be refused by both tracers alike, the ecc
    ops and sig rows the body edits follow onto the port's witness, the
    port's ``verify_super_circuit`` is held to the JAX verdict, and the
    kwargs of ``verify_super_circuit`` (other signed txs, the tx circuit's
    capacities) go to both packages' ``verify_super_circuit``."""

    def trace_block(self, block, txs, **kw):
        pblock, ptxs, paccounts = C.port_args(block, txs, kw.get("accounts"))
        pkw = {**kw, "accounts": paccounts}
        if kw.get("withdrawals"):
            pkw["withdrawals"] = [PY.Withdrawal(id=w.id, validator_id=w.validator_id,
                                                address=w.address, amount=w.amount)
                                  for w in kw["withdrawals"]]
        errors = []
        for T, args in ((JT, (block, txs, kw)), (PT, (pblock, ptxs, pkw))):
            try:
                errors.append((T.trace_block(args[0], args[1], **args[2]), None))
            except Exception as e:  # noqa: BLE001 - compared across the packages
                errors.append((None, e))
        (jw, jerr), (pw, perr) = errors
        if jerr is not None or perr is not None:
            if (type(jerr), str(jerr)) != (type(perr), str(perr)):
                raise ParityError(f"the JAX tracer: {jerr!r}, the port's: {perr!r}")
            raise jerr
        try:
            assert_same_witness(jw, pw)
        except AssertionError as e:
            raise ParityError(f"the witnesses differ: {e}") from e
        self.traced.append((jw, pw, copy.deepcopy((jw.rw.rws, jw.steps)),
                            (_ecc_ops(jw.ecc_circuit), _sig_fields(jw.sig_rows))))
        return jw

    def verify_super_circuit(self, jw, **kw):
        _, pw, (rws, steps), (ecc_ops, sig_fields) = next(t for t in self.traced if t[0] is jw)
        # the body's edits of the JAX witness, made on the port's
        if len(jw.rw.rws) != len(rws) or len(jw.steps) != len(steps):
            raise ParityError("the body resized the witness")
        for j, (now, was) in enumerate(zip(jw.rw.rws, rws)):
            if now != was:
                pw.rw.rws[j].update(now)
        for j, (now, was) in enumerate(zip(jw.steps, steps)):
            for f in STEP_FIELDS:
                if getattr(now, f) != getattr(was, f):
                    setattr(pw.steps[j], f, getattr(now, f))
        if _ecc_ops(jw.ecc_circuit) != ecc_ops:
            c = jw.ecc_circuit
            pw.ecc_circuit.add_ops = [PE.EcAdd(*op) for op in c.add_ops]
            pw.ecc_circuit.mul_ops = [PE.EcMul(*op) for op in c.mul_ops]
            pw.ecc_circuit.pairing_ops = [PE.EcPairing(*op) for op in c.pairing_ops]
        for prow, now, was in zip(pw.sig_rows, _sig_fields(jw.sig_rows), sig_fields):
            if now != was:
                vars(prow).update(now)
        if pw.rw.rws != jw.rw.rws:
            raise ParityError("the edited rw rows differ")
        if kw:
            # the tx circuit's other signed txs or capacities: both
            # packages' spec-mode verifiers
            pkw = dict(kw)
            if kw.get("signed_txs") is not None:
                pkw["signed_txs"] = [PTX.Transaction(*t) for t in kw["signed_txs"]]
            want = _outcome(JSC.verify_super_circuit, jw, **kw)
            got = _outcome(PSC.verify_super_circuit, pw, **pkw)
        else:
            with pytest.MonkeyPatch.context() as mp:
                fails = B.JaxSide(jw, mp).failures()
            pbv = CompiledBlockVerifier(pw, device="cpu")
            port_fails = pbv.run_device_combined(pbv.prepare())
            if port_fails != fails:
                raise ParityError(f"the JAX verifier fails {sorted(fails, key=str)[:8]}, "
                                  f"the port's {sorted(port_fails, key=str)[:8]}")
            want = f"{len(fails)} failures, first {sorted(fails, key=str)[:4]}" if fails else None
            got = _outcome(PSC.verify_super_circuit, pw)
        if (want is None) != (got is None):
            raise ParityError(f"the JAX verifier: {want}, the port's verify_super_circuit: {got}")
        if want is not None:
            raise AssertionError(want)


def run_body(module, name, monkeypatch, **kwargs):
    it = PrecompileIntercepted()
    monkeypatch.setattr(module, "trace_block", it.trace_block)
    monkeypatch.setattr(module, "verify_super_circuit", it.verify_super_circuit)
    getattr(module, name)(**kwargs)
    return it


PRECOMPILE_TESTS = sorted(n for n in vars(test_block_precompiles)
                          if n.startswith("test_") and n != "test_block_identity_length_sweep")
# the JAX file marks its 2-pair pairing block slow: so is its run here
SLOW = ("test_block_bn254_pairing_call",)


@pytest.mark.parametrize("name", [pytest.param(n, marks=pytest.mark.slow) if n in SLOW else n
                                  for n in PRECOMPILE_TESTS])
def test_precompile_blocks_match_jax(name, monkeypatch):
    it = run_body(test_block_precompiles, name, monkeypatch)
    if name != "test_block_identity_overlapping_regions_guarded":
        states = {s.execution_state.name for jw, *_ in it.traced for s in jw.steps}
        assert states & {"ECRECOVER", "DATACOPY", "BN254_ADD", "BN254_SCALAR_MUL",
                         "BN254_PAIRING"}, "no precompile traced"


def test_every_block_of_the_file_is_held():
    assert len(PRECOMPILE_TESTS) == 9


# -- what both tracers refuse -----------------------------------------------------------

def _call_block(Y, target, value=0, revert=False):
    """One tx that calls ``target`` with 32 bytes of args (and ``value``),
    then stops, or calls a sub-frame that does so and reverts."""
    inner = Y.Bytecode().push1(0x20).push1(0).push1(0x20).push1(0).push1(value) \
        .push1(target).push2(0xFFFF).call().pop()
    if revert:
        inner.push1(0).push1(0).revert()
        accounts = {0xAA: Y.Account(address=0xAA, code=inner, balance=10**18)}
        bc = Y.Bytecode().push1(0).push1(0).push1(0).push1(0).push1(0).push1(0xAA) \
            .push3(0xFFFFF).call().pop().stop()
    else:
        accounts = {0xFF: Y.Account(address=0xFF, balance=10**18)}
        bc = inner.stop()
    tx = Y.Transaction(id=1, gas=2000000, gas_price=int(2e9), caller_address=0xFE,
                       callee_address=0xFF)
    return Y.Block(base_fee=int(1e9)), [(tx, bc)], accounts


@pytest.mark.parametrize("target,value,revert,error,match", [
    (0x02, 0, False, NotImplementedError, "precompile 0x02"),  # SHA256: no gadget in either
    (0x09, 0, False, NotImplementedError, "precompile 0x09"),  # BLAKE2F
    (0x04, 1, False, AssertionError, "must carry no value"),
    (0x04, 0, True, AssertionError, "inside reverting frames"),
])
def test_tracers_refuse_alike(target, value, revert, error, match):
    it = PrecompileIntercepted()
    block, txs, accounts = _call_block(JY, target, value, revert)
    with pytest.raises(error, match=match):
        it.trace_block(block, txs, accounts=accounts)
