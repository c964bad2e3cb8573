"""The port's ``verify_super_circuit`` and its tracer on the JAX package's
whole-block tests, on the CPU, tolerance 0.

Every body of tests/test_super_circuit.py (one and two txs, a memory
program, the signatures, one of them from the wrong key, and a corrupted
stack write) runs through
``test_torch_precompiles_blocks.PrecompileIntercepted``: equal witnesses,
the port's block verifier equal to the JAX one key for key, and the port's
``verify_super_circuit`` raising exactly where the JAX verifier fails (with
the body's other signed txs or tx capacities, where the JAX
``verify_super_circuit`` raises).  tests/test_block_conformance.py's
``mega_full_witness`` (every registered state, the precompiles and the
withdrawals among them) traces to the same witness with both tracers, and a
block with a ninth BN254 add, one past ``EccCircuit(8, 8, 4)``'s capacity,
fails both packages' ecc check at the same row."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from zkevm_specs_tpu.evm.execution import EXECUTION_STATE_IMPL  # noqa: E402
from zkevm_specs_tpu.ops.ecc import bn254  # noqa: E402
from zkevm_specs_tpu.witness import typing as JY  # noqa: E402

import test_block_conformance  # noqa: E402
import test_block_precompiles  # noqa: E402
import test_super_circuit  # noqa: E402
import test_torch_precompiles_blocks as PB  # noqa: E402

torch.set_num_threads(1)

SUPER_TESTS = sorted(n for n in vars(test_super_circuit) if n.startswith("test_"))


@pytest.mark.parametrize("name", SUPER_TESTS)
def test_super_circuit_bodies_match_jax(name, monkeypatch):
    it = PB.run_body(test_super_circuit, name, monkeypatch)
    assert it.traced


def test_every_body_of_the_file_is_held():
    assert len(SUPER_TESTS) == 5


def test_mega_full_witness_traces_alike(monkeypatch):
    """The widest block the JAX tests build (three txs: the wide program and
    the call family; reverting frames and the error family; CREATE/CREATE2
    and every precompile state), with its withdrawals: both tracers' witnesses
    equal row for row, every registered state among the steps."""
    it = PB.PrecompileIntercepted()
    monkeypatch.setattr(test_block_conformance, "trace_block", it.trace_block)
    test_block_conformance.mega_full_witness()
    (jw, pw, *_), = it.traced
    names = {s.execution_state.name for s in pw.steps}
    assert names >= {s.name for s in EXECUTION_STATE_IMPL}
    assert [(w.id, w.amount) for w in pw.withdrawals] == [(w.id, w.amount) for w in jw.withdrawals]


def test_a_ninth_bn254_add_fails_both_ecc_checks_alike():
    """Nine ecAdd calls in one block: the ninth op is one past the tracer's
    ``EccCircuit(8, 8, 4)``, so both packages' ecc check fails at its row
    (8) and nowhere else."""
    p, q = bn254.g1_mul(bn254.G1, 2), bn254.g1_mul(bn254.G1, 3)
    bc = JY.Bytecode()
    test_block_precompiles._store(bc, b"".join(x.to_bytes(32, "big") for x in (*p, *q)))
    for _ in range(9):
        test_block_precompiles._call_precompile(bc, 0x06, cd=(0, 128), rd=(0x100, 64))
    bc.stop()
    tx = JY.Transaction(id=1, gas=2000000, gas_price=int(2e9), caller_address=0xFE,
                        callee_address=0xFF)
    it = PB.PrecompileIntercepted()
    jw = it.trace_block(JY.Block(base_fee=int(1e9)), [(tx, bc)])
    assert len(jw.ecc_circuit.add_ops) == 9
    with pytest.raises(AssertionError, match=r"1 failures, first \[\('ecc', 8\)\]"):
        it.verify_super_circuit(jw)
