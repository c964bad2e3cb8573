"""The precompile block through the port's tracer and block verifier,
against the JAX package, on the CPU, tolerance 0.

``workloads.build_precompile_block(1, 1, 2)`` (one rollup tx checking a
Groth16 proof through the shared verifier: 2 ecMul, 2 ecAdd and a 4-pair
ecPairing; one relayer tx of 2 signed messages through identity and
ecRecover, then an invalid v and an ecRecover out of gas) is traced by both
packages and verified by both, clean and with the edits of
``workloads.PRECOMPILE_EDITS`` that the card run makes (an ecAdd op's out y
+ 1 here; a sig row's is_valid flipped and an identity output byte + 1 in
tests/test_torch_precompile_block_edits.py, with the full-size block's
states and sizes), each failing exactly at its predicted keys; its lookup
log (the sig and ecc families among them) equals the JAX one.  (A file of
its own beside tests/test_torch_precompiles_blocks.py, so that a run
spread by file puts it on another worker.)"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from zkevm_specs_tpu.parallel import logup_shard as JLS  # noqa: E402
from zkevm_specs_tpu.witness import tracer as JT  # noqa: E402
from zkevm_specs_tpu.witness import typing as JY  # noqa: E402
from zkevm_specs_tpu_torch import workloads  # noqa: E402
from zkevm_specs_tpu_torch.parallel import logup_shard as PLS  # noqa: E402
from zkevm_specs_tpu_torch.runtime.block import CompiledBlockVerifier  # noqa: E402

import test_torch_block as B  # noqa: E402
from test_torch_block_flow import jax_txs  # noqa: E402
from test_torch_tracer import assert_same_witness  # noqa: E402

torch.set_num_threads(1)

SMALL_PRECOMPILE = (1, 1, 2)


def precompile_block_sides():
    """Both packages' witnesses of the small block."""
    ptxs, paccounts = workloads.precompile_block_txs(*SMALL_PRECOMPILE)
    accounts = {a.address: JY.Account(address=a.address, balance=a.balance,
                                      code=JY.Bytecode(bytearray(bytes(a.code.code))))
                for a in paccounts.values()}
    jw = JT.trace_block(JY.Block(**workloads.FLOW_BLOCK_HEADER), jax_txs(ptxs),
                        accounts=accounts)
    pw = workloads.build_precompile_block(*SMALL_PRECOMPILE)
    assert_same_witness(jw, pw)
    return jw, pw


# the clean block and the ecc edit here, the sig and identity edits in
# tests/test_torch_precompile_block_edits.py (a worker each)
EDITS_HERE = (None, "ecc_add_out")


def check_edit(edit, monkeypatch):
    """The small block traced by both packages, ``edit`` (a name of
    ``workloads.PRECOMPILE_EDITS``, or None) made on both witnesses, and
    both verifiers' failure dicts equal to the edit's predicted keys."""
    jw, pw = precompile_block_sides()
    if edit is not None:
        jkeys, _ = workloads.PRECOMPILE_EDITS[edit](jw)
        pkeys, _ = workloads.PRECOMPILE_EDITS[edit](pw)
    bv = CompiledBlockVerifier(pw, device="cpu")
    keys = set()
    if edit is not None:
        keys = pkeys(bv)
        assert jkeys(bv) == keys and len(keys) == 2
    want = B.JaxSide(jw, monkeypatch).failures()
    assert set(want) == keys
    assert bv.run_device_combined(bv.prepare()) == want


@pytest.mark.parametrize("edit", EDITS_HERE)
def test_precompile_block_matches_jax(edit, monkeypatch):
    check_edit(edit, monkeypatch)


def _multiset(entries):
    return sorted((int(i), bool(e)) for idx, en, *_ in entries for i, e in zip(idx, en))


def test_precompile_block_lookup_log_matches_jax():
    """``block_lookup_log`` on the small block: the sig and ecc families
    (the ecRecover and bn254 gadgets' lookups) among the families, each
    family's logged rows equal to the JAX package's and to the block
    verifier's partition-pass log, and the sig and ecc tables alike."""
    jw, pw = precompile_block_sides()
    jtables, jper = JLS.block_lookup_log(jw)
    ptables, pper = PLS.block_lookup_log(pw)
    assert set(pper) == set(jper) and {"sig", "ecc"} <= set(pper)
    assert {n: _multiset(v) for n, v in pper.items()} == {n: _multiset(v) for n, v in jper.items()}
    bv = CompiledBlockVerifier(pw, device="cpu")
    assert {n: _multiset(v) for n, v in bv.lookup_log.items()} == \
        {n: _multiset(v) for n, v in pper.items()}
    for name in ("sig", "ecc"):
        assert getattr(ptables, name).n_rows == getattr(jtables, name).n_rows > 0


def test_small_precompile_block_shape():
    """Every new state of the slice in the small block, the pairing true,
    two sig rows, and each tx successful."""
    _, pw = precompile_block_sides()
    names = [s.execution_state.name for s in pw.steps]
    for state, n in (("ECRECOVER", 3), ("DATACOPY", 2), ("BN254_ADD", 2),
                     ("BN254_SCALAR_MUL", 2), ("BN254_PAIRING", 1),
                     ("ErrorOutOfGasPrecompile", 1)):
        assert names.count(state) == n, state
    assert [op.out for op in pw.ecc_circuit.pairing_ops] == [1]
    assert len(pw.sig_rows) == 2 and pw.tx_success == [True, True]
