"""The precompile block's other two edits and its full size, against the
JAX package, on the CPU, tolerance 0: ``workloads.build_precompile_block(1,
1, 2)`` with a sig row's is_valid flipped and with an identity output byte
+ 1 (the card run's edits; tests/test_torch_precompile_block.py holds the
clean block and the ecc edit), each failing exactly at its predicted keys
in both packages, and the full-size block's states and sizes.  (A file of
its own, so that a run spread by file puts it on another worker.)"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from zkevm_specs_tpu_torch import workloads  # noqa: E402

import test_torch_precompile_block as PB  # noqa: E402

torch.set_num_threads(1)


def test_the_edits_are_split_across_the_files():
    assert set(PB.EDITS_HERE) | set(EDITS_HERE) == {None, *workloads.PRECOMPILE_EDITS}


EDITS_HERE = ("sig_row_is_valid", "identity_output")


@pytest.mark.parametrize("edit", EDITS_HERE)
def test_precompile_block_edit_matches_jax(edit, monkeypatch):
    PB.check_edit(edit, monkeypatch)


def test_precompile_block_full_size_states():
    """The full-size block (4 rollup txs, 4 relayer txs of 64 messages):
    the ecc circuit at its capacity (8 adds, 8 muls, 4 true pairings), 256
    sig rows, and each new state with 4 lanes or more, a device group at
    the default ``min_jit_lanes``."""
    w = workloads.build_precompile_block()
    names = [s.execution_state.name for s in w.steps]
    c = w.ecc_circuit
    assert (len(c.add_ops), len(c.mul_ops)) == (8, 8)
    assert [op.out for op in c.pairing_ops] == [1] * 4
    assert len(w.sig_rows) == 256 and all(w.tx_success)
    counts = {s: names.count(s) for s in ("ECRECOVER", "DATACOPY", "BN254_ADD",
                                          "BN254_SCALAR_MUL", "BN254_PAIRING",
                                          "ErrorOutOfGasPrecompile")}
    assert counts == {"ECRECOVER": 260, "DATACOPY": 256, "BN254_ADD": 8,
                      "BN254_SCALAR_MUL": 8, "BN254_PAIRING": 4, "ErrorOutOfGasPrecompile": 4}
    assert (len(w.steps), len(w.rw.rws), workloads.receipt_gas_used(w)) == (10733, 469909,
                                                                             2635528)
