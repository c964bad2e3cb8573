"""The identity precompile's length sweep through the port's tracer, block
verifier and ``verify_super_circuit``, against the JAX package, on the CPU,
tolerance 0: every case of tests/test_block_precompiles.py's
``test_block_identity_length_sweep`` (1 to 96 bytes copied in place) runs
as that file's own test body through
``test_torch_precompiles_blocks.PrecompileIntercepted``.  (A file of its own
beside tests/test_torch_precompiles_blocks.py, so that a run spread by file
puts it on another worker.)"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_block_precompiles  # noqa: E402
import test_torch_precompiles_blocks as PB  # noqa: E402

torch.set_num_threads(1)

SWEEP = next(m.args[1] for m in test_block_precompiles.test_block_identity_length_sweep.pytestmark
             if m.name == "parametrize")


@pytest.mark.parametrize("cd_len", SWEEP)
def test_identity_length_sweep_matches_jax(cd_len, monkeypatch):
    it = PB.run_body(test_block_precompiles, "test_block_identity_length_sweep", monkeypatch,
                     cd_len=cd_len)
    (jw, pw, *_), = it.traced
    assert sum(s.execution_state.name == "DATACOPY" for s in pw.steps) == 1
    assert len(pw.memory_setups) == cd_len


def test_every_length_is_held():
    assert list(SWEEP) == [1, 16, 31, 32, 33, 64, 96]
