"""CREATE/CREATE2 blocks through the port's tracer and block verifier,
against the JAX package, on the CPU, tolerance 0.

Every block of tests/test_block_create.py (CREATE and CREATE2 of the
self-replicating initcode, a reverting initcode, an empty initcode, a
CREATE2 collision, the precheck failures, a CREATE in a sub-call, with
value, in a reverting caller, the create-then-call chain, the four create
error states through their sub-factories and the corrupted deployed hash,
pushed address and initcode copy) runs as that file's own test body through
tests/test_torch_block_calls.py's interception: both tracers' witnesses
equal row for row, and the JAX verifier's failure dict in spec mode equal,
key for key, to the port's on both device passes.  The create block
runs in tests/test_torch_create_block.py."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_block_create  # noqa: E402
import test_torch_block_calls as C  # noqa: E402

torch.set_num_threads(1)

CREATE_TESTS = sorted(n for n in vars(test_block_create) if n.startswith("test_"))


@pytest.mark.parametrize("name", CREATE_TESTS)
def test_create_blocks_match_jax(name, monkeypatch):
    it = C.run_body(test_block_create, name, monkeypatch)
    states = {s.execution_state.name for jw, _, _ in it.traced for s in jw.steps}
    assert states & {"CREATE", "CREATE2", "ErrorOutOfGasCREATE"}, "no create traced"


def test_every_block_of_the_file_is_held():
    assert len(CREATE_TESTS) == 21
