"""REVERT blocks through the port's tracer and block verifier, against the
JAX package, on the CPU, tolerance 0.

The blocks of tests/test_block_revert.py that reach no error state (a root
REVERT after an SSTORE and a warm SLOAD, the same with its storage mirror
corrupted, a root REVERT of 32 bytes, a successful call inside a
reverting caller (itself a callee that writes and reverts), a CALL
with value to a reverting callee, a reverted tx whose receipt claims
success, a JUMPI not taken, a RETURNDATACOPY of the whole return buffer)
run as that file's own test bodies through
tests/test_torch_block_calls.py's interception: equal witnesses row for
row, and the JAX verifier's failure dict in spec mode, key for key, on both
of the port's device passes.

The blocks of the same file that reach an error state (invalid jumps, stack
underflow (test_block_subcall_revert's callee among them: its LOG1 has two
stack items, so it never reaches its REVERT), the out-of-gas family, an
invalid opcode, write protection in a static callee, return data out of
bound, a gas overflow) run the same way, verdict for verdict: the port's
witness carries the error state the JAX tracer emits there."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_block_revert  # noqa: E402
import test_torch_block_calls as C  # noqa: E402

torch.set_num_threads(1)

REVERT_TESTS = ("test_block_root_revert", "test_block_root_revert_corrupt_mirror_rejected",
                "test_block_revert_returns_data", "test_block_nested_revert_inside_reverting_caller",
                "test_block_revert_with_value_transfer", "test_block_revert_corrupt_status_rejected",
                "test_block_jumpi_not_taken_is_no_error", "test_block_returndatacopy_exact_bound")
# test_block_subcall_revert's callee runs LOG1 on two stack items: it halts
# in ErrorStack before its REVERT
ERROR_TESTS = ("test_block_subcall_revert", "test_block_invalid_jump_root", "test_block_invalid_jumpi_taken",
               "test_block_stack_underflow", "test_block_oog_constant", "test_block_invalid_opcode",
               "test_block_error_in_subcall_restores_caller", "test_block_write_protection",
               "test_block_oog_account_access", "test_block_oog_account_access_dirty_address",
               "test_block_oog_memory_copy_dirty_extcodecopy_address",
               "test_block_oog_static_memory_expansion", "test_block_oog_dynamic_memory_expansion",
               "test_block_oog_memory_copy", "test_block_returndata_out_of_bound",
               "test_block_oog_sstore_sentry", "test_block_oog_sload", "test_block_oog_log",
               "test_block_oog_exp", "test_block_oog_sha3", "test_block_oog_call",
               "test_block_gas_uint_overflow", "test_block_jump_into_push_data",
               "test_block_jump_to_code_end", "test_block_jump_to_huge_dest",
               "test_block_jump_in_subcall_restores_caller")


@pytest.mark.parametrize("name", REVERT_TESTS)
def test_revert_blocks_match_jax(name, monkeypatch):
    C.run_body(test_block_revert, name, monkeypatch)


@pytest.mark.parametrize("name", ERROR_TESTS)
def test_error_state_blocks_raise_naming_the_state(name, monkeypatch):
    """The error-state blocks, held as the REVERT blocks are: each traced
    witness has an error step, the JAX tracer's, at the same place."""
    it = C.run_body(test_block_revert, name, monkeypatch)
    for jw, pw, _ in it.traced:
        errors = [s.execution_state.name for s in pw.steps
                  if s.execution_state.name.startswith("Error")]
        assert errors and errors == [s.execution_state.name for s in jw.steps
                                     if s.execution_state.name.startswith("Error")]


def test_every_block_of_the_file_is_held():
    names = {n for n in vars(test_block_revert) if n.startswith("test_")}
    # the copy-edge sweeps stay in the root frame, held by test_torch_block_flow*.py's blocks
    rest = {"test_block_calldatacopy_edges", "test_block_codecopy_edges",
            "test_block_jump_valid_dest_after_push_data", "test_block_jumpi_huge_dest_not_taken"}
    assert names == set(REVERT_TESTS) | set(ERROR_TESTS) | rest
