"""The port's error-state gadgets (zkevm_specs_tpu_torch.evm.execution.errors)
against the JAX package, on the CPU, tolerance 0.

Every vector of tests/evm/test_errors.py, test_errors_oog.py and
test_errors_oog_matrix.py runs as that file's own test body with its
``Tables`` and ``verify_steps`` intercepted, test_errors.py's
``run_error_step`` too (``test_torch_flow_context.run_case``): both packages'
spec failure dicts equal key for key and message for message, then the
body's own expectation applied.  One vector of each of the 21 error
states is replayed on the port's ``CompiledGroupVerifier`` at 8 lanes and
fails exactly the lanes spec mode fails.  tests/test_torch_errors_matrix.py
runs the stack and invalid-opcode matrices."""
import pytest

import test_torch_flow_context as FC  # puts tests/evm on the path
import test_errors  # noqa: E402
import test_errors_oog  # noqa: E402
import test_errors_oog_matrix  # noqa: E402
from zkevm_specs_tpu_torch.evm.execution import EXECUTION_STATE_IMPL  # noqa: E402

OOG_TESTS = tuple(sorted(n for n in vars(test_errors_oog) if n.startswith("test_")))
CASES = FC._cases(((test_errors, None), (test_errors_oog, OOG_TESTS),
                   (test_errors_oog_matrix, None)))


def _run(case, monkeypatch):
    _, module, fn, kwargs = next(c for c in CASES if c[0] == case)
    return FC.run_case(module, fn, kwargs, monkeypatch, also=(test_errors,))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_error_vectors_match_jax(case, monkeypatch):
    _run(case, monkeypatch)


# one vector of each error state
REPLAYED = [
    ("ErrorInvalidOpcode", "test_errors.test_error_invalid_opcode[0]"),
    ("ErrorStack", "test_errors.test_error_stack_underflow[0]"),
    ("ErrorOutOfGasConstant", "test_errors.test_error_oog_constant[0]"),
    ("ErrorInvalidJump", "test_errors.test_error_invalid_jump[2]"),
    ("ErrorWriteProtection", "test_errors.test_error_write_protection[0]"),
    ("ErrorOutOfGasSHA3", "test_errors.test_error_oog_sha3[0]"),
    ("ErrorOutOfGasEXP", "test_errors.test_error_oog_exp[0]"),
    ("ErrorOutOfGasAccountAccess", "test_errors_oog.test_error_oog_account_access[0]"),
    ("ErrorOutOfGasStaticMemoryExpansion",
     "test_errors_oog.test_error_oog_static_memory_expansion[1]"),
    ("ErrorOutOfGasDynamicMemoryExpansion",
     "test_errors_oog.test_error_oog_dynamic_memory_expansion[0]"),
    ("ErrorOutOfGasMemoryCopy", "test_errors_oog.test_error_oog_memory_copy[0]"),
    ("ErrorOutOfGasSloadSstore", "test_errors_oog_matrix.test_oog_sstore_insufficient_slot_gas[0]"),
    ("ErrorOutOfGasLOG", "test_errors_oog.test_error_oog_log[1]"),
    ("ErrorReturnDataOutOfBound", "test_errors_oog.test_error_return_data_out_of_bound[0]"),
    ("ErrorOutOfGasCodeStore", "test_errors_oog.test_error_code_store[0]"),
    ("ErrorMaxCodeSizeExceeded", "test_errors_oog.test_error_code_store[1]"),
    ("ErrorInvalidCreationCode", "test_errors_oog.test_error_invalid_creation_code[0]"),
    ("ErrorOutOfGasCall", "test_errors_oog.test_error_oog_call[0]"),
    ("ErrorOutOfGasCREATE", "test_errors_oog_matrix.test_oog_create2_root[0]"),
    ("ErrorGasUintOverflow", "test_errors_oog.test_error_gas_uint_overflow[0]"),
    ("ErrorOutOfGasPrecompile", "test_errors_oog.test_error_oog_precompile[0]"),
]


def test_replay_covers_every_ported_error_state():
    assert {c[0] for c in CASES} >= {case for _, case in REPLAYED}
    ported = {s.name for s in EXECUTION_STATE_IMPL if s.name.startswith("Error")}
    assert {s for s, _ in REPLAYED} == ported and len(ported) == 21


@pytest.mark.parametrize("state,case", REPLAYED)
def test_replay_matches_spec(state, case, monkeypatch):
    (ptables, psteps, want), = [c for c in _run(case, monkeypatch)
                                if c[1][0].execution_state.name == state][:1]
    monkeypatch.undo()
    assert FC.replay_fails(ptables, psteps) == (list(range(FC.REPLAY_LANES)) if want else [])
