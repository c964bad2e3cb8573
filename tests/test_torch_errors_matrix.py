"""ErrorStack and ErrorInvalidOpcode on the port against the JAX package, on
the CPU, tolerance 0: every vector of tests/evm/test_error_stack_matrix.py
(every underflow and overflow band of every opcode, the valid pairs
rejected, the band edges) and tests/evm/test_invalid_opcode_matrix.py
(every invalid byte accepted, every valid byte rejected), each as that
file's own test body with its ``Tables`` and ``verify_steps`` intercepted
(``test_torch_flow_context.run_case``): both packages' spec failure dicts
equal key for key and message for message.  The two files' shape checks,
which verify nothing, are left to them."""
import pytest

import test_torch_flow_context as FC  # puts tests/evm on the path
import test_error_stack_matrix  # noqa: E402
import test_invalid_opcode_matrix  # noqa: E402

SHAPE_CHECKS = {"test_registry_shape", "test_invalid_set_shape"}
CASES = FC._cases(tuple(
    (m, tuple(sorted(n for n in vars(m) if n.startswith("test_") and n not in SHAPE_CHECKS)))
    for m in (test_error_stack_matrix, test_invalid_opcode_matrix)))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_error_matrix_vectors_match_jax(case, monkeypatch):
    _, module, fn, kwargs = next(c for c in CASES if c[0] == case)
    FC.run_case(module, fn, kwargs, monkeypatch)
