"""The port's CALL-family, RETURN/REVERT and STOP gadgets
(zkevm_specs_tpu_torch.evm.execution: callop, return_revert, stop, with
evm/gadgets/call_gadget.py and the restored caller context) against the
JAX package, on the CPU, tolerance 0.

Every vector of tests/evm/test_callop_return.py and
tests/evm/test_callop_matrix.py (the precheck-fail, depth-limit,
memory-expansion and negative vectors and
``test_stop_in_subcall_restores_context`` included) runs as that file's own
test body, with the module's ``Tables`` and ``verify_steps`` intercepted as
in tests/test_torch_flow_context.py: both packages' spec failure dicts must
be equal key for key and message for message, then the body's own
expectation is applied to them.

The replay: one vector of CALL_OP, of RETURN and of a STOP in a sub-call,
its lane eight times over, through the port's ``CompiledGroupVerifier`` on
the CPU, fails exactly the lanes spec mode fails."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "evm"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from zkevm_specs_tpu_torch.runtime.jit import CompiledGroupVerifier  # noqa: E402

import test_callop_matrix  # noqa: E402
import test_callop_return  # noqa: E402
import test_torch_flow_context as FC  # noqa: E402

torch.set_num_threads(1)

CASES = FC._cases(((test_callop_return, None), (test_callop_matrix, None)))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_callop_return_vectors_match_jax(case, monkeypatch):
    _, module, fn, kwargs = next(c for c in CASES if c[0] == case)
    FC.run_case(module, fn, kwargs, monkeypatch)


# (execution state, the vector): a CALL into its callee, a RETURN and a
# REVERT at the root, and a STOP in a sub-call back to its caller, clean and
# with the restored GasLeft corrupted
REPLAYED = [
    ("CALL_OP", "test_callop_return.test_call_to_contract[0]"),
    ("RETURN", "test_callop_return.test_return_revert_root[0]"),
    ("RETURN", "test_callop_return.test_return_revert_root[1]"),
    ("STOP", "test_callop_matrix.test_stop_in_subcall_restores_context[0]"),
    ("STOP", "test_callop_matrix.test_stop_in_subcall_restores_context[1]"),
]


def test_replayed_vectors_exist():
    assert {c[0] for c in CASES} >= {case for _, case in REPLAYED}
    assert {s for s, _ in REPLAYED} == {"CALL_OP", "RETURN", "STOP"}


@pytest.mark.parametrize("state,case", REPLAYED)
def test_replay_matches_spec(state, case, monkeypatch):
    """The vector's lane, eight times over, replayed by the port's
    ``CompiledGroupVerifier``: exactly the lanes spec mode fails."""
    _, module, fn, kwargs = next(c for c in CASES if c[0] == case)
    (ptables, psteps, want), = [c for c in FC.run_case(module, fn, kwargs, monkeypatch)
                                if c[1][0].execution_state.name == state][:1]
    monkeypatch.undo()
    # the STOP halts a sub-call; the CALL enters one
    if state == "STOP":
        assert not psteps[0].is_root
    if state == "CALL_OP":
        assert not psteps[1].is_root
    lanes = FC.REPLAY_LANES
    curr, nxt = [psteps[0]] * lanes, [psteps[1]] * lanes
    v = CompiledGroupVerifier(ptables, psteps[0].execution_state, curr, nxt, device="cpu")
    fail = v(*v.prepare_inputs(curr, nxt))
    assert torch.nonzero(fail).flatten().tolist() == (list(range(lanes)) if want else [])
