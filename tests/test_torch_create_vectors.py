"""The port's CREATE/CREATE2 gadget and BeginTx's contract-creation branch
(zkevm_specs_tpu_torch.evm.execution: create, begin_tx) against the JAX
package, on the CPU, tolerance 0.

Every vector of tests/evm/test_create.py and of
tests/evm/test_begin_end_tx.py's ``test_begin_tx`` (its two creation txs
among them: the port's tracer makes no creation tx, so these vectors are
what holds that branch) runs as that file's own test body with its
``Tables`` and ``verify_steps`` intercepted (``test_torch_flow_context.run_case``):
both packages' spec failure dicts equal key for key and message for
message, then the body's own expectation applied.  A CREATE and a CREATE2
vector are replayed on the port's ``CompiledGroupVerifier`` at 8 lanes:
the lanes spec mode fails, and the CREATE2 address hint (a host keccak a
lane in the eager pass) replayed from the hint stream."""
import pytest

import test_torch_flow_context as FC  # puts tests/evm on the path
import test_begin_end_tx  # noqa: E402
import test_create  # noqa: E402

CASES = FC._cases(((test_create, None), (test_begin_end_tx, ("test_begin_tx",))))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_create_vectors_match_jax(case, monkeypatch):
    _, module, fn, kwargs = next(c for c in CASES if c[0] == case)
    FC.run_case(module, fn, kwargs, monkeypatch)


def test_creation_txs_are_held():
    """test_begin_tx's creation txs (no callee) are among the cases."""
    creations = [k for k, v in enumerate(test_begin_end_tx.TESTING_DATA)
                 if v[0].callee_address is None]
    assert len(creations) == 2
    assert {f"test_begin_end_tx.test_begin_tx[{k}]" for k in creations} <= {c[0] for c in CASES}


@pytest.mark.parametrize("state,case", [
    ("CREATE", "test_create.test_create_empty_initcode[0]"),
    ("CREATE2", "test_create.test_create_empty_initcode[1]"),
    ("CREATE", "test_create.test_create_insufficient_balance[0]"),
])
def test_replay_matches_spec(state, case, monkeypatch):
    _, module, fn, kwargs = next(c for c in CASES if c[0] == case)
    (ptables, psteps, want), = FC.run_case(module, fn, kwargs, monkeypatch)
    monkeypatch.undo()
    assert psteps[0].execution_state.name == state
    assert FC.replay_fails(ptables, psteps) == (list(range(FC.REPLAY_LANES)) if want else [])
