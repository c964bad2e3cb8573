"""EVM-circuit entry point: grouped, batched step verification.

Counterpart of ``zkevm_specs_tpu/evm/main.py`` (reference:
src/zkevm_specs/evm_circuit/main.py:14-63).  Steps are grouped by
execution state (plus first/last-step flags) and each group is evaluated
as one batched constraint pass; data-dependent control paths split groups
lane-uniformly (see dsl/cs.py).  ``verify_steps`` is the eager spec run on
host tensors.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..dsl.cs import ConstraintSystem, LaneSplit
from ..dsl.value import Ctx
from ..tables.container import Tables
from .execution import EXECUTION_STATE_IMPL
from .execution_state import ExecutionState
from .instruction import Instruction
from .step import StepState, StepStateBatch

DUMMY_STEP_STATE = StepState(ExecutionState.EndBlock, rw_counter=-1)

MAX_LANE_SPLITS = 64


def verify_steps(
    tables: Tables,
    steps: List[StepState],
    begin_with_first_step: bool = False,
    end_with_last_step: bool = False,
    success: bool = True,
):
    steps = list(steps)
    if end_with_last_step:
        steps.append(DUMMY_STEP_STATE)

    n_pairs = len(steps) - 1
    # pair i: (steps[i], steps[i+1])
    groups: Dict[Tuple[ExecutionState, bool, bool], List[int]] = {}
    for i in range(n_pairs):
        key = (
            steps[i].execution_state,
            begin_with_first_step and i == 0,
            end_with_last_step and i == n_pairs - 1,
        )
        groups.setdefault(key, []).append(i)

    failures: Dict[int, str] = {}

    for (state, is_first, is_last), idxs in groups.items():
        if state not in EXECUTION_STATE_IMPL:
            raise NotImplementedError(f"no gadget for {state!r}")
        _run_group(tables, steps, state, is_first, is_last, idxs, [], failures)

    if success:
        if failures:
            first = min(failures)
            raise AssertionError(f"step {first}: {failures[first]}")
    else:
        assert failures, "expected verification to fail, but all steps passed"


def _run_group(
    tables: Tables,
    steps: List[StepState],
    state: ExecutionState,
    is_first: bool,
    is_last: bool,
    idxs: List[int],
    decisions: List,
    failures: Dict[int, str],
    depth: int = 0,
):
    assert depth <= MAX_LANE_SPLITS, "lane-split recursion exceeded bound"
    ctx = Ctx("cpu", len(idxs), "eager")
    cs = ConstraintSystem(ctx)
    cs.decisions = list(decisions)
    curr = StepStateBatch(ctx, [steps[i] for i in idxs], state)
    nxt = StepStateBatch(ctx, [steps[i + 1] for i in idxs])
    inst = Instruction(ctx, cs, tables.with_ctx(ctx), curr, nxt, is_first, is_last)
    try:
        verify_step(inst)
    except LaneSplit as split:
        taken = [i for i, m in zip(idxs, split.mask) if m]
        not_taken = [i for i, m in zip(idxs, split.mask) if not m]
        prefix = list(cs.decisions[: cs._decision_idx])
        _run_group(tables, steps, state, is_first, is_last, taken, prefix, failures, depth + 1)
        _run_group(tables, steps, state, is_first, is_last, not_taken, prefix, failures, depth + 1)
        return
    fail = cs.fail.numpy()
    if fail.any():
        msgs = cs.first_failure_message()
        for lane, i in enumerate(idxs):
            if fail[lane] and i not in failures:
                failures[i] = msgs[lane] or "constraint failed"


def verify_step(instruction: Instruction):
    """Per-step first/last/transition constraints + gadget dispatch
    (reference main.py:47-63)."""
    if instruction.is_first_step:
        instruction.constrain_in(
            instruction.curr.execution_state,
            [int(ExecutionState.BeginTx), int(ExecutionState.EndBlock)],
        )
        instruction.constrain_equal(instruction.curr.rw_counter, 1)

    if instruction.is_last_step:
        instruction.constrain_equal(instruction.curr.execution_state, int(ExecutionState.EndBlock))
    else:
        instruction.constrain_execution_state_transition()

    state = instruction.curr.execution_state_static
    if state not in EXECUTION_STATE_IMPL:
        raise NotImplementedError(f"no gadget for {state!r}")
    EXECUTION_STATE_IMPL[state](instruction)
