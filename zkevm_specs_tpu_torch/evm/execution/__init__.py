"""Execution-gadget registry (reference: execution/__init__.py:86-171).

Only the gadgets ported so far are registered; ``verify_steps`` raises
``NotImplementedError`` for any other execution state."""
from typing import Callable, Dict

from ..execution_state import ExecutionState
from .add_sub import add_sub
from .mul_div_mod import mul_div_mod

EXECUTION_STATE_IMPL: Dict[ExecutionState, Callable] = {
    ExecutionState.ADD: add_sub,
    ExecutionState.MUL: mul_div_mod,
}
