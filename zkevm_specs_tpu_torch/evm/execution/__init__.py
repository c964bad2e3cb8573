"""Execution-gadget registry (reference: execution/__init__.py:86-171).

Only the gadgets ported so far are registered; ``verify_steps`` raises
``NotImplementedError`` for any other execution state."""
from typing import Callable, Dict

from ..execution_state import ExecutionState
from .add_sub import add_sub
from .addmod import addmod
from .begin_tx import begin_tx
from .end_block import end_block
from .end_tx import end_tx
from .exp import exp
from .mul_div_mod import mul_div_mod
from .mulmod import mulmod
from .pop import pop
from .push import push
from .sdiv_smod import sdiv_smod
from .shl_shr import shl_shr
from .stop import stop

EXECUTION_STATE_IMPL: Dict[ExecutionState, Callable] = {
    ExecutionState.BeginTx: begin_tx,
    ExecutionState.EndTx: end_tx,
    ExecutionState.EndBlock: end_block,
    ExecutionState.ADD: add_sub,
    ExecutionState.MUL: mul_div_mod,
    ExecutionState.SDIV_SMOD: sdiv_smod,
    ExecutionState.ADDMOD: addmod,
    ExecutionState.MULMOD: mulmod,
    ExecutionState.EXP: exp,
    ExecutionState.SHL_SHR: shl_shr,
    ExecutionState.PUSH: push,
    ExecutionState.POP: pop,
    ExecutionState.STOP: stop,
}
