"""STOP gadget (reference: evm_circuit/execution/stop.py:7-52).  The
return to a caller's restored context (a STOP inside a sub-call) is not
ported; a lane that takes it raises."""
from ...tables.schemas import CallContextFieldTag
from ...utils.param import N_BYTES_PROGRAM_COUNTER
from ..execution_state import ExecutionState
from ..instruction import Instruction, Transition


def stop(instruction: Instruction):
    # When program_counter is out of code range the opcode fetch is skipped
    # (out-of-range fetches implicitly behave as STOP).
    code_length = instruction.bytecode_length(instruction.curr.code_hash)
    lt, eq = instruction.compare(code_length, instruction.curr.program_counter,
                                 N_BYTES_PROGRAM_COUNTER)
    is_out_of_range = lt + eq
    with instruction.masked(instruction.mask_of(1 - is_out_of_range)):
        instruction.responsible_opcode_lookup(instruction.opcode_lookup(True))

    is_success = instruction.call_context_lookup(CallContextFieldTag.IsSuccess)
    instruction.constrain_equal(is_success, 1)

    is_to_end_tx = instruction.is_equal(instruction.next.execution_state,
                                        int(ExecutionState.EndTx))
    instruction.constrain_equal(instruction.curr.is_root, is_to_end_tx)

    if instruction.branch(instruction.curr.is_root):
        instruction.constrain_step_state_transition(
            rw_counter=Transition.delta(1),
            call_id=Transition.same(),
        )
    else:
        raise NotImplementedError(
            "STOP in a sub-call (step_state_transition_to_restored_context) is not ported")
