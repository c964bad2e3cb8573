"""STOP gadget (reference: evm_circuit/execution/stop.py:7-52): the end of
the tx at the root, the return to the caller's restored context in a
sub-call."""
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
        instruction.step_state_transition_to_restored_context(
            rw_counter_delta=1,
            return_data_offset=instruction.fq(0),
            return_data_length=instruction.fq(0),
            gas_left=instruction.curr.gas_left,
        )
