"""NOT gadget (reference: evm_circuit/execution/not_.py:5-24)."""
from ...tables.schemas import FixedTableTag
from ..instruction import Instruction, Transition


def not_opcode(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    a = instruction.stack_pop()
    b = instruction.stack_push()
    a_le_bytes = a.to_le_bytes()
    b_le_bytes = b.to_le_bytes()

    for i in range(32):
        instruction.fixed_lookup(
            FixedTableTag.BitwiseXor, a_le_bytes[i], b_le_bytes[i], instruction.fq(255)
        )

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(2),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.same(),
    )
