"""AND/OR/XOR gadget (reference: evm_circuit/execution/bitwise.py:7-29)."""
from ...tables.schemas import FixedTableTag
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def bitwise(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    a = instruction.stack_pop()
    b = instruction.stack_pop()
    c = instruction.stack_push()

    a8s = a.to_le_bytes()
    b8s = b.to_le_bytes()
    c8s = c.to_le_bytes()

    # the reference computes tag = BitwiseAnd + (opcode - AND); here each of
    # the three computed-predicate tables is checked under its opcode mask
    tags = (
        (FixedTableTag.BitwiseAnd, instruction.is_equal(opcode, int(Opcode.AND))),
        (FixedTableTag.BitwiseOr, instruction.is_equal(opcode, int(Opcode.OR))),
        (FixedTableTag.BitwiseXor, instruction.is_equal(opcode, int(Opcode.XOR))),
    )
    for idx in range(32):
        for tag, sel in tags:
            with instruction.masked(instruction.mask_of(sel)):
                instruction.fixed_lookup(tag, a8s[idx], b8s[idx], c8s[idx])

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(3),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(1),
    )
