"""BYTE gadget (reference: evm_circuit/execution/byte.py:5-39)."""
from ...dsl.value import Word
from ..instruction import Instruction, Transition


def byte(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    a = instruction.stack_pop()
    b = instruction.stack_pop()
    c = instruction.stack_push()

    index = a.to_le_bytes()
    value = b.to_le_bytes()

    is_msb_sum_zero = instruction.is_zero(instruction.sum(index[1:]))
    is_byte_selected = [
        instruction.is_equal(index[0], 31 - idx) for idx in range(32)
    ]

    selected_byte = instruction.fq(0)
    for cell, is_selected in zip(value, is_byte_selected):
        selected_byte = selected_byte + is_selected * is_msb_sum_zero * cell

    instruction.constrain_equal_word(Word.from_lo(selected_byte), c)

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(3),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(1),
    )
