"""LT/GT/EQ gadget (reference: evm_circuit/execution/comparator.py:6-47)."""
from ...dsl.value import Word
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def cmp(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    is_eq = instruction.is_equal(opcode, int(Opcode.EQ))
    is_gt = instruction.is_equal(opcode, int(Opcode.GT))

    a = instruction.stack_pop()
    b = instruction.stack_pop()
    c = instruction.stack_push()

    # swap operands when GT
    aa = instruction.select_word(is_gt, b, a)
    bb = instruction.select_word(is_gt, a, b)

    lt_lo, eq_lo = instruction.compare(aa.lo, bb.lo, 16)
    lt_hi, eq_hi = instruction.compare(aa.hi, bb.hi, 16)

    lt = instruction.select(lt_hi, instruction.fq(1), eq_hi * lt_lo)
    eq = eq_lo * eq_hi
    result = instruction.select(is_eq, eq, lt)

    instruction.constrain_equal_word(Word.from_lo(result), c)

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(3),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(1),
    )
