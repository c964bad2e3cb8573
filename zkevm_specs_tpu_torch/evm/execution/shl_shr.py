"""SHL/SHR gadget (reference: evm_circuit/execution/shl_shr.py:6-133)."""
from ...dsl.value import Word
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def shl_shr(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    pop1 = instruction.stack_pop()
    pop2 = instruction.stack_pop()
    push = instruction.stack_push()

    is_shl = int(Opcode.SHR) - opcode
    shift = pop1
    shift_le_bytes = shift.to_le_bytes()
    shf0 = shift_le_bytes[0]

    # witness: divisor = 2^shf0 if shift < 256 else 0
    sh_ints = instruction.ints_of(shift)
    divisor = instruction.word_hint(
        [(1 << (s & 0xFF)) if s < 256 else 0 for s in sh_ints]
    )

    if instruction.branch(is_shl):
        dividend = push
        quotient = pop2
        remainder = instruction.word(0)
    else:
        dividend = pop2
        quotient = push
        di = instruction.ints_of(dividend)
        qi = instruction.ints_of(quotient)
        dv = instruction.ints_of(divisor)
        remainder = instruction.word_hint(
            [d - q * v for d, q, v in zip(di, qi, dv)]
        )

    is_shr = 1 - is_shl
    shf_lt256 = instruction.is_zero(instruction.sum(shift_le_bytes[1:]))
    divisor_is_zero = instruction.is_zero_word(divisor)

    instruction.constrain_equal_word(pop1, shift)
    instruction.constrain_equal_word(
        pop2,
        quotient.select_scale(is_shl).add_lanes(dividend.select_scale(is_shr)),
    )
    instruction.constrain_equal_word(
        push,
        dividend.select_scale(is_shl).add_lanes(
            quotient.select_scale(is_shr * (1 - divisor_is_zero))
        ),
    )
    instruction.constrain_zero(shf0 - shift_le_bytes[0])

    instruction.constrain_equal_word(
        shift.select_scale(1 - divisor_is_zero),
        Word.from_lo(shift_le_bytes[0]).select_scale(1 - divisor_is_zero),
    )

    instruction.constrain_zero(1 - divisor_is_zero - shf_lt256)

    remainder_lt_divisor, _ = instruction.compare_word(remainder, divisor)
    instruction.constrain_zero((1 - divisor_is_zero) * (1 - remainder_lt_divisor))

    remainder_is_zero = instruction.is_zero_word(remainder)
    instruction.constrain_zero(is_shl * (1 - remainder_is_zero))

    overflow = instruction.mul_add_words(quotient, divisor, remainder, dividend)
    instruction.constrain_zero(is_shr * overflow)

    with instruction.masked(instruction.mask_of(1 - divisor_is_zero)):
        instruction.pow2_lookup(shf0, divisor.lo, divisor.hi)

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(3),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(1),
    )
