"""SDIV/SMOD gadget (reference: evm_circuit/execution/sdiv_smod.py:6-133)."""
from ...dsl.value import Word
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def _int_abs(x: int) -> int:
    return ((1 << 256) - x) if (x >> 255) else x


def _int_neg(x: int) -> int:
    return 0 if x == 0 else (1 << 256) - x


def sdiv_smod(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    pop1 = instruction.stack_pop()
    pop2 = instruction.stack_pop()
    push = instruction.stack_push()

    quotient, divisor, remainder, dividend = _gen_witness(instruction, opcode, pop1, pop2, push)
    _check_witness(instruction, quotient, divisor, remainder, dividend)

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(3),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(1),
    )


def _check_witness(instruction: Instruction, quotient, divisor, remainder, dividend):
    quotient_abs, quotient_is_neg = instruction.abs_word(quotient)
    divisor_abs, divisor_is_neg = instruction.abs_word(divisor)
    remainder_abs, remainder_is_neg = instruction.abs_word(remainder)
    dividend_abs, dividend_is_neg = instruction.abs_word(dividend)

    quotient_is_non_zero = 1 - instruction.is_zero_word(quotient)
    divisor_is_non_zero = 1 - instruction.is_zero_word(divisor)
    remainder_is_non_zero = 1 - instruction.is_zero_word(remainder)

    overflow = instruction.mul_add_words(quotient_abs, divisor_abs, remainder_abs, dividend_abs)
    instruction.constrain_zero(overflow)

    remainder_abs_lt_divisor_abs, _ = instruction.compare_word(remainder_abs, divisor_abs)
    instruction.constrain_zero((1 - remainder_abs_lt_divisor_abs) * divisor_is_non_zero)

    condition = quotient_is_non_zero * divisor_is_non_zero * remainder_is_non_zero
    instruction.constrain_zero((dividend_is_neg - remainder_is_neg) * condition)

    dividend_is_signed_overflow = instruction.is_neg_word(dividend_abs)
    condition = quotient_is_non_zero * divisor_is_non_zero * (1 - dividend_is_signed_overflow)
    instruction.constrain_zero(
        (quotient_is_neg + divisor_is_neg - 2 * quotient_is_neg * divisor_is_neg - dividend_is_neg)
        * condition,
    )


def _gen_witness(instruction: Instruction, opcode, pop1, pop2, push):
    is_sdiv = (int(Opcode.SMOD) - opcode).fdiv_const(2)

    p1 = instruction.ints_of(pop1)
    p2 = instruction.ints_of(pop2)
    ps = instruction.ints_of(push)

    if instruction.branch(is_sdiv):
        quotient = push
        divisor = pop2
        rem = []
        for a, b, c in zip(p1, p2, ps):
            raw = _int_abs(a) - _int_abs(c) * _int_abs(b)
            rem.append(raw if (a >> 255) == 0 else _int_neg(raw % (1 << 256)))
        remainder = instruction.word_hint(rem)
        dividend = pop1
    else:
        quo = []
        for a, b in zip(p1, p2):
            if b == 0:
                quo.append(0)
            elif (a >> 255) == (b >> 255):
                quo.append(_int_abs(a) // _int_abs(b))
            else:
                quo.append(_int_neg(_int_abs(a) // _int_abs(b)))
        quotient = instruction.word_hint(quo)
        divisor = pop2
        remainder = instruction.select_word(instruction.is_zero_word(pop2), pop1, push)
        dividend = pop1

    return quotient, divisor, remainder, dividend
