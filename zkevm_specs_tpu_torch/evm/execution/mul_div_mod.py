"""MUL/DIV/MOD gadget (reference: evm_circuit/execution/mul_div_mod.py:6-73)."""
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def mul_div_mod(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    # degree-2 selectors out of opcode values 2/4/6 (see reference comment)
    is_mul = ((int(Opcode.DIV) - opcode) * (int(Opcode.MOD) - opcode)).fdiv_const(8)
    is_div = ((opcode - int(Opcode.MUL)) * (int(Opcode.MOD) - opcode)).fdiv_const(4)
    is_mod = ((opcode - int(Opcode.MUL)) * (opcode - int(Opcode.DIV))).fdiv_const(8)

    pop1 = instruction.stack_pop()
    pop2 = instruction.stack_pop()
    push = instruction.stack_push()

    # witness assignment (per-lane host hints)
    p1 = instruction.ints_of(pop1)
    p2 = instruction.ints_of(pop2)
    ps = instruction.ints_of(push)
    if instruction.branch(is_mul):
        a, b, c, d = pop1, pop2, instruction.word(0), push
    elif instruction.branch(is_div):
        d, b, a = pop1, pop2, push
        c = instruction.word_hint([di - bi * ai for di, bi, ai in zip(p1, p2, ps)])
    else:
        d, b = pop1, pop2
        a = instruction.word_hint(
            [0 if bi == 0 else (di - ci) // bi for di, bi, ci in zip(p1, p2, ps)]
        )
        # c = d where divisor == 0, else the pushed remainder
        zero_div = instruction.is_zero_word(b)
        c = instruction.select_word(zero_div, d, push)

    divisor_is_zero = instruction.is_zero_word(b)
    overflow = instruction.mul_add_words(a, b, c, d)

    instruction.constrain_equal_word(pop1, instruction.select_word(is_mul, a, d))
    instruction.constrain_equal_word(pop2, b)
    instruction.constrain_equal_word(
        push,
        d.select_scale(is_mul)
        .add_lanes(a.select_scale(is_div * (1 - divisor_is_zero)))
        .add_lanes(c.select_scale(is_mod * (1 - divisor_is_zero))),
    )

    instruction.constrain_zero(is_mul * instruction.sum(c.to_le_bytes()))

    lt, _ = instruction.compare_word(c, b)
    instruction.constrain_zero((1 - is_mul) * (1 - divisor_is_zero) * (1 - lt))
    instruction.constrain_zero((1 - is_mul) * overflow)

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(3),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(1),
    )
