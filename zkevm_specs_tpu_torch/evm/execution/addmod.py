"""ADDMOD gadget (reference: evm_circuit/execution/addmod.py:7-70)."""
from ...dsl.value import F, Word
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def lt_u256(instruction: Instruction, a: Word, b: Word) -> F:
    a_lt_b_lo, _ = instruction.compare(a.lo, b.lo, 16)
    a_lt_b_hi, a_eq_b_hi = instruction.compare(a.hi, b.hi, 16)
    return instruction.select(
        a_lt_b_hi, instruction.fq(1),
        instruction.select(a_eq_b_hi * a_lt_b_lo, instruction.fq(1), instruction.fq(0)),
    )


def addmod(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.ADDMOD))

    a = instruction.stack_pop()
    b = instruction.stack_pop()
    n = instruction.stack_pop()
    pushed_r = instruction.stack_push()

    # witness hints
    ai = instruction.ints_of(a)
    bi = instruction.ints_of(b)
    ni = instruction.ints_of(n)
    a_red, k, d, r_hint = [], [], [], []
    for av, bv, nv in zip(ai, bi, ni):
        if nv == 0:
            a_red.append(av)
            k.append(0)
            d.append(0)
            r_hint.append((av + bv) % (1 << 256))
        else:
            a_red.append(av % nv)
            k.append(av // nv)
            d.append(((av % nv) + bv) // nv)
            r_hint.append(None)
    n_is_zero_any = any(v == 0 for v in ni)
    a_reduced = instruction.word_hint(a_red)
    k_w = instruction.word_hint(k)
    d_w = instruction.word_hint(d)
    pr = instruction.ints_of(pushed_r)
    r = instruction.word_hint(
        [rh if rh is not None else pv for rh, pv in zip(r_hint, pr)]
    )

    # check a == a_reduced + k * n
    overflow = instruction.mul_add_words(k_w, n, a_reduced, a)
    instruction.constrain_zero(overflow)

    # check a_reduced + b == d * n + r in 512-bit space
    a_reduced_plus_b, overflow = instruction.add_words([a_reduced, b])
    n_is_zero = instruction.is_zero_word(n)
    hi_word = instruction.select_word(n_is_zero, instruction.word(0), Word.from_lo(overflow))
    instruction.mul_add_words_512(d_w, n, r, hi_word, a_reduced_plus_b)

    # r < n and a_reduced < n iff n != 0
    r_lt_n = lt_u256(instruction, r, n)
    a_reduced_lt_n = lt_u256(instruction, a_reduced, n)
    instruction.constrain_zero(2 - (a_reduced_lt_n + r_lt_n + 2 * n_is_zero))

    # reference asserts pushed_r == r * (1 - n_is_zero) (addmod.py:65)
    expected = r.select_scale(1 - n_is_zero)
    instruction.constrain_equal_word(pushed_r, expected)

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(4),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(2),
    )
