"""MULMOD gadget (reference: evm_circuit/execution/mulmod.py:7-72)."""
from ...dsl.value import Word
from ..instruction import Instruction, Transition
from ..opcode import Opcode

MOD = 2**256


def _mod_gadget(instruction: Instruction, a: Word, n: Word, r: Word):
    """Constrain r = a mod n (r = 0 if n == 0) — reference mulmod.py:7-30."""
    ai = instruction.ints_of(a)
    ni = instruction.ints_of(n)
    k = [0 if nv == 0 else av // nv for av, nv in zip(ai, ni)]
    n_is_zero = instruction.is_zero_word(n)
    a_or_zero = instruction.select_word(n_is_zero, instruction.word(0), a)
    instruction.mul_add_words(instruction.word_hint(k), n, r, a_or_zero)
    eq = instruction.is_equal_word(a, a_or_zero)
    cmp = instruction.compare_word(r, n)
    a_or_is_zero = instruction.is_zero_word(a_or_zero)
    instruction.constrain_zero((1 - eq) * (1 - n_is_zero * a_or_is_zero))
    instruction.constrain_zero(1 - cmp[0] - n_is_zero)


def mulmod(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.MULMOD))

    a = instruction.stack_pop()
    b = instruction.stack_pop()
    n = instruction.stack_pop()
    r = instruction.stack_push()

    ai = instruction.ints_of(a)
    bi = instruction.ints_of(b)
    ni = instruction.ints_of(n)
    ri = instruction.ints_of(r)

    a_red, k, d, e = [], [], [], []
    for av, bv, nv in zip(ai, bi, ni):
        ar = 0 if nv == 0 else av % nv
        kv = 0 if nv == 0 else (ar * bv) // nv
        a_red.append(ar)
        k.append(kv)
        prod = ar * bv
        e.append(prod % MOD)
        d.append(prod // MOD)
    a_reduced = instruction.word_hint(a_red)
    # reference safety assert (mulmod.py:53): a_reduced*b == k*n + r.  The
    # eager pass evaluates it on the host ints and records its bits as a
    # hint, so the replay checks the same bits (the JAX package's replay
    # compares placeholders there, and fails every lane)
    identity = instruction.f_hint(
        [int(ar * bv == kv * nv + rv) for ar, bv, nv, rv, kv in zip(a_red, bi, ni, ri, k)], 1)
    instruction.cs.check(
        identity.eq_mask(1),
        lambda: "mulmod witness identity a_reduced*b == k*n + r violated",
    )

    _mod_gadget(instruction, a, n, a_reduced)
    d_w = instruction.word_hint(d)
    e_w = instruction.word_hint(e)
    instruction.mul_add_words_512(a_reduced, b, instruction.word(0), d_w, e_w)
    instruction.mul_add_words_512(instruction.word_hint(k), n, r, d_w, e_w)

    n_is_zero = instruction.is_zero_word(n)
    cmp = instruction.compare_word(r, n)
    instruction.constrain_zero(1 - cmp[0] - n_is_zero)

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(4),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(2),
    )
