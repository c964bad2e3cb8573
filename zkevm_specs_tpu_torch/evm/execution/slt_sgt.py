"""SLT/SGT gadget (reference: evm_circuit/execution/slt_sgt.py:6-56)."""
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def scmp(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    is_sgt, _ = instruction.pair_select(opcode, Opcode.SGT, Opcode.SLT)

    a = instruction.stack_pop()
    b = instruction.stack_pop()
    c = instruction.stack_push()

    aa = instruction.select_word(is_sgt, b, a)
    bb = instruction.select_word(is_sgt, a, b)

    a8s = aa.to_le_bytes()
    b8s = bb.to_le_bytes()
    c8s = c.to_le_bytes()

    # reference asserts c8s[31] == 0 (plain assert -> constraint)
    instruction.constrain_zero(c8s[31])
    cc = instruction.bytes_to_fq(c8s[:31])

    a_lt_b_lo, _ = instruction.compare(aa.lo, bb.lo, 16)
    a_lt_b_hi, a_eq_b_hi = instruction.compare(aa.hi, bb.hi, 16)
    a_lt_b = instruction.select(
        a_lt_b_hi, instruction.fq(1),
        instruction.select(a_eq_b_hi * a_lt_b_lo, instruction.fq(1), instruction.fq(0)),
    )

    a_neg = instruction.fq(127).lt_mask(a8s[31])
    b_neg = instruction.fq(127).lt_mask(b8s[31])
    # a < 0 and b >= 0 => result 1; b < 0 and a >= 0 => result 0; else a_lt_b
    with instruction.masked(a_neg & ~b_neg):
        instruction.constrain_equal(cc, 1)
    with instruction.masked(b_neg & ~a_neg):
        instruction.constrain_equal(cc, 0)
    with instruction.masked(~(a_neg ^ b_neg)):
        instruction.constrain_equal(cc, a_lt_b)

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(3),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(1),
    )
