"""EXP gadget (reference: evm_circuit/execution/exp.py:5-51)."""
from ...dsl.value import F, Word
from ...utils.param import GAS_COST_EXP_PER_BYTE
from ..instruction import Instruction, Transition


def exp(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    base = instruction.stack_pop()
    exponent = instruction.stack_pop()
    exponentiation = instruction.stack_push()

    exponent_is_zero = instruction.is_zero(exponent.hi) * instruction.is_zero(exponent.lo)
    exponent_is_one = instruction.is_zero(exponent.hi) * instruction.is_equal(exponent.lo, 1)

    m_zero = instruction.mask_of(exponent_is_zero)
    m_one = instruction.mask_of(exponent_is_one)
    m_rest = ~(m_zero | m_one)

    with instruction.masked(m_zero):
        instruction.constrain_equal(exponentiation.lo, 1)
        instruction.constrain_zero(exponentiation.hi)
    with instruction.masked(m_one):
        instruction.constrain_equal(exponentiation.lo, base.lo)
        instruction.constrain_equal(exponentiation.hi, base.hi)
    with instruction.masked(m_rest):
        base_limbs = base.to_64s()
        identifier = instruction.curr.rw_counter + instruction.rw_counter_offset
        single_step = instruction.is_zero(exponent.hi) * instruction.is_equal(exponent.lo, 2)

        res = instruction.exp_lookup(identifier, single_step, base_limbs, exponent)
        int_res = instruction.exp_lookup(
            identifier, instruction.fq(1), base_limbs,
            Word(instruction.fq(2), instruction.fq(0)),
        )
        instruction.mul_add_words(base, base, instruction.word(0), int_res)
        instruction.constrain_equal_word(res, exponentiation)

    exponent_byte_size = instruction.byte_size(exponent)
    dynamic_gas_cost = GAS_COST_EXP_PER_BYTE * exponent_byte_size

    instruction.step_state_transition_in_same_context(
        opcode,
        program_counter=Transition.delta(1),
        rw_counter=Transition.delta(3),
        stack_pointer=Transition.delta(1),
        dynamic_gas_cost=dynamic_gas_cost,
    )
