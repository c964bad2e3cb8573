"""JUMPI gadget (reference: evm_circuit/execution/jumpi.py:6-33).

Counterpart of ``zkevm_specs_tpu/evm/execution/jumpi.py``.  The reference's
``if instruction.is_zero_word(cond):`` always takes the fall-through branch
(FQ has no __bool__), so its JUMPI never constrains a real jump; the JAX
package implements the intended semantics (jump when cond != 0), which
accepts and rejects every reference vector alike, and so does the port."""
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def jumpi(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.JUMPI))

    dest_word = instruction.stack_pop()
    instruction.constrain_zero(dest_word.hi)
    dest = dest_word.lo

    cond = instruction.stack_pop()

    cond_is_zero = instruction.is_zero_word(cond)
    taken = instruction.mask_of(1 - cond_is_zero)
    with instruction.masked(taken):
        instruction.constrain_equal(
            instruction.fq(Opcode.JUMPDEST), instruction.opcode_lookup_at(dest, True)
        )
    pc_diff = instruction.select(
        cond_is_zero, instruction.fq(1), dest - instruction.curr.program_counter
    )

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(2),
        program_counter=Transition.delta(pc_diff),
        stack_pointer=Transition.delta(2),
    )
