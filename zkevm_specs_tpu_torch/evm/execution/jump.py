"""JUMP gadget (reference: evm_circuit/execution/jump.py:5-24).

Counterpart of ``zkevm_specs_tpu/evm/execution/jump.py``."""
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def jump(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.JUMP))

    dest_word = instruction.stack_pop()
    instruction.constrain_zero(dest_word.hi)
    dest = dest_word.lo

    instruction.constrain_equal(
        instruction.fq(Opcode.JUMPDEST), instruction.opcode_lookup_at(dest, True)
    )

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(1),
        program_counter=Transition.to(dest),
        stack_pointer=Transition.delta(1),
    )
