"""GAS gadget (reference: evm_circuit/execution/gas.py:6-19).

Counterpart of ``zkevm_specs_tpu/evm/execution/gas.py``."""
from ...dsl.value import Word
from ..instruction import Instruction, Transition
from ..opcode import Opcode, constant_gas_cost


def gas(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.GAS))

    instruction.constrain_equal_word(
        Word.from_lo(instruction.curr.gas_left - constant_gas_cost(Opcode.GAS)),
        instruction.stack_push(),
    )

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(1),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(-1),
    )
