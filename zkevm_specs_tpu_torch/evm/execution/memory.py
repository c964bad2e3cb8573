"""MLOAD/MSTORE/MSTORE8 gadget (reference: evm_circuit/execution/memory.py:7-46).

Counterpart of ``zkevm_specs_tpu/evm/execution/memory.py``.  The reference
checks the memory bytes with a non-constraining ``is_equal``; that is
mirrored, so the verdicts are the same."""
from ...tables.schemas import RW
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def memory(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    address = instruction.word_to_address(instruction.stack_pop())

    is_mload = instruction.is_equal(opcode, int(Opcode.MLOAD))
    is_mstore8 = instruction.is_equal(opcode, int(Opcode.MSTORE8))
    is_store = 1 - is_mload
    is_not_mstore8 = 1 - is_mstore8

    if instruction.branch(is_mload):
        value = instruction.stack_push()
    else:
        value = instruction.stack_pop()
    value_le_bytes = value.to_le_bytes()

    memory_offset = instruction.curr.memory_word_size
    next_memory_size, memory_expansion_gas_cost = instruction.memory_expansion(
        memory_offset, address + 1 + (is_not_mstore8 * 31)
    )

    if instruction.branch(is_mstore8):
        instruction.is_equal(instruction.memory_lookup(RW.Write, address), value_le_bytes[0])
    if instruction.branch(is_not_mstore8):
        for idx in range(32):
            if instruction.branch(is_store):
                mem_byte = instruction.memory_lookup(RW.Write, address + idx)
            else:
                mem_byte = instruction.memory_lookup(RW.Read, address + idx)
            instruction.is_equal(mem_byte, value_le_bytes[31 - idx])

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(34 - (is_mstore8 * 31)),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(is_store * 2),
        memory_word_size=Transition.to(next_memory_size),
        dynamic_gas_cost=memory_expansion_gas_cost,
    )
