"""The copy-family gadgets: SHA3 (reference: evm_circuit/execution/sha3.py).

Counterpart of ``zkevm_specs_tpu/evm/execution/copy_family.py:sha3``
(:223-265); CALLDATACOPY, CODECOPY, EXTCODECOPY and RETURNDATACOPY are not
ported."""
from ...tables.schemas import CopyDataTypeTag
from ...utils.param import GAS_COST_COPY_SHA3
from ..instruction import Instruction, Transition


def sha3(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    offset = instruction.stack_pop()
    size = instruction.stack_pop()
    sha3_value = instruction.stack_push()

    memory_offset, length = instruction.memory_offset_and_length(offset, size)

    has_length = 1 - instruction.is_zero(length)
    with instruction.masked(instruction.mask_of(has_length)):
        copy_rwc_inc, rlc_acc = instruction.copy_lookup(
            instruction.curr.call_id,
            CopyDataTypeTag.Memory,
            instruction.curr.call_id,
            CopyDataTypeTag.RlcAcc,
            memory_offset,
            memory_offset + length,
            instruction.fq(0),
            length,
            instruction.curr.rw_counter + instruction.rw_counter_offset,
        )
    copy_rwc_inc = instruction.select(has_length, copy_rwc_inc, instruction.fq(0))
    rlc_acc = instruction.select(has_length, rlc_acc, instruction.fq(0))

    keccak256_output = instruction.keccak_lookup(length, rlc_acc)
    instruction.constrain_equal_word(keccak256_output, sha3_value)

    next_memory_size, memory_expansion_gas_cost = instruction.memory_expansion_dynamic_length(
        memory_offset, length
    )
    gas_cost = instruction.memory_copier_gas_cost(
        length, memory_expansion_gas_cost, GAS_COST_COPY_SHA3
    )

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(instruction.rw_counter_offset + copy_rwc_inc),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(1),
        memory_word_size=Transition.to(next_memory_size),
        dynamic_gas_cost=gas_cost,
    )
