"""Copy-family gadgets: CALLDATACOPY, CODECOPY, EXTCODECOPY, RETURNDATACOPY,
SHA3 (reference: evm_circuit/execution/{calldatacopy,codecopy,extcodecopy,
returndatacopy,sha3}.py).

Counterpart of ``zkevm_specs_tpu/evm/execution/copy_family.py``."""
from ...tables.schemas import RW, AccountFieldTag, CallContextFieldTag, CopyDataTypeTag
from ...utils.param import (
    EXTRA_GAS_COST_ACCOUNT_COLD_ACCESS,
    GAS_COST_COPY_SHA3,
    N_BYTES_MEMORY_ADDRESS,
    N_BYTES_MEMORY_WORD_SIZE,
)
from ..instruction import Instruction, Transition


def calldatacopy(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    memory_offset_word = instruction.stack_pop()
    data_offset_word = instruction.stack_pop()
    length_word = instruction.stack_pop()

    memory_offset, length = instruction.memory_offset_and_length(memory_offset_word, length_word)
    data_offset = instruction.word_to_fq(data_offset_word, N_BYTES_MEMORY_ADDRESS)

    if instruction.branch(instruction.curr.is_root):
        src_id = instruction.call_context_lookup(CallContextFieldTag.TxId, RW.Read)
        call_data_length = instruction.call_context_lookup(CallContextFieldTag.CallDataLength, RW.Read)
        call_data_offset = instruction.fq(0)
        src_tag = CopyDataTypeTag.TxCalldata
    else:
        src_id = instruction.call_context_lookup(CallContextFieldTag.CallerId, RW.Read)
        call_data_length = instruction.call_context_lookup(CallContextFieldTag.CallDataLength, RW.Read)
        call_data_offset = instruction.call_context_lookup(CallContextFieldTag.CallDataOffset, RW.Read)
        src_tag = CopyDataTypeTag.Memory

    next_memory_size, memory_expansion_gas_cost = instruction.memory_expansion_dynamic_length(
        memory_offset, length
    )
    gas_cost = instruction.memory_copier_gas_cost(length, memory_expansion_gas_cost)

    has_length = 1 - instruction.is_zero(length)
    with instruction.masked(instruction.mask_of(has_length)):
        copy_rwc_inc, _ = instruction.copy_lookup(
            src_id,
            src_tag,
            instruction.curr.call_id,
            CopyDataTypeTag.Memory,
            call_data_offset + data_offset,
            call_data_offset + call_data_length,
            memory_offset,
            length,
            instruction.curr.rw_counter + instruction.rw_counter_offset,
        )
    copy_rwc_inc = instruction.select(has_length, copy_rwc_inc, instruction.fq(0))

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(instruction.rw_counter_offset + copy_rwc_inc),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(3),
        memory_word_size=Transition.to(next_memory_size),
        dynamic_gas_cost=gas_cost,
    )


def codecopy(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    memory_offset_word = instruction.stack_pop()
    code_offset_word = instruction.stack_pop()
    size_word = instruction.stack_pop()

    memory_offset, size = instruction.memory_offset_and_length(memory_offset_word, size_word)
    code_offset = instruction.word_to_fq(code_offset_word, N_BYTES_MEMORY_ADDRESS)

    code_size = instruction.bytecode_length(instruction.curr.code_hash)

    next_memory_size, memory_expansion_gas_cost = instruction.memory_expansion_dynamic_length(
        memory_offset, size
    )
    gas_cost = instruction.memory_copier_gas_cost(size, memory_expansion_gas_cost)

    has_size = 1 - instruction.is_zero(size)
    with instruction.masked(instruction.mask_of(has_size)):
        copy_rwc_inc, _ = instruction.copy_lookup(
            instruction.curr.code_hash,
            CopyDataTypeTag.Bytecode,
            instruction.curr.call_id,
            CopyDataTypeTag.Memory,
            code_offset,
            code_size,
            memory_offset,
            size,
            instruction.curr.rw_counter + instruction.rw_counter_offset,
        )
    copy_rwc_inc = instruction.select(has_size, copy_rwc_inc, instruction.fq(0))

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(instruction.rw_counter_offset + copy_rwc_inc),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(3),
        memory_word_size=Transition.to(next_memory_size),
        dynamic_gas_cost=gas_cost,
    )


def extcodecopy(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    address = instruction.word_to_address(instruction.stack_pop())
    memory_offset_word = instruction.stack_pop()
    code_offset_word = instruction.stack_pop()
    size_word = instruction.stack_pop()

    code_offset = instruction.word_to_u64(code_offset_word)
    memory_offset, size = instruction.memory_offset_and_length(memory_offset_word, size_word)

    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    is_warm = instruction.add_account_to_access_list(tx_id, address, instruction.reversion_info())

    code_hash = instruction.account_read_word(address, AccountFieldTag.CodeHash)
    exists = 1 - instruction.is_zero_word(code_hash)
    with instruction.masked(instruction.mask_of(exists)):
        looked_up_size = instruction.bytecode_length(code_hash)
    code_size = instruction.select(exists, looked_up_size, instruction.fq(0))

    next_memory_size, memory_expansion_gas_cost = instruction.memory_expansion_dynamic_length(
        memory_offset, size
    )
    memory_copier_gas_cost = instruction.memory_copier_gas_cost(size, memory_expansion_gas_cost)
    gas_cost = memory_copier_gas_cost + instruction.select(
        is_warm, instruction.fq(0), instruction.fq(EXTRA_GAS_COST_ACCOUNT_COLD_ACCESS)
    )

    has_size = 1 - instruction.is_zero(size)
    with instruction.masked(instruction.mask_of(has_size)):
        copy_rwc_inc, _ = instruction.copy_lookup(
            code_hash,
            CopyDataTypeTag.Bytecode,
            instruction.curr.call_id,
            CopyDataTypeTag.Memory,
            code_offset,
            code_size,
            memory_offset,
            size,
            instruction.curr.rw_counter + instruction.rw_counter_offset,
        )
    copy_rwc_inc = instruction.select(has_size, copy_rwc_inc, instruction.fq(0))

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(instruction.rw_counter_offset + copy_rwc_inc),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(4),
        memory_word_size=Transition.to(next_memory_size),
        # the access-list write is reversible and must advance the
        # counter (deviation: the reference leaves it Same here but counts
        # the identical write in extcodesize.py:40/storage.py:45, which
        # would make mirror offsets collide in an integrated witness)
        reversible_write_counter=Transition.delta(1),
        dynamic_gas_cost=gas_cost,
    )


def returndatacopy(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    memory_offset_word = instruction.stack_pop()
    offset_word = instruction.stack_pop()
    size_word = instruction.stack_pop()

    last_callee_id = instruction.call_context_lookup(CallContextFieldTag.LastCalleeId)
    return_data_length = instruction.call_context_lookup(
        CallContextFieldTag.LastCalleeReturnDataLength, RW.Read
    )
    return_data_offset = instruction.call_context_lookup(
        CallContextFieldTag.LastCalleeReturnDataOffset, RW.Read
    )

    instruction.range_check(
        return_data_length
        - (instruction.word_to_fq(offset_word, 8) + instruction.word_to_fq(size_word, 8)),
        N_BYTES_MEMORY_WORD_SIZE,
    )

    memory_offset, size = instruction.memory_offset_and_length(memory_offset_word, size_word)
    next_memory_size, memory_expansion_gas_cost = instruction.memory_expansion_dynamic_length(
        memory_offset, size
    )
    gas_cost = instruction.memory_copier_gas_cost(size, memory_expansion_gas_cost)

    copy_rwc_inc, _ = instruction.copy_lookup(
        last_callee_id,
        CopyDataTypeTag.Memory,
        instruction.curr.call_id,
        CopyDataTypeTag.Memory,
        return_data_offset,
        return_data_offset + size,
        memory_offset,
        size,
        instruction.curr.rw_counter + instruction.rw_counter_offset,
    )

    # reference asserts copy_rwc_inc == 2*size (returndatacopy.py:51)
    instruction.constrain_equal(copy_rwc_inc, size * 2)
    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(instruction.rw_counter_offset + copy_rwc_inc),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(3),
        memory_word_size=Transition.to(next_memory_size),
        dynamic_gas_cost=gas_cost,
    )


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
