"""Error-state gadgets (reference: evm_circuit/execution/error_*.py).

Counterpart of ``zkevm_specs_tpu/evm/execution/errors.py``, every gadget
(ErrorOutOfGasPrecompile's, a precompile call given too little gas,
included).  All
constrain IsSuccess == 0 and share ``Instruction.constrain_error_state``
(reference instruction.py:1426-1452)."""
from ...tables.schemas import RW, CallContextFieldTag, FixedTableTag
from ...utils.param import (
    COLD_SLOAD_COST,
    GAS_COST_ACCOUNT_COLD_ACCESS,
    GAS_COST_CODE_DEPOSIT,
    GAS_COST_COPY_SHA3,
    GAS_COST_CREATE,
    GAS_COST_CREATION_TX,
    GAS_COST_EXP_PER_BYTE,
    GAS_COST_FASTEST,
    GAS_COST_INITCODE_WORD,
    GAS_COST_LOG,
    GAS_COST_LOGDATA,
    GAS_COST_SHA3,
    GAS_COST_SLOW,
    GAS_COST_SSTORE_SENTRY_EIP2200,
    GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE,
    GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE,
    GAS_COST_WARM_ACCESS,
    INVALID_FIRST_BYTE_CONTRACT_CODE,
    MAX_CODE_SIZE,
    MAX_INIT_CODE_SIZE,
    MAX_N_BYTES,
    MAX_U64,
    Bn254PairingPerPointGas,
    IdentityPerWordGas,
    N_BYTES_GAS,
    N_BYTES_MEMORY_ADDRESS,
    N_BYTES_MEMORY_WORD_SIZE,
    N_BYTES_PROGRAM_COUNTER,
    N_BYTES_STACK,
    N_BYTES_U64,
    SLOAD_GAS,
    SSTORE_RESET_GAS,
    SSTORE_SET_GAS,
    TxGas,
    TxGasContractCreation,
    TxDataNonZeroGasEIP2028,
    WARM_STORAGE_READ_COST,
)
from ..gadgets.call_gadget import CallGadget
from ..instruction import Instruction
from ..opcode import Opcode
from ..precompile import Precompile


def _finish(instruction: Instruction):
    instruction.constrain_error_state(
        instruction.rw_counter_offset + instruction.curr.reversible_write_counter
    )


def error_invalid_opcode(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.responsible_opcode_lookup(opcode)
    _finish(instruction)


def error_stack(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.responsible_opcode_lookup(opcode, instruction.curr.stack_pointer)
    _finish(instruction)


def error_invalid_jump(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_in(opcode, [int(Opcode.JUMP), int(Opcode.JUMPI)])
    _, is_jumpi = instruction.pair_select(opcode, Opcode.JUMP, Opcode.JUMPI)
    code_length = instruction.bytecode_length(instruction.curr.code_hash)
    dest = instruction.stack_pop()
    if instruction.branch(is_jumpi):
        condition = instruction.stack_pop()
        instruction.constrain_not_zero_word(condition)
    dest_value = instruction.word_to_u64(dest)

    within_range, _ = instruction.compare(dest_value, code_length, N_BYTES_PROGRAM_COUNTER)

    # NOTE: the reference only emits the error-state constraints inside this
    # branch (error_invalid_jump.py:25-33) — mirrored
    if instruction.branch(within_range):
        value, is_code = instruction.bytecode_lookup_pair(instruction.curr.code_hash, dest_value)
        is_jump_dest = instruction.is_equal(value, int(Opcode.JUMPDEST))
        instruction.constrain_zero(is_code * is_jump_dest)
        _finish(instruction)


def error_oog_constant(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    const_gas = instruction.opcode_constant_gas(opcode)
    instruction.fixed_lookup(FixedTableTag.OpcodeConstantGas, opcode, const_gas)

    gas_not_enough, _ = instruction.compare(instruction.curr.gas_left, const_gas, N_BYTES_GAS)
    instruction.constrain_equal(gas_not_enough, 1)
    _finish(instruction)


def error_write_protection(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    selectors = instruction.multiple_select(
        opcode,
        (Opcode.SSTORE, Opcode.CREATE, Opcode.CREATE2, Opcode.CALL,
         Opcode.SELFDESTRUCT, Opcode.LOG0, Opcode.LOG1, Opcode.LOG2,
         Opcode.LOG3, Opcode.LOG4),
    )
    instruction.constrain_equal(instruction.sum(selectors), 1)

    is_static = instruction.call_context_lookup(CallContextFieldTag.IsStatic)
    instruction.constrain_equal(is_static, 1)

    is_call = selectors[3]
    if instruction.branch(is_call):
        value = instruction.stack_lookup(RW.Read, 2)
        instruction.constrain_not_zero_word(value)
    _finish(instruction)


def error_oog_account_access(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    sels = instruction.multiple_select(
        opcode, (Opcode.BALANCE, Opcode.EXTCODESIZE, Opcode.EXTCODEHASH)
    )
    instruction.constrain_equal(instruction.sum(sels), 1)

    # truncating (geth semantics): a dirty-high-bit operand still keys the
    # access list by its low 160 bits (deviation noted in
    # word_to_address_truncated; reference error_oog_account_access.py
    # rejects such words)
    address = instruction.word_to_address_truncated(instruction.stack_pop())
    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    is_warm = instruction.read_account_to_access_list(tx_id, address)
    gas_cost = instruction.select(
        is_warm, instruction.fq(GAS_COST_WARM_ACCESS),
        instruction.fq(GAS_COST_ACCOUNT_COLD_ACCESS),
    )
    insufficient_gas, _ = instruction.compare(instruction.curr.gas_left, gas_cost, N_BYTES_GAS)
    instruction.constrain_equal(insufficient_gas, 1)
    _finish(instruction)


def error_oog_static_memory_expansion(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    is_mload, is_mstore, is_mstore8 = instruction.multiple_select(
        opcode, (Opcode.MLOAD, Opcode.MSTORE, Opcode.MSTORE8)
    )
    instruction.constrain_equal(is_mload + is_mstore + is_mstore8, 1)

    offset = instruction.word_to_fq(instruction.stack_pop(), N_BYTES_MEMORY_ADDRESS)
    size = instruction.select(is_mstore8, instruction.fq(1), instruction.fq(32))
    _, memory_expansion_gas = instruction.memory_expansion_dynamic_length(offset, size)
    gas_cost = GAS_COST_FASTEST + memory_expansion_gas

    insufficient_gas, _ = instruction.compare(instruction.curr.gas_left, gas_cost, N_BYTES_GAS)
    instruction.constrain_equal(insufficient_gas, 1)
    _finish(instruction)


def error_oog_dynamic_memory_expansion(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    is_return, is_revert = instruction.multiple_select(opcode, (Opcode.RETURN, Opcode.REVERT))
    instruction.constrain_equal(is_return + is_revert, 1)

    offset_word = instruction.stack_pop()
    size_word = instruction.stack_pop()
    offset, size = instruction.memory_offset_and_length(offset_word, size_word)
    _, memory_expansion_gas_cost = instruction.memory_expansion(offset, size)

    gas_not_enough, _ = instruction.compare(
        instruction.curr.gas_left, memory_expansion_gas_cost, N_BYTES_GAS
    )
    instruction.constrain_equal(gas_not_enough, 1)
    _finish(instruction)


def error_oog_memory_copy(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    is_cd, is_code, is_ext, is_rd = instruction.multiple_select(
        opcode, (Opcode.CALLDATACOPY, Opcode.CODECOPY, Opcode.EXTCODECOPY, Opcode.RETURNDATACOPY)
    )
    instruction.constrain_equal(is_cd + is_code + is_ext + is_rd, 1)

    stack_offset = 0
    is_extcodecopy = instruction.branch(is_ext)
    if is_extcodecopy:
        external_address = instruction.stack_lookup(RW.Read, stack_offset)
        stack_offset += 1
    memory_offset_word = instruction.stack_lookup(RW.Read, stack_offset)
    copy_size_word = instruction.stack_lookup(RW.Read, stack_offset + 2)

    if is_extcodecopy:
        # deviation: the reference narrows the external address to
        # N_BYTES_MEMORY_ADDRESS (error_oog_memory_copy.py:41), which rejects
        # any real 20-byte address (its own test dodges this with 0xCAFECAFE);
        # we use the full account-address width, truncating high bits like
        # geth (word_to_address_truncated)
        address = instruction.word_to_address_truncated(external_address)
        tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
        is_warm = instruction.read_account_to_access_list(tx_id, address)
        constant_gas = instruction.select(
            is_warm, instruction.fq(GAS_COST_WARM_ACCESS),
            instruction.fq(GAS_COST_ACCOUNT_COLD_ACCESS),
        )
    else:
        constant_gas = instruction.fq(GAS_COST_FASTEST)

    memory_offset, copy_size = instruction.memory_offset_and_length(
        memory_offset_word, copy_size_word
    )
    _, memory_expansion_gas_cost = instruction.memory_expansion_dynamic_length(
        memory_offset, copy_size
    )
    dynamic_gas = instruction.memory_copier_gas_cost(copy_size, memory_expansion_gas_cost)

    gas_not_enough, _ = instruction.compare(
        instruction.curr.gas_left, constant_gas + dynamic_gas, N_BYTES_GAS
    )
    instruction.constrain_equal(gas_not_enough, 1)
    _finish(instruction)


def error_oog_sload_sstore(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    is_sstore, is_sload = instruction.multiple_select(opcode, (Opcode.SSTORE, Opcode.SLOAD))
    instruction.constrain_equal(is_sstore + is_sload, 1)

    storage_key = instruction.stack_pop()
    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    callee_address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    callee_address = instruction.word_to_address(callee_address_word)
    is_warm = instruction.read_account_storage_to_access_list(tx_id, callee_address, storage_key)

    sload = instruction.branch(is_sload)
    if sload:
        gas_cost = instruction.select(
            is_warm, instruction.fq(WARM_STORAGE_READ_COST), instruction.fq(COLD_SLOAD_COST)
        )
    else:
        value = instruction.stack_pop()
        value_prev = instruction.account_storage_read(callee_address, storage_key, tx_id)
        original_value = instruction.word_hint(
            instruction.aux_ints(lambda a: int(a) if a is not None else 0)
        )
        eq_prev = instruction.is_equal_word(value, value_prev)
        prev_eq_orig = instruction.is_equal_word(value_prev, original_value)
        orig_zero = instruction.is_zero_word(original_value)
        slot_gas = instruction.select(
            eq_prev,
            instruction.fq(SLOAD_GAS),
            instruction.select(
                prev_eq_orig,
                instruction.select(
                    orig_zero, instruction.fq(SSTORE_SET_GAS), instruction.fq(SSTORE_RESET_GAS)
                ),
                instruction.fq(SLOAD_GAS),
            ),
        )
        gas_cost = instruction.select(is_warm, slot_gas, slot_gas + COLD_SLOAD_COST)

    insufficient_gas, _ = instruction.compare(instruction.curr.gas_left, gas_cost, N_BYTES_GAS)
    if sload:
        instruction.constrain_equal(insufficient_gas, 1)
    else:
        lt_gas, eq_gas = instruction.compare(
            instruction.curr.gas_left, instruction.fq(GAS_COST_SSTORE_SENTRY_EIP2200), N_BYTES_GAS
        )
        instruction.constrain_not_zero(lt_gas + eq_gas + insufficient_gas)
    _finish(instruction)


def error_oog_call(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    is_call, is_callcode, is_delegatecall, is_staticcall = instruction.multiple_select(
        opcode, (Opcode.CALL, Opcode.CALLCODE, Opcode.DELEGATECALL, Opcode.STATICCALL)
    )
    instruction.constrain_equal(is_call + is_callcode + is_delegatecall + is_staticcall, 1)

    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    call = CallGadget(instruction, instruction.fq(0), is_call, is_callcode,
                      is_delegatecall, is_staticcall)
    is_warm_access = instruction.read_account_to_access_list(tx_id, call.callee_address)
    gas_cost = call.gas_cost(instruction, is_warm_access)
    gas_not_enough, _ = instruction.compare(instruction.curr.gas_left, gas_cost, N_BYTES_GAS)
    instruction.constrain_equal(gas_not_enough, 1)
    _finish(instruction)


def error_oog_log(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.range_lookup(opcode - int(Opcode.LOG0), 5)

    mstart = instruction.word_to_fq(instruction.stack_pop(), N_BYTES_MEMORY_ADDRESS)
    msize = instruction.word_to_fq(instruction.stack_pop(), N_BYTES_MEMORY_ADDRESS)

    _, memory_expansion_gas = instruction.memory_expansion_dynamic_length(mstart, msize)
    gas_cost = (
        GAS_COST_LOG
        + GAS_COST_LOG * (opcode - int(Opcode.LOG0))
        + GAS_COST_LOGDATA * msize
        + memory_expansion_gas
    )
    insufficient_gas, _ = instruction.compare(instruction.curr.gas_left, gas_cost, N_BYTES_GAS)
    instruction.constrain_equal(insufficient_gas, 1)
    _finish(instruction)


def error_oog_exp(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.EXP))

    exponent = instruction.stack_lookup(RW.Read, 1)
    exponent_byte_size = instruction.byte_size(exponent)
    dynamic_gas_cost = GAS_COST_EXP_PER_BYTE * exponent_byte_size

    insufficient_gas, _ = instruction.compare(
        instruction.curr.gas_left, dynamic_gas_cost + GAS_COST_SLOW, N_BYTES_GAS
    )
    instruction.constrain_equal(insufficient_gas, 1)
    _finish(instruction)


def error_oog_sha3(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.SHA3))

    offset_word = instruction.stack_pop()
    size_word = instruction.stack_pop()
    memory_offset, copy_size = instruction.memory_offset_and_length(offset_word, size_word)

    _, memory_expansion_cost = instruction.memory_expansion_dynamic_length(memory_offset, copy_size)
    minimum_word_size, _ = instruction.constant_divmod(copy_size + 31, 32, N_BYTES_MEMORY_WORD_SIZE)
    dynamic_gas = minimum_word_size * GAS_COST_COPY_SHA3 + memory_expansion_cost

    insufficient_gas, _ = instruction.compare(
        instruction.curr.gas_left, dynamic_gas + GAS_COST_SHA3, N_BYTES_GAS
    )
    instruction.constrain_equal(insufficient_gas, 1)
    _finish(instruction)


def error_return_data_out_of_bound(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.RETURNDATACOPY))

    data_offset = instruction.word_to_fq(instruction.stack_lookup(RW.Read, 1), MAX_N_BYTES)
    length = instruction.word_to_fq(instruction.stack_lookup(RW.Read, 2), MAX_N_BYTES)

    return_data_length = instruction.call_context_lookup(
        CallContextFieldTag.LastCalleeReturnDataLength, RW.Read
    )

    end = data_offset + length
    is_data_offset_u64_overflow = instruction.is_u64_overflow(data_offset)
    is_end_u64_overflow = instruction.is_u64_overflow(end)
    is_end_over_return_data_len, _ = instruction.compare(return_data_length, end, MAX_N_BYTES)

    instruction.constrain_not_zero(
        is_data_offset_u64_overflow + is_end_u64_overflow + is_end_over_return_data_len
    )
    _finish(instruction)


def error_code_store(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.RETURN))
    instruction.constrain_equal(instruction.curr.is_create, 1)

    return_length_word = instruction.stack_lookup(RW.Read, 1)
    return_length = instruction.word_to_fq(return_length_word, N_BYTES_MEMORY_ADDRESS)

    is_static = instruction.call_context_lookup(CallContextFieldTag.IsStatic)
    instruction.constrain_equal(is_static, 0)

    over_max_code_size, _ = instruction.compare(
        instruction.fq(MAX_CODE_SIZE), return_length, N_BYTES_STACK
    )
    gas_cost_code_store = return_length * GAS_COST_CODE_DEPOSIT
    insufficient_gas, _ = instruction.compare(
        instruction.curr.gas_left, gas_cost_code_store, N_BYTES_GAS
    )
    instruction.constrain_not_zero(insufficient_gas + over_max_code_size)
    _finish(instruction)


def error_invalid_creation_code(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.RETURN))
    instruction.constrain_equal(instruction.curr.is_create, 1)

    return_offset = instruction.word_to_fq(instruction.stack_pop(), N_BYTES_MEMORY_ADDRESS)
    first_byte = instruction.memory_lookup(RW.Read, return_offset)
    instruction.constrain_equal(first_byte, instruction.fq(INVALID_FIRST_BYTE_CONTRACT_CODE))
    _finish(instruction)


def error_oog_create(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    is_create, is_create2 = instruction.pair_select(opcode, Opcode.CREATE, Opcode.CREATE2)
    instruction.constrain_equal(is_create + is_create2, 1)

    offset_word = instruction.stack_lookup(RW.Read, 1)
    size_word = instruction.stack_lookup(RW.Read, 2)
    offset, size = instruction.memory_offset_and_length(offset_word, size_word)

    is_root = instruction.call_context_lookup(CallContextFieldTag.IsRoot)

    if instruction.branch(instruction.is_equal(is_root, 1)):
        tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
        n = instruction.uniform_int(size)
        data = [instruction.tx_calldata_lookup(tx_id, instruction.fq(idx)) for idx in range(n)]
        nz = instruction.fq(0)
        for byte in data:
            nz = nz + (1 - instruction.is_zero(byte))
        gas_cost = (
            GAS_COST_CREATION_TX
            + nz * GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE
            + (instruction.fq(n) - nz) * GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE
        )
    else:
        _, memory_expansion_gas_cost = instruction.memory_expansion(offset, size)
        gas_cost = GAS_COST_CREATE + memory_expansion_gas_cost

    word_size, _ = instruction.constant_divmod(size + 31, 32, N_BYTES_MEMORY_WORD_SIZE)
    gas_cost = gas_cost + GAS_COST_INITCODE_WORD * word_size
    if instruction.branch(is_create2):
        gas_cost = gas_cost + GAS_COST_COPY_SHA3 * word_size

    is_exceed_max_initcode_size, _ = instruction.compare(
        instruction.fq(MAX_INIT_CODE_SIZE), size, N_BYTES_U64
    )
    insufficient_gas, _ = instruction.compare(instruction.curr.gas_left, gas_cost, N_BYTES_GAS)
    instruction.constrain_not_zero(insufficient_gas + is_exceed_max_initcode_size)
    _finish(instruction)


def error_oog_precompile(instruction: Instruction):
    BYTES_PER_PAIRING = 192

    address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    address = instruction.word_to_address(address_word)
    calldata_len = instruction.call_context_lookup(CallContextFieldTag.CallDataLength)

    instruction.constrain_equal(instruction.precompile(address), 1)

    gas_cost = instruction.fq(0)
    for p in Precompile:
        if instruction.branch(instruction.is_equal(address, int(p))):
            gas_cost = instruction.fq(p.base_gas_cost())
            if p == Precompile.BN254PAIRING:
                pairs, _ = instruction.constant_divmod_nocheck(calldata_len, BYTES_PER_PAIRING)
                gas_cost = gas_cost + Bn254PairingPerPointGas * pairs
            elif p == Precompile.DATACOPY:
                gas_cost = gas_cost + instruction.memory_copier_gas_cost(
                    calldata_len, instruction.fq(0), IdentityPerWordGas)
            break

    insufficient_gas, _ = instruction.compare(instruction.curr.gas_left, gas_cost, N_BYTES_GAS)
    instruction.constrain_equal(insufficient_gas, 1)
    _finish(instruction)


def error_gas_uint_overflow(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    sels = instruction.multiple_select(
        opcode,
        (Opcode.CALL, Opcode.CALLCODE, Opcode.DELEGATECALL, Opcode.STATICCALL,
         Opcode.CREATE, Opcode.CREATE2, Opcode.CALLDATACOPY, Opcode.CODECOPY,
         Opcode.EXTCODECOPY, Opcode.RETURNDATACOPY, Opcode.LOG0, Opcode.LOG1,
         Opcode.LOG2, Opcode.LOG3, Opcode.LOG4, Opcode.SHA3, Opcode.MLOAD,
         Opcode.MSTORE, Opcode.MSTORE8, Opcode.RETURN, Opcode.REVERT),
    )
    is_create = sels[4] + sels[5]

    zero = instruction.fq(0)
    is_opcode_memory_size_overflow = is_safe_mul_overflow = zero
    is_call_gas_cost_overflow = is_calldata_gas_overflow = is_initcode_gas_overflow = zero

    calldata_length = instruction.call_context_lookup(CallContextFieldTag.CallDataLength)
    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    is_root = instruction.call_context_lookup(CallContextFieldTag.IsRoot)

    if instruction.branch(instruction.is_equal(is_root, 1)):
        data_len = instruction.uniform_int(calldata_length)
        if data_len > 0:
            data = [
                instruction.tx_calldata_lookup(tx_id, instruction.fq(i))
                for i in range(data_len)
            ]
            nz = instruction.fq(0)
            for byte in data:
                nz = nz + (1 - instruction.is_zero(byte))
            gas0 = instruction.select(
                instruction.is_equal(is_create, 1),
                instruction.fq(TxGasContractCreation), instruction.fq(TxGas),
            )
            # overflow thresholds use the two possible constant gas values
            thr_nz = instruction.select(
                instruction.is_equal(is_create, 1),
                instruction.fq((MAX_U64 - TxGasContractCreation) // TxDataNonZeroGasEIP2028),
                instruction.fq((MAX_U64 - TxGas) // TxDataNonZeroGasEIP2028),
            )
            is_nz_overflow, _ = instruction.compare(thr_nz, nz, N_BYTES_U64)
            gas1 = gas0 + nz * GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE

            z = instruction.fq(data_len) - nz
            not_nz_overflow = instruction.mask_of(1 - is_nz_overflow)
            with instruction.masked(not_nz_overflow):
                q, _ = instruction.constant_divmod_nocheck(
                    instruction.fq(MAX_U64) - gas1, GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE
                )
                lt_z, _ = instruction.compare(q, z, N_BYTES_U64)
            is_z_overflow = instruction.select(
                1 - is_nz_overflow, lt_z, instruction.fq(0)
            )
            gas2 = gas1 + z * GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE

            if instruction.branch(instruction.is_equal(is_create, 1)):
                len_words, _ = instruction.constant_divmod(
                    instruction.fq(data_len) + 31, 32, N_BYTES_U64
                )
                with instruction.masked(not_nz_overflow):
                    q2, _ = instruction.constant_divmod_nocheck(
                        instruction.fq(MAX_U64) - gas2, GAS_COST_INITCODE_WORD
                    )
                    lt_w, _ = instruction.compare(q2, len_words, N_BYTES_U64)
                is_initcode_gas_overflow = lt_w

            is_calldata_gas_overflow = is_nz_overflow + is_z_overflow

    # reference `if is_dynamic_gas:` is always-truthy FQ (gas_uint_overflow
    # .py:155) — mirrored by always running the dynamic check
    mem_size, is_opcode_memory_size_overflow = instruction.memory_size(opcode)
    _, is_safe_mul_overflow = instruction.safe_mul(
        instruction.to_word_size(mem_size), instruction.fq(32)
    )

    is_overflow = (
        is_opcode_memory_size_overflow
        + is_safe_mul_overflow
        + is_call_gas_cost_overflow
        + is_calldata_gas_overflow
        + is_initcode_gas_overflow
    )
    instruction.constrain_not_zero(is_overflow)
    _finish(instruction)
