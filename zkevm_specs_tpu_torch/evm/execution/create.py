"""CREATE/CREATE2 gadget (reference: evm_circuit/execution/create.py:20-253).

Counterpart of ``zkevm_specs_tpu/evm/execution/create.py``, with its two
deviations from the reference: the outcome is read from the callee's
context, and the reversible writes of a CREATE that stays in its caller's
frame are counted as the initcode path counts them."""
from ...dsl.value import Word, WordOrValue
from ...ops.keccak import EMPTY_HASH
from ...tables.schemas import (
    RW,
    AccountFieldTag,
    CallContextFieldTag,
    CopyDataTypeTag,
)
from ...utils.param import (
    GAS_COST_COPY_SHA3,
    GAS_COST_CREATE,
    GAS_COST_INITCODE_WORD,
    MAX_U64,
    N_BYTES_ACCOUNT_ADDRESS,
    N_BYTES_GAS,
    N_BYTES_MEMORY_ADDRESS,
    N_BYTES_MEMORY_WORD_SIZE,
    N_BYTES_STACK,
    N_BYTES_U64,
)
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def create(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    is_create, is_create2 = instruction.pair_select(opcode, Opcode.CREATE, Opcode.CREATE2)
    instruction.responsible_opcode_lookup(opcode)

    callee_call_id = instruction.curr.rw_counter

    value_word = instruction.stack_pop()
    offset_word = instruction.stack_pop()
    size_word = instruction.stack_pop()
    if instruction.branch(is_create2):
        salt_word = instruction.stack_pop()
    else:
        salt_word = instruction.word(0)
    return_contract_address_word = instruction.stack_push()

    offset = instruction.word_to_fq(offset_word, N_BYTES_MEMORY_ADDRESS)
    size = instruction.word_to_fq(size_word, N_BYTES_MEMORY_ADDRESS)

    depth = instruction.call_context_lookup(CallContextFieldTag.Depth)
    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    caller_address_word = instruction.call_context_lookup_word(CallContextFieldTag.CallerAddress)
    caller_address = instruction.word_to_address(caller_address_word)
    nonce, nonce_prev = instruction.account_write(caller_address, AccountFieldTag.Nonce)
    balance = instruction.account_read(caller_address, AccountFieldTag.Balance)
    # The CREATE's outcome is the *initcode frame's* IsSuccess.  The
    # reference reads it from the CALLER's call context (create.py:45,
    # test_create.py:304) — incoherent in an integrated witness: a reverting
    # CREATE inside a succeeding caller would need two different values at
    # one state-circuit key.  Read it from the callee context instead (same
    # row position; the callop gadget does likewise, callop.py:277).
    is_success = instruction.call_context_lookup(
        CallContextFieldTag.IsSuccess, call_id=callee_call_id
    )
    is_static = instruction.call_context_lookup(CallContextFieldTag.IsStatic)
    reversion_info = instruction.reversion_info()

    has_init_code = instruction.branch(1 - instruction.is_zero(size))

    # reference calls is_zero(is_static) without constraining (create.py:55)
    instruction.is_zero(is_static)

    next_memory_size, memory_expansion_gas_cost = instruction.memory_expansion(offset, size)

    word_len, _ = instruction.constant_divmod(size + 31, 32, N_BYTES_MEMORY_WORD_SIZE)
    gas_left = instruction.curr.gas_left
    gas_cost = GAS_COST_CREATE + memory_expansion_gas_cost + word_len * GAS_COST_INITCODE_WORD
    if instruction.branch(is_create2):
        gas_cost = gas_cost + GAS_COST_COPY_SHA3 * word_len
    gas_available = gas_left - gas_cost

    one_64th_gas, _ = instruction.constant_divmod(gas_available, 64, N_BYTES_GAS)
    all_but_one_64th_gas = gas_available - one_64th_gas
    is_u64_gas = instruction.is_zero(
        instruction.sum(WordOrValue(gas_left).to_le_bytes()[N_BYTES_GAS:])
    )
    callee_gas_left = instruction.select(
        is_u64_gas,
        instruction.min(all_but_one_64th_gas, gas_left, N_BYTES_GAS),
        all_but_one_64th_gas,
    )

    is_depth_ok, _ = instruction.compare(depth, instruction.fq(1025), N_BYTES_STACK)
    is_insufficient_balance, _ = instruction.compare_word(Word.from_lo(balance), value_word)
    is_nonce_in_range, _ = instruction.compare(nonce_prev, instruction.fq(MAX_U64), N_BYTES_U64)

    is_precheck_ok = (
        instruction.branch(is_depth_ok)
        and instruction.branch(instruction.is_zero(is_insufficient_balance))
        and instruction.branch(is_nonce_in_range)
    )

    stack_pointer_delta = 2 + is_create2
    not_address_collision = False
    if is_precheck_ok:
        if has_init_code:
            code_hash = instruction.word_hint(
                instruction.aux_ints(lambda a: int(a) if a is not None else 0)
            )
        else:
            code_hash = instruction.word(EMPTY_HASH)
        if instruction.branch(is_create):
            contract_address = instruction.generate_contract_address(caller_address, nonce)
        else:
            contract_address = instruction.generate_CREAET2_contract_address(
                caller_address, salt_word, code_hash
            )
        contract_address_word = instruction.address_to_word(contract_address)

        instruction.add_account_to_access_list(tx_id, contract_address)

        callee_code_hash = instruction.account_read_word(contract_address, AccountFieldTag.CodeHash)
        callee_nonce = instruction.account_read(contract_address, AccountFieldTag.Nonce)
        is_zero_nonce = instruction.is_zero(callee_nonce)
        is_empty_hash = instruction.is_equal_word(callee_code_hash, instruction.word(EMPTY_HASH))
        is_zero_hash = instruction.is_equal_word(callee_code_hash, instruction.word(0))
        not_address_collision = instruction.branch(is_zero_nonce) and (
            instruction.branch(is_empty_hash) or instruction.branch(is_zero_hash)
        )

        if not_address_collision:
            instruction.constrain_equal(
                instruction.word_to_fq(return_contract_address_word, N_BYTES_ACCOUNT_ADDRESS),
                is_success * contract_address,
            )

            callee_reversion_info = instruction.reversion_info(call_id=callee_call_id)
            instruction.constrain_equal(
                callee_reversion_info.is_persistent,
                reversion_info.is_persistent * is_success,
            )

            instruction.transfer(caller_address, contract_address, value_word, callee_reversion_info)

            nonce, _ = instruction.account_write(contract_address, AccountFieldTag.Nonce)
            instruction.constrain_equal(nonce, 1)

            if has_init_code:
                copy_rwc_inc, _ = instruction.copy_lookup(
                    instruction.curr.call_id,
                    CopyDataTypeTag.Memory,
                    instruction.next.code_hash,
                    CopyDataTypeTag.Bytecode,
                    offset,
                    offset + size,
                    instruction.fq(0),
                    size,
                    instruction.curr.rw_counter + instruction.rw_offset_f(),
                )
                instruction.add_rw_counter_dyn(copy_rwc_inc)

                code_size = instruction.bytecode_length(instruction.next.code_hash)
                instruction.constrain_equal(code_size, size)

                for field_tag, expected_value in (
                    (CallContextFieldTag.ProgramCounter, instruction.curr.program_counter + 1),
                    (CallContextFieldTag.StackPointer, instruction.curr.stack_pointer + stack_pointer_delta),
                    (CallContextFieldTag.GasLeft, gas_left - gas_cost - callee_gas_left),
                    (CallContextFieldTag.MemorySize, next_memory_size),
                    (CallContextFieldTag.ReversibleWriteCounter, instruction.curr.reversible_write_counter + 1),
                ):
                    instruction.constrain_equal(
                        instruction.call_context_lookup(field_tag, RW.Write),
                        expected_value,
                    )
                for field_tag, expected_word_or_value in (
                    (CallContextFieldTag.CallerId, instruction.curr.call_id),
                    (CallContextFieldTag.TxId, tx_id),
                    (CallContextFieldTag.Depth, depth + 1),
                    (CallContextFieldTag.CallerAddress, caller_address_word),
                    (CallContextFieldTag.CalleeAddress, contract_address_word),
                    (CallContextFieldTag.IsSuccess, is_success),
                    (CallContextFieldTag.IsStatic, instruction.fq(0)),
                    (CallContextFieldTag.IsRoot, instruction.fq(0)),
                    (CallContextFieldTag.IsCreate, instruction.fq(1)),
                ):
                    instruction.constrain_equal_word(
                        instruction.call_context_lookup_word(field_tag, call_id=callee_call_id),
                        WordOrValue(expected_word_or_value),
                    )
                instruction.constrain_equal_word(
                    instruction.call_context_lookup_word(
                        CallContextFieldTag.CodeHash, call_id=callee_call_id
                    ),
                    code_hash,
                )

                instruction.step_state_transition_to_new_context(
                    rw_counter=Transition.delta(instruction.rw_offset_f()),
                    call_id=Transition.to(callee_call_id),
                    is_root=Transition.to(0),
                    is_create=Transition.to(1),
                    code_hash=Transition.to_word(instruction.next.code_hash),
                    gas_left=Transition.to(callee_gas_left),
                    reversible_write_counter=Transition.to(3),
                    log_id=Transition.same(),
                )

    if not is_precheck_ok or not not_address_collision or not has_init_code:
        if not is_precheck_ok or not not_address_collision:
            instruction.constrain_equal(is_success, 0)

        for field_tag, expected_value in (
            (CallContextFieldTag.LastCalleeId, instruction.fq(0)),
            (CallContextFieldTag.LastCalleeReturnDataOffset, instruction.fq(0)),
            (CallContextFieldTag.LastCalleeReturnDataLength, instruction.fq(0)),
        ):
            instruction.constrain_equal(
                instruction.call_context_lookup(field_tag, RW.Write),
                expected_value,
            )

        # Reversible-write accounting: the access-list write (emitted for
        # every precheck-ok CREATE) is mirrored at the caller's current
        # offset, so it must be counted — the reference counts it in the
        # initcode path (create.py:179 saves curr+1) but drops it here
        # (create.py:240-246 counts only transfer+nonce), which would make
        # the next reversible write's mirror collide.  Counted consistently:
        # +1 access list when precheck ok, +3 transfer/nonce when deployed.
        reversible_write_counter_delta = (1 if is_precheck_ok else 0) + (
            3 if not_address_collision and not has_init_code else 0
        )
        instruction.constrain_step_state_transition(
            rw_counter=Transition.delta(instruction.rw_offset_f()),
            program_counter=Transition.delta(1),
            stack_pointer=Transition.delta(stack_pointer_delta),
            reversible_write_counter=Transition.delta(reversible_write_counter_delta),
            gas_left=Transition.delta(-gas_cost),
            memory_word_size=Transition.to(next_memory_size),
            call_id=Transition.same(),
            is_root=Transition.same(),
            is_create=Transition.same(),
            code_hash=Transition.same_word(),
        )
