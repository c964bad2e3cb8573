"""CALL/CALLCODE/DELEGATECALL/STATICCALL gadget (reference:
evm_circuit/execution/callop.py:12-341).

Counterpart of ``zkevm_specs_tpu/evm/execution/callop.py``, its precompile
branch included (the port's tracer refuses a call to a precompile, so no
traced block reaches that branch yet)."""
from ...dsl.value import WordOrValue
from ...ops.keccak import EMPTY_HASH
from ...tables.schemas import (
    RW,
    AccountFieldTag,
    CallContextFieldTag,
    CopyDataTypeTag,
)
from ...utils.param import (
    GAS_STIPEND_CALL_WITH_VALUE,
    N_BYTES_GAS,
    N_BYTES_MEMORY_WORD_SIZE,
    N_BYTES_STACK,
)
from ..execution_state import ExecutionState, precompile_execution_states
from ..gadgets.call_gadget import CallGadget
from ..gadgets.precompile_gadget import PrecompileGadget
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def callop(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    is_call, is_callcode, is_delegatecall, is_staticcall = instruction.multiple_select(
        opcode, (Opcode.CALL, Opcode.CALLCODE, Opcode.DELEGATECALL, Opcode.STATICCALL)
    )
    instruction.responsible_opcode_lookup(opcode)

    callee_call_id = instruction.curr.rw_counter

    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    reversion_info = instruction.reversion_info()
    ctx_caller_address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    ctx_caller_address = instruction.word_to_address(ctx_caller_address_word)
    is_static = instruction.call_context_lookup(CallContextFieldTag.IsStatic)
    depth = instruction.call_context_lookup(CallContextFieldTag.Depth)
    if instruction.branch(is_delegatecall):
        parent_caller_address_word = instruction.call_context_lookup_word(CallContextFieldTag.CallerAddress)
        parent_call_value = instruction.call_context_lookup_word(CallContextFieldTag.Value)
    else:
        parent_caller_address_word = WordOrValue(instruction.fq(0))
        parent_call_value = WordOrValue(instruction.fq(0))

    call = CallGadget(instruction, instruction.fq(1), is_call, is_callcode, is_delegatecall, is_staticcall)

    callee_address = instruction.select(
        is_callcode + is_delegatecall, ctx_caller_address, call.callee_address
    )
    callee_address_word = instruction.address_to_word(callee_address)
    caller_address_word = instruction.select_word(
        is_delegatecall, parent_caller_address_word, ctx_caller_address_word
    )
    caller_address = instruction.word_to_address(caller_address_word)

    is_warm_access = instruction.add_account_to_access_list(
        tx_id, call.callee_address, reversion_info
    )

    has_value = call.has_value
    instruction.constrain_zero(has_value * is_static)

    callee_reversion_info = instruction.reversion_info(call_id=callee_call_id)
    instruction.constrain_equal(
        callee_reversion_info.is_persistent,
        reversion_info.is_persistent * call.is_success,
    )
    success = instruction.branch(call.is_success)
    persistent = instruction.branch(reversion_info.is_persistent)
    if success and not persistent:
        instruction.constrain_equal(
            callee_reversion_info.rw_counter_end_of_reversion,
            reversion_info.rw_counter_of_reversion(),
        )

    # stack depth and balance pre-check
    insufficient_balance = instruction.fq(0)
    if instruction.branch(is_call + is_callcode):
        caller_balance = instruction.account_read_word(caller_address, AccountFieldTag.Balance)
        insufficient_balance, _ = instruction.compare_word(caller_balance, call.value)
    is_depth_ok, _ = instruction.compare(depth, instruction.fq(1025), N_BYTES_STACK)
    is_precheck_ok = (
        instruction.branch(is_depth_ok)
        and instruction.branch(instruction.is_zero(insufficient_balance))
    )

    if not is_precheck_ok:
        instruction.constrain_zero(call.is_success)

    if instruction.branch(is_call) and is_precheck_ok:
        instruction.transfer(caller_address, callee_address, call.value, callee_reversion_info)
    if instruction.branch(is_callcode) and success:
        instruction.constrain_zero(insufficient_balance)

    gas_cost = call.gas_cost(instruction, is_warm_access, is_call)
    gas_available = instruction.curr.gas_left - gas_cost
    one_64th_gas, _ = instruction.constant_divmod(gas_available, 64, N_BYTES_GAS)
    all_but_one_64th_gas = gas_available - one_64th_gas
    callee_gas_left = instruction.select(
        call.is_u64_gas,
        instruction.min(all_but_one_64th_gas, call.gas, N_BYTES_GAS),
        all_but_one_64th_gas,
    )

    is_precompile = instruction.precompile(call.callee_address)
    next_is_precompile_state = instruction.fq(0)
    # DEVIATION: the reference omits ErrorOutOfGasPrecompile from the allowed
    # next states (callop.py:122 + execution_state.py:403-414), leaving its
    # own error gadget unreachable from a call; including it makes an
    # out-of-gas precompile call provable at block level
    for s in list(precompile_execution_states()) + [
            ExecutionState.ErrorOutOfGasPrecompile]:
        next_is_precompile_state = next_is_precompile_state + instruction.is_equal(
            instruction.next.execution_state, int(s)
        )
    instruction.constrain_equal(is_precompile, next_is_precompile_state)

    stack_pointer_delta = 5 + is_call + is_callcode
    no_callee_code = call.is_empty_code_hash + call.callee_not_exists

    precompile_branch = instruction.branch(is_precompile)
    no_code_branch = instruction.branch(no_callee_code) and not precompile_branch

    if (not is_precheck_ok) or no_code_branch:
        for field_tag, expected_value in (
            (CallContextFieldTag.LastCalleeId, instruction.fq(0)),
            (CallContextFieldTag.LastCalleeReturnDataOffset, instruction.fq(0)),
            (CallContextFieldTag.LastCalleeReturnDataLength, instruction.fq(0)),
        ):
            instruction.constrain_equal(
                instruction.call_context_lookup(field_tag, RW.Write),
                expected_value,
            )

        instruction.constrain_step_state_transition(
            rw_counter=Transition.delta(instruction.rw_counter_offset),
            program_counter=Transition.delta(1),
            stack_pointer=Transition.delta(stack_pointer_delta),
            gas_left=Transition.delta(has_value * GAS_STIPEND_CALL_WITH_VALUE - gas_cost),
            memory_word_size=Transition.to(call.next_memory_size),
            reversible_write_counter=Transition.delta(3),
            call_id=Transition.same(),
            is_root=Transition.same(),
            is_create=Transition.same(),
            code_hash=Transition.same_word(),
        )
    elif precompile_branch:
        input_lens = instruction.aux_ints(
            lambda a: int(a[0]) if a is not None else 0)
        return_lens = instruction.aux_ints(
            lambda a: int(a[1]) if a is not None else 0)
        rd_lens = instruction.ints_of(call.rd_length)
        min_rd_sizes = [min(rl, rd) for rl, rd in zip(return_lens, rd_lens)]
        precompile_input_len = instruction.f_hint(input_lens, 64)
        precompile_return_length = instruction.f_hint(return_lens, 64)
        min_rd_copy_size = instruction.f_hint(min_rd_sizes, 64)

        instruction.constrain_equal(no_callee_code, 1)
        instruction.constrain_equal(is_warm_access, 1)

        for field_tag, expected_value in (
            (CallContextFieldTag.IsSuccess, call.is_success),
            (CallContextFieldTag.CalleeAddress, callee_address_word),
            (CallContextFieldTag.CallerId, instruction.curr.call_id),
            (CallContextFieldTag.CallDataOffset, call.cd_offset),
            (CallContextFieldTag.CallDataLength, call.cd_length),
            (CallContextFieldTag.ReturnDataOffset, call.rd_offset),
            (CallContextFieldTag.ReturnDataLength, call.rd_length),
        ):
            instruction.constrain_equal_word(
                instruction.call_context_lookup_word(field_tag, RW.Write, callee_call_id),
                WordOrValue(expected_value),
            )

        for field_tag, expected_value in (
            (CallContextFieldTag.ProgramCounter, instruction.curr.program_counter + 1),
            (CallContextFieldTag.StackPointer, instruction.curr.stack_pointer + stack_pointer_delta),
            (CallContextFieldTag.GasLeft, instruction.curr.gas_left - gas_cost - callee_gas_left),
            (CallContextFieldTag.MemorySize, call.next_memory_size),
            (CallContextFieldTag.ReversibleWriteCounter, instruction.curr.reversible_write_counter + 1),
            (CallContextFieldTag.LastCalleeId, callee_call_id),
            (CallContextFieldTag.LastCalleeReturnDataOffset, instruction.fq(0)),
            (CallContextFieldTag.LastCalleeReturnDataLength, precompile_return_length),
        ):
            instruction.constrain_equal(
                instruction.call_context_lookup(field_tag, RW.Write),
                expected_value,
            )

        rw_counter_inc = instruction.fq(instruction.rw_counter_offset)
        if instruction.branch(1 - instruction.is_zero(precompile_input_len)):
            input_copy_rwc_inc, _ = instruction.copy_lookup(
                instruction.curr.call_id,
                CopyDataTypeTag.Memory,
                callee_call_id,
                CopyDataTypeTag.RlcAcc,
                call.cd_offset,
                call.cd_offset + precompile_input_len,
                instruction.fq(0),
                precompile_input_len,
                instruction.curr.rw_counter + rw_counter_inc,
            )
            rw_counter_inc = rw_counter_inc + input_copy_rwc_inc

        if success and instruction.branch(1 - instruction.is_zero(precompile_return_length)):
            output_copy_rwc_inc, _ = instruction.copy_lookup(
                callee_call_id,
                CopyDataTypeTag.Memory,
                callee_call_id,
                CopyDataTypeTag.RlcAcc,
                instruction.fq(0),
                precompile_return_length,
                instruction.fq(0),
                precompile_return_length,
                instruction.curr.rw_counter + rw_counter_inc,
            )
            rw_counter_inc = rw_counter_inc + output_copy_rwc_inc

            return_copy_rwc_inc, _ = instruction.copy_lookup(
                callee_call_id,
                CopyDataTypeTag.Memory,
                instruction.curr.call_id,
                CopyDataTypeTag.Memory,
                instruction.fq(0),
                min_rd_copy_size,
                call.rd_offset,
                min_rd_copy_size,
                instruction.curr.rw_counter + rw_counter_inc,
            )
            rw_counter_inc = rw_counter_inc + return_copy_rwc_inc

        precompile_memory_word_size, _ = instruction.constant_divmod(
            min_rd_copy_size + 31, 32, N_BYTES_MEMORY_WORD_SIZE
        )

        callee_gas_left = callee_gas_left + has_value * GAS_STIPEND_CALL_WITH_VALUE

        instruction.constrain_step_state_transition(
            rw_counter=Transition.delta(rw_counter_inc),
            call_id=Transition.to(callee_call_id),
            is_root=Transition.to(0),
            is_create=Transition.to(0),
            code_hash=Transition.to_word(instruction.word(EMPTY_HASH)),
            gas_left=Transition.to(callee_gas_left),
            reversible_write_counter=Transition.to(2),
            program_counter=Transition.delta(1),
            stack_pointer=Transition.same(),
            memory_word_size=Transition.to(precompile_memory_word_size),
        )

        PrecompileGadget(
            instruction, call.callee_address, precompile_return_length, call.cd_length
        )
    else:
        for field_tag, expected_value in (
            (CallContextFieldTag.ProgramCounter, instruction.curr.program_counter + 1),
            (CallContextFieldTag.StackPointer, instruction.curr.stack_pointer + stack_pointer_delta),
            (CallContextFieldTag.GasLeft, instruction.curr.gas_left - gas_cost - callee_gas_left),
            (CallContextFieldTag.MemorySize, call.next_memory_size),
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
            (CallContextFieldTag.CalleeAddress, callee_address_word),
            (CallContextFieldTag.CallDataOffset, call.cd_offset),
            (CallContextFieldTag.CallDataLength, call.cd_length),
            (CallContextFieldTag.ReturnDataOffset, call.rd_offset),
            (CallContextFieldTag.ReturnDataLength, call.rd_length),
            (
                CallContextFieldTag.Value,
                instruction.select_word(is_delegatecall, parent_call_value, call.value),
            ),
            (CallContextFieldTag.IsSuccess, call.is_success),
            # the callee is static if the caller is OR this is a STATICCALL
            # (EVM semantics; deviation — the reference pins the callee to
            # the caller's flag alone, callop.py:278, which makes
            # ErrorWriteProtection unreachable in an integrated witness)
            (CallContextFieldTag.IsStatic,
             is_static + is_staticcall - is_static * is_staticcall),
            (CallContextFieldTag.LastCalleeId, instruction.fq(0)),
            (CallContextFieldTag.LastCalleeReturnDataOffset, instruction.fq(0)),
            (CallContextFieldTag.LastCalleeReturnDataLength, instruction.fq(0)),
            (CallContextFieldTag.IsRoot, instruction.fq(0)),
            (CallContextFieldTag.IsCreate, instruction.fq(0)),
            (CallContextFieldTag.CodeHash, call.callee_code_hash),
        ):
            instruction.constrain_equal_word(
                instruction.call_context_lookup_word(field_tag, call_id=callee_call_id),
                WordOrValue(expected_word_or_value),
            )

        callee_gas_left = callee_gas_left + has_value * GAS_STIPEND_CALL_WITH_VALUE

        instruction.step_state_transition_to_new_context(
            rw_counter=Transition.delta(instruction.rw_counter_offset),
            call_id=Transition.to(callee_call_id),
            is_root=Transition.to(0),
            is_create=Transition.to(0),
            code_hash=Transition.to_word(call.callee_code_hash),
            gas_left=Transition.to(callee_gas_left),
            reversible_write_counter=Transition.to(2),
            log_id=Transition.same(),
        )
