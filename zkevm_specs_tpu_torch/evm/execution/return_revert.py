"""RETURN/REVERT gadget (reference: evm_circuit/execution/return_revert.py:10-131).

Counterpart of ``zkevm_specs_tpu/evm/execution/return_revert.py``, its
``is_create`` branch included (the port's tracer emits no create frame
yet)."""
from ...ops.keccak import EMPTY_HASH
from ...tables.schemas import AccountFieldTag, CallContextFieldTag, CopyDataTypeTag
from ...utils.param import GAS_COST_CODE_DEPOSIT, MAX_CODE_SIZE, N_BYTES_MEMORY_ADDRESS
from ..execution_state import ExecutionState
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def return_revert(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    is_return, _ = instruction.pair_select(opcode, Opcode.RETURN, Opcode.REVERT)

    is_success = instruction.call_context_lookup(CallContextFieldTag.IsSuccess)
    instruction.constrain_equal(is_success, is_return)

    return_offset_word = instruction.stack_pop()
    return_length_word = instruction.stack_pop()

    return_offset = instruction.word_to_fq(return_offset_word, N_BYTES_MEMORY_ADDRESS)
    return_length = instruction.word_to_fq(return_length_word, N_BYTES_MEMORY_ADDRESS)
    return_end = return_offset + return_length

    rwc_delta = instruction.fq(3)

    callee_gas_left = instruction.curr.gas_left
    # reference: `if instruction.curr.is_create and is_success:`
    # (return_revert.py:30) — is_success is an FQ with no __bool__, so the
    # conjunction reduces to is_create alone (its test witnesses include the
    # deployment rows for REVERT too).  Mirrored.
    is_create = instruction.branch(instruction.curr.is_create)
    if is_create:
        # A. deploy the returned memory chunk as contract code.
        # The CalleeAddress lookup and the CodeHash account write are two rw
        # rows the reference forgets to count (return_revert.py:33-41 leaves
        # rwc_delta at 3); counted here so the next step's rw_counter does
        # not overlap the last two rows of a deploying halt.
        rwc_delta = rwc_delta + 2
        callee_address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
        callee_address = instruction.word_to_address(callee_address_word)
        code_hash, code_hash_prev = instruction.account_write_word(
            callee_address, AccountFieldTag.CodeHash
        )
        instruction.constrain_equal_word(code_hash_prev, instruction.word(EMPTY_HASH))
        instruction.constrain_equal_word(code_hash, instruction.curr.code_hash)

        instruction.range_lookup(return_length, MAX_CODE_SIZE)

        callee_gas_left = callee_gas_left - return_length * GAS_COST_CODE_DEPOSIT

        copy_length = return_length
        if instruction.branch(1 - instruction.is_zero(return_length)):
            copy_rwc_inc, _ = instruction.copy_lookup(
                instruction.curr.call_id,
                CopyDataTypeTag.Memory,
                code_hash,
                CopyDataTypeTag.Bytecode,
                return_offset,
                return_end,
                instruction.fq(0),
                copy_length,
                instruction.curr.rw_counter + instruction.rw_offset_f(),
            )
            instruction.constrain_equal(copy_rwc_inc, copy_length)
            instruction.add_rw_counter_dyn(copy_rwc_inc)
            rwc_delta = rwc_delta + copy_length
            code_size = instruction.bytecode_length(code_hash)
            instruction.constrain_equal(code_size, copy_length)

    is_root = instruction.branch(instruction.curr.is_root)
    if not is_root and not is_create:
        # D. return the memory chunk to the caller.  The reference emits the
        # copy lookup even for copy_length == 0 (return_revert.py:71-84),
        # which would require a zero-length copy-table row no witness builder
        # can produce; gated on copy_length != 0 here (same convention as the
        # callop precompile branch, callop.py:187-201).
        caller_return_offset = instruction.call_context_lookup(CallContextFieldTag.ReturnDataOffset)
        caller_return_length = instruction.call_context_lookup(CallContextFieldTag.ReturnDataLength)
        copy_length = instruction.min(return_length, caller_return_length, N_BYTES_MEMORY_ADDRESS)
        if instruction.branch(1 - instruction.is_zero(copy_length)):
            copy_rwc_inc, _ = instruction.copy_lookup(
                instruction.curr.call_id,
                CopyDataTypeTag.Memory,
                instruction.next.call_id,
                CopyDataTypeTag.Memory,
                return_offset,
                return_end,
                caller_return_offset,
                copy_length,
                instruction.curr.rw_counter + instruction.rw_offset_f(),
            )
            instruction.constrain_equal(copy_rwc_inc, 2 * copy_length)
            instruction.add_rw_counter_dyn(copy_rwc_inc)
        rwc_delta = rwc_delta + 2 + 2 * copy_length

    # B1. end the execution — go to EndTx only when is_root
    is_to_end_tx = instruction.is_equal(
        instruction.next.execution_state, int(ExecutionState.EndTx)
    )
    instruction.constrain_equal(instruction.curr.is_root, is_to_end_tx)

    _next_memory_size, memory_expansion_gas = instruction.memory_expansion_dynamic_length(
        return_offset, return_length
    )

    # E. revert state changes: REVERT lanes skip the reversion-mirror
    # section — the mirrored writes of this frame's reversible_write_counter
    # state writes occupy the next reversible_write_counter rw counters
    # (LIFO, ending at RwCounterEndOfReversion).  The reference *intends*
    # this (return_revert.py:106-107 "E. Revert state changes") but the
    # guard `if not is_return:` is dead code — py_ecc FQ defines no
    # __bool__, so `not FQ(0)` is always False — and its per-gadget vectors
    # encode the dead behavior.  The skip is required for a coherent
    # whole-block witness (state circuit + EndBlock rw totality), so it is
    # implemented here; error halts already do the same (errors.py _finish).
    if not instruction.branch(is_return):
        rwc_delta = rwc_delta + instruction.curr.reversible_write_counter

    if is_root:
        is_persistent = instruction.call_context_lookup(CallContextFieldTag.IsPersistent)
        instruction.constrain_equal(is_persistent, is_return)

        instruction.constrain_step_state_transition(
            rw_counter=Transition.delta(rwc_delta + 1),
            gas_left=Transition.to(callee_gas_left),
            call_id=Transition.same(),
        )
    else:
        # C. restore caller context; only RETURN accumulates this frame's
        # reversible writes into the caller (REVERT already mirrored them)
        instruction.step_state_transition_to_restored_context(
            rw_counter_delta=rwc_delta,
            return_data_offset=return_offset,
            return_data_length=return_length,
            gas_left=callee_gas_left - memory_expansion_gas,
            accumulated_reversible=is_return * instruction.curr.reversible_write_counter,
        )
