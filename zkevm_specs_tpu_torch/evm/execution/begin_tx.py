"""BeginTx gadget (reference: evm_circuit/execution/begin_tx.py:23-267).

The contract-creation branch (a tx with no callee: its calldata copied to
an RLC and to the bytecode table, its code hash from the keccak table) is
ported; the tracer makes no creation tx, so only the gadget vectors reach
it.  The call to a precompile is a branch decision only: a lane that takes
it raises ``NotImplementedError``, as in the JAX package."""
from ...dsl.value import WordOrValue
from ...ops.keccak import EMPTY_HASH
from ...tables.schemas import (
    AccountFieldTag,
    BlockContextFieldTag,
    CallContextFieldTag,
    CopyDataTypeTag,
    TxContextFieldTag,
)
from ...utils.param import (
    GAS_COST_CREATION_TX,
    GAS_COST_INITCODE_WORD,
    GAS_COST_TX,
    MAX_N_BYTES,
    N_BYTES_U64,
)
from ..execution_state import ExecutionState
from ..instruction import Instruction, Transition
from ..precompile import Precompile


def begin_tx(instruction: Instruction):
    call_id = instruction.curr.rw_counter

    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId, call_id=call_id)
    reversion_info = instruction.reversion_info(call_id=call_id)
    instruction.constrain_equal(
        instruction.call_context_lookup(CallContextFieldTag.IsSuccess, call_id=call_id),
        reversion_info.is_persistent,
    )

    if instruction.is_first_step:
        instruction.constrain_equal(tx_id, 1)

    coinbase_word = instruction.block_context_lookup_word(BlockContextFieldTag.Coinbase)
    coinbase = instruction.word_to_address(coinbase_word)

    tx_caller_address_word = instruction.tx_context_lookup_word(tx_id,
                                                                TxContextFieldTag.CallerAddress)
    tx_caller_address = instruction.word_to_address(tx_caller_address_word)
    tx_callee_address_word = instruction.tx_context_lookup_word(tx_id,
                                                                TxContextFieldTag.CalleeAddress)
    tx_callee_address = instruction.word_to_address(tx_callee_address_word)
    tx_is_create = instruction.tx_context_lookup(tx_id, TxContextFieldTag.IsCreate)
    tx_value = instruction.tx_context_lookup_word(tx_id, TxContextFieldTag.Value)
    tx_call_data_length = instruction.tx_context_lookup(tx_id, TxContextFieldTag.CallDataLength)

    instruction.constrain_not_zero(tx_caller_address)

    is_tx_invalid = instruction.tx_context_lookup(tx_id, TxContextFieldTag.TxInvalid)
    tx_nonce = instruction.tx_context_lookup(tx_id, TxContextFieldTag.Nonce)
    nonce, nonce_prev = instruction.account_write(tx_caller_address, AccountFieldTag.Nonce)
    is_nonce_valid = instruction.is_zero(tx_nonce - nonce_prev)
    instruction.constrain_equal(nonce, nonce_prev + 1 - is_tx_invalid)

    tx_gas = instruction.tx_context_lookup(tx_id, TxContextFieldTag.Gas)
    tx_gas_price = instruction.tx_gas_price(tx_id)
    gas_fee = instruction.mul_word_by_u64(tx_gas_price, tx_gas)

    tx_calldata_gas_cost = instruction.tx_context_lookup(tx_id, TxContextFieldTag.CallDataGasCost)
    is_create_branch = instruction.branch(instruction.is_equal(tx_is_create, 1))
    if is_create_branch:
        len_words, _ = instruction.constant_divmod(tx_call_data_length + 31, 32, N_BYTES_U64)
        tx_cost_gas = GAS_COST_CREATION_TX + len_words * GAS_COST_INITCODE_WORD
    else:
        tx_cost_gas = instruction.fq(GAS_COST_TX)

    tx_accesslist_gas = instruction.tx_context_lookup(tx_id, TxContextFieldTag.AccessListGasCost)
    tx_intrinsic_gas = tx_calldata_gas_cost + tx_cost_gas + tx_accesslist_gas

    gas_not_enough, _ = instruction.compare(tx_gas, tx_intrinsic_gas, MAX_N_BYTES)
    gas_left = instruction.select(gas_not_enough, tx_gas, tx_gas - tx_intrinsic_gas)

    contract_address = instruction.generate_contract_address(tx_caller_address, tx_nonce)
    contract_address_word = instruction.address_to_word(contract_address)

    callee_address = instruction.select(
        instruction.is_equal(tx_is_create, 1), contract_address, tx_callee_address)

    instruction.constrain_zero(instruction.add_account_to_access_list(tx_id, coinbase))
    instruction.constrain_zero(instruction.add_account_to_access_list(tx_id, tx_caller_address))
    instruction.constrain_zero(instruction.add_account_to_access_list(tx_id, callee_address))

    invalid_mask = instruction.mask_of(is_tx_invalid)
    zero_word = instruction.word(0)
    sender_balance_pair, _ = instruction.transfer_with_gas_fee(
        tx_caller_address,
        callee_address,
        zero_word.select(invalid_mask, tx_value),
        zero_word.select(invalid_mask, gas_fee),
        reversion_info,
    )
    sender_balance_prev = sender_balance_pair[1]
    balance_not_enough, _ = instruction.compare(
        instruction.word_to_fq(sender_balance_prev, MAX_N_BYTES),
        instruction.word_to_fq(tx_value, MAX_N_BYTES)
        + instruction.word_to_fq(gas_fee, MAX_N_BYTES),
        MAX_N_BYTES,
    )
    invalid_tx = 1 - (1 - balance_not_enough) * (1 - gas_not_enough) * is_nonce_valid

    instruction.constrain_equal(is_tx_invalid, invalid_tx)

    if is_create_branch:
        _creation_tx(instruction, call_id, tx_id, reversion_info, is_tx_invalid,
                     tx_call_data_length, tx_caller_address_word, contract_address_word, tx_value,
                     gas_left)
        return

    for p in Precompile:
        if instruction.branch(instruction.is_equal(tx_callee_address, int(p))):
            # mirrors reference begin_tx.py:216-218
            raise NotImplementedError("BeginTx to precompile is not implemented")

    code_hash = instruction.account_read_word(tx_callee_address, AccountFieldTag.CodeHash)
    is_empty_code_hash = instruction.is_equal_word(code_hash, instruction.word(EMPTY_HASH))

    if instruction.branch(
        instruction.is_equal(is_empty_code_hash, 1)
    ) or instruction.branch(instruction.is_equal(is_tx_invalid, 1)):
        instruction.constrain_equal(reversion_info.is_persistent, 1)
        instruction.constrain_equal(instruction.next.execution_state, int(ExecutionState.EndTx))
        instruction.constrain_step_state_transition(
            rw_counter=Transition.delta(instruction.rw_counter_offset),
            call_id=Transition.to(call_id),
        )
    else:
        for tag, word_or_value in (
            (CallContextFieldTag.Depth, instruction.fq(1)),
            (CallContextFieldTag.CallerAddress, tx_caller_address_word),
            (CallContextFieldTag.CalleeAddress, tx_callee_address_word),
            (CallContextFieldTag.CallDataOffset, instruction.fq(0)),
            (CallContextFieldTag.CallDataLength, tx_call_data_length),
            (CallContextFieldTag.Value, tx_value),
            (CallContextFieldTag.IsStatic, instruction.fq(0)),
            (CallContextFieldTag.LastCalleeId, instruction.fq(0)),
            (CallContextFieldTag.LastCalleeReturnDataOffset, instruction.fq(0)),
            (CallContextFieldTag.LastCalleeReturnDataLength, instruction.fq(0)),
            (CallContextFieldTag.IsRoot, instruction.fq(1)),
            (CallContextFieldTag.IsCreate, instruction.fq(0)),
            (CallContextFieldTag.CodeHash, code_hash),
        ):
            instruction.constrain_equal_word(
                instruction.call_context_lookup_word(tag, call_id=call_id),
                WordOrValue(word_or_value),
            )

        instruction.step_state_transition_to_new_context(
            rw_counter=Transition.delta(instruction.rw_counter_offset),
            call_id=Transition.to(call_id),
            is_root=Transition.to(1),
            is_create=Transition.to(0),
            code_hash=Transition.to_word(code_hash),
            gas_left=Transition.to(gas_left),
            reversible_write_counter=Transition.to(2),
            log_id=Transition.to(0),
        )


def _creation_tx(instruction: Instruction, call_id, tx_id, reversion_info, is_tx_invalid,
                 tx_call_data_length, tx_caller_address_word, contract_address_word, tx_value,
                 gas_left):
    """A contract-creation tx: an invalid one or one with no initcode ends
    at once; otherwise the initcode (the tx's calldata) is copied to an RLC
    and to the bytecode table, its hash looked up in the keccak table, and
    the root context enters it as a create frame."""
    if instruction.branch(
        instruction.is_equal(is_tx_invalid, 1)
    ) or instruction.branch(instruction.is_zero(tx_call_data_length)):
        instruction.constrain_equal(reversion_info.is_persistent, 1)
        instruction.constrain_equal(instruction.next.execution_state, int(ExecutionState.EndTx))
        instruction.constrain_step_state_transition(
            rw_counter=Transition.delta(instruction.rw_counter_offset),
            call_id=Transition.to(call_id),
        )
        return

    copy_rwc_inc, tx_calldata_rlc = instruction.copy_lookup(
        tx_id, CopyDataTypeTag.TxCalldata, call_id, CopyDataTypeTag.RlcAcc,
        instruction.fq(0), tx_call_data_length, instruction.fq(0), tx_call_data_length,
        instruction.curr.rw_counter + instruction.rw_counter_offset,
    )
    instruction.constrain_zero(copy_rwc_inc)

    code_hash = instruction.keccak_lookup(tx_call_data_length, tx_calldata_rlc)

    copy_rwc_inc, _ = instruction.copy_lookup(
        tx_id, CopyDataTypeTag.TxCalldata, code_hash, CopyDataTypeTag.Bytecode,
        instruction.fq(0), tx_call_data_length, instruction.fq(0), tx_call_data_length,
        instruction.curr.rw_counter + instruction.rw_counter_offset,
    )
    instruction.constrain_zero(copy_rwc_inc)

    for tag, word_or_value in (
        (CallContextFieldTag.Depth, instruction.fq(1)),
        (CallContextFieldTag.CallerAddress, tx_caller_address_word),
        (CallContextFieldTag.CalleeAddress, contract_address_word),
        (CallContextFieldTag.CallDataOffset, instruction.fq(0)),
        (CallContextFieldTag.CallDataLength, tx_call_data_length),
        (CallContextFieldTag.Value, tx_value),
        (CallContextFieldTag.IsStatic, instruction.fq(0)),
        (CallContextFieldTag.LastCalleeId, instruction.fq(0)),
        (CallContextFieldTag.LastCalleeReturnDataOffset, instruction.fq(0)),
        (CallContextFieldTag.LastCalleeReturnDataLength, instruction.fq(0)),
        (CallContextFieldTag.IsRoot, instruction.fq(1)),
        (CallContextFieldTag.IsCreate, instruction.fq(1)),
        (CallContextFieldTag.CodeHash, code_hash),
    ):
        instruction.constrain_equal_word(
            instruction.call_context_lookup_word(tag, call_id=call_id),
            WordOrValue(word_or_value),
        )

    instruction.step_state_transition_to_new_context(
        rw_counter=Transition.delta(instruction.rw_counter_offset),
        call_id=Transition.to(call_id),
        is_root=Transition.to(1),
        is_create=Transition.to(1),
        code_hash=Transition.to_word(code_hash),
        gas_left=Transition.to(gas_left),
        reversible_write_counter=Transition.to(2),
        log_id=Transition.to(0),
    )
