"""EndTx gadget (reference: evm_circuit/execution/end_tx.py:7-87)."""
from ...tables.schemas import (
    BlockContextFieldTag,
    CallContextFieldTag,
    TxContextFieldTag,
    TxReceiptFieldTag,
)
from ...utils.param import MAX_REFUND_QUOTIENT_OF_GAS_USED, N_BYTES_GAS
from ..execution_state import ExecutionState
from ..instruction import Instruction, Transition


def end_tx(instruction: Instruction):
    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    is_persistent = instruction.call_context_lookup(CallContextFieldTag.IsPersistent)
    is_tx_invalid = instruction.tx_context_lookup(tx_id, TxContextFieldTag.TxInvalid)

    tx_gas = instruction.tx_context_lookup(tx_id, TxContextFieldTag.Gas)
    gas_used = tx_gas - instruction.curr.gas_left
    max_refund, _ = instruction.constant_divmod(gas_used, MAX_REFUND_QUOTIENT_OF_GAS_USED,
                                                N_BYTES_GAS)
    refund = instruction.tx_refund_read(tx_id)
    effective_refund = instruction.min(max_refund, refund, 8)

    invalid_mask = instruction.mask_of(instruction.is_equal(is_tx_invalid, 1))
    with instruction.masked(invalid_mask):
        instruction.constrain_zero(effective_refund)

    tx_gas_price = instruction.tx_gas_price(tx_id)
    value = instruction.mul_word_by_u64(tx_gas_price, instruction.curr.gas_left + effective_refund)
    tx_caller_address_word = instruction.tx_context_lookup_word(tx_id,
                                                                TxContextFieldTag.CallerAddress)
    tx_caller_address = instruction.word_to_address(tx_caller_address_word)
    instruction.add_balance(tx_caller_address, [value])

    base_fee = instruction.block_context_lookup_word(BlockContextFieldTag.BaseFee)
    effective_tip, _ = instruction.sub_word(tx_gas_price, base_fee)
    reward = instruction.mul_word_by_u64(effective_tip, gas_used)
    coinbase_word = instruction.block_context_lookup_word(BlockContextFieldTag.Coinbase)
    coinbase = instruction.word_to_address(coinbase_word)
    instruction.add_balance(coinbase, [reward])

    instruction.constrain_equal(
        (1 - is_tx_invalid) * is_persistent,
        instruction.tx_receipt_write(tx_id, TxReceiptFieldTag.PostStateOrStatus),
    )

    log_id = instruction.tx_receipt_write(tx_id, TxReceiptFieldTag.LogLength)
    instruction.constrain_equal(log_id, instruction.curr.log_id)
    with instruction.masked(invalid_mask):
        instruction.constrain_zero(log_id)

    is_first_tx = instruction.branch(instruction.is_equal(tx_id, 1))
    if is_first_tx:
        current_cumulative_gas_used = instruction.fq(0)
    else:
        current_cumulative_gas_used = instruction.tx_receipt_read(
            tx_id - 1, TxReceiptFieldTag.CumulativeGasUsed)

    instruction.constrain_equal(
        current_cumulative_gas_used + gas_used,
        instruction.tx_receipt_write(tx_id, TxReceiptFieldTag.CumulativeGasUsed),
    )

    if instruction.branch(
        instruction.is_equal(instruction.next.execution_state, int(ExecutionState.BeginTx))
    ):
        instruction.constrain_equal(
            instruction.call_context_lookup(CallContextFieldTag.TxId,
                                            call_id=instruction.next.rw_counter),
            tx_id + 1,
        )
        instruction.constrain_step_state_transition(
            rw_counter=Transition.delta(10 - int(is_first_tx)))

    if instruction.branch(
        instruction.is_equal(instruction.next.execution_state, int(ExecutionState.EndBlock))
    ):
        instruction.constrain_step_state_transition(
            rw_counter=Transition.delta(9 - int(is_first_tx)), call_id=Transition.same())
