"""SLOAD/SSTORE gadgets (reference: evm_circuit/execution/storage.py:15-160).

Counterpart of ``zkevm_specs_tpu/evm/execution/storage.py``."""
from ...tables.schemas import CallContextFieldTag
from ...utils.param import (
    COLD_SLOAD_COST,
    SLOAD_GAS,
    SSTORE_CLEARS_SCHEDULE,
    SSTORE_RESET_GAS,
    SSTORE_SET_GAS,
    WARM_STORAGE_READ_COST,
)
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def sload(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.SLOAD))

    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    reversion_info = instruction.reversion_info()
    callee_address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    callee_address = instruction.word_to_address(callee_address_word)

    storage_key = instruction.stack_pop()

    instruction.constrain_equal_word(
        instruction.account_storage_read(callee_address, storage_key, tx_id),
        instruction.stack_push(),
    )

    is_warm = instruction.add_account_storage_to_access_list(
        tx_id, callee_address, storage_key, reversion_info
    )

    dynamic_gas_cost = instruction.select(
        is_warm, instruction.fq(WARM_STORAGE_READ_COST), instruction.fq(COLD_SLOAD_COST)
    )

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(8),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(0),
        reversible_write_counter=Transition.delta(1),
        dynamic_gas_cost=dynamic_gas_cost,
    )


def sstore(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.SSTORE))

    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    instruction.constrain_equal(
        instruction.fq(0), instruction.call_context_lookup(CallContextFieldTag.IsStatic)
    )

    reversion_info = instruction.reversion_info()
    callee_address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    callee_address = instruction.word_to_address(callee_address_word)

    storage_key = instruction.stack_pop()
    storage_value = instruction.stack_pop()
    value, value_prev, original_value = instruction.account_storage_write(
        callee_address, storage_key, tx_id, reversion_info
    )
    instruction.constrain_equal_word(storage_value, value)

    is_warm = instruction.add_account_storage_to_access_list(
        tx_id, callee_address, storage_key, reversion_info
    )

    gas_refund, gas_refund_prev = instruction.tx_refund_write(tx_id, reversion_info)

    # EIP-3529 refund schedule (reference storage.py:88-131)
    nz_allne_case_refund = instruction.select(
        instruction.is_zero_word(value_prev),
        gas_refund_prev - SSTORE_CLEARS_SCHEDULE,
        instruction.select(
            instruction.is_zero_word(value),
            gas_refund_prev + SSTORE_CLEARS_SCHEDULE,
            gas_refund_prev,
        ),
    )
    nz_ne_ne_case_refund = instruction.select(
        1 - instruction.is_equal_word(original_value, value),
        nz_allne_case_refund,
        nz_allne_case_refund + SSTORE_RESET_GAS - SLOAD_GAS,
    )
    ne_ne_case_refund = instruction.select(
        1 - instruction.is_zero_word(original_value),
        nz_ne_ne_case_refund,
        instruction.select(
            instruction.is_equal_word(original_value, value),
            gas_refund_prev + SSTORE_SET_GAS - SLOAD_GAS,
            gas_refund_prev,
        ),
    )
    gas_refund_new = instruction.select(
        instruction.is_equal_word(value_prev, value),
        gas_refund_prev,
        instruction.select(
            instruction.is_equal_word(original_value, value_prev),
            instruction.select(
                (1 - instruction.is_zero_word(original_value)) * instruction.is_zero_word(value),
                gas_refund_prev + SSTORE_CLEARS_SCHEDULE,
                gas_refund_prev,
            ),
            ne_ne_case_refund,
        ),
    )

    instruction.constrain_equal(gas_refund, gas_refund_new)

    eq_prev = instruction.is_equal_word(value_prev, value)
    prev_ne_original = 1 - instruction.is_equal_word(value_prev, original_value)
    warm_case_gas = instruction.select(
        eq_prev + prev_ne_original - eq_prev * prev_ne_original,
        instruction.fq(SLOAD_GAS),
        instruction.select(
            instruction.is_zero_word(original_value),
            instruction.fq(SSTORE_SET_GAS),
            instruction.fq(SSTORE_RESET_GAS),
        ),
    )
    dynamic_gas_cost = instruction.select(
        is_warm, warm_case_gas, warm_case_gas + COLD_SLOAD_COST
    )

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(10),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(2),
        reversible_write_counter=Transition.delta(3),
        dynamic_gas_cost=dynamic_gas_cost,
    )
