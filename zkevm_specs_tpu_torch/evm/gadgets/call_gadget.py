"""The stack-frame decode shared by the CALL family (reference:
evm_circuit/util/call_gadget.py:18-125).

Counterpart of ``zkevm_specs_tpu/evm/gadgets/call_gadget.py``."""
from ...dsl.value import F, Word
from ...ops.keccak import EMPTY_HASH
from ...tables.schemas import AccountFieldTag
from ...utils.param import (
    GAS_COST_ACCOUNT_COLD_ACCESS,
    GAS_COST_CALL_WITH_VALUE,
    GAS_COST_NEW_ACCOUNT,
    GAS_COST_WARM_ACCESS,
    N_BYTES_ACCOUNT_ADDRESS,
    N_BYTES_GAS,
)
from ..instruction import Instruction


class CallGadget:
    def __init__(self, instruction: Instruction, is_success_call: F, is_call: F,
                 is_callcode: F, is_delegatecall: F, is_staticcall: F):
        self.IS_SUCCESS_CALL = is_success_call

        instruction.constrain_equal(is_call + is_callcode + is_delegatecall + is_staticcall, 1)

        gas = instruction.stack_pop()
        callee_address = instruction.stack_pop()
        # DELEGATECALL and STATICCALL pop no value
        if instruction.branch(is_call + is_callcode):
            self.value = instruction.stack_pop()
        else:
            self.value = instruction.word(0)
        cd_offset = instruction.stack_pop()
        cd_length = instruction.stack_pop()
        rd_offset = instruction.stack_pop()
        rd_length = instruction.stack_pop()
        result = instruction.stack_push()
        self.is_success = result.lo
        instruction.constrain_equal_word(Word.from_lo(self.is_success), result)

        instruction.constrain_bool(self.is_success)
        if instruction.branch(1 - is_success_call):
            instruction.constrain_zero(self.is_success)

        self.gas = instruction.word_to_fq(gas, N_BYTES_GAS)
        self.is_u64_gas = instruction.is_zero(instruction.sum(gas.to_le_bytes()[N_BYTES_GAS:]))
        if instruction.branch(is_delegatecall + is_staticcall):
            self.has_value = instruction.fq(0)
            instruction.constrain_zero_word(self.value)
        else:
            self.has_value = 1 - instruction.is_zero_word(self.value)

        self.callee_address = instruction.word_to_fq(callee_address, N_BYTES_ACCOUNT_ADDRESS)
        self.cd_offset, self.cd_length = instruction.memory_offset_and_length(cd_offset,
                                                                              cd_length)
        self.rd_offset, self.rd_length = instruction.memory_offset_and_length(rd_offset,
                                                                              rd_length)
        self.next_memory_size, self.memory_expansion_gas_cost = \
            instruction.memory_expansion_dynamic_length(self.cd_offset, self.cd_length,
                                                        self.rd_offset, self.rd_length)

        self.callee_code_hash = instruction.account_read_word(self.callee_address,
                                                              AccountFieldTag.CodeHash)
        self.is_empty_code_hash = instruction.is_equal_word(self.callee_code_hash,
                                                            instruction.word(EMPTY_HASH))
        self.callee_not_exists = instruction.is_zero_word(self.callee_code_hash)

    def gas_cost(self, instruction: Instruction, is_warm_access: F, is_call: F = None) -> F:
        if is_call is None:
            is_call = instruction.fq(1)
        return (
            instruction.select(is_warm_access, instruction.fq(GAS_COST_WARM_ACCESS),
                               instruction.fq(GAS_COST_ACCOUNT_COLD_ACCESS))
            + self.has_value * (GAS_COST_CALL_WITH_VALUE
                                + is_call * self.is_success * self.callee_not_exists
                                * GAS_COST_NEW_ACCOUNT)
            + self.memory_expansion_gas_cost
        )
