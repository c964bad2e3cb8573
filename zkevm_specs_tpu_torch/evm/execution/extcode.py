"""EXTCODESIZE / EXTCODEHASH gadgets (reference:
evm_circuit/execution/{extcodesize,extcodehash}.py).

Counterpart of ``zkevm_specs_tpu/evm/execution/extcode.py``."""
from ...dsl.value import Word
from ...tables.schemas import AccountFieldTag, CallContextFieldTag
from ...utils.param import EXTRA_GAS_COST_ACCOUNT_COLD_ACCESS
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def extcodesize(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.EXTCODESIZE))

    address = instruction.word_to_address(instruction.stack_pop())

    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    is_warm = instruction.add_account_to_access_list(tx_id, address, instruction.reversion_info())

    code_hash = instruction.account_read_word(address, AccountFieldTag.CodeHash)
    exists = 1 - instruction.is_zero_word(code_hash)

    with instruction.masked(instruction.mask_of(exists)):
        looked_up = instruction.bytecode_length(code_hash)
    code_size = instruction.select(exists, looked_up, instruction.fq(0))

    instruction.constrain_equal_word(
        Word.from_lo(instruction.select(exists, code_size, instruction.fq(0))),
        instruction.stack_push(),
    )

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(7),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.same(),
        dynamic_gas_cost=instruction.select(
            is_warm, instruction.fq(0), instruction.fq(EXTRA_GAS_COST_ACCOUNT_COLD_ACCESS)
        ),
        reversible_write_counter=Transition.delta(1),
    )


def extcodehash(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.EXTCODEHASH))

    address = instruction.word_to_address(instruction.stack_pop())

    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    is_warm = instruction.add_account_to_access_list(tx_id, address, instruction.reversion_info())

    code_hash = instruction.account_read_word(address, AccountFieldTag.CodeHash)

    instruction.constrain_equal_word(code_hash, instruction.stack_push())

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(7),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.same(),
        dynamic_gas_cost=instruction.select(
            is_warm, instruction.fq(0), instruction.fq(EXTRA_GAS_COST_ACCOUNT_COLD_ACCESS)
        ),
        # the access-list write is reversible and must advance the counter
        # (deviation: the reference leaves it Same here but counts the
        # identical write in extcodesize.py:40/storage.py:45, which would
        # make mirror offsets collide in an integrated witness)
        reversible_write_counter=Transition.delta(1),
    )
