"""BALANCE gadget (reference: evm_circuit/execution/balance.py:7-37).

Counterpart of ``zkevm_specs_tpu/evm/execution/balance.py``."""
from ...tables.schemas import AccountFieldTag, CallContextFieldTag
from ...utils.param import EXTRA_GAS_COST_ACCOUNT_COLD_ACCESS
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def balance(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.BALANCE))

    address = instruction.word_to_address(instruction.stack_pop())

    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    is_warm = instruction.add_account_to_access_list(
        tx_id, address, instruction.reversion_info()
    )

    exists = 1 - instruction.is_zero_word(
        instruction.account_read_word(address, AccountFieldTag.CodeHash)
    )

    # an extra balance read only exists for existing accounts (rw schedule
    # depends on it — lane-uniform via branch)
    if instruction.branch(exists):
        balance_word = instruction.account_read_word(address, AccountFieldTag.Balance)
        exists_delta = 1
    else:
        balance_word = instruction.word(0)
        exists_delta = 0

    instruction.constrain_equal_word(
        instruction.select_word(exists, balance_word, instruction.word(0)),
        instruction.stack_push(),
    )

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(7 + exists_delta),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.same(),
        # the access-list write is reversible and must advance the
        # counter (deviation: the reference leaves it Same here but counts
        # the identical write in extcodesize.py:40/storage.py:45, which
        # would make mirror offsets collide in an integrated witness)
        reversible_write_counter=Transition.delta(1),
        dynamic_gas_cost=instruction.select(
            is_warm, instruction.fq(0), instruction.fq(EXTRA_GAS_COST_ACCOUNT_COLD_ACCESS)
        ),
    )
