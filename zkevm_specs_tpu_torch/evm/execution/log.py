"""LOG0..LOG4 gadget (reference: evm_circuit/execution/log.py:8-103).

Counterpart of ``zkevm_specs_tpu/evm/execution/log.py``."""
from ...tables.schemas import CallContextFieldTag, CopyDataTypeTag, TxLogFieldTag
from ...utils.param import GAS_COST_LOG, GAS_COST_LOGDATA
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def log(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.range_lookup(opcode - int(Opcode.LOG0), 5)

    mstart = instruction.word_to_fq(instruction.stack_pop(), 8)
    msize = instruction.word_to_fq(instruction.stack_pop(), 8)

    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    instruction.constrain_equal(
        instruction.fq(0), instruction.call_context_lookup(CallContextFieldTag.IsStatic)
    )

    contract_address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    is_persistent = instruction.call_context_lookup(CallContextFieldTag.IsPersistent)
    persistent = instruction.branch(is_persistent)
    if persistent:
        instruction.constrain_equal_word(
            contract_address_word,
            instruction.tx_log_lookup_word(
                tx_id=tx_id, log_id=instruction.curr.log_id + 1,
                field_tag=TxLogFieldTag.Address,
            ),
        )

    # topic count is encoded in the opcode (lane-uniform by grouping)
    topic_count = 0
    for tc in range(5):
        if instruction.branch(instruction.is_equal(opcode, int(Opcode.LOG0) + tc)):
            topic_count = tc
            break

    topic_selectors = [0] * 4
    for i in range(4):
        if i < topic_count:
            topic_selectors[i] = 1
            topic = instruction.stack_pop()
            if persistent:
                instruction.constrain_equal_word(
                    topic,
                    instruction.tx_log_lookup_word(
                        tx_id=tx_id, log_id=instruction.curr.log_id + 1,
                        field_tag=TxLogFieldTag.Topic, index=i,
                    ),
                )

    for i in range(4):
        instruction.constrain_bool(instruction.fq(topic_selectors[i]))
        if i > 0:
            instruction.constrain_bool(
                instruction.fq(topic_selectors[i - 1] - topic_selectors[i])
            )

    if instruction.branch(1 - instruction.is_zero(msize)) and persistent:
        copy_rwc_inc, _ = instruction.copy_lookup(
            instruction.curr.call_id,
            CopyDataTypeTag.Memory,
            tx_id,
            CopyDataTypeTag.TxLog,
            mstart,
            mstart + msize,
            instruction.fq(0),
            msize,
            instruction.curr.rw_counter + instruction.rw_counter_offset,
            log_id=instruction.curr.log_id + 1,
        )
    else:
        copy_rwc_inc = instruction.fq(0)

    next_memory_size, memory_expansion_gas = instruction.memory_expansion_dynamic_length(
        mstart, msize
    )
    dynamic_gas = (
        GAS_COST_LOG
        + GAS_COST_LOG * (opcode - int(Opcode.LOG0))
        + GAS_COST_LOGDATA * msize
        + memory_expansion_gas
    )

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(instruction.rw_counter_offset + copy_rwc_inc),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(2 + opcode - int(Opcode.LOG0)),
        dynamic_gas_cost=dynamic_gas,
        memory_word_size=Transition.to(next_memory_size),
        log_id=Transition.delta(is_persistent),
    )
