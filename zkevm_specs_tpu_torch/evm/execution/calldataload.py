"""CALLDATALOAD gadget (reference: evm_circuit/execution/calldataload.py:8-60).

Counterpart of ``zkevm_specs_tpu/evm/execution/calldataload.py``.  The
buffer reader's distances to the buffer's end are host hints, computed by
the eager pass and replayed on the card (``BufferReaderGadget``)."""
from ...dsl.value import Word
from ...tables.schemas import RW, CallContextFieldTag
from ...utils.param import N_BYTES_WORD
from ..gadgets.memory_gadget import BufferReaderGadget
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def calldataload(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.CALLDATALOAD))

    offset = instruction.word_to_fq(instruction.stack_pop(), 8)

    is_root = instruction.branch(instruction.curr.is_root)
    if is_root:
        src_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
        calldata_length = instruction.call_context_lookup(CallContextFieldTag.CallDataLength)
        calldata_offset = instruction.fq(0)
    else:
        src_id = instruction.call_context_lookup(CallContextFieldTag.CallerId)
        calldata_length = instruction.call_context_lookup(CallContextFieldTag.CallDataLength)
        calldata_offset = instruction.call_context_lookup(CallContextFieldTag.CallDataOffset)

    src_addr = offset + calldata_offset
    src_addr_end = calldata_length + calldata_offset

    buffer_reader = BufferReaderGadget(
        instruction, N_BYTES_WORD, src_addr, src_addr_end, instruction.fq(N_BYTES_WORD)
    )

    calldata_bytes = []
    for idx in range(N_BYTES_WORD):
        if is_root:
            # tx-table lookups have no offset bookkeeping — maskable
            flag = buffer_reader.read_flag(idx)
            m = instruction.mask_of(flag)
            with instruction.masked(m):
                tx_byte = instruction.tx_calldata_lookup(src_id, src_addr + idx)
                buffer_reader.constrain_byte(idx, tx_byte)
            calldata_bytes.append(instruction.select(flag, tx_byte, instruction.fq(0)))
        else:
            # memory lookups consume rw offsets — lane-uniform branch
            if instruction.branch(buffer_reader.read_flag(idx)):
                mem_byte = instruction.memory_lookup(RW.Read, src_addr + idx, src_id)
                buffer_reader.constrain_byte(idx, mem_byte)
                calldata_bytes.append(mem_byte)
            else:
                calldata_bytes.append(instruction.fq(0))

    # The reference packs the read-order bytes LITTLE-endian into the word
    # (Word(bytes(calldata_word)), calldataload.py:49-52): b_0 is the lowest
    # byte of the pushed value.
    lo = instruction.bytes_to_fq(calldata_bytes[:16])
    hi = instruction.bytes_to_fq(calldata_bytes[16:])
    instruction.constrain_equal_word(Word(lo, hi), instruction.stack_push())

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(instruction.rw_counter_offset),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.same(),
    )
