"""Context/environment query gadgets: ADDRESS, CALLER, CALLVALUE,
CALLDATASIZE, CODESIZE, GASPRICE, ORIGIN, SELFBALANCE, RETURNDATASIZE,
BlockCtx, BLOCKHASH (reference: evm_circuit/execution/{address,caller,
callvalue,calldatasize,codesize,gasprice,origin,selfbalance,
returndatasize,block_ctx,blockhash}.py).

Counterpart of ``zkevm_specs_tpu/evm/execution/context.py``."""
import torch

from ...dsl.value import Word, WordOrValue
from ...tables.schemas import (
    AccountFieldTag,
    BlockContextFieldTag,
    CallContextFieldTag,
    TxContextFieldTag,
)
from ...utils.param import N_BYTES_U64
from ..instruction import Instruction, Transition
from ..opcode import Opcode


def _push_ctx_word(instruction, opcode_val, field_tag):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(opcode_val))
    instruction.constrain_equal_word(
        instruction.call_context_lookup_word(field_tag),
        instruction.stack_push(),
    )
    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(2),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(-1),
    )


def address(instruction: Instruction):
    _push_ctx_word(instruction, Opcode.ADDRESS, CallContextFieldTag.CalleeAddress)


def caller(instruction: Instruction):
    _push_ctx_word(instruction, Opcode.CALLER, CallContextFieldTag.CallerAddress)


def callvalue(instruction: Instruction):
    _push_ctx_word(instruction, Opcode.CALLVALUE, CallContextFieldTag.Value)


def calldatasize(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.CALLDATASIZE))
    instruction.constrain_equal_word(
        Word.from_lo(instruction.call_context_lookup(CallContextFieldTag.CallDataLength)),
        instruction.stack_push(),
    )
    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(2),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(-1),
    )


def returndatasize(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.RETURNDATASIZE))
    instruction.constrain_equal_word(
        Word.from_lo(
            instruction.call_context_lookup(CallContextFieldTag.LastCalleeReturnDataLength)
        ),
        instruction.stack_push(),
    )
    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(2),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(-1),
    )


def codesize(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.CODESIZE))
    code_size = instruction.bytecode_length(instruction.curr.code_hash)
    instruction.constrain_equal_word(Word.from_lo(code_size), instruction.stack_push())
    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(1),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(-1),
    )


def gasprice(instruction: Instruction):
    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.GASPRICE))
    instruction.constrain_equal_word(
        instruction.tx_context_lookup_word(tx_id, TxContextFieldTag.GasPrice),
        instruction.stack_push(),
    )
    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(2),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(-1),
    )


def origin(instruction: Instruction):
    tx_id = instruction.call_context_lookup(CallContextFieldTag.TxId)
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.ORIGIN))
    instruction.constrain_equal_word(
        instruction.tx_context_lookup_word(tx_id, TxContextFieldTag.CallerAddress),
        instruction.stack_push(),
    )
    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(2),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(-1),
    )


def selfbalance(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    instruction.constrain_equal(opcode, int(Opcode.SELFBALANCE))
    callee_address_word = instruction.call_context_lookup_word(CallContextFieldTag.CalleeAddress)
    callee_address = instruction.word_to_address(callee_address_word)
    balance = instruction.account_read_word(callee_address, AccountFieldTag.Balance)
    instruction.constrain_equal_word(instruction.stack_push(), balance)
    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(3),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(-1),
    )


_BLOCK_CTX_TAGS = {
    Opcode.COINBASE: BlockContextFieldTag.Coinbase,
    Opcode.TIMESTAMP: BlockContextFieldTag.Timestamp,
    Opcode.NUMBER: BlockContextFieldTag.Number,
    Opcode.GASLIMIT: BlockContextFieldTag.GasLimit,
    Opcode.PREVRANDAO: BlockContextFieldTag.PrevRandao,
    Opcode.BASEFEE: BlockContextFieldTag.BaseFee,
    Opcode.CHAINID: BlockContextFieldTag.ChainId,
}


def blockctx(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)
    for op, tag in _BLOCK_CTX_TAGS.items():
        if instruction.branch(instruction.is_equal(opcode, int(op))):
            ctx_word = instruction.block_context_lookup_word(tag)
            break
    else:
        # invalid opcode: fail every lane (the responsible-opcode check would too)
        instruction.cs.check(
            torch.zeros((instruction.ctx.batch,), dtype=torch.bool, device=instruction.ctx.device),
            lambda: "BlockCtx: unexpected opcode",
        )
        ctx_word = WordOrValue(instruction.fq(0))

    instruction.constrain_equal_word(ctx_word, instruction.stack_push())

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(1),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.delta(-1),
    )


def blockhash(instruction: Instruction):
    opcode = instruction.opcode_lookup(True)

    block_number = instruction.word_to_u64(instruction.stack_pop())
    current_block_number = instruction.block_context_lookup(BlockContextFieldTag.Number)
    block_hash = instruction.stack_push()

    block_lt, _ = instruction.compare(block_number, current_block_number, N_BYTES_U64)
    diff_lt, _ = instruction.compare(current_block_number, 256 + block_number, 2)

    valid = instruction.is_equal(block_lt * diff_lt, 1)
    m_valid = instruction.mask_of(valid)
    with instruction.masked(m_valid):
        looked_up = instruction.block_context_lookup_word(
            BlockContextFieldTag.HistoryHash, block_number
        )
    expected = instruction.select_word(valid, looked_up, WordOrValue(instruction.fq(0)))
    instruction.constrain_equal_word(block_hash, expected)

    instruction.step_state_transition_in_same_context(
        opcode,
        rw_counter=Transition.delta(2),
        program_counter=Transition.delta(1),
        stack_pointer=Transition.same(),
    )
