"""Execution-gadget registry (reference: execution/__init__.py:86-171).

Every gadget of the JAX package's registry is registered: the CALL
family, RETURN/REVERT, CREATE/CREATE2, every error state and the five
precompiles the JAX package implements (ecRecover, identity, BN254 add,
scalar mul and pairing).  SHA256, RIPEMD160, BIGMODEXP and BLAKE2F have no
gadget there either (the reference's execution/__init__.py:160-168);
``verify_steps`` raises ``NotImplementedError`` for their states."""
from typing import Callable, Dict

from ..execution_state import ExecutionState
from .add_sub import add_sub
from .addmod import addmod
from .balance import balance
from .begin_tx import begin_tx
from .bitwise import bitwise
from .byte import byte
from .calldataload import calldataload
from .callop import callop
from .comparator import cmp
from .create import create
from .context import (
    address,
    blockctx,
    blockhash,
    caller,
    calldatasize,
    callvalue,
    codesize,
    gasprice,
    origin,
    returndatasize,
    selfbalance,
)
from .copy_family import calldatacopy, codecopy, extcodecopy, returndatacopy, sha3
from .end_block import end_block
from .end_tx import end_tx
from .errors import (
    error_code_store,
    error_gas_uint_overflow,
    error_invalid_creation_code,
    error_invalid_jump,
    error_invalid_opcode,
    error_oog_account_access,
    error_oog_call,
    error_oog_constant,
    error_oog_create,
    error_oog_dynamic_memory_expansion,
    error_oog_exp,
    error_oog_log,
    error_oog_memory_copy,
    error_oog_precompile,
    error_oog_sha3,
    error_oog_sload_sstore,
    error_oog_static_memory_expansion,
    error_return_data_out_of_bound,
    error_stack,
    error_write_protection,
)
from .exp import exp
from .extcode import extcodehash, extcodesize
from .gas import gas
from .iszero import iszero
from .jump import jump
from .jumpi import jumpi
from .log import log
from .memory import memory
from .msize import msize
from .mul_div_mod import mul_div_mod
from .mulmod import mulmod
from .not_ import not_opcode
from .pop import pop
from .precompiles import dataCopy, ecAdd, ecMul, ecPairing, ecRecover
from .push import push
from .return_revert import return_revert
from .sar import sar
from .sdiv_smod import sdiv_smod
from .shl_shr import shl_shr
from .signextend import signextend
from .slt_sgt import scmp
from .stack_family import dup, jumpdest, pc, swap
from .stop import stop
from .storage import sload, sstore

EXECUTION_STATE_IMPL: Dict[ExecutionState, Callable] = {
    ExecutionState.BeginTx: begin_tx,
    ExecutionState.EndTx: end_tx,
    ExecutionState.EndBlock: end_block,
    ExecutionState.CALL_OP: callop,
    ExecutionState.CREATE: create,
    ExecutionState.CREATE2: create,
    ExecutionState.RETURN: return_revert,
    ExecutionState.ADD: add_sub,
    ExecutionState.MUL: mul_div_mod,
    ExecutionState.SDIV_SMOD: sdiv_smod,
    ExecutionState.ADDMOD: addmod,
    ExecutionState.MULMOD: mulmod,
    ExecutionState.EXP: exp,
    ExecutionState.SHL_SHR: shl_shr,
    ExecutionState.SAR: sar,
    ExecutionState.CMP: cmp,
    ExecutionState.SCMP: scmp,
    ExecutionState.ISZERO: iszero,
    ExecutionState.NOT: not_opcode,
    ExecutionState.BITWISE: bitwise,
    ExecutionState.BYTE: byte,
    ExecutionState.SIGNEXTEND: signextend,
    ExecutionState.MEMORY: memory,
    ExecutionState.SLOAD: sload,
    ExecutionState.SSTORE: sstore,
    ExecutionState.SHA3: sha3,
    ExecutionState.PUSH: push,
    ExecutionState.POP: pop,
    ExecutionState.STOP: stop,
    ExecutionState.ADDRESS: address,
    ExecutionState.BALANCE: balance,
    ExecutionState.BLOCKHASH: blockhash,
    ExecutionState.BlockCtx: blockctx,
    ExecutionState.CALLDATACOPY: calldatacopy,
    ExecutionState.CALLDATALOAD: calldataload,
    ExecutionState.CALLDATASIZE: calldatasize,
    ExecutionState.CODECOPY: codecopy,
    ExecutionState.EXTCODECOPY: extcodecopy,
    ExecutionState.EXTCODEHASH: extcodehash,
    ExecutionState.EXTCODESIZE: extcodesize,
    ExecutionState.LOG: log,
    ExecutionState.RETURNDATACOPY: returndatacopy,
    ExecutionState.CALLER: caller,
    ExecutionState.CALLVALUE: callvalue,
    ExecutionState.CODESIZE: codesize,
    ExecutionState.GASPRICE: gasprice,
    ExecutionState.ORIGIN: origin,
    ExecutionState.RETURNDATASIZE: returndatasize,
    ExecutionState.SELFBALANCE: selfbalance,
    ExecutionState.GAS: gas,
    ExecutionState.JUMP: jump,
    ExecutionState.JUMPI: jumpi,
    ExecutionState.MSIZE: msize,
    # beyond the reference: DUP/SWAP/PC/JUMPDEST exist in its enum but are
    # never registered there (execution/__init__.py:86-171)
    ExecutionState.DUP: dup,
    ExecutionState.SWAP: swap,
    ExecutionState.PC: pc,
    ExecutionState.JUMPDEST: jumpdest,
    # the error states
    ExecutionState.ErrorInvalidJump: error_invalid_jump,
    ExecutionState.ErrorGasUintOverflow: error_gas_uint_overflow,
    ExecutionState.ErrorOutOfGasCall: error_oog_call,
    ExecutionState.ErrorInvalidOpcode: error_invalid_opcode,
    ExecutionState.ErrorOutOfGasConstant: error_oog_constant,
    ExecutionState.ErrorStack: error_stack,
    ExecutionState.ErrorOutOfGasDynamicMemoryExpansion: error_oog_dynamic_memory_expansion,
    ExecutionState.ErrorOutOfGasMemoryCopy: error_oog_memory_copy,
    ExecutionState.ErrorOutOfGasLOG: error_oog_log,
    ExecutionState.ErrorWriteProtection: error_write_protection,
    ExecutionState.ErrorMaxCodeSizeExceeded: error_code_store,
    ExecutionState.ErrorOutOfGasCodeStore: error_code_store,
    ExecutionState.ErrorOutOfGasEXP: error_oog_exp,
    ExecutionState.ErrorInvalidCreationCode: error_invalid_creation_code,
    ExecutionState.ErrorOutOfGasSHA3: error_oog_sha3,
    ExecutionState.ErrorOutOfGasAccountAccess: error_oog_account_access,
    ExecutionState.ErrorOutOfGasStaticMemoryExpansion: error_oog_static_memory_expansion,
    ExecutionState.ErrorOutOfGasSloadSstore: error_oog_sload_sstore,
    ExecutionState.ErrorReturnDataOutOfBound: error_return_data_out_of_bound,
    ExecutionState.ErrorOutOfGasCREATE: error_oog_create,
    ExecutionState.ErrorOutOfGasPrecompile: error_oog_precompile,
    # the precompiles (SHA256, RIPEMD160, BIGMODEXP and BLAKE2F have no
    # gadget, as in the reference, execution/__init__.py:160-168)
    ExecutionState.ECRECOVER: ecRecover,
    ExecutionState.DATACOPY: dataCopy,
    ExecutionState.BN254_ADD: ecAdd,
    ExecutionState.BN254_PAIRING: ecPairing,
    ExecutionState.BN254_SCALAR_MUL: ecMul,
}
