"""Execution-state machine of the EVM circuit.

Protocol data equivalent to the reference's ExecutionState enum and its
responsible-opcode map (reference:
src/zkevm_specs/evm_circuit/execution_state.py:14-414).
"""
from __future__ import annotations

from enum import IntEnum, auto
from typing import List, Sequence, Tuple, Union

from .opcode import (
    Opcode,
    invalid_opcodes,
    stack_overflow_pairs,
    stack_underflow_pairs,
    state_write_opcodes,
)


class ExecutionState(IntEnum):
    BeginTx = auto()
    EndTx = auto()
    EndBlock = auto()
    # opcode successes
    STOP = auto()
    ADD = auto()          # ADD, SUB
    MUL = auto()          # MUL, DIV, MOD
    SDIV_SMOD = auto()
    ADDMOD = auto()
    MULMOD = auto()
    EXP = auto()
    SIGNEXTEND = auto()
    CMP = auto()          # LT, GT, EQ
    SCMP = auto()         # SLT, SGT
    ISZERO = auto()
    BITWISE = auto()      # AND, OR, XOR
    NOT = auto()
    BYTE = auto()
    SHL_SHR = auto()
    SAR = auto()
    SHA3 = auto()
    ADDRESS = auto()
    BALANCE = auto()
    ORIGIN = auto()
    CALLER = auto()
    CALLVALUE = auto()
    CALLDATALOAD = auto()
    CALLDATASIZE = auto()
    CALLDATACOPY = auto()
    CODESIZE = auto()
    CODECOPY = auto()
    GASPRICE = auto()
    EXTCODESIZE = auto()
    EXTCODECOPY = auto()
    RETURNDATASIZE = auto()
    RETURNDATACOPY = auto()
    EXTCODEHASH = auto()
    BLOCKHASH = auto()
    BlockCtx = auto()
    SELFBALANCE = auto()
    POP = auto()
    MEMORY = auto()       # MLOAD, MSTORE, MSTORE8
    SLOAD = auto()
    SSTORE = auto()
    JUMP = auto()
    JUMPI = auto()
    PC = auto()
    MSIZE = auto()
    GAS = auto()
    JUMPDEST = auto()
    PUSH = auto()         # PUSH0..PUSH32
    DUP = auto()          # DUP1..DUP16
    SWAP = auto()         # SWAP1..SWAP16
    LOG = auto()          # LOG0..LOG4
    CREATE = auto()
    CALL_OP = auto()      # CALL, CALLCODE, DELEGATECALL, STATICCALL
    RETURN = auto()
    CREATE2 = auto()
    REVERT = auto()
    SELFDESTRUCT = auto()
    # opcode errors
    ErrorInvalidOpcode = auto()
    ErrorGasUintOverflow = auto()
    ErrorStack = auto()
    ErrorWriteProtection = auto()
    ErrorDepth = auto()
    ErrorInsufficientBalance = auto()
    ErrorContractAddressCollision = auto()
    ErrorInvalidCreationCode = auto()
    ErrorNonceUintOverflow = auto()
    ErrorMaxCodeSizeExceeded = auto()
    ErrorInvalidJump = auto()
    ErrorReturnDataOutOfBound = auto()
    ErrorOutOfGasConstant = auto()
    ErrorOutOfGasStaticMemoryExpansion = auto()
    ErrorOutOfGasDynamicMemoryExpansion = auto()
    ErrorOutOfGasMemoryCopy = auto()
    ErrorOutOfGasAccountAccess = auto()
    ErrorOutOfGasCodeStore = auto()
    ErrorOutOfGasLOG = auto()
    ErrorOutOfGasEXP = auto()
    ErrorOutOfGasSHA3 = auto()
    ErrorOutOfGasSloadSstore = auto()
    ErrorOutOfGasCall = auto()
    ErrorOutOfGasCREATE = auto()
    ErrorOutOfGasSELFDESTRUCT = auto()
    ErrorOutOfGasPrecompile = auto()
    # precompile successes
    ECRECOVER = auto()
    SHA256 = auto()
    RIPEMD160 = auto()
    DATACOPY = auto()
    BIGMODEXP = auto()
    BN254_ADD = auto()
    BN254_SCALAR_MUL = auto()
    BN254_PAIRING = auto()
    BLAKE2F = auto()

    def halts_in_success(self) -> bool:
        return self in (
            ExecutionState.STOP,
            ExecutionState.RETURN,
            ExecutionState.SELFDESTRUCT,
        )

    def halts_in_exception(self) -> bool:
        return self in _HALT_EXCEPTIONS

    def halts(self) -> bool:
        return (
            self.halts_in_success()
            or self.halts_in_exception()
            or self == ExecutionState.REVERT
        )

    def responsible_opcode(self) -> Union[Sequence[int], Sequence[Tuple[int, int]]]:
        if self == ExecutionState.ErrorInvalidOpcode:
            return invalid_opcodes()
        if self == ExecutionState.ErrorStack:
            return stack_overflow_pairs() + stack_underflow_pairs()
        if self == ExecutionState.ErrorWriteProtection:
            return state_write_opcodes()
        return _RESPONSIBLE.get(self, [])


_HALT_EXCEPTIONS = frozenset(
    {
        ExecutionState.ErrorInvalidOpcode,
        ExecutionState.ErrorGasUintOverflow,
        ExecutionState.ErrorStack,
        ExecutionState.ErrorWriteProtection,
        ExecutionState.ErrorDepth,
        ExecutionState.ErrorInsufficientBalance,
        ExecutionState.ErrorContractAddressCollision,
        ExecutionState.ErrorInvalidCreationCode,
        ExecutionState.ErrorMaxCodeSizeExceeded,
        ExecutionState.ErrorInvalidJump,
        ExecutionState.ErrorReturnDataOutOfBound,
        ExecutionState.ErrorOutOfGasConstant,
        ExecutionState.ErrorOutOfGasStaticMemoryExpansion,
        ExecutionState.ErrorOutOfGasDynamicMemoryExpansion,
        ExecutionState.ErrorOutOfGasMemoryCopy,
        ExecutionState.ErrorOutOfGasAccountAccess,
        ExecutionState.ErrorOutOfGasCodeStore,
        ExecutionState.ErrorOutOfGasLOG,
        ExecutionState.ErrorOutOfGasEXP,
        ExecutionState.ErrorOutOfGasSHA3,
        ExecutionState.ErrorOutOfGasSloadSstore,
        ExecutionState.ErrorOutOfGasCall,
        ExecutionState.ErrorOutOfGasCREATE,
        ExecutionState.ErrorOutOfGasSELFDESTRUCT,
    }
)

_O = Opcode
_RESPONSIBLE = {
    ExecutionState.STOP: [_O.STOP],
    ExecutionState.ADD: [_O.ADD, _O.SUB],
    ExecutionState.MUL: [_O.MUL, _O.DIV, _O.MOD],
    ExecutionState.SDIV_SMOD: [_O.SDIV, _O.SMOD],
    ExecutionState.ADDMOD: [_O.ADDMOD],
    ExecutionState.MULMOD: [_O.MULMOD],
    ExecutionState.EXP: [_O.EXP],
    ExecutionState.SIGNEXTEND: [_O.SIGNEXTEND],
    ExecutionState.CMP: [_O.LT, _O.GT, _O.EQ],
    ExecutionState.SCMP: [_O.SLT, _O.SGT],
    ExecutionState.ISZERO: [_O.ISZERO],
    ExecutionState.BITWISE: [_O.AND, _O.OR, _O.XOR],
    ExecutionState.NOT: [_O.NOT],
    ExecutionState.BYTE: [_O.BYTE],
    ExecutionState.SHL_SHR: [_O.SHL, _O.SHR],
    ExecutionState.SAR: [_O.SAR],
    ExecutionState.SHA3: [_O.SHA3],
    ExecutionState.ADDRESS: [_O.ADDRESS],
    ExecutionState.BALANCE: [_O.BALANCE],
    ExecutionState.ORIGIN: [_O.ORIGIN],
    ExecutionState.CALLER: [_O.CALLER],
    ExecutionState.CALLVALUE: [_O.CALLVALUE],
    ExecutionState.CALLDATALOAD: [_O.CALLDATALOAD],
    ExecutionState.CALLDATASIZE: [_O.CALLDATASIZE],
    ExecutionState.CALLDATACOPY: [_O.CALLDATACOPY],
    ExecutionState.CODESIZE: [_O.CODESIZE],
    ExecutionState.CODECOPY: [_O.CODECOPY],
    ExecutionState.GASPRICE: [_O.GASPRICE],
    ExecutionState.EXTCODESIZE: [_O.EXTCODESIZE],
    ExecutionState.EXTCODECOPY: [_O.EXTCODECOPY],
    ExecutionState.RETURNDATASIZE: [_O.RETURNDATASIZE],
    ExecutionState.RETURNDATACOPY: [_O.RETURNDATACOPY],
    ExecutionState.EXTCODEHASH: [_O.EXTCODEHASH],
    ExecutionState.BLOCKHASH: [_O.BLOCKHASH],
    ExecutionState.BlockCtx: [
        _O.COINBASE, _O.TIMESTAMP, _O.NUMBER, _O.PREVRANDAO,
        _O.GASLIMIT, _O.BASEFEE, _O.CHAINID,
    ],
    ExecutionState.SELFBALANCE: [_O.SELFBALANCE],
    ExecutionState.POP: [_O.POP],
    ExecutionState.MEMORY: [_O.MLOAD, _O.MSTORE, _O.MSTORE8],
    ExecutionState.SLOAD: [_O.SLOAD],
    ExecutionState.SSTORE: [_O.SSTORE],
    ExecutionState.JUMP: [_O.JUMP],
    ExecutionState.JUMPI: [_O.JUMPI],
    ExecutionState.PC: [_O.PC],
    ExecutionState.MSIZE: [_O.MSIZE],
    ExecutionState.GAS: [_O.GAS],
    ExecutionState.JUMPDEST: [_O.JUMPDEST],
    ExecutionState.PUSH: [_O[f"PUSH{i}"] for i in range(0, 33)],
    ExecutionState.DUP: [_O[f"DUP{i}"] for i in range(1, 17)],
    ExecutionState.SWAP: [_O[f"SWAP{i}"] for i in range(1, 17)],
    ExecutionState.LOG: [_O.LOG0, _O.LOG1, _O.LOG2, _O.LOG3, _O.LOG4],
    ExecutionState.CREATE: [_O.CREATE],
    ExecutionState.CALL_OP: [_O.CALL, _O.CALLCODE, _O.DELEGATECALL, _O.STATICCALL],
    ExecutionState.RETURN: [_O.RETURN],
    ExecutionState.CREATE2: [_O.CREATE2],
    ExecutionState.REVERT: [_O.REVERT],
    ExecutionState.SELFDESTRUCT: [_O.SELFDESTRUCT],
}


def precompile_execution_states() -> Sequence[ExecutionState]:
    return [
        ExecutionState.ECRECOVER,
        ExecutionState.SHA256,
        ExecutionState.RIPEMD160,
        ExecutionState.DATACOPY,
        ExecutionState.BIGMODEXP,
        ExecutionState.BN254_ADD,
        ExecutionState.BN254_SCALAR_MUL,
        ExecutionState.BN254_PAIRING,
        ExecutionState.BLAKE2F,
    ]


def responsible_opcode_codes() -> List[int]:
    """Sorted (state, opcode, aux) codes for the fixed-table predicate:
    code = state*(2048*256) + opcode*2048 + aux."""
    codes = []
    for state in ExecutionState:
        for entry in state.responsible_opcode():
            op, aux = entry if isinstance(entry, tuple) else (entry, 0)
            codes.append(int(state) * 2048 * 256 + int(op) * 2048 + int(aux))
    return sorted(set(codes))
