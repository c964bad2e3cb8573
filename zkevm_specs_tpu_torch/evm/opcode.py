"""EVM opcode set and static opcode metadata.

Protocol data equivalent to the reference's Opcode enum + OPCODE_INFO_MAP
(reference: src/zkevm_specs/evm_circuit/opcode.py:8-358) — one flat data
table: name -> (byte, min_stack_pointer, max_stack_pointer, constant_gas,
has_dynamic_gas).
"""
from __future__ import annotations

from enum import IntEnum
from typing import List, Tuple

from ..utils.param import (
    GAS_COST_ZERO, GAS_COST_ONE, GAS_COST_QUICK, GAS_COST_FASTEST,
    GAS_COST_FAST, GAS_COST_MID, GAS_COST_SLOW, GAS_COST_EXT,
    GAS_COST_SHA3, GAS_COST_CREATE, GAS_COST_CREATE2,
    GAS_COST_SELF_DESTRUCT, GAS_COST_WARM_ACCESS,
)

_Z, _O, _Q, _F3, _F5, _M, _S, _E = (
    GAS_COST_ZERO, GAS_COST_ONE, GAS_COST_QUICK, GAS_COST_FASTEST,
    GAS_COST_FAST, GAS_COST_MID, GAS_COST_SLOW, GAS_COST_EXT,
)
_W = GAS_COST_WARM_ACCESS

# name: (byte, min_sp, max_sp, constant_gas, dynamic)
_T = {
    "STOP": (0x00, 0, 1024, _Z, False),
    "ADD": (0x01, -1, 1022, _F3, False),
    "MUL": (0x02, -1, 1022, _F5, False),
    "SUB": (0x03, -1, 1022, _F3, False),
    "DIV": (0x04, -1, 1022, _F5, False),
    "SDIV": (0x05, -1, 1022, _F5, False),
    "MOD": (0x06, -1, 1022, _F5, False),
    "SMOD": (0x07, -1, 1022, _F5, False),
    "ADDMOD": (0x08, -2, 1021, _M, False),
    "MULMOD": (0x09, -2, 1021, _M, False),
    "EXP": (0x0A, -1, 1022, _Z, True),
    "SIGNEXTEND": (0x0B, -1, 1022, _F5, False),
    "LT": (0x10, -1, 1022, _F3, False),
    "GT": (0x11, -1, 1022, _F3, False),
    "SLT": (0x12, -1, 1022, _F3, False),
    "SGT": (0x13, -1, 1022, _F3, False),
    "EQ": (0x14, -1, 1022, _F3, False),
    "ISZERO": (0x15, 0, 1023, _F3, False),
    "AND": (0x16, -1, 1022, _F3, False),
    "OR": (0x17, -1, 1022, _F3, False),
    "XOR": (0x18, -1, 1022, _F3, False),
    "NOT": (0x19, 0, 1023, _F3, False),
    "BYTE": (0x1A, -1, 1022, _F3, False),
    "SHL": (0x1B, -1, 1022, _F3, False),
    "SHR": (0x1C, -1, 1022, _F3, False),
    "SAR": (0x1D, -1, 1022, _F3, False),
    "SHA3": (0x20, -1, 1022, GAS_COST_SHA3, True),
    "ADDRESS": (0x30, 1, 1024, _Q, False),
    "BALANCE": (0x31, 0, 1023, _W, True),
    "ORIGIN": (0x32, 1, 1024, _Q, False),
    "CALLER": (0x33, 1, 1024, _Q, False),
    "CALLVALUE": (0x34, 1, 1024, _Q, False),
    "CALLDATALOAD": (0x35, 0, 1023, _F3, False),
    "CALLDATASIZE": (0x36, 1, 1024, _Q, False),
    "CALLDATACOPY": (0x37, -3, 1021, _F3, True),
    "CODESIZE": (0x38, 1, 1024, _Q, False),
    "CODECOPY": (0x39, -3, 1021, _F3, True),
    "GASPRICE": (0x3A, 1, 1024, _Q, False),
    "EXTCODESIZE": (0x3B, 0, 1023, _W, True),
    "EXTCODECOPY": (0x3C, -4, 1020, _W, True),
    "RETURNDATASIZE": (0x3D, 1, 1024, _Q, False),
    "RETURNDATACOPY": (0x3E, -3, 1021, _F3, True),
    "EXTCODEHASH": (0x3F, 0, 1023, _W, True),
    "BLOCKHASH": (0x40, 0, 1023, _E, False),
    "COINBASE": (0x41, 1, 1024, _Q, False),
    "TIMESTAMP": (0x42, 1, 1024, _Q, False),
    "NUMBER": (0x43, 1, 1024, _Q, False),
    "PREVRANDAO": (0x44, 1, 1024, _Q, False),
    "GASLIMIT": (0x45, 1, 1024, _Q, False),
    "CHAINID": (0x46, 1, 1024, _Q, False),
    "SELFBALANCE": (0x47, 1, 1024, _F5, False),
    "BASEFEE": (0x48, 1, 1024, _Q, False),
    "POP": (0x50, -1, 1023, _Q, False),
    "MLOAD": (0x51, 0, 1023, _F3, True),
    "MSTORE": (0x52, -2, 1022, _F3, True),
    "MSTORE8": (0x53, -2, 1022, _F3, True),
    "SLOAD": (0x54, 0, 1023, _Z, True),
    "SSTORE": (0x55, -2, 1022, _Z, True),
    "JUMP": (0x56, -1, 1023, _M, False),
    "JUMPI": (0x57, -2, 1022, _S, False),
    "PC": (0x58, 1, 1024, _Q, False),
    "MSIZE": (0x59, 1, 1024, _Q, False),
    "GAS": (0x5A, 1, 1024, _Q, False),
    "JUMPDEST": (0x5B, 0, 1024, _O, False),
    "PUSH0": (0x5F, 1, 1024, _Q, False),
    "LOG0": (0xA0, -2, 1022, _Z, True),
    "LOG1": (0xA1, -3, 1021, _Z, True),
    "LOG2": (0xA2, -4, 1020, _Z, True),
    "LOG3": (0xA3, -5, 1019, _Z, True),
    "LOG4": (0xA4, -6, 1018, _Z, True),
    "CREATE": (0xF0, -2, 1021, GAS_COST_CREATE, True),
    "CALL": (0xF1, -6, 1017, _W, True),
    "CALLCODE": (0xF2, -6, 1017, _W, True),
    "RETURN": (0xF3, -2, 1022, _Z, True),
    "DELEGATECALL": (0xF4, -5, 1018, _W, True),
    "CREATE2": (0xF5, -3, 1020, GAS_COST_CREATE2, True),
    "STATICCALL": (0xFA, -5, 1018, _W, True),
    "REVERT": (0xFD, -2, 1022, _Z, True),
    "SELFDESTRUCT": (0xFF, -1, 1023, GAS_COST_SELF_DESTRUCT, True),
}
# PUSH1..PUSH32, DUP1..DUP16, SWAP1..SWAP16 are regular families:
for _i in range(1, 33):
    _T[f"PUSH{_i}"] = (0x60 + _i - 1, 1, 1024, _F3, False)
for _i in range(1, 17):
    _T[f"DUP{_i}"] = (0x80 + _i - 1, 1, 1024 - _i, _F3, False)
for _i in range(1, 17):
    _T[f"SWAP{_i}"] = (0x90 + _i - 1, 0, 1023 - _i, _F3, False)


Opcode = IntEnum("Opcode", {name: spec[0] for name, spec in _T.items()})

_INFO = {spec[0]: spec[1:] for spec in _T.values()}


def min_stack_pointer(op) -> int:
    return _INFO[int(op)][0]


def max_stack_pointer(op) -> int:
    return _INFO[int(op)][1]


def constant_gas_cost(op) -> int:
    return _INFO[int(op)][2]


def has_dynamic_gas(op) -> bool:
    return _INFO[int(op)][3]


def valid_opcodes() -> List[Opcode]:
    return list(Opcode)


def invalid_opcodes() -> List[int]:
    valid = set(int(o) for o in Opcode)
    return [b for b in range(256) if b not in valid]


def stack_overflow_pairs() -> List[Tuple[int, int]]:
    pairs = []
    for op in valid_opcodes():
        if min_stack_pointer(op) > 0:
            for sp in range(min_stack_pointer(op)):
                pairs.append((int(op), sp))
    return pairs


def stack_underflow_pairs() -> List[Tuple[int, int]]:
    pairs = []
    for op in valid_opcodes():
        if max_stack_pointer(op) < 1024:
            for sp in range(max_stack_pointer(op), 1024):
                pairs.append((int(op), sp + 1))
    return pairs


def constant_gas_cost_pairs() -> List[Tuple[int, int]]:
    return [
        (int(op), constant_gas_cost(op))
        for op in valid_opcodes()
        if not has_dynamic_gas(op) and constant_gas_cost(op) > 0
    ]


def state_write_opcodes() -> List[int]:
    return [
        int(o)
        for o in (
            Opcode.SSTORE, Opcode.LOG0, Opcode.LOG1, Opcode.LOG2, Opcode.LOG3,
            Opcode.LOG4, Opcode.CREATE, Opcode.CALL, Opcode.CREATE2,
            Opcode.SELFDESTRUCT,
        )
    ]


def call_opcodes() -> List[Opcode]:
    return [Opcode.CALL, Opcode.CALLCODE, Opcode.DELEGATECALL, Opcode.STATICCALL]


def ether_transfer_opcodes() -> List[Opcode]:
    return [Opcode.CALL, Opcode.CALLCODE]


def create_opcodes() -> List[Opcode]:
    return [Opcode.CREATE, Opcode.CREATE2]


def jump_opcodes() -> List[Opcode]:
    return [Opcode.JUMP, Opcode.JUMPI]


def is_push(op) -> bool:
    return Opcode.PUSH0 <= int(op) <= Opcode.PUSH32


def is_push_with_data(op) -> bool:
    return Opcode.PUSH1 <= int(op) <= Opcode.PUSH32


def get_push_size(op) -> int:
    return int(op) - int(Opcode.PUSH0) if is_push_with_data(op) else 0
