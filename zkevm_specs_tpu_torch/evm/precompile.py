"""Precompiled contract metadata.

Equivalent to reference src/zkevm_specs/evm_circuit/precompile.py:8-72.
"""
from __future__ import annotations

from enum import IntEnum
from typing import List, Tuple

from ..utils import param
from .execution_state import ExecutionState


class Precompile(IntEnum):
    ECRECOVER = 0x01
    SHA256 = 0x02
    RIPEMD160 = 0x03
    DATACOPY = 0x04
    BIGMODEXP = 0x05
    BN254ADD = 0x06
    BN254SCALARMUL = 0x07
    BN254PAIRING = 0x08
    BLAKE2F = 0x09

    def execution_state(self) -> ExecutionState:
        return _INFO[self][1]

    def base_gas_cost(self) -> int:
        return _INFO[self][0]

    @classmethod
    def len(cls) -> int:
        return len(cls)


_INFO = {
    Precompile.ECRECOVER: (param.EcrecoverGas, ExecutionState.ECRECOVER),
    Precompile.SHA256: (param.Sha256BaseGas, ExecutionState.SHA256),
    Precompile.RIPEMD160: (param.Ripemd160BaseGas, ExecutionState.RIPEMD160),
    Precompile.DATACOPY: (param.IdentityBaseGas, ExecutionState.DATACOPY),
    Precompile.BIGMODEXP: (param.BigModExpBaseGas, ExecutionState.BIGMODEXP),
    Precompile.BN254ADD: (param.Bn254AddGas, ExecutionState.BN254_ADD),
    Precompile.BN254SCALARMUL: (param.Bn254ScalarMulGas, ExecutionState.BN254_SCALAR_MUL),
    Precompile.BN254PAIRING: (param.Bn254PairingBaseGas, ExecutionState.BN254_PAIRING),
    Precompile.BLAKE2F: (param.Blake2fBaseGas, ExecutionState.BLAKE2F),
}


def valid_precompiles() -> List[Precompile]:
    return list(Precompile)


def precompile_info_pairs() -> List[Tuple[int, int, int]]:
    return [
        (int(p.execution_state()), int(p), p.base_gas_cost())
        for p in valid_precompiles()
    ]
