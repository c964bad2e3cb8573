"""Typed circuit configuration, as far as the block verifier reads it.

Counterpart of ``zkevm_specs_tpu/config.py``: the tx circuit's floor
capacities and chain id, the bytecode circuit's floor size and the
randomness of the keccak, bytecode and withdrawal tables.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CircuitConfig:
    # tx circuit (reference tx_circuit.py:253-258)
    max_txs: int = 2
    max_calldata_bytes: int = 64
    # bytecode circuit table size 2^k (reference bytecode_circuit.py:104-106)
    bytecode_k: int = 10
    # randomness (tests pin these like the reference, pi_circuit.py:834-836)
    keccak_randomness: int = 0x64
    # chain parameters
    chain_id: int = 1

    def tx_circuit_params(self):
        return (self.max_txs, self.max_calldata_bytes, self.chain_id)


DEFAULT_CONFIG = CircuitConfig()
