"""Typed circuit configuration, as far as the block verifier reads it.

Counterpart of ``zkevm_specs_tpu/config.py``: the bytecode circuit's floor
size and the randomness of the keccak, bytecode and withdrawal tables.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CircuitConfig:
    # bytecode circuit table size 2^k (reference bytecode_circuit.py:104-106)
    bytecode_k: int = 10
    # randomness (tests pin these like the reference, pi_circuit.py:834-836)
    keccak_randomness: int = 0x64


DEFAULT_CONFIG = CircuitConfig()
