"""Seeded witness batches for one EVM step group.

``build_add_workload`` is the flagship group of the JAX package's entry
point (``__graft_entry__._build_add_workload``): ADD steps over random
256-bit words from ``numpy.random.RandomState(seed)``, drawn in the same
order, so both packages see the same words.  ``build_mul_workload`` is the
MUL group built on the same pattern (the JAX package's
``tests/test_jit_runner.py:build_binop_batch``).  ``corrupt_lane`` makes
that lane's pushed result wrong by one, so exactly that lane must fail.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from .evm.execution_state import ExecutionState
from .evm.opcode import Opcode, constant_gas_cost
from .evm.step import StepState
from .tables.container import Tables
from .witness.typing import Block, Bytecode, RWDictionary

WORD = 1 << 256


def random_word_pairs(n_steps: int, seed: int = 0) -> List[Tuple[int, int]]:
    """The (a, b) operand words of each step, in the JAX builder's draw
    order: a then b, 32 little-endian bytes each."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        a = int.from_bytes(rng.bytes(32), "little")
        b = int.from_bytes(rng.bytes(32), "little")
        out.append((a, b))
    return out


def build_binop_workload(state: ExecutionState, op_name: str, result_of: Callable[[int, int], int],
                         n_steps: int, seed: int = 0, corrupt_lane: Optional[int] = None):
    """(tables, steps, next_steps) for n_steps of one 2-pop/1-push opcode
    sharing one bytecode, with per-lane rw rows."""
    bytecode = getattr(Bytecode(), op_name.lower())(1, 2).stop()
    h = bytecode.hash()
    gas = constant_gas_cost(Opcode[op_name])
    rw = RWDictionary(9)
    steps, nexts = [], []
    rwc = 9
    for i, (a, b) in enumerate(random_word_pairs(n_steps, seed)):
        c = result_of(a, b)
        if i == corrupt_lane:
            c = (c + 1) % WORD
        rw.stack_read(1, 1022, a).stack_read(1, 1023, b).stack_write(1, 1023, c)
        steps.append(StepState(state, rwc, call_id=1, is_root=True, code_hash=h,
                               program_counter=66, stack_pointer=1022, gas_left=gas))
        nexts.append(StepState(ExecutionState.STOP, rwc + 3, call_id=1, is_root=True,
                               code_hash=h, program_counter=67, stack_pointer=1023,
                               gas_left=0))
        rwc += 3
    tables = Tables(
        block_table=Block().table_assignments(),
        bytecode_table=bytecode.table_assignments(),
        rw_table=rw.rws,
    )
    return tables, steps, nexts


def build_add_workload(n_steps: int, seed: int = 0, corrupt_lane: Optional[int] = None):
    """The ADD group: c = (a + b) mod 2^256."""
    return build_binop_workload(ExecutionState.ADD, "ADD", lambda a, b: (a + b) % WORD,
                                n_steps, seed, corrupt_lane)


def build_mul_workload(n_steps: int, seed: int = 0, corrupt_lane: Optional[int] = None):
    """The MUL group: c = (a * b) mod 2^256."""
    return build_binop_workload(ExecutionState.MUL, "MUL", lambda a, b: (a * b) % WORD,
                                n_steps, seed, corrupt_lane)
