"""Seeded witnesses for the port's paths: EVM step groups, the state
circuit's two row mixes and the bytecode circuit's ALU-mix bytecodes.

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
from .tables.schemas import RW, AccountFieldTag, BytecodeFieldTag
from .witness.typing import Block, Bytecode, RWDictionary

WORD = 1 << 256

# the sizes the paths are run at on the card: bench.py's default
# BENCH_STEPS lanes for the step groups, and the round-5 ALU-heavy block
# (bench.py:_alu_heavy_txs(8, 11000)): about 528k rw rows -> 2^19 state
# rows; 528017 unrolled bytecode rows -> k = 20 (bytecode_k)
GROUP_LANES = 131072
ALU_BLOCK_TXS, ALU_BLOCK_OPS = 8, 11000
ALU_BLOCK_STATE_ROWS = 1 << 19


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


# -- state circuit --------------------------------------------------------------
#
# The two mixes of bench.py's state modes.  With seed 0 the values are
# bench.py's; a seed offsets them.  Each returns (rows, mpt_rows) for
# circuits.state.pack_state_inputs.

def build_state_memory_stack(n_rows: int, seed: int = 0, corrupt_row: Optional[int] = None):
    """``bench.py:bench_state_circuit`` (:57-66): one Start row, then Memory
    writes to consecutive addresses and Stack writes at pointer 1023.
    ``corrupt_row`` (a Memory row, 1 .. (n_rows - 1) // 2) gets the value
    256, which is not a byte, so exactly that row fails."""
    from .circuits.state import MemoryOp, StackOp, StartOp, assign_state_circuit, mpt_table_from_ops

    n_mem = (n_rows - 1) // 2
    ops = [StartOp(rw_counter=1, rw=RW.Read, lexicographic_ordering_selector=0)]
    rwc = 1
    for i in range(n_mem):
        ops.append(MemoryOp(rw_counter=rwc, rw=RW.Write, call_id=1, mem_addr=i,
                            value=(i + seed) % 256))
        rwc += 1
    for i in range(n_rows - 1 - n_mem):
        ops.append(StackOp(rw_counter=rwc, rw=RW.Write, call_id=1, stack_ptr=1023, value=i + seed))
        rwc += 1
    if corrupt_row is not None:
        assert 1 <= corrupt_row <= n_mem, "corrupt_row must be a Memory row"
        ops[corrupt_row].value = 256
    return assign_state_circuit(ops), mpt_table_from_ops(ops)


def build_state_storage_account(n_rows: int, seed: int = 0, corrupt_row: Optional[int] = None):
    """``bench.py:bench_state_storage`` (:264-276): one Start row, then
    Storage writes (three quarters) and Account balance writes, each key
    distinct, so every row is the last access of its key and does an MPT
    lookup.  ``corrupt_row`` (a Storage row) gets its value changed after
    the MPT table is built, so exactly that row's lookup is unsatisfied."""
    from .circuits.state import AccountOp, StartOp, StorageOp, assign_state_circuit, mpt_table_from_ops

    n_storage = (n_rows - 1) * 3 // 4
    ops = [StartOp(rw_counter=1, rw=RW.Read, lexicographic_ordering_selector=0)]
    rwc = 2
    for i in range(n_storage):
        ops.append(StorageOp(rw_counter=rwc, rw=RW.Write, tx_id=1, addr=0x1000 + i, key=i,
                             value=i + 1 + seed, committed_value=0))
        rwc += 1
    for i in range(n_rows - 1 - n_storage):
        ops.append(AccountOp(rw_counter=rwc, rw=RW.Write, addr=0x2000 + i,
                             field_tag=AccountFieldTag.Balance, value=i + 1 + seed,
                             committed_value=0))
        rwc += 1
    rows = assign_state_circuit(ops)
    mpt_rows = mpt_table_from_ops(ops)
    if corrupt_row is not None:
        assert 1 <= corrupt_row <= n_storage, "corrupt_row must be a Storage row"
        rows[corrupt_row]["value"] += 1
    return rows, mpt_rows


# -- bytecode circuit -----------------------------------------------------------

def alu_bytecodes(n_txs: int, ops_per_tx: int, seed: int = 0) -> List[bytes]:
    """The bytecodes of ``bench.py:_alu_heavy_txs`` (:481-485): per tx,
    ``ops_per_tx`` rounds of PUSH1 j, PUSH1 j+1, ADD, POP, then STOP; a seed
    offsets the pushed bytes."""
    codes = []
    for _ in range(n_txs):
        bc = Bytecode()
        for j in range(ops_per_tx):
            bc.push1((j + seed) & 0xFF).push1((j + 1 + seed) & 0xFF).add().pop()
        codes.append(bytes(bc.stop().code))
    return codes


def bytecode_k(codes: List[bytes], floor: int = 0) -> int:
    """The bytecode circuit's k for these codes, by ``CompiledBlockVerifier``'s
    rule (``runtime/block.py:199-204``): 2^k above the unrolled rows plus the
    trailing Header."""
    n_rows = sum(len(c) + 1 for c in codes) + 1
    return max(floor, n_rows.bit_length())


def build_alu_bytecodes(n_txs: int, ops_per_tx: int, k: Optional[int] = None, seed: int = 0,
                        corrupt_row: Optional[int] = None):
    """(rows, keccak_rows, r) of the bytecode circuit over the ALU-mix
    bytecodes at 2^k rows (k by ``bytecode_k`` when None), with a keccak
    randomness r drawn from ``numpy.random.RandomState(seed)``.  When the
    codes fill fewer rows, they are cut at 2^k rows, as
    ``assign_bytecode_circuit`` cuts them.  ``corrupt_row`` gets its byte
    value changed by one (mod 256), as the JAX package's bad-byte vector."""
    from .circuits.bytecode import assign_bytecode_circuit, assign_keccak_table, unroll
    from .ops.fr import P

    codes = alu_bytecodes(n_txs, ops_per_tx, seed)
    k = bytecode_k(codes) if k is None else k
    r = int.from_bytes(np.random.RandomState(seed).bytes(32), "little") % P
    unrolled = {c: unroll(c) for c in set(codes)}
    rows = assign_bytecode_circuit(k, [unrolled[c] for c in codes], r)
    keccak_rows = assign_keccak_table(codes, r)
    if corrupt_row is not None:
        assert rows[corrupt_row]["tag"] == int(BytecodeFieldTag.Byte), "corrupt_row must be a Byte row"
        rows[corrupt_row]["value"] = (rows[corrupt_row]["value"] + 1) % 256
    return rows, keccak_rows, r
