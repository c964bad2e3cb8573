"""Seeded witnesses for the port's paths: EVM step groups, the state
circuit's two row mixes, the bytecode circuit's ALU-mix bytecodes, the
keccak circuit's two tables (the ALU block's bytecodes, and the many short
preimages of a SHA3-heavy block) and the withdrawal circuit's mainnet
payload; and two blocks traced by the port's tracer for the block
verifier, the ALU block (``build_alu_block``) and the arithmetic block
(``build_arith_block``).

``build_alu_group`` builds the groups of the last eight ALU gadgets
(``ALU_GROUPS``: LT, SLT, ISZERO, NOT, AND, BYTE, SIGNEXTEND, SAR) on the
same seeded words.  ``build_add_workload`` is the flagship group of the JAX package's entry
point (``__graft_entry__._build_add_workload``): ADD steps over random
256-bit words from ``numpy.random.RandomState(seed)``, drawn in the same
order, so both packages see the same words.  ``build_mul_workload`` is the
MUL group built on the same pattern (the JAX package's
``tests/test_jit_runner.py:build_binop_batch``).  ``corrupt_lane`` makes
that lane's pushed result wrong by one, so exactly that lane must fail.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .evm.execution_state import ExecutionState
from .evm.opcode import Opcode, constant_gas_cost
from .evm.step import StepState
from .tables.container import Tables
from .tables.schemas import RW, AccountFieldTag, BytecodeFieldTag
from .witness.tracer import _ALU_BINARY, signextend, trace_block
from .witness.typing import Block, Bytecode, RWDictionary, Transaction, Withdrawal

WORD = 1 << 256

# the sizes the paths are run at on the card: bench.py's default
# BENCH_STEPS lanes for the step groups, and the round-5 ALU-heavy block
# (bench.py:_alu_heavy_txs(8, 11000)): about 528k rw rows -> 2^19 state
# rows; 528017 unrolled bytecode rows -> k = 20 (bytecode_k)
GROUP_LANES = 131072
ALU_BLOCK_TXS, ALU_BLOCK_OPS = 8, 11000
ALU_BLOCK_STATE_ROWS = 1 << 19
# the keccak table of a SHA3-heavy block: a 30M-gas block of 64-byte
# mapping-slot hashes (42 gas each plus a few stack operations) hashes
# hundreds of thousands of preimages; 65536 sits inside that
SHA3_MIX_PREIMAGES = 65536
# mainnet's MAX_WITHDRAWALS_PER_PAYLOAD (EIP-4895)
MAX_WITHDRAWALS_PER_PAYLOAD = 16


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


def build_op_workload(state: ExecutionState, op_name: str, result_of: Callable[..., int],
                      operands: List[Tuple[int, ...]], corrupt_lane: Optional[int] = None,
                      corrupt: str = "result"):
    """(tables, steps, next_steps) for one opcode that pops the operands of
    each lane (one or two words) and pushes ``result_of(*operands)``, the
    lanes sharing one bytecode, each with its own rw rows.
    ``corrupt_lane``'s pushed result is wrong by one (``corrupt="result"``)
    or its step's gas_left one too high (``"gas_left"``)."""
    n_pops = len(operands[0])
    bytecode = getattr(Bytecode(), op_name.lower())(*range(1, n_pops + 1)).stop()
    h = bytecode.hash()
    gas = constant_gas_cost(Opcode[op_name])
    sp0, pc = 1024 - n_pops, 33 * n_pops
    rw = RWDictionary(9)
    steps, nexts = [], []
    rwc = 9
    for i, pops in enumerate(operands):
        c = result_of(*pops)
        if i == corrupt_lane and corrupt == "result":
            c = (c + 1) % WORD
        for k, v in enumerate(pops):
            rw.stack_read(1, sp0 + k, v)
        rw.stack_write(1, 1023, c)
        steps.append(StepState(state, rwc, call_id=1, is_root=True, code_hash=h,
                               program_counter=pc, stack_pointer=sp0,
                               gas_left=gas + (i == corrupt_lane and corrupt == "gas_left")))
        nexts.append(StepState(ExecutionState.STOP, rwc + n_pops + 1, call_id=1, is_root=True,
                               code_hash=h, program_counter=pc + 1, stack_pointer=1023,
                               gas_left=0))
        rwc += n_pops + 1
    tables = Tables(
        block_table=Block().table_assignments(),
        bytecode_table=bytecode.table_assignments(),
        rw_table=rw.rws,
    )
    return tables, steps, nexts


# the last eight ALU gadgets' groups, one representative opcode each:
# (execution state, opcode, operands of a lane from its seeded word pair,
# result, as the tracer computes it, and what ``corrupt_lane`` makes wrong:
# the pushed result, or for SIGNEXTEND, whose gadget leaves the result bytes
# unconstrained (as the JAX package's does, so a wrong result passes in
# both), the step's gas_left).  An index or shift is cut to a small range
# from its word, so that both sides of the gadget's selectors occur (a BYTE
# index past 31, a SIGNEXTEND index of 31 or more, a SAR shift of 256 or
# more); ISZERO's operand is zero on every fourth lane.
ALU_GROUPS = {
    "LT": (ExecutionState.CMP, "LT", lambda i, a, b: (a, b), _ALU_BINARY[Opcode.LT], "result"),
    "SLT": (ExecutionState.SCMP, "SLT", lambda i, a, b: (a, b), _ALU_BINARY[Opcode.SLT],
            "result"),
    "ISZERO": (ExecutionState.ISZERO, "ISZERO", lambda i, a, b: (0 if i % 4 == 0 else a,),
               lambda a: int(a == 0), "result"),
    "NOT": (ExecutionState.NOT, "NOT", lambda i, a, b: (a,), lambda a: a ^ (WORD - 1), "result"),
    "AND": (ExecutionState.BITWISE, "AND", lambda i, a, b: (a, b), _ALU_BINARY[Opcode.AND],
            "result"),
    "BYTE": (ExecutionState.BYTE, "BYTE", lambda i, a, b: (a % 40, b), _ALU_BINARY[Opcode.BYTE],
             "result"),
    "SIGNEXTEND": (ExecutionState.SIGNEXTEND, "SIGNEXTEND", lambda i, a, b: (a % 34, b),
                   signextend, "gas_left"),
    "SAR": (ExecutionState.SAR, "SAR", lambda i, a, b: (a % 288, b), _ALU_BINARY[Opcode.SAR],
            "result"),
}


def build_alu_group(name: str, n_steps: int, seed: int = 0, corrupt_lane: Optional[int] = None):
    """(tables, steps, next_steps) of ``ALU_GROUPS[name]`` on n_steps lanes of
    seeded words (``random_word_pairs``).  ``corrupt_lane``'s pushed result
    is wrong by one, or its gas_left one too high, as the group's entry
    says."""
    state, op_name, operands_of, result_of, corrupt = ALU_GROUPS[name]
    operands = [operands_of(i, a, b) for i, (a, b) in enumerate(random_word_pairs(n_steps, seed))]
    return build_op_workload(state, op_name, result_of, operands, corrupt_lane, corrupt)


def build_add_workload(n_steps: int, seed: int = 0, corrupt_lane: Optional[int] = None):
    """The ADD group: c = (a + b) mod 2^256."""
    return build_op_workload(ExecutionState.ADD, "ADD", lambda a, b: (a + b) % WORD,
                             random_word_pairs(n_steps, seed), corrupt_lane)


def build_mul_workload(n_steps: int, seed: int = 0, corrupt_lane: Optional[int] = None):
    """The MUL group: c = (a * b) mod 2^256."""
    return build_op_workload(ExecutionState.MUL, "MUL", lambda a, b: (a * b) % WORD,
                             random_word_pairs(n_steps, seed), corrupt_lane)


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


def draw_randomness(rng: np.random.RandomState) -> int:
    """The keccak randomness of a seeded witness: the next 32 bytes of
    ``rng``, little-endian, mod p (the first draw of every builder)."""
    from .ops.fr import P

    return int.from_bytes(rng.bytes(32), "little") % P


def build_alu_bytecodes(n_txs: int, ops_per_tx: int, k: Optional[int] = None, seed: int = 0,
                        corrupt_row: Optional[int] = None):
    """(rows, keccak_rows, r) of the bytecode circuit over the ALU-mix
    bytecodes at 2^k rows (k by ``bytecode_k`` when None), with a keccak
    randomness r drawn from ``numpy.random.RandomState(seed)``.  When the
    codes fill fewer rows, they are cut at 2^k rows, as
    ``assign_bytecode_circuit`` cuts them.  ``corrupt_row`` gets its byte
    value changed by one (mod 256), as the JAX package's bad-byte vector."""
    from .circuits.bytecode import assign_bytecode_circuit, assign_keccak_table, unroll

    codes = alu_bytecodes(n_txs, ops_per_tx, seed)
    k = bytecode_k(codes) if k is None else k
    r = draw_randomness(np.random.RandomState(seed))
    unrolled = {c: unroll(c) for c in set(codes)}
    rows = assign_bytecode_circuit(k, [unrolled[c] for c in codes], r)
    keccak_rows = assign_keccak_table(codes, r)
    if corrupt_row is not None:
        assert rows[corrupt_row]["tag"] == int(BytecodeFieldTag.Byte), "corrupt_row must be a Byte row"
        rows[corrupt_row]["value"] = (rows[corrupt_row]["value"] + 1) % 256
    return rows, keccak_rows, r


# -- the ALU block -----------------------------------------------------------------

def alu_block_txs(n_txs: int, ops_per_tx: int) -> List[Tuple[Transaction, Bytecode]]:
    """``bench.py:_alu_heavy_txs`` (:474-490): per tx, ``ops_per_tx`` rounds
    of PUSH1 j, PUSH1 j+1, ADD, POP, then STOP, with 21000 + 11 gas a round
    + 1000.  bench.py traces them signed, which gives every tx the address
    of its own key as caller; traced unsigned, each tx here has its own
    caller address (0xFE + 0x100 i) instead, so that every tx's nonce 0 is
    valid (with one shared caller, txs 2.. fail BeginTx's nonce check)."""
    txs = []
    for i in range(n_txs):
        bc = Bytecode()
        for j in range(ops_per_tx):
            bc.push1(j & 0xFF).push1((j + 1) & 0xFF).add().pop()
        bc.stop()
        txs.append((Transaction(id=i + 1, gas=21000 + 11 * ops_per_tx + 1000,
                                gas_price=int(2e9), caller_address=0xFE + 0x100 * i,
                                callee_address=0xFF + i), bc))
    return txs


def build_alu_block(n_txs: int = ALU_BLOCK_TXS, ops_per_tx: int = ALU_BLOCK_OPS,
                    call_data: Sequence[bytes] = ()):
    """The ALU block's witness, as bench.py's ``_run_block_once`` traces it
    (``Block(base_fee=10**9, gas_limit=30 * 10**6)``), unsigned: the port
    does not have the tx and sig circuits a signed block feeds.
    ``call_data`` gives the first txs calldata, for the pi circuit's
    calldata region (bench.py's txs have none; a tx's 1000 spare gas covers
    up to 62 nonzero bytes)."""
    txs = alu_block_txs(n_txs, ops_per_tx)
    for (tx, _), data in zip(txs, call_data):
        tx.call_data = data
    return trace_block(Block(base_fee=10**9, gas_limit=30 * 10**6), txs, sign=False)


# -- the arithmetic block --------------------------------------------------------------
#
# A ~1 M-gas block (bench.py:bench_super_jit_1m's unit) of fixed-point and
# DeFi math: each tx calls its own contract, whose code is as many cycles as
# fit under EIP-170's 24576-byte code limit, then STOP.  One cycle runs each
# opcode of the 512-bit word product once on fresh operands and pops the
# result: MUL, DIV, MOD, SDIV, SMOD (two PUSH32), ADDMOD, MULMOD (three
# PUSH32), EXP (PUSH32 base, PUSH1 exponent in [2, 255]), SHL, SHR (PUSH32
# value, PUSH1 shift): 653 code bytes, 42 steps and 183 gas a cycle (the
# opcode table charges EXP only its 50 gas a byte of exponent, not the
# EVM's 10 on top; ROADMAP.md §C).

ARITH_BLOCK_TXS, ARITH_BLOCK_CYCLES = 40, 37
ARITH_CYCLE_GAS = 183
ARITH_EDGE_WORDS = (0, 1, 1 << 255, WORD - 1)


def _arith_operand(rng: np.random.RandomState) -> int:
    """A full 256-bit word; one in eight an edge value (0, which makes a
    zero divisor or modulus, 1, 2^255 or 2^256 - 1)."""
    if rng.randint(8) == 0:
        return ARITH_EDGE_WORDS[rng.randint(len(ARITH_EDGE_WORDS))]
    return int.from_bytes(rng.bytes(32), "little")


def arith_block_txs(n_txs: int, cycles: int, seed: int = 0) -> List[Tuple[Transaction, Bytecode]]:
    """The arithmetic block's txs, operands from ``numpy.random.RandomState
    (seed)``; a caller per tx (0xFE + 0x100 i, unsigned, as the ALU block)
    and the tx's gas for its cycles plus 1000."""
    rng = np.random.RandomState(seed)
    txs = []
    for i in range(n_txs):
        bc = Bytecode()
        for _ in range(cycles):
            for op in ("mul", "div", "mod", "sdiv", "smod"):
                getattr(bc, op)(_arith_operand(rng), _arith_operand(rng)).pop()
            for op in ("addmod", "mulmod"):
                getattr(bc, op)(*(_arith_operand(rng) for _ in range(3))).pop()
            bc.push1(int(rng.randint(2, 256))).push32(_arith_operand(rng)).exp().pop()
            for op in ("shl", "shr"):
                getattr(bc.push32(_arith_operand(rng)).push1(int(rng.randint(256))), op)().pop()
        bc.stop()
        txs.append((Transaction(id=i + 1, gas=21000 + ARITH_CYCLE_GAS * cycles + 1000,
                                gas_price=int(2e9), caller_address=0xFE + 0x100 * i,
                                callee_address=0xFF + i), bc))
    return txs


def build_arith_block(n_txs: int = ARITH_BLOCK_TXS, cycles: int = ARITH_BLOCK_CYCLES,
                      seed: int = 0):
    """The arithmetic block's witness, traced unsigned by the port's tracer
    under ``Block(base_fee=10**9, gas_limit=30 * 10**6)`` (the ALU block's
    header)."""
    return trace_block(Block(base_fee=10**9, gas_limit=30 * 10**6),
                       arith_block_txs(n_txs, cycles, seed), sign=False)


# (side, elements, m limbs) of every logUp partial sum (K13 call) of the two
# blocks' checks: a query side's m is en (one limb), a table side's the
# multiplicities (four limbs).  chip_smoke.py checks these against the
# blocks it builds; profile_replay.py --logup times K13 at them without
# building the blocks.
LOGUP_SIDES = (
    ("ALU rw query", 528401, 1), ("ALU rw table", 528369, 4),
    ("ALU bytecode query", 6160016, 1), ("ALU bytecode table", 66002, 4),
    ("ALU tx query", 180, 1), ("ALU tx table", 96, 4),
    ("ALU block query", 55, 1), ("ALU block table", 8, 4),
    ("arith rw query", 136713, 1), ("arith rw table", 96561, 4),
    ("arith bytecode query", 1150040, 1), ("arith bytecode table", 966520, 4),
    ("arith exp query", 2960, 1), ("arith exp table", 13365, 4),
    ("arith tx query", 916, 1), ("arith tx table", 480, 4),
    ("arith block query", 279, 1), ("arith block table", 8, 4))


def receipt_gas_used(witness) -> int:
    """Gas used by the block, from its receipt rows (``bench.py:445-451``)."""
    from .tables.schemas import Target, TxReceiptFieldTag

    vals = [r["value"] for r in witness.rw.rws
            if r["key0"] == int(Target.TxReceipt)
            and r["field_tag"] == int(TxReceiptFieldTag.CumulativeGasUsed)]
    return max(vals) if vals else 0


# -- keccak circuit ---------------------------------------------------------------
#
# Each returns (preimages, keccak_rows, r) for circuits.keccak.keccak_kernel.
# r is drawn as build_alu_bytecodes draws it unless given.  ``corrupt_row``
# makes that row's table entry wrong, as the JAX package's vectors do
# (tests/test_keccak_circuit.py:24-37): ``corrupt="output"`` flips the
# digest's low bit, ``corrupt="input_rlc"`` adds one to the RLC; exactly
# that row must fail.

PAD_EDGE_LENGTHS = (0, 135, 136, 271, 272, 300)


def _corrupt_keccak(rows: List[dict], corrupt_row: Optional[int], corrupt: str) -> None:
    if corrupt_row is None:
        return
    if corrupt == "output":
        rows[corrupt_row]["output"] ^= 1
    elif corrupt == "input_rlc":
        rows[corrupt_row]["input_rlc"] += 1
    else:
        raise ValueError(f"unknown keccak corruption {corrupt!r}")


def keccak_table_rows(preimages: List[bytes], r: int) -> List[dict]:
    """The rows ``circuits.bytecode.assign_keccak_table`` gives, with the
    digests hashed in one batch (``ops.keccak.keccak256_batch``)."""
    from .ops.keccak import keccak256_batch
    from .witness.rlc import linear_combine_bytes

    return [{"state_tag": 2,
             "input_rlc": linear_combine_bytes(bytes(reversed(d)), r, range_check=False),
             "input_len": len(d), "output": int.from_bytes(h, "big")}
            for d, h in zip(preimages, keccak256_batch(preimages))]


def build_keccak_alu_block(n_txs: int = ALU_BLOCK_TXS, ops_per_tx: int = ALU_BLOCK_OPS,
                           seed: int = 0, corrupt_row: Optional[int] = None,
                           corrupt: str = "output", r: Optional[int] = None):
    """The keccak table ``CompiledBlockVerifier`` builds for the ALU block:
    its bytecodes (``alu_bytecodes``; 8 of 66001 bytes, 486 rate blocks
    each, at the default size) with ``assign_keccak_table``."""
    from .circuits.bytecode import assign_keccak_table

    codes = alu_bytecodes(n_txs, ops_per_tx, seed)
    r = draw_randomness(np.random.RandomState(seed)) if r is None else r
    rows = assign_keccak_table(codes, r)
    _corrupt_keccak(rows, corrupt_row, corrupt)
    return codes, rows, r


def sha3_mix_lengths(n: int, rng: np.random.RandomState) -> np.ndarray:
    """Preimage lengths of a SHA3-heavy block: half 64 bytes (mapping-slot
    hashes), a quarter 32 bytes, the rest spread over the pad boundaries
    ``PAD_EDGE_LENGTHS``, in an order drawn from ``rng``."""
    n64, n32 = n // 2, n // 4
    lengths = np.concatenate([np.full(n64, 64), np.full(n32, 32),
                              np.resize(np.array(PAD_EDGE_LENGTHS), n - n64 - n32)])
    return rng.permutation(lengths.astype(np.int64))


def build_keccak_sha3_mix(n: int = SHA3_MIX_PREIMAGES, seed: int = 0,
                          corrupt_row: Optional[int] = None, corrupt: str = "output",
                          r: Optional[int] = None):
    """The keccak table of a SHA3-heavy block: ``n`` random preimages with
    ``sha3_mix_lengths``, all from ``numpy.random.RandomState(seed)`` after
    the randomness's 32 bytes."""
    rng = np.random.RandomState(seed)
    drawn = draw_randomness(rng)
    r = drawn if r is None else r
    lengths = sha3_mix_lengths(n, rng)
    data = rng.bytes(int(lengths.sum()))
    ends = np.cumsum(lengths)
    preimages = [data[e - l:e] for e, l in zip(ends.tolist(), lengths.tolist())]
    rows = keccak_table_rows(preimages, r)
    _corrupt_keccak(rows, corrupt_row, corrupt)
    return preimages, rows, r


# -- withdrawal circuit -----------------------------------------------------------

def build_withdrawals(n: int = MAX_WITHDRAWALS_PER_PAYLOAD, n_real: Optional[int] = None,
                      seed: int = 0, corrupt_row: Optional[int] = None,
                      r: Optional[int] = None):
    """(witness, n, r) of the withdrawal circuit at ``n`` rows: ``n_real``
    (default all) seeded withdrawals with consecutive ids, the rest padding,
    chained through ``withdrawals2witness``, and a block table whose
    ``WithdrawalRoot`` is the final chained root.  ``corrupt_row`` (a real
    withdrawal) gets its amount raised by one after the witness is built,
    so its RLP no longer hashes to the row's hash (the JAX package's
    tests/test_withdrawal_circuit.py:46) and exactly that row fails."""
    from .circuits.withdrawal import Witness, withdrawals2witness

    n_real = n if n_real is None else n_real
    assert 0 <= n_real <= n
    rng = np.random.RandomState(seed)
    drawn = draw_randomness(rng)
    r = drawn if r is None else r
    first_id = int(rng.randint(0, 1 << 30))
    wds = [Withdrawal(first_id + i, int(rng.randint(0, 1 << 40)),
                      int.from_bytes(rng.bytes(20), "big"), int(rng.randint(1, 1 << 62)))
           for i in range(n_real)]
    witness = withdrawals2witness(wds, n, r, [])
    block_rows = Block(withdrawal_root=witness.rows[-1].root).table_assignments()
    rows = list(witness.rows)
    if corrupt_row is not None:
        assert 0 <= corrupt_row < n_real, "corrupt_row must be a real withdrawal"
        rows[corrupt_row] = rows[corrupt_row]._replace(amount=rows[corrupt_row].amount + 1)
    return Witness(rows, witness.mpt_rows, witness.keccak_rows, block_rows), n, r
