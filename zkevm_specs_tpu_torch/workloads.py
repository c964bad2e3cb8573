"""Seeded witnesses for the port's paths: EVM step groups, the state
circuit's two row mixes, the bytecode circuit's ALU-mix bytecodes, the
keccak circuit's two tables (the ALU block's bytecodes, and the many short
preimages of a SHA3-heavy block) and the withdrawal circuit's mainnet
payload; six blocks traced and signed by the port's tracer for the
block verifier, the ALU block (``build_alu_block``), the arithmetic block
(``build_arith_block``), the SSTORE-heavy block (``build_sstore_block``),
the loop block (``build_flow_block``: the root frame's context, account,
copy and log opcodes, then a for-loop over a calldata word), the call
block (``build_call_block``: routers calling other contracts with the four
call opcodes, a 3-deep call and a reverting callee) and the create block
(``build_create_block``: factories deploying with CREATE2 and calling what
they deployed, the other creates, callees and sub-factories that halt in
error states, and a tx that fails at its root), with the small blocks
that run every root-frame execution state (``build_conformance_block``)
and the four call opcodes besides (``build_conformance_mega_block``) and
tests/test_block_create.py's create-then-call chain
(``build_create_chain_block``); and
the signed transfers of the tx and sig circuits' largest block
(``signed_transfers``).

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
from .witness.typing import Account, Block, Bytecode, RWDictionary, Transaction, Withdrawal

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
    + 1000, every tx from caller 0xFE (signing gives each tx its own key's
    address)."""
    txs = []
    for i in range(n_txs):
        bc = Bytecode()
        for j in range(ops_per_tx):
            bc.push1(j & 0xFF).push1((j + 1) & 0xFF).add().pop()
        bc.stop()
        txs.append((Transaction(id=i + 1, gas=21000 + 11 * ops_per_tx + 1000,
                                gas_price=int(2e9), caller_address=0xFE,
                                callee_address=0xFF + i), bc))
    return txs


BLOCK_HEADER = dict(base_fee=10**9, gas_limit=30 * 10**6)  # bench.py:_run_block_once's


def build_alu_block(n_txs: int = ALU_BLOCK_TXS, ops_per_tx: int = ALU_BLOCK_OPS,
                    call_data: Sequence[bytes] = ()):
    """The ALU block's witness, as bench.py's ``_run_block_once`` traces it:
    ``Block(base_fee=10**9, gas_limit=30 * 10**6)``, signed.  ``call_data``
    gives the first txs calldata, for the pi circuit's calldata region
    (bench.py's txs have none; a tx's 1000 spare gas covers up to 62
    nonzero bytes)."""
    txs = alu_block_txs(n_txs, ops_per_tx)
    for (tx, _), data in zip(txs, call_data):
        tx.call_data = data
    return trace_block(Block(**BLOCK_HEADER), txs)


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
    (seed)``; every tx from caller 0xFE, as the ALU block's, and with the
    gas of its cycles plus 1000."""
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
                                gas_price=int(2e9), caller_address=0xFE,
                                callee_address=0xFF + i), bc))
    return txs


def build_arith_block(n_txs: int = ARITH_BLOCK_TXS, cycles: int = ARITH_BLOCK_CYCLES,
                      seed: int = 0):
    """The arithmetic block's witness, traced and signed by the port's
    tracer under the ALU block's header."""
    return trace_block(Block(**BLOCK_HEADER), arith_block_txs(n_txs, cycles, seed))


# -- the SSTORE-heavy block ------------------------------------------------------------

SSTORE_BLOCK_TXS = 7   # bench.py:bench_super_jit_1m's default BENCH_TXS


def sstore_block_txs(n_txs: int) -> List[Tuple[Transaction, Bytecode]]:
    """``bench.py:_sstore_heavy_txs`` (:454-471): per tx, six rounds of a
    cold SSTORE of j + 1 to slot 64 i + j, a warm SLOAD of it and an
    ADD, then a SHA3 of the first 32 bytes of memory and STOP; 200000 gas,
    caller 0xFE, callee 0xFF + i."""
    txs = []
    for i in range(n_txs):
        bc = Bytecode()
        for j in range(6):
            bc.push1(j + 1).push2(i * 64 + j).sstore()
            bc.push2(i * 64 + j).sload().pop()
            bc.push1(3).push1(5).add().pop()
        bc.push1(32).push1(0).sha3().pop()
        bc.stop()
        txs.append((Transaction(id=i + 1, gas=200000, gas_price=int(2e9),
                                caller_address=0xFE, callee_address=0xFF + i), bc))
    return txs


def build_sstore_block(n_txs: int = SSTORE_BLOCK_TXS):
    """The SSTORE-heavy block's witness, as bench.py's ``_run_block_once``
    traces it (the ALU block's header, signed): about 1 M gas at 7 txs."""
    return trace_block(Block(**BLOCK_HEADER), sstore_block_txs(n_txs))


# -- the loop block -------------------------------------------------------------------
#
# A ~1 M-gas block (bench.py's headline unit) shaped like the code users run:
# a Solidity for-loop over a calldata argument that ends in a log.  Each tx
# calls its own contract (0xFF + i, the same code) with 36 bytes of calldata
# (a 4-byte selector, then one 32-byte word, from numpy.random.RandomState
# (seed)).  The code reads every context value once, queries 0xCAFE's
# account (cold, then warm), copies from its code, the calldata and its own
# code, runs ``iterations`` rounds of ``acc += CALLDATALOAD(4)`` and stores
# the sum in a LOG1.  RETURNDATACOPY is left out: a root frame has no return
# data, so a nonzero size is an error state, and the gadget's copy lookup is
# not masked by the size, so a zero-length copy fails verification in the
# JAX package too.

FLOW_BLOCK_TXS, FLOW_BLOCK_ITERATIONS = 8, 1600
FLOW_ITERATION_STEPS, FLOW_ITERATION_GAS = 17, 61
FLOW_EXT_ACCOUNT = 0xCAFE
FLOW_TOPIC = 0x71
# tests/test_block_conformance.py:96's block: BLOCKHASH reads its history
FLOW_BLOCK_HEADER = dict(base_fee=10**9, number=256,
                         history_hashes=[0x1000 + i for i in range(256)])
_FLOW_CONTEXT_OPS = ("address", "caller", "callvalue", "calldatasize", "codesize", "gasprice",
                     "origin", "selfbalance", "returndatasize", "coinbase", "timestamp",
                     "number", "gaslimit", "prevrandao", "basefee", "chainid", "gas", "pc",
                     "msize")


def flow_accounts():
    """The account the loop block's prologue queries: 0xCAFE with a balance
    and two bytes of code (tests/test_block_conformance.py:104-107)."""
    return {FLOW_EXT_ACCOUNT: Account(address=FLOW_EXT_ACCOUNT, balance=1234,
                                      code=Bytecode().push1(1).stop())}


def flow_code(iterations: int) -> Bytecode:
    """The loop block's contract: the prologue, each push followed by POP;
    then, with the stack holding (acc, i), ``iterations`` rounds of

        top:  JUMPDEST DUP1 PUSH2 n GT ISZERO PUSH2 exit JUMPI
              PUSH1 4 CALLDATALOAD SWAP1 SWAP2 ADD SWAP1 PUSH1 1 ADD PUSH2 top JUMP

    (17 steps and 61 gas a round, the check of the last round 7 more), and
    ``exit: JUMPDEST POP PUSH1 0 MSTORE PUSH1 topic PUSH1 32 PUSH1 0 LOG1
    STOP``."""
    assert 0 <= iterations < 1 << 16
    bc = Bytecode()
    for op in _FLOW_CONTEXT_OPS:
        getattr(bc, op)().pop()
    bc.push1(255).blockhash().pop()
    for op in ("balance", "extcodesize", "extcodehash"):
        getattr(bc.push2(FLOW_EXT_ACCOUNT), op)().pop()
    bc.push1(2).push1(0).push1(128).push2(FLOW_EXT_ACCOUNT).extcodecopy()
    bc.push1(8).push1(4).push1(64).calldatacopy()
    bc.push1(16).push1(0).push1(96).codecopy()
    bc.push1(0).push1(0)                              # acc, i
    top = len(bc.code)
    exit_pc = top + 25                                # the loop's 25 bytes
    bc.jumpdest().dup1().push2(iterations).gt().iszero().push2(exit_pc).jumpi()
    bc.push1(4).calldataload().swap1().swap2().add().swap1().push1(1).add()
    bc.push2(top).jump()
    assert len(bc.code) == exit_pc
    bc.jumpdest().pop().push1(0).mstore()
    bc.push1(FLOW_TOPIC).push1(32).push1(0).log1().stop()
    return bc


def flow_block_txs(n_txs: int, iterations: int, seed: int = 0
                   ) -> List[Tuple[Transaction, Bytecode]]:
    """The loop block's txs: caller 0xFE (signing gives each tx its own
    key's address), callee 0xFF + i, 36 bytes of seeded calldata, and the
    gas of the loop plus 10000 for the prologue, the log and the calldata."""
    rng = np.random.RandomState(seed)
    code = flow_code(iterations)
    txs = []
    for i in range(n_txs):
        call_data = rng.bytes(4) + rng.bytes(32)
        txs.append((Transaction(id=i + 1,
                                gas=21000 + FLOW_ITERATION_GAS * iterations + 10000,
                                gas_price=int(2e9), caller_address=0xFE, callee_address=0xFF + i,
                                call_data=call_data),
                    Bytecode(bytearray(code.code))))
    return txs


def build_flow_block(n_txs: int = FLOW_BLOCK_TXS, iterations: int = FLOW_BLOCK_ITERATIONS,
                     seed: int = 0):
    """The loop block's witness, signed: about 123 k gas a tx at 1600
    rounds, so about 1 M gas at 8 txs."""
    return trace_block(Block(**FLOW_BLOCK_HEADER), flow_block_txs(n_txs, iterations, seed),
                       accounts=flow_accounts())


def conformance_code() -> Bytecode:
    """tests/test_block_conformance.py:wide_program and its STOP: the ALU,
    comparison, shift, memory, storage, context, copy, log and flow
    families in one root frame."""
    return _wide_program().stop()


def _wide_program() -> Bytecode:
    """tests/test_block_conformance.py:wide_program."""
    bc = Bytecode()
    bc.push1(3).push1(5).add().pop()
    bc.push1(7).push1(3).sub().pop()
    bc.push1(6).push1(7).mul().pop()
    bc.push1(3).push1(40).div().pop()
    bc.push1(7).push1(40).mod().pop()
    bc.push2(0x0100).push1(2).sdiv().pop()
    bc.push1(7).push1(45).smod().pop()
    bc.push1(5).push1(9).push1(13).addmod().pop()
    bc.push1(5).push1(9).push1(13).mulmod().pop()
    bc.push1(3).push1(2).exp().pop()
    bc.push1(0xFF).push1(0).signextend().pop()
    bc.push1(1).push1(2).lt().pop()
    bc.push1(1).push1(2).gt().pop()
    bc.push1(5).push1(5).eq().pop()
    bc.push1(5).push1(3).slt().pop()
    bc.push1(5).push1(3).sgt().pop()
    bc.push1(0).iszero().pop()
    bc.push1(0b1100).push1(0b1010).and_().pop()
    bc.push1(0b1100).push1(0b1010).or_().pop()
    bc.push1(0b1100).push1(0b1010).xor_().pop()
    bc.push1(5).not_().pop()
    bc.push1(0xAB).push1(31).byte().pop()
    bc.push1(0xF0).push1(4).shl().pop()
    bc.push1(0xF0).push1(4).shr().pop()
    bc.push1(0xF0).push1(2).sar().pop()
    bc.push1(11).push1(22).dup2().swap1().pop().pop().pop()
    bc.push1(0x42).push1(0).mstore()
    bc.push1(0).mload().pop()
    bc.push1(0x99).push1(33).mstore8()
    bc.msize().pop()
    bc.push1(0x11).push1(0x01).sstore()
    bc.push1(0x22).push1(0x01).sstore()
    bc.push1(0x01).sload().pop()
    for op in ("address", "caller", "callvalue", "calldatasize"):
        getattr(bc, op)().pop()
    bc.push1(1).calldataload().pop()
    for op in ("codesize", "gasprice", "origin", "selfbalance", "returndatasize", "coinbase",
               "timestamp", "number", "gaslimit", "prevrandao", "basefee", "chainid", "gas",
               "pc"):
        getattr(bc, op)().pop()
    bc.push1(100).blockhash().pop()
    bc.push2(0xCAFE).balance().pop()
    bc.push2(0xCAFE).extcodesize().pop()
    bc.push2(0xCAFE).extcodehash().pop()
    bc.push1(2).push1(0).push1(128).push2(0xCAFE).extcodecopy()
    bc.push2(0xBEEF).balance().pop()      # an account that does not exist
    bc.push1(8).push1(2).push1(64).calldatacopy()
    bc.push1(16).push1(0).push1(96).codecopy()
    bc.push1(8).push1(64).sha3().pop()
    bc.push1(4).push1(0).log0()
    bc.push1(0x71).push1(4).push1(0).log1()
    bc.push1(0x72).push1(0x71).push1(4).push1(0).log2()
    bc.jumpdest()
    return bc


def build_conformance_block():
    """tests/test_block_conformance.py:test_block_conformance_wide's block
    (:93-108): one tx of value 10 with 32 calldata bytes running
    ``conformance_code``, signed."""
    tx = Transaction(id=1, gas=1000000, gas_price=int(2e9), caller_address=0xFE,
                     callee_address=0xFF, value=10, call_data=bytes(range(1, 33)))
    return trace_block(Block(**FLOW_BLOCK_HEADER), [(tx, conformance_code())],
                       accounts=flow_accounts())


def build_conformance_mega_block():
    """tests/test_block_conformance.py:test_block_conformance_mega's block
    (:183-218): the wide program, then CALL with value, STATICCALL,
    DELEGATECALL and CALLCODE into a callee that returns 32 bytes, a
    RETURNDATACOPY, a JUMP over a STOP and a JUMPI not taken; one tx of
    value 10 with 32 calldata bytes, signed."""
    bc = _wide_program()
    callee = Bytecode().push1(0x42).push1(0).mstore().push1(32).push1(0).return_()
    bc.push1(32).push1(0).push1(0).push1(0).push1(5).push2(0x5000).push2(0xFFFF).call().pop()
    bc.push1(8).push1(0).push2(0x0100).returndatacopy()
    bc.push1(32).push1(0).push1(0).push1(0).push2(0x5000).push2(0xFFFF).staticcall().pop()
    bc.push1(32).push1(0).push1(0).push1(0).push2(0x5000).push2(0xFFFF).delegatecall().pop()
    bc.push1(32).push1(0).push1(0).push1(0).push1(0).push2(0x5000).push2(0xFFFF).callcode().pop()
    target = len(bc.code) + 5
    bc.push2(target).jump()
    bc.stop()
    bc.jumpdest()
    bc.push1(0).push2(target + 9).jumpi()
    bc.stop()
    tx = Transaction(id=1, gas=2000000, gas_price=int(2e9), caller_address=0xFE,
                     callee_address=0xFF, value=10, call_data=bytes(range(1, 33)))
    accounts = {**flow_accounts(), 0x5000: Account(address=0x5000, balance=0, code=callee)}
    return trace_block(Block(**FLOW_BLOCK_HEADER), [(tx, bc)], accounts=accounts)


# -- the call block: a router calling other contracts, about 1 M gas -----------------------

# 316 rounds: 1000488 gas at 8 txs (58755 gas a tx at one round, and 1684
# a round over the block, from the tracer at 1 and 3 rounds)
CALL_BLOCK_TXS, CALL_BLOCK_ROUNDS = 8, 316
# a round's gas with CALL and CALLCODE (DELEGATECALL and STATICCALL push no
# value: 209), and the gas of the rest of a tx (the intrinsic 21000, the
# prologue, the first call's cold access, the three calls after the loop:
# 58545 at most) with room to spare
CALL_ROUND_GAS = 212
CALL_TAIL_GAS = 81000
CALL_LEAF, CALL_MIDDLE, CALL_REVERTING = 0xC0DE, 0xB0B, 0xDEAD
CALL_OPS = ("call", "staticcall", "delegatecall", "callcode")
CALL_ROUTER_BALANCE = 10**18


def _call(bc: Bytecode, op: str, target: int, value: int = 0, args=(0, 32),
          ret=(0, 0)) -> Bytecode:
    """``op(gas 0xFFFF, target, value, args, ret)``, its stack pushed in the
    order the opcode pops it (no value for DELEGATECALL and STATICCALL)."""
    bc.push1(ret[1]).push1(ret[0]).push1(args[1]).push1(args[0])
    if op in ("call", "callcode"):
        bc.push1(value)
    return getattr(bc.push2(target).push2(0xFFFF), op)()


def call_accounts(n_txs: int):
    """The callees and the routers' balances: 0xC0DE reads its calldata (the
    caller's memory) and returns it + 1 as 32 bytes; 0xB0B copies its
    calldata, calls 0xC0DE with it and returns what it got back; 0xDEAD
    writes 1 to the slot its caller's address names and reverts with 32
    bytes.  Router 0xFF + i holds a balance, so that a CALL with value
    succeeds.  (0xDEAD keys its slot by its caller: the JAX verifier's mock
    MPT keeps one update a slot, so a slot written in two txs fails its
    state circuit; ROADMAP.md §C.)"""
    leaf = (Bytecode().push1(0).calldataload().push1(1).add().push1(0).mstore()
            .push1(32).push1(0).return_())
    middle = Bytecode().push1(32).push1(0).push1(0).calldatacopy()
    _call(middle, "call", CALL_LEAF).pop()
    middle.push1(32).push1(0).push1(0).returndatacopy().push1(32).push1(0).return_()
    reverting = Bytecode().push1(1).caller().sstore().push1(32).push1(0).revert()
    accounts = {addr: Account(address=addr, code=code)
                for addr, code in ((CALL_LEAF, leaf), (CALL_MIDDLE, middle),
                                   (CALL_REVERTING, reverting))}
    for i in range(n_txs):
        accounts[0xFF + i] = Account(address=0xFF + i, balance=CALL_ROUTER_BALANCE)
    return accounts


def call_code(op: str, rounds: int, reverts: bool) -> Bytecode:
    """A router's contract: ``MSTORE(0, CALLDATALOAD(4))``, then, with the
    stack holding i, ``rounds`` rounds of

        top:  JUMPDEST DUP1 PUSH2 n GT ISZERO PUSH2 exit JUMPI
              op(0xFFFF, 0xC0DE, [0,] mem[0..32), no return region) POP
              RETURNDATASIZE POP RETURNDATACOPY(0, 0, 32)
              PUSH1 1 ADD PUSH2 top JUMP

    (35 steps a round, 34 for DELEGATECALL and STATICCALL), so each round's
    args are the last round's return data; then a CALL with value 1 to
    0xC0DE, a CALL to 0xB0B with a 32-byte return region (three frames
    deep), a CALL to 0xDEAD and a RETURNDATACOPY of its revert data, and a
    RETURN of 32 bytes, or a REVERT of 32 bytes when ``reverts``."""
    assert 0 <= rounds < 1 << 16
    bc = Bytecode().push1(4).calldataload().push1(0).mstore()
    bc.push1(0)                                       # i
    top = len(bc.code)
    bc.jumpdest().dup1().push2(rounds).gt().iszero()
    jumpi_at = len(bc.code)
    bc.push2(0).jumpi()                               # exit, patched below
    _call(bc, op, CALL_LEAF).pop()
    bc.returndatasize().pop().push1(32).push1(0).push1(0).returndatacopy()
    bc.push1(1).add().push2(top).jump()
    exit_pc = len(bc.code)
    bc.code[jumpi_at + 1:jumpi_at + 3] = exit_pc.to_bytes(2, "big")
    bc.jumpdest().pop()
    _call(bc, "call", CALL_LEAF, value=1).pop()
    _call(bc, "call", CALL_MIDDLE, ret=(0, 32)).pop()
    _call(bc, "call", CALL_REVERTING).pop()
    bc.push1(32).push1(0).push1(0).returndatacopy()
    bc.push1(32).push1(0)
    return bc.revert() if reverts else bc.return_()


def call_block_txs(n_txs: int, rounds: int, seed: int = 0
                   ) -> List[Tuple[Transaction, Bytecode]]:
    """The call block's txs: caller 0xFE (signing gives each tx its own
    key's address), router 0xFF + i running ``call_code`` with
    ``CALL_OPS[i % 4]``, 36 bytes of seeded calldata as ``flow_block_txs``
    draws them, and the last tx reverting at its root."""
    rng = np.random.RandomState(seed)
    txs = []
    for i in range(n_txs):
        call_data = rng.bytes(4) + rng.bytes(32)
        code = call_code(CALL_OPS[i % len(CALL_OPS)], rounds, reverts=i == n_txs - 1)
        txs.append((Transaction(id=i + 1, gas=CALL_ROUND_GAS * rounds + CALL_TAIL_GAS,
                                gas_price=int(2e9), caller_address=0xFE, callee_address=0xFF + i,
                                call_data=call_data), code))
    return txs


def build_call_block(n_txs: int = CALL_BLOCK_TXS, rounds: int = CALL_BLOCK_ROUNDS,
                     seed: int = 0):
    """The call block's witness, signed: each tx a router calling 0xC0DE
    ``rounds`` times with CALL, STATICCALL, DELEGATECALL or CALLCODE
    (tx i uses ``CALL_OPS[i % 4]``), then a transfer, a 3-deep call and a
    reverting callee; the last tx reverts at its root."""
    return trace_block(Block(**FLOW_BLOCK_HEADER), call_block_txs(n_txs, rounds, seed),
                       accounts=call_accounts(n_txs))


# -- the create-and-fail block: factories deploying and calling, and failed frames --------

CREATE_BLOCK_TXS, CREATE_BLOCK_ROUNDS = 8, 8
CREATE_FACTORY_BALANCE = 10**18
# a round's gas and the rest of a tx's (the intrinsic 21000, the five
# creates after the loop, the eight error callees and the four
# sub-factories), with room to spare
CREATE_ROUND_GAS = 40000
CREATE_TAIL_GAS = 600000
CREATE_ERROR_GAS = 0x400          # the gas each error callee is given
CREATE_FAILED_EMPTY = 4           # the empty-initcode CREATEs of the failing tx


def self_replicating_initcode() -> Bytecode:
    """The 12-byte initcode that deploys its own bytes, CODECOPY(0, 0, 12)
    then RETURN(0, 12) (tests/test_block_create.py:31-40): the RETURN
    gadget pins the deployed code hash to the frame's, so the JAX package
    (and so the port) deploys only an initcode that returns itself."""
    ic = Bytecode().push1(12).push1(0).push1(0).codecopy().push1(12).push1(0).return_()
    assert len(ic.code) == 12
    return ic


def reverting_initcode() -> Bytecode:
    """An initcode that writes a slot and reverts (tests/test_block_create.py:43)."""
    return Bytecode().push1(0x31).push1(0x0F).sstore().push1(0).push1(0).revert()


def _store_code(bc: Bytecode, code: Bytecode, offset: int = 0) -> int:
    """MSTORE ``code`` into memory, left-aligned at ``offset``; returns its
    length."""
    data = bytes(code.code)
    for i in range(0, len(data), 32):
        bc.push32(int.from_bytes(data[i:i + 32].ljust(32, b"\x00"), "big"))
        bc.push1(offset + i).mstore()
    return len(data)


def _call_with_gas(bc: Bytecode, op: str, target: int, gas: int, ret=(0, 0)) -> Bytecode:
    """``op(gas, target, [value 0,] no args, ret)``."""
    bc.push1(ret[1]).push1(ret[0]).push1(0).push1(0)
    if op == "call":
        bc.push1(0)
    return getattr(bc.push2(target).push3(gas), op)()


# the error callees: (address, code, the call opcode); each halts in one
# error state when called with CREATE_ERROR_GAS
CREATE_ERROR_CALLEES = (
    (0xE000, Bytecode(bytearray([0x0C])), "call"),                        # ErrorInvalidOpcode
    (0xE001, Bytecode().pop(), "call"),                                   # ErrorStack
    (0xE002, Bytecode().push1(0).jump(), "call"),                         # ErrorInvalidJump
    (0xE003, Bytecode().jumpdest().push1(0).jump(), "call"),              # ErrorOutOfGasConstant
    (0xE004, Bytecode().push1(1).push1(0).sstore(), "staticcall"),        # ErrorWriteProtection
    (0xE005, Bytecode().push1(1).push1(0).push1(0).returndatacopy(),      # ErrorReturnData-
     "call"),                                                             # OutOfBound
    (0xE006, Bytecode().push3(0xFFFFF).push1(0).sha3(), "call"),         # ErrorOutOfGasSHA3
    (0xE007, Bytecode().push3(0xFFFFF).mload(), "call"),                  # ErrorOutOfGasStatic-
)                                                                         # MemoryExpansion


def _sub_factory(initcode: Bytecode, halt: bool = True) -> Bytecode:
    """A factory that CREATEs ``initcode`` (tests/test_block_create.py:
    271-330's sub-factories)."""
    bc = Bytecode()
    size = _store_code(bc, initcode)
    bc.push1(size).push1(0).push1(0).create()
    return bc.pop().stop() if halt else bc


# the sub-factories: (address, code, the gas the call gives it); each
# gives its initcode only the gas its create error needs
CREATE_SUB_FACTORIES = (
    # ErrorInvalidCreationCode: the initcode returns 0xEF as its first byte
    (0x5000, _sub_factory(Bytecode().push1(0xEF).push1(0).mstore8().push1(1).push1(0).return_()),
     32200),
    # ErrorMaxCodeSizeExceeded: the initcode returns 30000 bytes
    (0x5001, _sub_factory(Bytecode().push3(30000).push1(0).return_()), 37000),
    # ErrorOutOfGasCodeStore: the initcode cannot pay its 2400-gas deposit
    (0x5002, _sub_factory(self_replicating_initcode()), 34000),
    # ErrorOutOfGasCREATE: the CREATE's constant gas, not its initcode word
    (0x5003, _sub_factory(self_replicating_initcode(), halt=False), 32022),
)


def create_accounts(n_txs: int):
    """The factories (0xFF + i, each holding a balance), the error callees
    and the sub-factories."""
    accounts = {addr: Account(address=addr, code=code)
                for addr, code, _ in CREATE_ERROR_CALLEES + CREATE_SUB_FACTORIES}
    for i in range(n_txs):
        accounts[0xFF + i] = Account(address=0xFF + i, balance=CREATE_FACTORY_BALANCE)
    return accounts


def create_code(rounds: int, fails: bool) -> Bytecode:
    """A factory's contract: the self-replicating initcode MSTOREd at 0;
    ``rounds`` rounds of CREATE2(0, mem[0..12), salt = the round) then a
    CALL of the new address with a 12-byte return region at 32 (a
    deployment that is then used); a CREATE, a CREATE with value 1, a
    CREATE2 that collides with round 0's, a CREATE of the reverting
    initcode (MSTOREd at 64) and a CREATE of no initcode (four when
    ``fails``: the lanes of the failing tx's, whose transfer takes the
    non-persistent branch, then fill a device group); a call to each
    error callee and to each sub-factory; then RETURN(32, 12), or an
    invalid opcode at the root when ``fails``.  The deployer of a CREATE
    is the frame's CallerAddress (the JAX package's quirk), so the root
    frame's creates deploy from the tx's sender."""
    bc = Bytecode()
    size = _store_code(bc, self_replicating_initcode())
    rev_size = _store_code(bc, reverting_initcode(), 64)
    for r in range(rounds):
        bc.push1(r).push1(size).push1(0).push1(0).create2()        # the new address
        bc.push1(12).push1(32).push1(0).push1(0).push1(0)          # ret, args, value
        bc.dup6().push2(0xFFFF).call().pop().pop()
    bc.push1(size).push1(0).push1(0).create().pop()
    bc.push1(size).push1(0).push1(1).create().pop()
    if rounds:
        bc.push1(0).push1(size).push1(0).push1(0).create2().pop()
    bc.push1(rev_size).push1(64).push1(0).create().pop()
    # a failing tx's empty-initcode CREATEs take the non-persistent
    # transfer's branch: it makes four, so that they fill a device group
    for _ in range(CREATE_FAILED_EMPTY if fails else 1):
        bc.push1(0).push1(0).push1(0).create().pop()
    for addr, _, op in CREATE_ERROR_CALLEES:
        _call_with_gas(bc, op, addr, CREATE_ERROR_GAS).pop()
    for addr, _, gas in CREATE_SUB_FACTORIES:
        _call_with_gas(bc, "call", addr, gas).pop()
    if fails:
        bc.code.append(0x0C)
        bc.is_code.append(True)
        return bc
    return bc.push1(12).push1(32).return_()


def create_block_txs(n_txs: int, rounds: int, seed: int = 0
                     ) -> List[Tuple[Transaction, Bytecode]]:
    """The create block's txs: caller 0xFE (signing gives each tx its own
    key's address, so each its own CREATE2 deployer), factory 0xFF + i
    running ``create_code``, 36 bytes of seeded calldata as
    ``flow_block_txs`` draws them, and the last tx failing at its root."""
    rng = np.random.RandomState(seed)
    txs = []
    for i in range(n_txs):
        call_data = rng.bytes(4) + rng.bytes(32)
        txs.append((Transaction(id=i + 1, gas=CREATE_ROUND_GAS * rounds + CREATE_TAIL_GAS,
                                gas_price=int(2e9), caller_address=0xFE, callee_address=0xFF + i,
                                call_data=call_data),
                    create_code(rounds, fails=i == n_txs - 1)))
    return txs


def build_create_block(n_txs: int = CREATE_BLOCK_TXS, rounds: int = CREATE_BLOCK_ROUNDS,
                       seed: int = 0):
    """The create block's witness, signed: each tx a factory deploying with
    CREATE2 and calling what it deployed ``rounds`` times, then the five
    creates, the eight error callees and the four create errors; the last
    tx halts at its root in ErrorInvalidOpcode."""
    return trace_block(Block(**FLOW_BLOCK_HEADER), create_block_txs(n_txs, rounds, seed),
                       accounts=create_accounts(n_txs))


def build_create_chain_block():
    """tests/test_block_create.py:test_block_create_then_call_then_create2_chain's
    block: one tx that CREATEs the self-replicating initcode, CALLs the new
    contract (at the address of the sender's nonce 2, the CREATE's nonce
    after BeginTx's) and CREATE2s it with salt 0xAB."""
    from .ops.keccak import keccak256
    from .witness.rlp import rlp_encode
    from .witness.tracer import tx_sender_address

    bc = Bytecode()
    size = _store_code(bc, self_replicating_initcode())
    bc.push1(size).push1(0).push1(0).create().pop()
    addr = int.from_bytes(keccak256(rlp_encode([tx_sender_address(1).to_bytes(20, "big"),
                                                2]))[-20:], "big")
    bc.push1(0).push1(0).push1(0).push1(0).push1(0).push32(addr).push2(0xFFFF).call().pop()
    bc.push1(0xAB).push1(size).push1(0).push1(0).create2().pop()
    bc.stop()
    tx = Transaction(id=1, gas=2000000, gas_price=int(2e9), caller_address=0xFE,
                     callee_address=0xFF)
    return trace_block(Block(base_fee=int(1e9)), [(tx, bc)])


# -- the proof-verifier and signature-relayer block: the precompiles ---------------------

PRECOMPILE_VERIFIER_TXS, PRECOMPILE_RELAYER_TXS, PRECOMPILE_MESSAGES = 4, 4, 64
PRECOMPILE_VERIFIER = 0xBEEF      # the rollups' shared Groth16 verifier
PRECOMPILE_RELAYER_TOPIC = 0x7E1A  # the relayer's event topic
PRECOMPILE_PREFIX = 36            # the seeded calldata bytes before a proof
PROOF_BYTES = 320                 # in1, in2, A (G1), B (G2), C (G1)
MESSAGE_BYTES = 128               # a relayed message: (hash, v, r, s)
ECRECOVER_OOG_GAS = 2999          # one below ecRecover's 3000
PRECOMPILE_VERIFIER_GAS = 400000
PRECOMPILE_RELAYER_BASE_GAS = 250000
PRECOMPILE_MESSAGE_GAS = 5000

# the verifier's memory: the pairing's 4 pairs at 0x200 (-A, B; alpha, beta;
# vk_x, gamma; C, delta), its output at 0x500; ecMul(IC1, in1) at 0x600 into
# 0x700, ecMul(IC2, in2) at 0x660 into 0x7C0, ecAdd(IC0, _) at 0x6C0 into
# 0x780, ecAdd(_, _) at 0x780 into vk_x's slot at 0x380: every return region
# disjoint from its call's input region
_PAIRING_AT, _PAIRING_OUT = 0x200, 0x500
_MUL1_AT, _MUL2_AT, _ADD1_AT = 0x600, 0x660, 0x6C0
_MUL1_OUT, _ADD1_OUT, _MUL2_OUT = 0x700, 0x780, 0x7C0


def _g1_words(pt) -> List[int]:
    return [pt[0], pt[1]]


def _g2_words(pt) -> List[int]:
    """A G2 point in the EVM's order: x's c1, x's c0, y's c1, y's c0."""
    return [pt[0].c[1], pt[0].c[0], pt[1].c[1], pt[1].c[0]]


def groth16_keys(rng: np.random.RandomState) -> dict:
    """A verifying key's scalars (alpha, beta, gamma, delta, ic0..ic2), each
    a point's discrete log, drawn from ``rng``."""
    from .ops.ecc import bn254

    names = ("alpha", "beta", "gamma", "delta", "ic0", "ic1", "ic2")
    return {k: 1 + int.from_bytes(rng.bytes(32), "big") % (bn254.R - 1) for k in names}


def groth16_proof(keys: dict, rng: np.random.RandomState) -> bytes:
    """A valid proof with 2 public inputs, as calldata (in1, in2, A, B, C):
    every point a multiple of G1 or G2, and c = (a b - alpha beta - x gamma)
    / delta mod R with x = ic0 + in1 ic1 + in2 ic2, so that e(-A, B) e(alpha,
    beta) e(vk_x, gamma) e(C, delta) = 1."""
    from .ops.ecc import bn254

    R = bn254.R
    in1, in2, a, b = (1 + int.from_bytes(rng.bytes(32), "big") % (R - 1) for _ in range(4))
    x = (keys["ic0"] + in1 * keys["ic1"] + in2 * keys["ic2"]) % R
    c = ((a * b - keys["alpha"] * keys["beta"] - x * keys["gamma"])
         * pow(keys["delta"], R - 2, R)) % R
    words = ([in1, in2] + _g1_words(bn254.g1_mul(bn254.G1, a))
             + _g2_words(bn254.g2_mul(bn254.G2, b)) + _g1_words(bn254.g1_mul(bn254.G1, c)))
    return b"".join(w.to_bytes(32, "big") for w in words)


def _mstore_words(bc: Bytecode, at: int, words: List[int]) -> Bytecode:
    for i, w in enumerate(words):
        bc.push32(w).push2(at + 32 * i).mstore()
    return bc


def _staticcall(bc: Bytecode, target: int, args, ret, gas: int = 0xFFFFFF) -> Bytecode:
    """``STATICCALL(gas, target, args, ret)`` and a POP of its success bit."""
    bc.push2(ret[1]).push2(ret[0]).push2(args[1]).push2(args[0])
    return bc.push2(target).push3(gas).staticcall().pop()


def groth16_verifier_code(keys: dict) -> Bytecode:
    """The shared verifier (a Solidity Groth16 verifier's shape): the
    verifying key's points stored from its code, the proof's B and C copied
    and -A computed from its calldata, vk_x = IC0 + in1 IC1 + in2 IC2 by two
    ecMul (0x07) and two ecAdd (0x06), then ecPairing (0x08) on the 4 pairs
    (768 bytes) and a RETURN of its 32-byte result."""
    from .ops.ecc import bn254

    def g1(k):
        return _g1_words(bn254.g1_mul(bn254.G1, k))

    def g2(k):
        return _g2_words(bn254.g2_mul(bn254.G2, k))

    bc = Bytecode()
    _mstore_words(bc, _MUL1_AT, g1(keys["ic1"]))
    _mstore_words(bc, _MUL2_AT, g1(keys["ic2"]))
    _mstore_words(bc, _ADD1_AT, g1(keys["ic0"]))
    # the calldata by CALLDATACOPY (the JAX package's CALLDATALOAD packs
    # its word little-endian, the reference's quirk)
    bc.push1(32).push1(0).push2(_MUL1_AT + 64).calldatacopy()         # in1
    bc.push1(32).push1(32).push2(_MUL2_AT + 64).calldatacopy()        # in2
    # -A = (A.x, P - A.y), then B, alpha, beta, gamma, C, delta
    bc.push1(64).push1(64).push2(_PAIRING_AT).calldatacopy()
    bc.push2(_PAIRING_AT + 32).mload().push32(bn254.P).sub().push2(_PAIRING_AT + 32).mstore()
    bc.push1(128).push1(128).push2(_PAIRING_AT + 64).calldatacopy()   # B
    _mstore_words(bc, _PAIRING_AT + 192, g1(keys["alpha"]) + g2(keys["beta"]))
    _mstore_words(bc, _PAIRING_AT + 448, g2(keys["gamma"]))
    bc.push1(64).push2(256).push2(_PAIRING_AT + 576).calldatacopy()   # C
    _mstore_words(bc, _PAIRING_AT + 640, g2(keys["delta"]))
    _staticcall(bc, 0x07, (_MUL1_AT, 96), (_MUL1_OUT, 64))
    _staticcall(bc, 0x07, (_MUL2_AT, 96), (_MUL2_OUT, 64))
    _staticcall(bc, 0x06, (_ADD1_AT, 128), (_ADD1_OUT, 64))
    _staticcall(bc, 0x06, (_ADD1_OUT, 128), (_PAIRING_AT + 384, 64))     # vk_x
    _staticcall(bc, 0x08, (_PAIRING_AT, 768), (_PAIRING_OUT, 32))
    return bc.push1(32).push2(_PAIRING_OUT).return_()


def rollup_code(slot: int) -> Bytecode:
    """A rollup's contract: its calldata's proof (after the 36-byte prefix)
    copied to memory, a STATICCALL of the verifier with it, and the 32-byte
    result SSTOREd in ``slot``."""
    bc = Bytecode().push2(PROOF_BYTES).push1(PRECOMPILE_PREFIX).push1(0).calldatacopy()
    _staticcall(bc, PRECOMPILE_VERIFIER, (0, PROOF_BYTES), (PROOF_BYTES, 32))
    return bc.push2(PROOF_BYTES).mload().push1(slot).sstore().stop()


def signed_messages(n: int, rng: np.random.RandomState) -> bytes:
    """``n`` messages (hash, v = 27 + the recovery id, r, s), each signed by
    its own key, as 128-byte calldata records; the hashes, keys and nonces
    drawn from ``rng``."""
    from .ops.ecc import secp256k1
    from .ops.keccak import keccak256

    out = bytearray()
    for _ in range(n):
        msg_hash = int.from_bytes(keccak256(rng.bytes(32)), "big")
        key = 1 + int.from_bytes(rng.bytes(32), "big") % (secp256k1.N - 1)
        nonce = 1 + int.from_bytes(rng.bytes(32), "big") % (secp256k1.N - 1)
        v, r, s = secp256k1.sign(msg_hash, key, nonce)
        assert v in (0, 1)
        out += b"".join(w.to_bytes(32, "big") for w in (msg_hash, 27 + v, r, s))
    return bytes(out)


def relayer_code(messages: int) -> Bytecode:
    """A relayer's contract, with the stack holding i, ``messages`` rounds
    of

        top:  JUMPDEST DUP1 PUSH2 n GT ISZERO PUSH2 exit JUMPI
              CALLDATACOPY(0x100, i << 7, 128)
              STATICCALL identity (0x04): mem[0x100..0x180) -> mem[0..128) POP
              STATICCALL ecRecover (0x01): mem[0..128) -> mem[0x180..0x1A0) POP
              LOG1(mem[0x180..0x1A0), topic) PUSH1 1 ADD PUSH2 top JUMP

    then one ecRecover of the last message with v = 29 (invalid: it returns
    nothing) and one given 2999 gas (ErrorOutOfGasPrecompile), and STOP."""
    assert 0 <= messages < 1 << 16
    bc = Bytecode().push1(0)                                         # i
    top = len(bc.code)
    bc.jumpdest().dup1().push2(messages).gt().iszero()
    jumpi_at = len(bc.code)
    bc.push2(0).jumpi()                                              # exit, patched below
    bc.push1(MESSAGE_BYTES).dup2().push1(7).shl().push2(0x100).calldatacopy()
    _staticcall(bc, 0x04, (0x100, MESSAGE_BYTES), (0, MESSAGE_BYTES))
    _staticcall(bc, 0x01, (0, MESSAGE_BYTES), (0x180, 32))
    bc.push2(PRECOMPILE_RELAYER_TOPIC).push1(32).push2(0x180).log1()
    bc.push1(1).add().push2(top).jump()
    exit_pc = len(bc.code)
    bc.code[jumpi_at + 1:jumpi_at + 3] = exit_pc.to_bytes(2, "big")
    bc.jumpdest().pop()
    bc.push1(29).push1(32).mstore()
    _staticcall(bc, 0x01, (0, MESSAGE_BYTES), (0x180, 32))
    _staticcall(bc, 0x01, (0, MESSAGE_BYTES), (0x180, 32), gas=ECRECOVER_OOG_GAS)
    return bc.stop()


def precompile_accounts(keys: dict):
    return {PRECOMPILE_VERIFIER: Account(address=PRECOMPILE_VERIFIER,
                                         code=groth16_verifier_code(keys))}


def precompile_block_txs(n_verifier_txs: int, n_relayer_txs: int, messages: int,
                         seed: int = 0):
    """The precompile block's txs and accounts: caller 0xFE (signing gives
    each tx its own key's address); txs 1..n_verifier_txs to rollup 0xFF + i
    with 36 seeded calldata bytes and a proof, the rest to relayer 0xFF + i
    with ``messages`` signed messages."""
    rng = np.random.RandomState(seed)
    keys = groth16_keys(rng)
    txs = []
    for i in range(n_verifier_txs + n_relayer_txs):
        if i < n_verifier_txs:
            call_data = rng.bytes(PRECOMPILE_PREFIX) + groth16_proof(keys, rng)
            code, gas = rollup_code(i), PRECOMPILE_VERIFIER_GAS
        else:
            call_data = signed_messages(messages, rng)
            code = relayer_code(messages)
            gas = PRECOMPILE_RELAYER_BASE_GAS + PRECOMPILE_MESSAGE_GAS * messages
        txs.append((Transaction(id=i + 1, gas=gas, gas_price=int(2e9), caller_address=0xFE,
                                callee_address=0xFF + i, call_data=call_data), code))
    return txs, precompile_accounts(keys)


def build_precompile_block(n_verifier_txs: int = PRECOMPILE_VERIFIER_TXS,
                           n_relayer_txs: int = PRECOMPILE_RELAYER_TXS,
                           messages: int = PRECOMPILE_MESSAGES, seed: int = 0):
    """The precompile block's witness, signed: rollups checking a Groth16
    proof each through the shared verifier (2 ecMul, 2 ecAdd and a 4-pair
    ecPairing a tx: at 4 txs the ecc circuit's capacity, 8 / 8 / 4), then
    relayers recovering ``messages`` signers each through identity and
    ecRecover, an invalid v and an ecRecover out of gas."""
    txs, accounts = precompile_block_txs(n_verifier_txs, n_relayer_txs, messages, seed)
    return trace_block(Block(**FLOW_BLOCK_HEADER), txs, accounts=accounts)


# the card run's three edits of a precompile block's witness (either
# package's: they go by the witness's names alone).  Each returns the keys
# the edit must fail at, as a function of the port's verifier of the edited
# witness, and the undo of the edit.

def _first_step(w, state: str) -> int:
    return next(i for i, s in enumerate(w.steps) if s.execution_state.name == state)


def edit_ecc_add_out(w):
    """The first ecAdd op's out y + 1 (tests/test_block_jit.py:228-249's
    edit): its ecc row's chip verdict and the BN254_ADD step's ecc lookup
    fail."""
    op = w.ecc_circuit.add_ops[0]
    w.ecc_circuit.add_ops[0] = op._replace(out=(op.out[0], op.out[1] + 1))
    step = _first_step(w, "BN254_ADD")

    def undo():
        w.ecc_circuit.add_ops[0] = op

    return (lambda bv: {step, ("ecc", 0)}), undo


def edit_sig_row_is_valid(w):
    """The first sig row's is_valid flipped (tests/test_block_jit.py:
    222-225's edit): its sig_trace row's ECDSA verdict and the first
    ECRECOVER step's sig lookup fail."""
    row = w.sig_rows[0]
    row.is_valid = not row.is_valid
    step = _first_step(w, "ECRECOVER")

    def undo():
        row.is_valid = not row.is_valid

    return (lambda bv: {step, ("sig_trace", 0)}), undo


def edit_identity_output(w):
    """The first identity call's first output byte + 1 in the rw rows, the
    DATACOPY step's write into the caller's return region
    (tests/test_block_precompiles.py:198-214's edit): the copy row of that
    write and the state row of the next read of the byte fail."""
    from .tables.schemas import Target

    d = _first_step(w, "DATACOPY")
    lo, hi, caller = w.steps[d].rw_counter, w.steps[d + 1].rw_counter, w.steps[d - 1].call_id
    memory = int(Target.Memory)
    row = next(r for r in w.rw.rws if lo <= r["rw_counter"] < hi and r["key0"] == memory
               and r["rw"] == 1 and r["id"] == caller)
    read = min((r["rw_counter"] for r in w.rw.rws
                if r["key0"] == memory and r["rw"] == 0 and r["id"] == caller
                and r["address"] == row["address"] and r["rw_counter"] > row["rw_counter"]))
    copy_row = next(k for k, c in enumerate(w.copy_circuit.rows)
                    if c["q_step"] == 0 and c["rw_counter"] == row["rw_counter"])
    row["value"] += 1

    def keys(bv):
        return {("copy", copy_row), *(("state", k) for k, r in enumerate(bv._state_rows)
                                      if r["rw_counter"] == read)}

    def undo():
        row["value"] -= 1

    return keys, undo


PRECOMPILE_EDITS = {"ecc_add_out": edit_ecc_add_out, "sig_row_is_valid": edit_sig_row_is_valid,
                    "identity_output": edit_identity_output}


# -- signed transfers: the tx and sig circuits' largest block ----------------------------

TX_SIG_CHAIN_ID = 1337                        # bench.py:bench_sig's
TX_SIG_TXS = 30_000_000 // 21_000             # the most transfers a 30 M-gas block holds
TX_SIG_MAX_CALLDATA = 64


def signed_transfers(n: int):
    """``bench.py:bench_sig``'s txs: transfer i signed with key 1000 + i,
    nonce i, gas price 2e9, gas 21000, to 0xFF, value i, no data, chain
    1337 (``circuits.tx.Transaction``s, for ``txs2witness`` and
    ``sig_witness_from_txs``)."""
    from .circuits.tx import Transaction as SignedTx, sign_tx

    return [sign_tx(1000 + i, SignedTx(nonce=i, gas_price=int(2e9), gas=21000, to=0xFF,
                                       value=i, data=b"", sig_v=0, sig_r=0, sig_s=0),
                    TX_SIG_CHAIN_ID)
            for i in range(n)]


# (side, elements, m limbs) of every logUp partial sum (K13 call) of the
# checks of chip_smoke.py's seven blocks: the ALU block at a quarter of its
# rounds (build_alu_block(8, 2750)), the arithmetic block at an eighth of its
# txs (build_arith_block(5, 37)), the SSTORE block, the loop block at half
# its txs and a quarter of its rounds (build_flow_block(4, 400)), the call
# block at a sixteenth of its rounds (build_call_block(8, 19)), the create
# block (build_create_block(8, 8)) and the precompile block
# (build_precompile_block(4, 4, 64)).  A query side's m is en (one
# limb), a table side's the multiplicities (four limbs).  A side of the same
# shape as one an earlier family of its block gave is listed once (the
# SSTORE block's keccak query side is its copy query side's shape, its block
# table its keccak table's).  chip_smoke.py checks these against the blocks
# it builds; profile_replay.py --logup times K13 at them without building
# the blocks.
LOGUP_SIDES = (
    ("ALU rw query", 132401, 1), ("ALU rw table", 132369, 4),
    ("ALU bytecode query", 1540016, 1), ("ALU bytecode table", 16502, 4),
    ("ALU tx query", 180, 1), ("ALU tx table", 96, 4),
    ("ALU block query", 55, 1), ("ALU block table", 8, 4),
    ("arith rw query", 17083, 1), ("arith rw table", 12071, 4),
    ("arith bytecode query", 143755, 1), ("arith bytecode table", 120815, 4),
    ("arith exp query", 370, 1), ("arith exp table", 1682, 4),
    ("arith tx query", 111, 1), ("arith tx table", 60, 4),
    ("arith block query", 34, 1), ("arith block table", 8, 4),
    ("sstore rw query", 1568, 1), ("sstore rw table", 1765, 4),
    ("sstore bytecode query", 7854, 1), ("sstore bytecode table", 770, 4),
    ("sstore copy query", 7, 1), ("sstore copy table", 7, 4),
    ("sstore keccak table", 8, 4),
    ("sstore tx query", 157, 1), ("sstore tx table", 84, 4),
    ("sstore block query", 48, 1),
    ("flow rw query", 60065, 1), ("flow rw table", 60413, 4),
    ("flow bytecode query", 297760, 1), ("flow bytecode table", 128, 4),
    ("flow copy query", 16, 1), ("flow copy table", 16, 4),
    ("flow tx query", 51296, 1), ("flow tx table", 192, 4),
    ("flow block query", 63, 1), ("flow block table", 264, 4),
    ("calls rw query", 43035, 1), ("calls rw table", 46746, 4),
    ("calls bytecode query", 116138, 1), ("calls bytecode table", 669, 4),
    ("calls copy query", 184, 1), ("calls copy table", 184, 4),
    ("calls tx query", 524, 1), ("calls tx table", 384, 4),
    ("calls block query", 63, 1), ("calls block table", 264, 4),
    ("create rw query", 36326, 1), ("create rw table", 33282, 4),
    ("create bytecode query", 115169, 1), ("create bytecode table", 1395, 4),
    ("create copy query", 408, 1), ("create copy table", 408, 4),
    ("create tx query", 268, 1), ("create tx table", 384, 4),
    ("create block query", 63, 1), ("create block table", 264, 4),
    ("precompile rw query", 107977, 1), ("precompile rw table", 469909, 4),
    ("precompile bytecode query", 214968, 1), ("precompile bytecode table", 1219, 4),
    ("precompile copy query", 5712, 1), ("precompile copy table", 2656, 4),
    ("precompile tx query", 180, 1), ("precompile tx table", 34288, 4),
    ("precompile block query", 55, 1), ("precompile block table", 264, 4),
    ("precompile sig query", 260, 1), ("precompile sig table", 256, 4),
    ("precompile ecc query", 20, 1), ("precompile ecc table", 20, 4))


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
