"""A plain tracer of the benchmark's blocks: each tx a call of its own
contract, whose code uses only PUSH1, PUSH2, ADD, POP, SLOAD, SSTORE, SHA3
and STOP, in a block that opens every tx with BeginTx, closes it with
EndTx and ends with EndBlock.

It works out, from the transactions alone, what a zkEVM witness of the
block holds: every step's state (execution state, rw counter, program
counter, stack pointer, gas left, memory size, reversible write counter),
every row of the rw table in the order the block's circuits read it, and
each tx's gas.  The layout is the zkEVM specification's (the BeginTx,
EndTx and EndBlock gadgets' rw order; a Start row, then the root calls'
context set up at rw counters 1 .. 11 n before the txs run); the costs
are the Shanghai schedule's (EIP-2929 cold and warm access, EIP-2200
SSTORE, EIP-3529 refunds).  A tx sender is the address of the key the
block signs it with, keccak("zkevm-specs-tpu tx key #<id>") mod n."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from .keccak import keccak256, keccak_int
from .secp256k1 import N, address_of_key

WORD = 1 << 256

# rw table targets (the witness's key0)
T_START, T_ACCESS, T_ACCESS_SLOT, T_REFUND, T_ACCOUNT, T_STORAGE, T_CONTEXT, T_STACK, T_MEMORY, \
    T_LOG, T_RECEIPT = range(1, 12)
# call context fields
CC_RWCEOR, CC_TX_ID, CC_DEPTH, CC_CALLER, CC_CALLEE, CC_CD_OFFSET = 1, 3, 4, 5, 6, 7
CC_CD_LENGTH, CC_VALUE, CC_IS_SUCCESS, CC_IS_PERSISTENT, CC_IS_STATIC = 8, 11, 12, 13, 14
CC_IS_ROOT, CC_IS_CREATE = 15, 16
CC_CODE_HASH, CC_LAST_ID, CC_LAST_RD_OFFSET, CC_LAST_RD_LENGTH = 17, 18, 19, 20
# account fields, receipt fields
ACC_NONCE, ACC_BALANCE, ACC_CODE_HASH = 1, 2, 3
RCPT_STATUS, RCPT_CUMULATIVE_GAS, RCPT_LOG_LENGTH = 1, 2, 3
# the state circuit's tags, in its sort order, of the targets it sorts first
STATE_TAG = {T_START: 1, T_MEMORY: 2, T_STACK: 3, T_STORAGE: 4}

OPCODES = {0x00: "STOP", 0x01: "ADD", 0x20: "SHA3", 0x50: "POP", 0x54: "SLOAD", 0x55: "SSTORE",
           0x60: "PUSH1", 0x61: "PUSH2"}
MNEMONIC = {name: op for op, name in OPCODES.items()}
# the execution state of each opcode's step
STATE_OF = {"STOP": "STOP", "ADD": "ADD", "SHA3": "SHA3", "POP": "POP", "SLOAD": "SLOAD",
            "SSTORE": "SSTORE", "PUSH1": "PUSH", "PUSH2": "PUSH"}
CONST_GAS = {"STOP": 0, "ADD": 3, "SHA3": 30, "POP": 2, "SLOAD": 0, "SSTORE": 0, "PUSH1": 3,
             "PUSH2": 3}
TX_GAS, COLD_SLOAD, WARM_READ, SSTORE_SET, SSTORE_RESET = 21000, 2100, 100, 20000, 2900
SHA3_WORD_GAS, MEMORY_GAS, MAX_REFUND_QUOTIENT = 6, 3, 5

ROW_FIELDS = ("rw_counter", "rw", "key0", "id", "address", "field_tag", "storage_key", "value",
              "value_prev", "aux0")
STEP_FIELDS = ("execution_state", "rw_counter", "call_id", "is_root", "is_create", "code_hash",
               "program_counter", "stack_pointer", "gas_left", "memory_word_size",
               "reversible_write_counter", "log_id")


@dataclass
class Tx:
    """One tx of a block spec: a call of ``callee`` running ``code``."""
    id: int
    gas: int
    gas_price: int
    callee: int
    code: bytes


def tx_key(tx_id: int) -> int:
    return int.from_bytes(keccak256(b"zkevm-specs-tpu tx key #%d" % tx_id), "big") % N or 1


def disassemble(code: bytes) -> List[Tuple[int, str, int]]:
    """(pc, mnemonic, immediate) of each instruction; refuses any opcode
    outside the mixes' eight."""
    out, pc = [], 0
    while pc < len(code):
        name = OPCODES.get(code[pc])
        if name is None:
            raise ValueError(f"opcode 0x{code[pc]:02x} at pc {pc} is outside the reference's set")
        n = {"PUSH1": 1, "PUSH2": 2}.get(name, 0)
        out.append((pc, name, int.from_bytes(code[pc + 1:pc + 1 + n], "big")))
        pc += 1 + n
    return out


class Trace:
    """The block's steps (tuples in STEP_FIELDS order) and rw rows (tuples
    in ROW_FIELDS order), each tx's gas used and the block's."""

    def __init__(self):
        self.steps: List[tuple] = []
        self.rws: List[tuple] = []
        self.tx_gas_used: List[int] = []
        self.senders: List[int] = []

    @property
    def gas(self) -> int:
        return sum(self.tx_gas_used)


class _Rw:
    def __init__(self, counter: int):
        self.counter = counter
        self.rows: List[tuple] = []

    def add(self, rw, key0, id=0, address=0, field_tag=0, storage_key=0, value=0, value_prev=0,
            aux0=0):
        self.rows.append((self.counter, rw, key0, id, address, field_tag, storage_key, value,
                          value_prev, aux0))
        self.counter += 1

    def ctx(self, call_id, tag, value, write=0):
        self.add(write, T_CONTEXT, call_id, tag, value=value)

    def account(self, address, tag, value, value_prev, write=1):
        self.add(write, T_ACCOUNT, 0, address, tag, value=value, value_prev=value_prev)


def trace(txs: Sequence[Tx], coinbase: int, base_fee: int, caller_balance: int) -> Trace:
    """The witness of a block of ``txs`` (see the module's docstring)."""
    out = Trace()
    start = 1 + 11 * len(txs)
    rw = _Rw(start)
    balances: Dict[int, int] = {}
    storage: Dict[Tuple[int, int], int] = {}
    code_hashes: Dict[bytes, int] = {}
    cumulative = 0
    call_ids = []
    for n, tx in enumerate(txs):
        caller = address_of_key(tx_key(tx.id))
        out.senders.append(caller)
        balances.setdefault(caller, caller_balance)
        code_hash = code_hashes.setdefault(tx.code, keccak_int(tx.code))
        call_id = rw.counter
        call_ids.append(call_id)
        warm_addr = set(range(1, 10))
        warm_slot, committed = set(), {}
        refund = 0

        begin = rw.counter
        rw.ctx(call_id, CC_TX_ID, tx.id)
        rw.ctx(call_id, CC_RWCEOR, 0)
        rw.ctx(call_id, CC_IS_PERSISTENT, 1)
        rw.ctx(call_id, CC_IS_SUCCESS, 1)
        rw.account(caller, ACC_NONCE, 1, 0)
        for addr in (coinbase, caller, tx.callee):
            rw.add(1, T_ACCESS, tx.id, addr, value=1, value_prev=int(addr in warm_addr))
            warm_addr.add(addr)
        bal = balances[caller]
        balances[caller] = bal - tx.gas * tx.gas_price
        rw.account(caller, ACC_BALANCE, balances[caller], bal)
        callee_bal = balances.get(tx.callee, 0)
        balances[tx.callee] = callee_bal
        rw.account(tx.callee, ACC_BALANCE, callee_bal, callee_bal)
        rw.account(tx.callee, ACC_CODE_HASH, code_hash, code_hash, write=0)
        for tag, value in ((CC_DEPTH, 1), (CC_CALLER, caller), (CC_CALLEE, tx.callee),
                           (CC_CD_OFFSET, 0), (CC_CD_LENGTH, 0), (CC_VALUE, 0), (CC_IS_STATIC, 0),
                           (CC_LAST_ID, 0), (CC_LAST_RD_OFFSET, 0), (CC_LAST_RD_LENGTH, 0),
                           (CC_IS_ROOT, 1), (CC_IS_CREATE, 0), (CC_CODE_HASH, code_hash)):
            rw.ctx(call_id, tag, value)
        out.steps.append(("BeginTx", begin, 0, False, False, 0, 0, 1024, 0, 0, 0, 0))

        gas = tx.gas - TX_GAS
        rev, mws = 2, 0
        stack: List[int] = []
        program = {pc: (name, imm) for pc, name, imm in disassemble(tx.code)}
        pc = 0

        def pop():
            v = stack.pop()
            rw.add(0, T_STACK, call_id, 1023 - len(stack), value=v)
            return v

        def push(v):
            stack.append(v)
            rw.add(1, T_STACK, call_id, 1024 - len(stack), value=v)

        while True:
            name, imm = program.get(pc, ("STOP", 0))
            out.steps.append((STATE_OF[name], rw.counter, call_id, True, False, code_hash, pc,
                              1024 - len(stack), gas, mws, rev, 0))
            gas -= CONST_GAS[name]
            if name == "STOP":
                rw.ctx(call_id, CC_IS_SUCCESS, 1)
                break
            if name in ("PUSH1", "PUSH2"):
                push(imm)
                pc += 2 if name == "PUSH1" else 3
                continue
            if name == "POP":
                pop()
            elif name == "ADD":
                a, b = pop(), pop()
                push((a + b) % WORD)
            elif name == "SLOAD":
                rw.ctx(call_id, CC_TX_ID, tx.id)
                rw.ctx(call_id, CC_RWCEOR, 0)
                rw.ctx(call_id, CC_IS_PERSISTENT, 1)
                rw.ctx(call_id, CC_CALLEE, tx.callee)
                key = pop()
                slot = (tx.callee, key)
                value = storage.get(slot, 0)
                original = committed.setdefault(slot, value)
                rw.add(0, T_STORAGE, tx.id, tx.callee, 0, key, value, value, original)
                push(value)
                warm = slot in warm_slot
                rw.add(1, T_ACCESS_SLOT, tx.id, tx.callee, 0, key, 1, int(warm))
                warm_slot.add(slot)
                rev += 1
                gas -= WARM_READ if warm else COLD_SLOAD
            elif name == "SSTORE":
                rw.ctx(call_id, CC_TX_ID, tx.id)
                rw.ctx(call_id, CC_IS_STATIC, 0)
                rw.ctx(call_id, CC_RWCEOR, 0)
                rw.ctx(call_id, CC_IS_PERSISTENT, 1)
                rw.ctx(call_id, CC_CALLEE, tx.callee)
                key, value = pop(), pop()
                slot = (tx.callee, key)
                prev = storage.get(slot, 0)
                original = committed.setdefault(slot, prev)
                rw.add(1, T_STORAGE, tx.id, tx.callee, 0, key, value, prev, original)
                storage[slot] = value
                warm = slot in warm_slot
                rw.add(1, T_ACCESS_SLOT, tx.id, tx.callee, 0, key, 1, int(warm))
                warm_slot.add(slot)
                refund_prev = refund
                if value != prev:
                    if original == prev:
                        if original != 0 and value == 0:
                            refund += 4800
                    else:
                        if original != 0:
                            refund -= 4800 if prev == 0 else 0
                            refund += 4800 if value == 0 else 0
                        if original == value:
                            refund += (SSTORE_SET if original == 0 else SSTORE_RESET) - WARM_READ
                rw.add(1, T_REFUND, tx.id, value=refund, value_prev=refund_prev)
                rev += 3
                if value == prev or prev != original:
                    cost = WARM_READ
                else:
                    cost = SSTORE_SET if original == 0 else SSTORE_RESET
                gas -= cost if warm else cost + COLD_SLOAD
            elif name == "SHA3":
                offset, length = pop(), pop()
                push(keccak_int(bytes(length)))      # memory is never written: zeros
                for i in range(length):
                    rw.add(0, T_MEMORY, call_id, offset + i, value=0)
                if length:
                    words = (offset + length + 31) // 32
                    new = max(mws, words)
                    gas -= MEMORY_GAS * (new - mws) + new * new // 512 - mws * mws // 512
                    mws = new
                gas -= SHA3_WORD_GAS * ((length + 31) // 32)
            pc += 1

        end = rw.counter
        used = tx.gas - gas
        rw.ctx(call_id, CC_TX_ID, tx.id)
        rw.ctx(call_id, CC_IS_PERSISTENT, 1)
        rw.add(0, T_REFUND, tx.id, value=refund, value_prev=refund)
        effective_refund = min(refund, used // MAX_REFUND_QUOTIENT)
        bal = balances[caller]
        balances[caller] = bal + (gas + effective_refund) * tx.gas_price
        rw.account(caller, ACC_BALANCE, balances[caller], bal)
        cb = balances.get(coinbase, 0)
        balances[coinbase] = cb + (tx.gas_price - base_fee) * used
        rw.account(coinbase, ACC_BALANCE, balances[coinbase], cb)
        rw.add(1, T_RECEIPT, tx.id, field_tag=RCPT_STATUS, value=1)
        rw.add(1, T_RECEIPT, tx.id, field_tag=RCPT_LOG_LENGTH, value=0)
        if tx.id > 1:
            rw.add(0, T_RECEIPT, tx.id - 1, field_tag=RCPT_CUMULATIVE_GAS, value=cumulative)
        cumulative += used
        rw.add(1, T_RECEIPT, tx.id, field_tag=RCPT_CUMULATIVE_GAS, value=cumulative)
        if n + 1 < len(txs):
            rw.ctx(rw.counter + 1, CC_TX_ID, tx.id + 1)
        out.steps.append(("EndTx", end, call_id, False, False, 0, 0, 1024, gas, 0, 0, 0))
        out.tx_gas_used.append(used)

    final = rw.counter
    rw.ctx(call_ids[-1], CC_TX_ID, len(txs))
    rw.add(0, T_RECEIPT, len(txs), field_tag=RCPT_CUMULATIVE_GAS, value=cumulative)
    out.steps.append(("EndBlock", final, call_ids[-1], False, False, 0, 0, 1024, 0, 0, 0, 0))

    prologue = _Rw(1)
    for tx, call_id, caller in zip(txs, call_ids, out.senders):
        for tag, value in ((CC_TX_ID, tx.id), (CC_RWCEOR, 0), (CC_IS_PERSISTENT, 1),
                           (CC_IS_SUCCESS, 1), (CC_DEPTH, 1), (CC_CALLER, caller),
                           (CC_CALLEE, tx.callee), (CC_CD_LENGTH, 0), (CC_VALUE, 0),
                           (CC_IS_ROOT, 1), (CC_CODE_HASH, code_hashes[tx.code])):
            prologue.ctx(call_id, tag, value, write=1)
    assert prologue.counter == start
    out.rws = [(1, 0, T_START, 0, 0, 0, 0, 0, 0, 0)] + prologue.rows + rw.rows
    return out


def state_key(row: tuple) -> tuple:
    """The state circuit's sort key of an rw row of a target it sorts first
    (Start, Memory, Stack, Storage): (tag, id, address, field_tag,
    storage_key, rw_counter)."""
    rwc, _rw, key0, id_, address, field_tag, storage_key = row[:7]
    return STATE_TAG[key0], id_, address, field_tag, storage_key, rwc
