"""Mini EVM tracer, the ALU subset: builds a coherent block witness (steps
and rw rows, and the exp circuit's squaring trace) for blocks of PUSH /
ALU / ADDMOD / MULMOD / EXP / POP / STOP bytecodes.

Counterpart of ``zkevm_specs_tpu/witness/tracer.py`` (``BlockWitness``
:167-201, ``_resolve_anchor`` :207-218, ``_Tracer.run_tx`` :374-548,
``step_op`` :721-749, the handlers :1861-1928 and ``trace_block``
:2629-2754).  Each executed opcode emits exactly the rw rows its gadget
looks up, with the JAX tracer's rw_counter / gas / stack-pointer
bookkeeping, so the witness equals the JAX tracer's row for row.

Not ported, and raising ``NotImplementedError`` where a block reaches
them: the error states (invalid opcode, stack under/overflow, out of gas,
EXP's dynamic out of gas), every opcode without a handler here, and signed
blocks (``sign=True``: the tx and sig circuits).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..evm.execution_state import ExecutionState
from ..evm.opcode import (
    Opcode,
    constant_gas_cost,
    get_push_size,
    is_push_with_data,
    max_stack_pointer,
    min_stack_pointer,
)
from ..evm.step import StepState
from ..tables.schemas import AccountFieldTag, CallContextFieldTag, Target, TxReceiptFieldTag
from ..utils.param import (
    GAS_COST_EXP_PER_BYTE,
    GAS_COST_SLOW,
    GAS_COST_TX,
    MAX_REFUND_QUOTIENT_OF_GAS_USED,
)
from .typing import Account, Block, Bytecode, ExpCircuit, RWDictionary, Transaction

U256M = (1 << 256) - 1
U255 = 1 << 255


class BlockWitness:
    def __init__(self):
        self.steps: List[StepState] = []
        self.rw = RWDictionary(1)
        self.block = Block()
        self.txs: List[Transaction] = []
        self.bytecodes: List[Bytecode] = []
        self.withdrawals: List = []        # EIP-4895 withdrawals (withdrawal circuit)
        self.exp_circuit: Optional[ExpCircuit] = None  # EXP events (None: none)
        # sub-circuit witnesses of the JAX tracer that the ALU subset never
        # fills; the block verifier refuses a witness that carries one
        self.copy_circuit = None
        self.ecc_circuit = None
        self.signed_txs = None
        self.sig_rows: List = []
        self.sha3_preimages: List[bytes] = []
        self.tx_code_hashes: List[int] = []    # per-tx root code hash
        self.subcall_setups: List[List[Tuple[int, object, int]]] = []
        self.memory_setups: List[Tuple[int, int, int]] = []  # (call_id, addr, byte)
        self.tx_success: List[bool] = []   # per-tx root-frame outcome
        self.tx_rwceor: List[int] = []     # per-tx root RwCounterEndOfReversion
        self.chain_id = 0x01

    def tables_kwargs(self) -> dict:
        tx_rows = []
        for tx in self.txs:
            tx_rows += tx.table_assignments()
        bc_rows = []
        for bc in self.bytecodes:
            bc_rows += bc.table_assignments()
        return dict(
            block_table=self.block.table_assignments(),
            tx_table=tx_rows,
            bytecode_table=bc_rows,
            rw_table=self.rw.rws,
        )


_N_SETUP_ROWS = 11  # incl. RwCounterEndOfReversion (non-zero for reverted txs)


def _resolve_anchor(a: dict) -> int:
    """RwCounterEndOfReversion of a frame (reference reversion chaining,
    tests/evm/test_callop.py:202-208): a frame that fails owns its mirror
    section; one reverted by an ancestor sits inside the ancestor's section
    at parent - (caller_rev_at_call + 1); a persistent frame has none."""
    if a["failed"]:
        assert a["own"] is not None, "reversion anchor unresolved"
        return a["own"]
    if a["persistent"] or a["parent"] is None:
        return 0
    p = _resolve_anchor(a["parent"])
    return 0 if p == 0 else p - a["poffset"]


def _signed(v: int) -> int:
    return v - (1 << 256) if v >= U255 else v


def _byte_size(v: int) -> int:
    return (v.bit_length() + 7) // 8


class _Tracer:
    """Single-block interpreter emitting gadget-exact witness rows."""

    def __init__(self, block: Block, start_counter: int,
                 accounts: Optional[Dict[int, Account]] = None,
                 outcomes: Optional[List[bool]] = None):
        self.w = BlockWitness()
        self.w.block = block
        self.w.rw = RWDictionary(start_counter)
        self.w.exp_circuit = ExpCircuit()
        self.rw = self.w.rw
        self.block = block
        self.cumulative_gas = 0
        self.call_ids: List[int] = []
        self._code_hashes: Dict[int, Bytecode] = {}

        # frame-outcome oracle: pass 1 (outcomes=None) executes the block to
        # discover which frames halt in failure; pass 2 replays with the
        # oracle so persistence-dependent witness values are right at
        # emission time
        self.outcomes = outcomes
        self.discovered: List[bool] = []
        self.fseq = 0
        # deferred RwCounterEndOfReversion reads: (row_dict, anchor)
        self.fixups: List[Tuple[dict, dict]] = []
        self.root_anchors: List[dict] = []

        # world state
        self.balances: Dict[int, int] = {}
        self.nonces: Dict[int, int] = {}
        for addr, acct in (accounts or {}).items():
            self.balances[addr] = acct.balance
            self.nonces[addr] = acct.nonce
            if len(acct.code.code):
                self._register_code(acct.code)

    # -- helpers ------------------------------------------------------------

    def _register_code(self, bytecode: Bytecode) -> int:
        h = bytecode.hash()
        if h not in self._code_hashes:
            self._code_hashes[h] = bytecode
            self.w.bytecodes.append(bytecode)
        return h

    # -- frame outcome / reversion machinery --------------------------------

    def _frame_outcome(self) -> Tuple[int, bool]:
        idx = self.fseq
        self.fseq += 1
        if self.outcomes is None:
            self.discovered.append(True)  # optimistic; no ported halt fails
            return idx, True
        return idx, self.outcomes[idx]

    def _mirror_last(self):
        """Record the reversion mirror of the rw row just emitted (value and
        value_prev swapped); it would be placed at the owning frame's
        failing halt, and is dropped when the frame never fails."""
        base = self.rw.rws[-1]
        m = dict(base)
        m["value"], m["value_prev"] = base["value_prev"], base["value"]
        self.pending.append(m)

    def _fix_rwceor(self, anchor: dict):
        """Defer the value of the RwCounterEndOfReversion row just emitted."""
        self.fixups.append((self.rw.rws[-1], anchor))

    # -- per-tx execution ---------------------------------------------------

    def run_tx(self, tx: Transaction, bytecode: Bytecode) -> int:
        rw, block = self.rw, self.block
        tx_id = tx.id
        self.w.txs.append(tx)
        code_hash = self._register_code(bytecode)
        self.w.tx_code_hashes.append(code_hash)
        call_id = rw.rw_counter
        self.call_ids.append(call_id)

        self.tx = tx
        self.call_id = call_id
        self.code_hash = code_hash
        self.code = bytecode
        # precompile addresses are always warm (EIP-2929)
        self.warm_addr = set(range(1, 10))
        self.refund = 0
        self.log_count = 0
        self.rev = 0          # reversible_write_counter
        self.stack: List[int] = []
        self.mws = 0          # memory_word_size
        self.pc = 0
        self.stopped = False
        self.is_root = True
        self.is_create_frame = False

        # root-frame reversion machinery
        idx, success = self._frame_outcome()
        self.frame_idx = idx
        self.pending: List[dict] = []
        self.anchor = {"own": None, "parent": None, "poffset": 0,
                       "persistent": success, "failed": not success}
        self.root_anchors.append(self.anchor)
        self.w.tx_success.append(success)

        # --- BeginTx (gadget rw order, begin_tx.py) ---
        begin_rwc = rw.rw_counter
        rw.call_context_read(call_id, CallContextFieldTag.TxId, tx_id)
        rw.call_context_read(call_id, CallContextFieldTag.RwCounterEndOfReversion, 0)
        self._fix_rwceor(self.anchor)
        rw.call_context_read(call_id, CallContextFieldTag.IsPersistent, int(success))
        rw.call_context_read(call_id, CallContextFieldTag.IsSuccess, int(success))
        # invalid (skipped) txs and empty-code callees take the gadget's
        # direct BeginTx->EndTx branch: no context setup reads, no steps
        is_invalid = bool(tx.invalid_tx)
        skip_execution = is_invalid or len(bytecode.code) == 0
        nonce_prev = self.nonces.get(tx.caller_address, tx.nonce)
        rw.account_write(tx.caller_address, AccountFieldTag.Nonce,
                         nonce_prev + 1 - int(is_invalid), nonce_prev)
        self.nonces[tx.caller_address] = nonce_prev + 1 - int(is_invalid)
        for addr in (block.coinbase, tx.caller_address, tx.callee_address):
            rw.tx_access_list_account_write(tx_id, addr, True, addr in self.warm_addr)
            self.warm_addr.add(addr)
        # the transfer pair is reversible, bound to the root frame; begin_tx
        # masks the amounts to zero for invalid txs (the rows still exist)
        tx_value = 0 if is_invalid else tx.value
        gas_fee = 0 if is_invalid else tx.gas * tx.gas_price
        caller_bal_prev = self.balances.get(tx.caller_address, 0)
        caller_bal = caller_bal_prev - tx_value - gas_fee
        rw.account_write(tx.caller_address, AccountFieldTag.Balance, caller_bal, caller_bal_prev)
        self._mirror_last()
        self.balances[tx.caller_address] = caller_bal
        callee_bal_prev = self.balances.get(tx.callee_address, 0)
        rw.account_write(tx.callee_address, AccountFieldTag.Balance,
                         callee_bal_prev + tx_value, callee_bal_prev)
        self._mirror_last()
        self.balances[tx.callee_address] = callee_bal_prev + tx_value
        rw.account_read(tx.callee_address, AccountFieldTag.CodeHash, code_hash)
        CC = CallContextFieldTag
        for tag, value in () if skip_execution else (
            (CC.Depth, 1),
            (CC.CallerAddress, tx.caller_address),
            (CC.CalleeAddress, tx.callee_address),
            (CC.CallDataOffset, 0),
            (CC.CallDataLength, len(tx.call_data)),
            (CC.Value, tx.value),
            (CC.IsStatic, 0),
            (CC.LastCalleeId, 0),
            (CC.LastCalleeReturnDataOffset, 0),
            (CC.LastCalleeReturnDataLength, 0),
            (CC.IsRoot, 1),
            (CC.IsCreate, 0),
            (CC.CodeHash, code_hash),
        ):
            rw.call_context_read(call_id, tag, value)

        # intrinsic gas includes the EIP-2930 access-list charge
        self.gas_left = (0 if is_invalid else
                         tx.gas - GAS_COST_TX - tx.call_data_gas_cost()
                         - tx.access_list_gas_cost())
        self.w.steps.append(StepState(
            ExecutionState.BeginTx, begin_rwc,
            gas_left=self.gas_left if skip_execution else 0))
        self.rev = 2  # the two transfer balance writes are reversible

        # --- interpret the bytecode ---
        while not skip_execution and not self.stopped:
            self.step_op()

        # --- EndTx (gadget rw order, end_tx.py) ---
        end_rwc = rw.rw_counter
        gas_used = tx.gas - self.gas_left
        effective_refund = min(self.refund, gas_used // MAX_REFUND_QUOTIENT_OF_GAS_USED)
        success = self.w.tx_success[-1]
        rw.call_context_read(call_id, CC.TxId, tx_id)
        rw.call_context_read(call_id, CC.IsPersistent, int(success))
        rw.tx_refund_read(tx_id, self.refund)
        refund_value = (self.gas_left + effective_refund) * tx.gas_price
        bal_prev = self.balances.get(tx.caller_address, 0)
        rw.account_write(tx.caller_address, AccountFieldTag.Balance, bal_prev + refund_value, bal_prev)
        self.balances[tx.caller_address] = bal_prev + refund_value
        effective_tip = tx.gas_price - block.base_fee
        cb_prev = self.balances.get(block.coinbase, 0)
        reward = effective_tip * gas_used
        rw.account_write(block.coinbase, AccountFieldTag.Balance, cb_prev + reward, cb_prev)
        self.balances[block.coinbase] = cb_prev + reward
        # end_tx.py: status == (1 - is_tx_invalid) * is_persistent
        rw.tx_receipt_write(tx_id, TxReceiptFieldTag.PostStateOrStatus,
                            int(success) * (1 - int(is_invalid)))
        rw.tx_receipt_write(tx_id, TxReceiptFieldTag.LogLength, self.log_count)
        if tx_id > 1:
            rw.tx_receipt_read(tx_id - 1, TxReceiptFieldTag.CumulativeGasUsed,
                               self.cumulative_gas)
        self.cumulative_gas += gas_used
        rw.tx_receipt_write(tx_id, TxReceiptFieldTag.CumulativeGasUsed, self.cumulative_gas)
        if self.has_next_tx:
            # EndTx additionally reads the NEXT BeginTx's TxId row
            # (end_tx.py:73-78): one extra rw row bound to the next call id
            next_call_id = rw.rw_counter + 1
            rw.call_context_read(next_call_id, CC.TxId, tx_id + 1)
        self.w.steps.append(
            StepState(ExecutionState.EndTx, end_rwc, call_id=call_id,
                      gas_left=self.gas_left, log_id=self.log_count))
        return call_id

    # -- opcode dispatch ----------------------------------------------------

    def _detect_error(self, raw: int) -> Optional[ExecutionState]:
        """The pre-dispatch error classes an opcode with a ported handler can
        hit, in geth's order: invalid opcode, stack validation, constant
        gas, then EXP's dynamic gas.  (Write protection needs a static frame
        and the other dynamic-gas checks belong to opcodes without a handler
        here.)"""
        E = ExecutionState
        if _OP_BY_RAW[raw] is None:
            return E.ErrorInvalidOpcode
        sp = 1024 - len(self.stack)
        if sp < _MIN_SP[raw] or sp > _MAX_SP[raw]:
            return E.ErrorStack
        if self.gas_left < _CONST_GAS[raw]:
            return E.ErrorOutOfGasConstant
        if (raw == Opcode.EXP and self.gas_left
                < GAS_COST_SLOW + GAS_COST_EXP_PER_BYTE * _byte_size(self.stack[-2])):
            return E.ErrorOutOfGasEXP
        return None

    def step_op(self):
        code = self.code.code
        raw = code[self.pc] if self.pc < len(code) else 0  # STOP
        err = self._detect_error(raw)
        if err is not None:
            raise NotImplementedError(
                f"tracer: error state {err.name} (tx {self.tx.id}, pc {self.pc}) is not ported")
        handler = _HANDLER[raw]
        if handler is None:
            raise NotImplementedError(f"tracer: no handler for {_OP_BY_RAW[raw]!r} is ported")
        sp = 1024 - len(self.stack)
        self.w.steps.append(
            StepState(_STATE[raw], self.rw.rw_counter, call_id=self.call_id,
                      is_root=self.is_root, is_create=self.is_create_frame,
                      code_hash=self.code_hash,
                      program_counter=self.pc, stack_pointer=sp,
                      gas_left=self.gas_left, memory_word_size=self.mws,
                      reversible_write_counter=self.rev,
                      log_id=self.log_count))
        self.gas_left -= _CONST_GAS[raw]
        handler(self, _OP_BY_RAW[raw])

    # stack rw helpers (emit the row AND mutate the model stack)
    def spush(self, v: int):
        self.stack.append(v)
        self.rw.stack_write(self.call_id, 1024 - len(self.stack), v)

    def spop(self) -> int:
        v = self.stack.pop()
        self.rw.stack_read(self.call_id, 1023 - len(self.stack), v)
        return v

    # -- handlers -----------------------------------------------------------

    def op_stop(self, op):
        self.rw.call_context_read(self.call_id, CallContextFieldTag.IsSuccess, 1)
        # every ported frame is a root frame (no CALL / CREATE handler)
        self.stopped = True

    def op_push(self, op):
        n = get_push_size(op)
        v = int.from_bytes(self.code.code[self.pc + 1: self.pc + 1 + n], "big")
        self.spush(v)
        self.pc += 1 + n

    def op_pop(self, op):
        self.spop()
        self.pc += 1

    def op_alu(self, op):
        a = self.spop()
        if op in (Opcode.NOT, Opcode.ISZERO):
            out = (a ^ U256M) if op == Opcode.NOT else int(a == 0)
        else:
            b = self.spop()
            out = _ALU_BINARY[op](a, b)
        self.spush(out)
        self.pc += 1

    def op_mod3(self, op):
        a, b, n = self.spop(), self.spop(), self.spop()
        if n == 0:
            out = 0
        elif op == Opcode.ADDMOD:
            out = (a + b) % n
        else:
            out = (a * b) % n
        self.spush(out)
        self.pc += 1

    def op_exp(self, op):
        base, exponent = self.spop(), self.spop()
        self.spush(pow(base, exponent, 1 << 256))
        if exponent > 1:
            identifier = self.w.steps[-1].rw_counter + 3
            self.w.exp_circuit.add_event(base, exponent, identifier)
        self.gas_left -= GAS_COST_EXP_PER_BYTE * _byte_size(exponent)
        self.pc += 1


_ALU_BINARY = {
    Opcode.ADD: lambda a, b: (a + b) & U256M,
    Opcode.SUB: lambda a, b: (a - b) & U256M,
    Opcode.MUL: lambda a, b: (a * b) & U256M,
    Opcode.DIV: lambda a, b: a // b if b else 0,
    Opcode.MOD: lambda a, b: a % b if b else 0,
    Opcode.SDIV: lambda a, b: (abs(_signed(a)) // abs(_signed(b))
                               * (1 if (_signed(a) < 0) == (_signed(b) < 0) else -1)
                               ) & U256M if b else 0,
    Opcode.SMOD: lambda a, b: ((abs(_signed(a)) % abs(_signed(b)))
                               * (1 if _signed(a) >= 0 else -1)) & U256M if b else 0,
    Opcode.LT: lambda a, b: int(a < b),
    Opcode.GT: lambda a, b: int(a > b),
    Opcode.EQ: lambda a, b: int(a == b),
    Opcode.SLT: lambda a, b: int(_signed(a) < _signed(b)),
    Opcode.SGT: lambda a, b: int(_signed(a) > _signed(b)),
    Opcode.AND: lambda a, b: a & b,
    Opcode.OR: lambda a, b: a | b,
    Opcode.XOR: lambda a, b: a ^ b,
    Opcode.BYTE: lambda a, b: (b >> (8 * (31 - a))) & 0xFF if a < 32 else 0,
    Opcode.SHL: lambda a, b: (b << a) & U256M if a < 256 else 0,
    Opcode.SHR: lambda a, b: b >> a if a < 256 else 0,
    Opcode.SAR: lambda a, b: (_signed(b) >> a) & U256M if a < 256
    else (U256M if _signed(b) < 0 else 0),
}

# execution state of each opcode with a ported handler (the JAX tracer's
# _STATE_BY_OPCODE, :81-161, restricted to them)
_ES = ExecutionState
_STATE_BY_OPCODE = {
    Opcode.STOP: _ES.STOP, Opcode.POP: _ES.POP,
    Opcode.ADD: _ES.ADD, Opcode.SUB: _ES.ADD,
    Opcode.MUL: _ES.MUL, Opcode.DIV: _ES.MUL, Opcode.MOD: _ES.MUL,
    Opcode.SDIV: _ES.SDIV_SMOD, Opcode.SMOD: _ES.SDIV_SMOD,
    Opcode.ADDMOD: _ES.ADDMOD, Opcode.MULMOD: _ES.MULMOD, Opcode.EXP: _ES.EXP,
    Opcode.LT: _ES.CMP, Opcode.GT: _ES.CMP, Opcode.EQ: _ES.CMP,
    Opcode.SLT: _ES.SCMP, Opcode.SGT: _ES.SCMP,
    Opcode.ISZERO: _ES.ISZERO, Opcode.NOT: _ES.NOT,
    Opcode.AND: _ES.BITWISE, Opcode.OR: _ES.BITWISE, Opcode.XOR: _ES.BITWISE,
    Opcode.BYTE: _ES.BYTE, Opcode.SHL: _ES.SHL_SHR, Opcode.SHR: _ES.SHL_SHR,
    Opcode.SAR: _ES.SAR,
}

# -- hot-path dispatch tables: 256-entry arrays indexed by the raw byte ------
_OP_BY_RAW: List[Optional[Opcode]] = [None] * 256
_MIN_SP = [0] * 256
_MAX_SP = [1024] * 256
_CONST_GAS = [0] * 256
_STATE: List[Optional[ExecutionState]] = [None] * 256
_HANDLER: List[Optional[object]] = [None] * 256
for _o in Opcode:
    _raw = int(_o)
    _OP_BY_RAW[_raw] = _o
    _MIN_SP[_raw] = min_stack_pointer(_o)
    _MAX_SP[_raw] = max_stack_pointer(_o)
    _CONST_GAS[_raw] = constant_gas_cost(_o)
    if is_push_with_data(_o) or _o is Opcode.PUSH0:
        _STATE[_raw], _HANDLER[_raw] = _ES.PUSH, _Tracer.op_push
    elif _o in _STATE_BY_OPCODE:
        _STATE[_raw] = _STATE_BY_OPCODE[_o]
        _HANDLER[_raw] = {Opcode.STOP: _Tracer.op_stop, Opcode.POP: _Tracer.op_pop,
                          Opcode.ADDMOD: _Tracer.op_mod3, Opcode.MULMOD: _Tracer.op_mod3,
                          Opcode.EXP: _Tracer.op_exp}.get(_o, _Tracer.op_alu)


def trace_block(
    block: Block,
    txs: List[Tuple[Transaction, Bytecode]],
    caller_balance: int = 10**21,
    withdrawals: Optional[List] = None,
    accounts: Optional[Dict[int, Account]] = None,
    sign: bool = True,
) -> BlockWitness:
    """Execute txs (each a call to a contract with the given bytecode) and
    emit the full witness, as the JAX ``trace_block`` does with
    ``sign=False``: two passes (the frame-outcome oracle, then the replay
    with the prologue budget reserved), EndBlock, the rw table's Start
    padding row and the call-context setup prologue at rw counters
    1..11*n_txs (verified in-circuit by ``circuits/super_circuit.py``).

    ``sign=True`` (the JAX default) raises: the tx and sig circuits that a
    signed block feeds are not ported."""
    if sign:
        raise NotImplementedError(
            "trace_block(sign=True): the tx and sig circuits are not ported; pass sign=False")
    if withdrawals:
        # chain the mock MPT withdrawal roots up front so the block table's
        # WithdrawalRoot matches the withdrawal circuit's final root
        block.withdrawal_root = 7 * sum(1 for wd in withdrawals if wd.amount)

    def run(start: int, outcomes=None) -> _Tracer:
        tracer = _Tracer(block, start, accounts, outcomes)
        for i, (tx, bytecode) in enumerate(txs):
            tracer.balances.setdefault(tx.caller_address, caller_balance)
            tracer.has_next_tx = i + 1 < len(txs)
            tracer.run_tx(tx, bytecode)
        return tracer

    # pass 1 discovers each frame's halt outcome and how many prologue setup
    # rows the state circuit needs; pass 2 replays with the outcome oracle
    # and the prologue budget reserved
    start = 1 + _N_SETUP_ROWS * len(txs)
    probe = run(start)
    outcomes = probe.discovered
    n_setup_rows = (sum(len(s) for s in probe.w.subcall_setups)
                    + len(probe.w.memory_setups))
    tracer = run(start + n_setup_rows, outcomes)
    assert tracer.discovered == [] and tracer.fseq == len(outcomes), (
        "tracer: non-deterministic frame structure between passes")
    w = tracer.w
    rw = w.rw

    # resolve deferred RwCounterEndOfReversion reads
    for row, anchor in tracer.fixups:
        row["value"] = _resolve_anchor(anchor)
    w.tx_rwceor = [_resolve_anchor(a) for a in tracer.root_anchors]

    # --- EndBlock ---
    final_rwc = rw.rw_counter
    if txs:
        call_id = tracer.call_ids[-1]
        rw.call_context_read(call_id, CallContextFieldTag.TxId, len(txs))
        rw.tx_receipt_read(len(txs), TxReceiptFieldTag.CumulativeGasUsed,
                           tracer.cumulative_gas)
        w.steps.append(StepState(ExecutionState.EndBlock, final_rwc, call_id=call_id))
    else:
        w.steps.append(StepState(ExecutionState.EndBlock, final_rwc))
    # rw-table Start padding row for the totality argument
    start_rows = [{"rw_counter": 1, "rw": 0, "key0": int(Target.Start), "id": 0,
                   "address": 0, "field_tag": 0, "storage_key": 0, "value": 0,
                   "value_prev": 0, "aux0": 0}]

    # --- call-context setup prologue: rw counters 1..11*n_txs for the root
    # frames (the subcall and memory regions stay empty: no CALL handler) ---
    prologue = RWDictionary(1)
    CC = CallContextFieldTag
    for i, ((tx, bytecode), call_id) in enumerate(zip(txs, tracer.call_ids)):
        success = int(w.tx_success[i])
        for tag, value in (
            (CC.TxId, tx.id),
            (CC.RwCounterEndOfReversion, w.tx_rwceor[i]),
            (CC.IsPersistent, success),
            (CC.IsSuccess, success),
            (CC.Depth, 1),
            (CC.CallerAddress, tx.caller_address),
            (CC.CalleeAddress, tx.callee_address),
            (CC.CallDataLength, len(tx.call_data)),
            (CC.Value, tx.value),
            (CC.IsRoot, 1),
            (CC.CodeHash, bytecode.hash()),
        ):
            prologue.call_context_write(call_id, tag, value)
    assert prologue.rw_counter == start + n_setup_rows
    w.rw.rws = start_rows + prologue.rws + w.rw.rws

    w.withdrawals = list(withdrawals or [])
    if not w.exp_circuit.rows:
        w.exp_circuit = None
    return w
