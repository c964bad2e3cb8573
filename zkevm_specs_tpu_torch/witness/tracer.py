"""Mini EVM tracer: builds a coherent block witness (steps and rw rows, the
exp circuit's squaring trace and the copy circuit's rows) for blocks of
PUSH / DUP / SWAP / POP / ALU / SIGNEXTEND / ADDMOD / MULMOD / EXP / MLOAD /
MSTORE / MSTORE8 / MSIZE / SLOAD / SSTORE / SHA3 / JUMP / JUMPI / JUMPDEST /
PC / GAS / ADDRESS / CALLER / CALLVALUE / CALLDATASIZE / CALLDATALOAD /
CALLDATACOPY / CODESIZE / CODECOPY / GASPRICE / ORIGIN / SELFBALANCE /
RETURNDATASIZE / RETURNDATACOPY / COINBASE / TIMESTAMP / NUMBER / GASLIMIT /
PREVRANDAO / BASEFEE / CHAINID / BLOCKHASH / BALANCE / EXTCODESIZE /
EXTCODEHASH / EXTCODECOPY / LOG0-LOG4 / CALL / CALLCODE / DELEGATECALL /
STATICCALL / CREATE / CREATE2 / RETURN / REVERT / STOP bytecodes, calls the
precompiles ecRecover (0x01), identity (0x04) and BN254 add, scalar mul and
pairing (0x06-0x08), halts a frame in any error state (a precompile given
too little gas in ErrorOutOfGasPrecompile), and signs its txs.  A call
enters its callee's frame (its calldata a slice of the caller's memory), a
create its initcode's frame; STOP, RETURN and REVERT in a sub-call restore
the caller's context (a create frame's RETURN deploys its code), a REVERT
or an error halt mirrors its frame's reversible writes, at the root or in a
sub-call.  A call to a precompile runs it on the host and emits its step in
the callee's frame, which restores the caller's context at once.

Counterpart of ``zkevm_specs_tpu/witness/tracer.py`` (``BlockWitness``
:167-201, ``_resolve_anchor`` :207-218, ``_Tracer`` :246-366, ``run_tx``
:374-548, ``_detect_error`` :564-714, ``_valid_jumpdest`` :716, ``step_op``
and ``_halt_error`` :721-880, the frames :914-974, ``op_callop``
:976-1252, ``op_create`` :1253-1477, the precompile calls
``_precompile_required_gas`` :221-237, ``_enter_precompile`` :1478-1730,
``_enter_precompile_oog`` :1732-1826 and ``_ecc_circuit`` :1828-1833, the
handlers :1835-2584, the signing
:2585-2626 and ``trace_block`` :2629-2754).  Each executed opcode emits
exactly the rw rows its gadget looks up, with the JAX tracer's rw_counter /
gas / stack-pointer / memory-size / refund / reversion bookkeeping, so the
witness equals the JAX tracer's row for row.

The JAX tracer's refusals hold here too, with its conditions: SELFDESTRUCT
(no handler) and a call to 0x02, 0x03, 0x05 or 0x09 raise
``NotImplementedError``; a precompile call with value, one inside a
reverting frame and an identity call whose regions break its layout fail
its assertions.  So do its limits: an initcode must return its own bytes
(the RETURN gadget pins the deployed code hash to the frame's), and a
CREATE2's deployer is the frame's CallerAddress.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..config import DEFAULT_CONFIG
from ..evm.execution_state import ExecutionState
from ..evm.opcode import (
    Opcode,
    constant_gas_cost,
    get_push_size,
    is_push_with_data,
    max_stack_pointer,
    min_stack_pointer,
)
from ..evm.precompile import Precompile
from ..evm.step import StepState
from ..ops.keccak import EMPTY_HASH, keccak256
from ..tables.schemas import (
    AccountFieldTag,
    CallContextFieldTag,
    CopyDataTypeTag,
    Target,
    TxLogFieldTag,
    TxReceiptFieldTag,
)
from ..utils.param import (
    COLD_SLOAD_COST,
    Bn254AddGas,
    Bn254PairingBaseGas,
    Bn254PairingPerPointGas,
    Bn254ScalarMulGas,
    EcrecoverGas,
    IdentityBaseGas,
    IdentityPerWordGas,
    EXTRA_GAS_COST_ACCOUNT_COLD_ACCESS,
    GAS_COST_ACCOUNT_COLD_ACCESS,
    GAS_COST_CALL_WITH_VALUE,
    GAS_COST_CODE_DEPOSIT,
    GAS_COST_COPY,
    GAS_COST_COPY_SHA3,
    GAS_COST_CREATE,
    GAS_COST_EXP_PER_BYTE,
    GAS_COST_FASTEST,
    GAS_COST_INITCODE_WORD,
    GAS_COST_LOG,
    GAS_COST_LOGDATA,
    GAS_COST_NEW_ACCOUNT,
    GAS_COST_SHA3,
    GAS_COST_SLOW,
    GAS_COST_SSTORE_SENTRY_EIP2200,
    GAS_COST_TX,
    GAS_COST_WARM_ACCESS,
    GAS_STIPEND_CALL_WITH_VALUE,
    INVALID_FIRST_BYTE_CONTRACT_CODE,
    MAX_CODE_SIZE,
    MAX_REFUND_QUOTIENT_OF_GAS_USED,
    SLOAD_GAS,
    SSTORE_CLEARS_SCHEDULE,
    SSTORE_RESET_GAS,
    SSTORE_SET_GAS,
    WARM_STORAGE_READ_COST,
)
from .rlc import RLC
from .rlp import rlp_encode
from .typing import (
    Account,
    Block,
    Bytecode,
    CopyCircuit,
    ExpCircuit,
    RWDictionary,
    Transaction,
    init_is_code,
)

U256M = (1 << 256) - 1
_ADDR_MASK = (1 << 160) - 1  # geth truncates address operands to 160 bits
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
        self.copy_circuit: Optional[CopyCircuit] = None  # SHA3 copy events (None: none)
        self.signed_txs = None             # signed tx list (tx + sig circuits)
        self.ecc_circuit = None            # the bn254 precompiles' ops (EccCircuit)
        self.sig_rows: List = []           # the sig rows of recovered ecRecover calls
        self.sha3_preimages: List[bytes] = []
        self.tx_code_hashes: List[int] = []    # per-tx root code hash
        self.subcall_setups: List[List[Tuple[int, object, object]]] = []
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


def _precompile_required_gas(target: int, cd_length: int) -> int:
    """A precompile's gas as errors.error_oog_precompile computes it (the
    reference's error_oog_precompile.py: the base cost, per word for
    identity, per pair for the bn254 pairing)."""
    p = Precompile(target)
    gas = p.base_gas_cost()
    if p == Precompile.BN254PAIRING:
        gas += Bn254PairingPerPointGas * (cd_length // 192)
    elif p == Precompile.DATACOPY:
        gas += IdentityPerWordGas * ((cd_length + 31) // 32)
    return gas


def _signed(v: int) -> int:
    return v - (1 << 256) if v >= U255 else v


def _byte_size(v: int) -> int:
    return (v.bit_length() + 7) // 8


class _Tracer:
    """Single-block interpreter emitting gadget-exact witness rows."""

    def __init__(self, block: Block, start_counter: int,
                 accounts: Optional[Dict[int, Account]] = None,
                 outcomes: Optional[List[bool]] = None, curve_results: Optional[dict] = None):
        self.w = BlockWitness()
        # the precompiles' curve results (recovered keys, pairing verdicts),
        # shared by trace_block's two passes, which run the same calls
        self.curve_results = {} if curve_results is None else curve_results
        self.w.block = block
        self.w.rw = RWDictionary(start_counter)
        self.w.exp_circuit = ExpCircuit()
        self.w.copy_circuit = CopyCircuit()
        self.rw = self.w.rw
        self.copy_r = 0x64  # randomness of the copy events' RLC (the JAX tracer's)
        # the randomness the keccak, sig and ecc tables share
        # (DEFAULT_CONFIG.keccak_randomness, as in the JAX tracer)
        self.keccak_r = DEFAULT_CONFIG.keccak_randomness
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
        self.codes: Dict[int, Bytecode] = {}   # address -> deployed code
        self.storage: Dict[Tuple[int, int], int] = {}
        for addr, acct in (accounts or {}).items():
            self.balances[addr] = acct.balance
            self.nonces[addr] = acct.nonce
            if len(acct.code.code):
                self.codes[addr] = acct.code
                self._register_code(acct.code)
            for k, v in acct.storage.items():
                self.storage[(addr, k)] = v

    # -- helpers ------------------------------------------------------------

    def _register_code(self, bytecode: Bytecode) -> int:
        h = bytecode.hash()
        if h not in self._code_hashes:
            self._code_hashes[h] = bytecode
            self.w.bytecodes.append(bytecode)
        return h

    def _account_code_hash(self, addr: int) -> int:
        """The account table's CodeHash: 0 when the account does not exist."""
        if addr in self.codes:
            return self.codes[addr].hash()
        if self.balances.get(addr, 0) or self.nonces.get(addr, 0):
            return EMPTY_HASH
        return 0

    # -- frame outcome / reversion machinery --------------------------------

    def _frame_outcome(self) -> Tuple[int, bool]:
        idx = self.fseq
        self.fseq += 1
        if self.outcomes is None:
            self.discovered.append(True)  # optimistic; patched at a failing halt
            return idx, True
        return idx, self.outcomes[idx]

    def _mark_failed(self):
        if self.outcomes is None:
            self.discovered[self.frame_idx] = False

    def _mirror_last(self, pending: Optional[List[dict]] = None):
        """Record the reversion mirror of the rw row just emitted (value and
        value_prev swapped); it is placed at the owning frame's failing
        halt, and dropped when the frame never fails."""
        base = self.rw.rws[-1]
        m = dict(base)
        m["value"], m["value_prev"] = base["value_prev"], base["value"]
        (self.pending if pending is None else pending).append(m)

    def _materialize_reversion(self):
        """Place this frame's mirror section in the rw counters its halting
        gadget skipped: the write of offset c lands at
        RwCounterEndOfReversion - c (last in, first out)."""
        n = len(self.pending)
        end = self.rw.rw_counter
        rwceor = end + n - 1
        for c, row in enumerate(self.pending):
            row["rw_counter"] = rwceor - c
            self.rw.rws.append(row)
        self.rw.rw_counter = end + n
        self.anchor["own"] = rwceor
        self.anchor["failed"] = True
        self.pending = []

    def _snapshot(self) -> dict:
        return dict(balances=dict(self.balances), nonces=dict(self.nonces),
                    codes=dict(self.codes), storage=dict(self.storage),
                    warm_addr=set(self.warm_addr), warm_slot=set(self.warm_slot),
                    refund=self.refund, log_count=self.log_count)

    def _rollback(self, s: dict):
        self.balances = dict(s["balances"])
        self.nonces = dict(s["nonces"])
        self.codes = dict(s["codes"])
        self.storage = dict(s["storage"])
        self.warm_addr = set(s["warm_addr"])
        self.warm_slot = set(s["warm_slot"])
        self.refund = s["refund"]
        self.log_count = s["log_count"]

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
        self.codes.setdefault(tx.callee_address, bytecode)
        call_id = rw.rw_counter
        self.call_ids.append(call_id)

        self.tx = tx
        self.tx_id = tx_id
        self.call_id = call_id
        self.code_hash = code_hash
        self.code = bytecode
        # precompile addresses are always warm (EIP-2929)
        self.warm_addr = set(range(1, 10))
        self.warm_slot = set()
        self.committed: Dict[Tuple[int, int], int] = {}
        self.refund = 0
        self.log_count = 0
        self.rev = 0          # reversible_write_counter
        self.stack: List[int] = []
        self.memory: Dict[int, int] = {}
        self.mws = 0          # memory_word_size
        self.pc = 0
        self.stopped = False
        # the frame's context (the root's; a call saves and restores the
        # _FRAME_FIELDS)
        self.is_root = True
        self.callee_address = tx.callee_address
        self.caller_address = tx.caller_address
        self.value = tx.value
        self.is_static = 0
        self.depth = 1
        self.calldata = bytes(tx.call_data)
        self.cd_offset_abs = 0        # the calldata's offset in the caller's memory
        self.caller_frame_id = 0
        self.rd_offset_abs = 0        # the return region the caller asked for
        self.rd_length = 0
        self.last_callee = (0, 0, 0)  # (id, return data offset, length)
        self.frames: List[dict] = []
        self.memories: Dict[int, Dict[int, int]] = {}  # the finished frames' memories

        # root-frame reversion machinery
        idx, success = self._frame_outcome()
        self.frame_idx = idx
        self.persistent = success  # root frame: persistent == own success
        self.pending: List[dict] = []
        self.anchor = {"own": None, "parent": None, "poffset": 0,
                       "persistent": success, "failed": not success}
        self.is_create_frame = False
        self.snapshot: dict = {}
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
        self.snapshot = self._snapshot()
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

    def _expansion_gas(self, offset: int, length: int) -> int:
        """Memory-expansion gas, without changing the memory size."""
        if length == 0:
            return 0
        size = (offset + length + 31) // 32
        new = max(self.mws, size)
        return 3 * (new - self.mws) + new * new // 512 - self.mws * self.mws // 512

    _WRITE_PROTECTED = frozenset(
        [Opcode.SSTORE, Opcode.CREATE, Opcode.CREATE2, Opcode.SELFDESTRUCT, Opcode.LOG0,
         Opcode.LOG1, Opcode.LOG2, Opcode.LOG3, Opcode.LOG4])

    def _detect_error(self, raw: int) -> Optional[ExecutionState]:
        """The pre-dispatch error classes an opcode with a ported handler can
        hit, in geth's order: invalid opcode, stack validation, write
        protection in a static frame, constant gas, then the per-opcode
        dynamic checks (the JAX tracer's ``_detect_error``, :564-714): an
        invalid JUMP / JUMPI destination, account-access gas, static memory
        expansion, RETURN / REVERT memory gas (and a create frame's code
        checks), copy gas and RETURNDATACOPY's bounds, SLOAD / SSTORE gas,
        LOG gas, EXP gas, SHA3 gas, a sub-call's CREATE gas and the CALL
        family's gas.  One table
        lookup a check and an immediate exit for the opcodes with no dynamic
        check: the tracer runs this every step."""
        E = ExecutionState
        op = _OP_BY_RAW[raw]
        if op is None:
            return E.ErrorInvalidOpcode
        sp = 1024 - len(self.stack)
        if sp < _MIN_SP[raw] or sp > _MAX_SP[raw]:
            return E.ErrorStack
        if self.is_static and (op in self._WRITE_PROTECTED
                               or (op is Opcode.CALL and self.stack[-3] != 0)):
            return E.ErrorWriteProtection
        gas = self.gas_left
        if gas < _CONST_GAS[raw]:
            return E.ErrorOutOfGasConstant
        if not _HAS_DYNAMIC_CHECK[raw]:
            return None
        st = self.stack  # top is st[-1]
        if op in (Opcode.JUMP, Opcode.JUMPI):
            jumps = op == Opcode.JUMP or st[-2] != 0
            if jumps and not self._valid_jumpdest(st[-1]):
                return E.ErrorInvalidJump
        elif op in (Opcode.BALANCE, Opcode.EXTCODESIZE, Opcode.EXTCODEHASH):
            warm = (st[-1] & _ADDR_MASK) in self.warm_addr
            if gas < (GAS_COST_WARM_ACCESS if warm else GAS_COST_ACCOUNT_COLD_ACCESS):
                return E.ErrorOutOfGasAccountAccess
        elif op in (Opcode.MLOAD, Opcode.MSTORE, Opcode.MSTORE8):
            size = 1 if op == Opcode.MSTORE8 else 32
            if st[-1] + size > (1 << 64) - 1:
                return E.ErrorGasUintOverflow
            if gas < GAS_COST_FASTEST + self._expansion_gas(st[-1], size):
                return E.ErrorOutOfGasStaticMemoryExpansion
        elif op in (Opcode.RETURN, Opcode.REVERT):
            offset, length = st[-1], st[-2]
            exp_gas = self._expansion_gas(offset if length else 0, length)
            if gas < exp_gas:
                return E.ErrorOutOfGasDynamicMemoryExpansion
            if op == Opcode.RETURN and self.is_create_frame:
                if length and self.memory.get(offset, 0) == INVALID_FIRST_BYTE_CONTRACT_CODE:
                    return E.ErrorInvalidCreationCode
                if length > MAX_CODE_SIZE:
                    return E.ErrorMaxCodeSizeExceeded
                if gas - exp_gas < length * GAS_COST_CODE_DEPOSIT:
                    return E.ErrorOutOfGasCodeStore
        elif op in (Opcode.CALLDATACOPY, Opcode.CODECOPY, Opcode.EXTCODECOPY,
                    Opcode.RETURNDATACOPY):
            base = -2 if op == Opcode.EXTCODECOPY else -1
            mem_off, length = st[base], st[base - 2]
            if op == Opcode.EXTCODECOPY:
                warm = (st[-1] & _ADDR_MASK) in self.warm_addr
                const = GAS_COST_WARM_ACCESS if warm else GAS_COST_ACCOUNT_COLD_ACCESS
            else:
                const = GAS_COST_FASTEST
            dyn = (GAS_COST_COPY * ((length + 31) // 32)
                   + self._expansion_gas(mem_off if length else 0, length))
            if gas < const + dyn:
                return E.ErrorOutOfGasMemoryCopy
            if op == Opcode.RETURNDATACOPY:
                data_off, length = st[-2], st[-3]
                if data_off + length > self.last_callee[2]:
                    return E.ErrorReturnDataOutOfBound
        elif op in (Opcode.SLOAD, Opcode.SSTORE):
            if op == Opcode.SSTORE and gas <= GAS_COST_SSTORE_SENTRY_EIP2200:
                return E.ErrorOutOfGasSloadSstore
            skey = (self.callee_address, st[-1])
            warm = skey in self.warm_slot
            if op == Opcode.SLOAD:
                need = WARM_STORAGE_READ_COST if warm else COLD_SLOAD_COST
            else:
                need = _sstore_gas(st[-2], self.storage.get(skey, 0),
                                   self.committed.get(skey, self.storage.get(skey, 0)), warm)
            if gas < need:
                return E.ErrorOutOfGasSloadSstore
        elif op in _LOG_OPS:
            n = int(op) - int(Opcode.LOG0)
            mstart, msize = st[-1], st[-2]
            need = (GAS_COST_LOG * (1 + n) + GAS_COST_LOGDATA * msize
                    + self._expansion_gas(mstart, msize))
            if gas < need:
                return E.ErrorOutOfGasLOG
        elif op == Opcode.EXP:
            if gas < GAS_COST_SLOW + GAS_COST_EXP_PER_BYTE * _byte_size(st[-2]):
                return E.ErrorOutOfGasEXP
        elif op == Opcode.SHA3:
            off, size = st[-1], st[-2]
            need = (GAS_COST_SHA3 + GAS_COST_COPY_SHA3 * ((size + 31) // 32)
                    + self._expansion_gas(off if size else 0, size))
            if gas < need:
                return E.ErrorOutOfGasSHA3
        elif op in (Opcode.CREATE, Opcode.CREATE2) and not self.is_root:
            # (the gadget's root branch prices the tx's calldata; the JAX
            # tracer reaches this state in sub-calls only)
            offset, size = st[-2], st[-3]
            words = (size + 31) // 32
            need = (GAS_COST_CREATE + self._expansion_gas(offset if size else 0, size)
                    + words * GAS_COST_INITCODE_WORD
                    + (GAS_COST_COPY_SHA3 * words if op == Opcode.CREATE2 else 0))
            if gas < need:
                return E.ErrorOutOfGasCREATE
        elif op in _CALL_OPS:
            has_val = op in (Opcode.CALL, Opcode.CALLCODE)
            target = st[-2]
            value = st[-3] if has_val else 0
            cdo, cdl = (st[-4], st[-5]) if has_val else (st[-3], st[-4])
            rdo, rdl = (st[-6], st[-7]) if has_val else (st[-5], st[-6])
            warm = target in self.warm_addr
            mem = self._call_expansion_gas(cdo, cdl, rdo, rdl)[1]
            callee_missing = self._account_code_hash(target) == 0
            need = ((GAS_COST_WARM_ACCESS if warm else GAS_COST_ACCOUNT_COLD_ACCESS)
                    + (GAS_COST_CALL_WITH_VALUE
                       + (GAS_COST_NEW_ACCOUNT if op == Opcode.CALL and callee_missing else 0)
                       if value != 0 else 0)
                    + mem)
            if gas < need:
                return E.ErrorOutOfGasCall
        return None

    def _call_expansion_gas(self, cd_offset: int, cd_length: int, rd_offset: int,
                            rd_length: int) -> Tuple[int, int]:
        """The memory size after a call's calldata and return regions, and
        its expansion gas (CallGadget's ``memory_expansion_dynamic_length``)."""
        sizes = [self.mws]
        if cd_length:
            sizes.append((cd_offset + cd_length + 31) // 32)
        if rd_length:
            sizes.append((rd_offset + rd_length + 31) // 32)
        new = max(sizes)
        return new, 3 * (new - self.mws) + new * new // 512 - self.mws * self.mws // 512

    def _valid_jumpdest(self, dest: int) -> bool:
        """A JUMPDEST byte that is code, not PUSH data."""
        code = self.code.code
        return dest < len(code) and code[dest] == int(Opcode.JUMPDEST) and self.code.is_code[dest]

    def step_op(self):
        code = self.code.code
        raw = code[self.pc] if self.pc < len(code) else 0  # STOP
        err = self._detect_error(raw)
        handler = _HANDLER[raw]
        if err is None and handler is None:
            raise NotImplementedError(f"tracer: no handler for {_OP_BY_RAW[raw]!r} is ported")
        sp = 1024 - len(self.stack)
        self.w.steps.append(
            StepState(err or _STATE[raw], self.rw.rw_counter, call_id=self.call_id,
                      is_root=self.is_root, is_create=self.is_create_frame,
                      code_hash=self.code_hash,
                      program_counter=self.pc, stack_pointer=sp,
                      gas_left=self.gas_left, memory_word_size=self.mws,
                      reversible_write_counter=self.rev,
                      log_id=self.log_count))
        if err is not None:
            self._halt_error(err, raw)
            return
        self.gas_left -= _CONST_GAS[raw]
        handler(self, _OP_BY_RAW[raw])

    def _halt_error(self, state: ExecutionState, raw: int):
        """An error halt: the rows of the state's gadget
        (evm/execution/errors.py), IsSuccess == 0, the caller's restored
        context in a sub-call, then the frame's mirror section in the rw
        counters the gadget skips.  The frame's gas is consumed."""
        self._mark_failed()
        rw = self.rw
        E = ExecutionState
        CC = CallContextFieldTag
        op = _OP_BY_RAW[raw]
        sp = 1024 - len(self.stack)
        st = self.stack

        def sread(offset):  # stack_lookup(RW.Read, offset), no pop
            rw.stack_read(self.call_id, sp + offset, st[-1 - offset])

        if state == E.ErrorInvalidJump:
            self.spop()
            if op == Opcode.JUMPI:
                self.spop()
        elif state == E.ErrorWriteProtection:
            self.cc_read(CC.IsStatic, 1)
            if op == Opcode.CALL:
                sread(2)
        elif state == E.ErrorOutOfGasAccountAccess:
            # the access list is keyed by the operand's low 160 bits
            addr = self.spop() & _ADDR_MASK
            self.cc_read(CC.TxId, self.tx_id)
            rw.tx_access_list_account_read(self.tx_id, addr, addr in self.warm_addr)
        elif state == E.ErrorOutOfGasStaticMemoryExpansion:
            self.spop()
        elif state in (E.ErrorOutOfGasDynamicMemoryExpansion, E.ErrorOutOfGasSHA3,
                       E.ErrorOutOfGasLOG):
            self.spop()
            self.spop()
        elif state == E.ErrorOutOfGasMemoryCopy:
            off = 0
            if op == Opcode.EXTCODECOPY:
                sread(0)
                off = 1
            sread(off)
            sread(off + 2)
            if op == Opcode.EXTCODECOPY:
                self.cc_read(CC.TxId, self.tx_id)
                ext = st[-1] & _ADDR_MASK
                rw.tx_access_list_account_read(self.tx_id, ext, ext in self.warm_addr)
        elif state == E.ErrorReturnDataOutOfBound:
            sread(1)
            sread(2)
            self.cc_read(CC.LastCalleeReturnDataLength, self.last_callee[2])
        elif state == E.ErrorOutOfGasSloadSstore:
            key = self.spop()
            self.cc_read(CC.TxId, self.tx_id)
            self.cc_read(CC.CalleeAddress, self.callee_address)
            skey = (self.callee_address, key)
            rw.tx_access_list_account_storage_read(self.tx_id, self.callee_address, key,
                                                   skey in self.warm_slot)
            if op == Opcode.SSTORE:
                self.spop()
                value_prev = self.storage.get(skey, 0)
                committed = self.committed.get(skey, value_prev)
                rw.account_storage_read(self.callee_address, key, value_prev, self.tx_id,
                                        committed)
                # the gadget's original-value hint rides the step's aux
                self.w.steps[-1].aux_data = committed
        elif state == E.ErrorGasUintOverflow:
            # the gadget's CallDataLength, TxId and IsRoot reads, then
            # memory_size's pops; reached by MLOAD / MSTORE / MSTORE8 with an
            # offset past u64 (a root frame would need the calldata rows)
            assert not self.is_root, "tracer: a root-frame gas-uint overflow needs calldata lookups"
            self.cc_read(CC.CallDataLength, len(self.calldata))
            self.cc_read(CC.TxId, self.tx_id)
            self.cc_read(CC.IsRoot, 0)
            self.spop()
            if op in (Opcode.MSTORE, Opcode.MSTORE8):
                self.spop()
        elif state == E.ErrorOutOfGasCREATE:
            sread(1)
            sread(2)
            self.cc_read(CC.IsRoot, 0)
        elif state in (E.ErrorOutOfGasCodeStore, E.ErrorMaxCodeSizeExceeded):
            sread(1)
            self.cc_read(CC.IsStatic, 0)
        elif state == E.ErrorInvalidCreationCode:
            offset = self.spop()
            rw.memory_read(self.call_id, offset, self.memory.get(offset, 0))
        elif state == E.ErrorOutOfGasEXP:
            sread(1)
        elif state == E.ErrorOutOfGasCall:
            self.cc_read(CC.TxId, self.tx_id)
            self.spop()                # gas
            target = self.spop()
            if op in (Opcode.CALL, Opcode.CALLCODE):
                self.spop()            # value
            for _ in range(4):         # cd_offset, cd_length, rd_offset, rd_length
                self.spop()
            self.spush(0)              # CallGadget pins is_success to 0
            rw.account_read(target, AccountFieldTag.CodeHash, self._account_code_hash(target))
            rw.tx_access_list_account_read(self.tx_id, target, target in self.warm_addr)
        rw.call_context_read(self.call_id, CC.IsSuccess, 0)
        self.gas_left = 0
        if self.is_root:
            self._materialize_reversion()
            self._rollback(self.snapshot)
            self.stopped = True
            return
        saved = self.frames[-1]
        last_callee = (self.call_id, 0, 0)
        self._restore_context_rows(saved, last_callee)
        self._materialize_reversion()
        self._rollback(self.snapshot)
        self._pop_frame(last_callee, success=False)

    # stack rw helpers (emit the row AND mutate the model stack)
    def spush(self, v: int):
        self.stack.append(v)
        self.rw.stack_write(self.call_id, 1024 - len(self.stack), v)

    def spop(self) -> int:
        v = self.stack.pop()
        self.rw.stack_read(self.call_id, 1023 - len(self.stack), v)
        return v

    def cc_read(self, tag, value):
        self.rw.call_context_read(self.call_id, tag, value)

    def reversion_reads(self):
        self.cc_read(CallContextFieldTag.RwCounterEndOfReversion, 0)
        self._fix_rwceor(self.anchor)
        self.cc_read(CallContextFieldTag.IsPersistent, int(self.persistent))

    def _expand_dyn(self, offset: int, length: int):
        """Dynamic-length memory expansion: deducts its gas."""
        if length:
            self.gas_left -= self._expansion_gas(offset, length)
            self.mws = max(self.mws, (offset + length + 31) // 32)

    def _copier_gas(self, length: int, per_word: int = GAS_COST_COPY):
        self.gas_left -= per_word * ((length + 31) // 32)

    def _mem_bytes(self, offset: int, length: int) -> bytes:
        return bytes(self.memory.get(offset + i, 0) for i in range(length))

    def _access_account(self, addr: int) -> bool:
        """TxId, the reversion reads and the access-list write; returns
        whether the account was warm."""
        self.cc_read(CallContextFieldTag.TxId, self.tx_id)
        self.reversion_reads()
        warm = addr in self.warm_addr
        self.rw.tx_access_list_account_write(self.tx_id, addr, True, warm)
        self._mirror_last()
        self.rev += 1
        self.warm_addr.add(addr)
        self.gas_left -= 0 if warm else EXTRA_GAS_COST_ACCOUNT_COLD_ACCESS
        return warm

    # -- call frames ----------------------------------------------------------

    _FRAME_FIELDS = (
        "call_id", "code_hash", "code", "stack", "memory", "mws", "pc",
        "gas_left", "rev", "is_root", "callee_address", "caller_address",
        "value", "is_static", "depth", "calldata", "cd_offset_abs",
        "caller_frame_id", "rd_offset_abs", "rd_length", "last_callee",
        "frame_idx", "persistent", "pending", "anchor", "snapshot",
        "is_create_frame",
    )

    def _push_frame(self) -> dict:
        saved = {f: getattr(self, f) for f in self._FRAME_FIELDS}
        self.frames.append(saved)
        return saved

    def _pop_frame(self, last_callee, success: bool = True):
        self.memories[self.call_id] = self.memory
        callee_gas = self.gas_left
        callee_rev = self.rev
        callee_pending = self.pending
        saved = self.frames.pop()
        for f in self._FRAME_FIELDS:
            setattr(self, f, saved[f])
        self.pc = saved["resume_pc"]
        self.gas_left = saved["resume_gas"] + callee_gas
        self.mws = saved["resume_mws"]
        if success:
            # a halt in success: the callee's reversible writes accumulate
            # into the caller, and its pending mirrors join the caller's
            # section at the offsets the reversion chaining reserved
            self.rev = saved["resume_rev"] + callee_rev
            self.pending = self.pending + callee_pending
        else:
            self.rev = saved["resume_rev"]
        self.last_callee = last_callee

    def _restore_context_rows(self, saved: dict, last_callee, read_caller_id: bool = True):
        """The 12 rows of ``step_state_transition_to_restored_context``
        (evm/instruction.py): the CallerId read (which a gadget that passes
        the caller's id, identity's, skips), the caller's saved fields and
        its last-callee writes."""
        caller_id = saved["call_id"]
        CC = CallContextFieldTag
        if read_caller_id:
            self.rw.call_context_read(self.call_id, CC.CallerId, caller_id)
        for tag, value in (
            (CC.IsRoot, int(saved["is_root"])),
            (CC.IsCreate, 0),
            (CC.CodeHash, saved["code_hash"]),
            (CC.ProgramCounter, saved["resume_pc"]),
            (CC.StackPointer, 1024 - len(saved["stack"])),
            (CC.GasLeft, saved["resume_gas"]),
            (CC.MemorySize, saved["resume_mws"]),
            (CC.ReversibleWriteCounter, saved["resume_rev"]),
        ):
            self.rw.call_context_read(caller_id, tag, value)
        for tag, value in zip((CC.LastCalleeId, CC.LastCalleeReturnDataOffset,
                               CC.LastCalleeReturnDataLength), last_callee):
            self.rw.call_context_write(caller_id, tag, value)

    def op_callop(self, op):
        """CALL / CALLCODE / DELEGATECALL / STATICCALL: the call into a
        callee's frame, the no-code and precheck-fail calls that stay in the
        caller, and the calls to a precompile (evm/execution/callop.py's row
        order)."""
        is_call = op == Opcode.CALL
        is_callcode = op == Opcode.CALLCODE
        is_delegatecall = op == Opcode.DELEGATECALL
        is_staticcall = op == Opcode.STATICCALL
        rw = self.rw
        CC = CallContextFieldTag
        callee_call_id = self.w.steps[-1].rw_counter
        # the gadget charges the access cost dynamically and no constant
        # cost: undo step_op's
        self.gas_left += constant_gas_cost(op)

        self.cc_read(CC.TxId, self.tx_id)
        self.reversion_reads()
        self.cc_read(CC.CalleeAddress, self.callee_address)
        self.cc_read(CC.IsStatic, self.is_static)
        self.cc_read(CC.Depth, self.depth)
        if is_delegatecall:
            self.cc_read(CC.CallerAddress, self.caller_address)
            self.cc_read(CC.Value, self.value)

        gas_arg = self.spop()
        target = self.spop()
        value = self.spop() if (is_call or is_callcode) else 0
        cd_offset_w = self.spop()
        cd_length = self.spop()
        rd_offset_w = self.spop()
        rd_length = self.spop()
        cd_offset = cd_offset_w if cd_length else 0
        rd_offset = rd_offset_w if rd_length else 0

        # the precheck (callop.py's depth and balance) and the outcome
        callee_code = self.codes.get(target)
        code_hash = self._account_code_hash(target)
        callee_not_exists = int(code_hash == 0)
        no_code = code_hash in (0, EMPTY_HASH) or callee_code is None
        balance_ok = (not (is_call or is_callcode)
                      or self.balances.get(self.callee_address, 0) >= value)
        precheck_ok = self.depth < 1025 and balance_ok
        is_precompile = 1 <= target <= 9
        enters_callee = precheck_ok and not no_code and not is_precompile
        has_value = int(value != 0) if not (is_delegatecall or is_staticcall) else 0
        next_mws, mem_gas = self._call_expansion_gas(cd_offset, cd_length, rd_offset, rd_length)
        warm = target in self.warm_addr
        gas_cost = ((GAS_COST_WARM_ACCESS if warm else GAS_COST_ACCOUNT_COLD_ACCESS)
                    + has_value * (GAS_COST_CALL_WITH_VALUE
                                   + (GAS_COST_NEW_ACCOUNT if is_call and callee_not_exists
                                      else 0))
                    + mem_gas)
        gas_available = self.gas_left - gas_cost
        all_but_64th = gas_available - gas_available // 64
        callee_gas = min(all_but_64th, gas_arg) if gas_arg < (1 << 64) else all_but_64th
        # a precompile call runs out of gas (ErrorOutOfGasPrecompile) when
        # the callee's gas is below the precompile's cost
        prec_oog = (is_precompile and precheck_ok
                    and callee_gas < _precompile_required_gas(target, cd_length))
        if enters_callee:
            cidx, csucc = self._frame_outcome()
        else:
            # no-code and precompile calls succeed unless the precompile
            # runs out of gas
            cidx, csucc = None, bool(precheck_ok) and not prec_oog
        self.spush(int(csucc))

        rw.account_read(target, AccountFieldTag.CodeHash, code_hash)
        rw.tx_access_list_account_write(self.tx_id, target, True, warm)
        al_row = rw.rws[-1]
        self._mirror_last()
        self.rev += 1
        self.warm_addr.add(target)

        callee_persistent = self.persistent and csucc
        callee_anchor = {"own": None, "parent": self.anchor, "poffset": self.rev,
                         "persistent": callee_persistent,
                         "failed": enters_callee and not csucc}
        rw.call_context_read(callee_call_id, CC.RwCounterEndOfReversion, 0)
        self._fix_rwceor(callee_anchor)
        rw.call_context_read(callee_call_id, CC.IsPersistent, int(callee_persistent))
        # the state circuit wants the first access of each callee context key
        # to be a write: the block's prologue writes these (the anchor
        # resolves after the trace)
        setup = [(callee_call_id, CC.RwCounterEndOfReversion, callee_anchor),
                 (callee_call_id, CC.IsPersistent, int(callee_persistent))]
        self.w.subcall_setups.append(setup)

        # the callee frame's addresses and value (callop.py:48-55)
        ctx_callee = self.callee_address if (is_callcode or is_delegatecall) else target
        ctx_caller = self.caller_address if is_delegatecall else self.callee_address
        ctx_value = self.value if is_delegatecall else value

        if is_call or is_callcode:
            rw.account_read(ctx_caller if is_callcode else self.callee_address,
                            AccountFieldTag.Balance, self.balances.get(self.callee_address, 0))
        snapshot = self._snapshot()  # the callee rolls back to before the transfer
        callee_pending: List[dict] = []
        if is_call and precheck_ok:
            # the value transfer, reversible and bound to the callee's frame
            src, dst = self.callee_address, target
            src_prev = self.balances.get(src, 0)
            rw.account_write(src, AccountFieldTag.Balance, src_prev - value, src_prev)
            self._mirror_last(callee_pending)
            self.balances[src] = src_prev - value
            dst_prev = self.balances.get(dst, 0)
            rw.account_write(dst, AccountFieldTag.Balance, dst_prev + value, dst_prev)
            self._mirror_last(callee_pending)
            self.balances[dst] = dst_prev + value
        # the gadget sets the callee's reversible_write_counter to 2 with or
        # without the transfer rows (callop.py:300, and the caller's delta 3):
        # the missing offsets get no-op rewrites of the access-list row, so
        # the skipped rw range has no gap for EndBlock's count
        while len(callee_pending) < 2:
            pad = dict(al_row)
            pad["value"] = pad["value_prev"] = 1
            callee_pending.append(pad)

        if is_precompile and precheck_ok:
            if prec_oog:
                self._enter_precompile_oog(target, callee_call_id, callee_anchor, callee_pending,
                                           cd_offset, cd_length, rd_offset, rd_length, gas_cost,
                                           callee_gas, next_mws)
            else:
                self._enter_precompile(target, callee_call_id, cd_offset, cd_length, rd_offset,
                                       rd_length, value, gas_cost, callee_gas, next_mws)
            return

        if not enters_callee:
            # the call stays in the caller's frame (callop.py:120-142), whose
            # reversible delta is 3 either way: a failed precheck's two
            # transfer mirrors are the no-op rewrites above
            for tag in (CC.LastCalleeId, CC.LastCalleeReturnDataOffset,
                        CC.LastCalleeReturnDataLength):
                rw.call_context_write(self.call_id, tag, 0)
            self.pending += callee_pending
            self.rev += 2
            self.last_callee = (0, 0, 0)
            # the gadget refunds the stipend in this branch, a failed
            # precheck too (callop.py:135)
            self.gas_left += has_value * GAS_STIPEND_CALL_WITH_VALUE - gas_cost
            self.mws = next_mws
            self.pc += 1
            return

        # the caller's context, saved (5 writes)
        resume_gas = self.gas_left - gas_cost - callee_gas
        for tag, v in ((CC.ProgramCounter, self.pc + 1),
                       (CC.StackPointer, 1024 - len(self.stack)),
                       (CC.GasLeft, resume_gas),
                       (CC.MemorySize, next_mws),
                       (CC.ReversibleWriteCounter, self.rev)):
            rw.call_context_write(self.call_id, tag, v)

        # the callee is static if the caller is or this is a STATICCALL
        callee_static = 1 if (self.is_static or is_staticcall) else 0
        for tag, v in ((CC.CallerId, self.call_id), (CC.TxId, self.tx_id),
                       (CC.Depth, self.depth + 1), (CC.CallerAddress, ctx_caller),
                       (CC.CalleeAddress, ctx_callee), (CC.CallDataOffset, cd_offset),
                       (CC.CallDataLength, cd_length), (CC.ReturnDataOffset, rd_offset),
                       (CC.ReturnDataLength, rd_length), (CC.Value, ctx_value),
                       (CC.IsSuccess, int(csucc)), (CC.IsStatic, callee_static),
                       (CC.LastCalleeId, 0), (CC.LastCalleeReturnDataOffset, 0),
                       (CC.LastCalleeReturnDataLength, 0), (CC.IsRoot, 0), (CC.IsCreate, 0),
                       (CC.CodeHash, code_hash)):
            rw.call_context_read(callee_call_id, tag, v)
            setup.append((callee_call_id, tag, v))

        # enter the callee's frame
        calldata = bytes(self.memory.get(cd_offset + i, 0) for i in range(cd_length))
        saved = self._push_frame()
        saved["resume_pc"] = self.pc + 1
        saved["resume_gas"] = resume_gas
        saved["resume_mws"] = next_mws
        saved["resume_rev"] = self.rev
        self.call_id = callee_call_id
        self.code = callee_code
        self.code_hash = callee_code.hash()
        self.stack = []
        self.memory = {}
        self.mws = 0
        self.pc = 0
        self.gas_left = callee_gas + has_value * GAS_STIPEND_CALL_WITH_VALUE
        self.rev = 2
        self.is_root = False
        self.callee_address = ctx_callee
        self.caller_address = ctx_caller
        self.value = ctx_value
        self.is_static = callee_static
        self.depth = self.depth + 1
        self.calldata = calldata
        self.cd_offset_abs = cd_offset
        self.caller_frame_id = saved["call_id"]
        self.rd_offset_abs = rd_offset
        self.rd_length = rd_length
        self.last_callee = (0, 0, 0)
        self.frame_idx = cidx
        self.persistent = callee_persistent
        self.pending = callee_pending
        self.anchor = callee_anchor
        self.snapshot = snapshot
        self.is_create_frame = False

    # -- the calls to a precompile ---------------------------------------------

    def _run_precompile(self, target: int, inp: bytes, cd_offset: int, cd_length: int,
                        rd_offset: int, rd_length: int):
        """The precompile run on the host: (its output, its gas, its
        execution state, the step's aux_data), with the witness rows it adds
        (a sig row for a recovered ecRecover, an ecc op for bn254)."""
        from ..circuits.ecc import EcAdd, EcMul, EcPairing
        from ..circuits.sig import SigRow
        from ..evm.execution.precompiles import PrecompileAuxData
        from ..ops.ecc import bn254, secp256k1

        def words(data: bytes, n: int):
            return [int.from_bytes(data[i:i + 32], "big") for i in range(0, 32 * n, 32)]

        if target == 1:  # ECRECOVER
            assert cd_length == 128, "tracer: ecrecover needs 128-byte calldata"
            msg_hash, v, r, s_ = words(inp, 4)
            pub = self._curve_result(("recover", msg_hash, v, r, s_),
                                     lambda: secp256k1.recover(msg_hash, v - 27, r, s_))
            addr = (int.from_bytes(keccak256(secp256k1.pubkey_bytes(pub))[-20:], "big")
                    if pub is not None else 0)
            ib = b"".join(int(x).to_bytes(32, "little") for x in (msg_hash, v, r, s_))
            input_rlc = RLC(bytes(reversed(ib)), self.keccak_r, n_bytes=128).expr()
            output_rlc = RLC(bytes(reversed(addr.to_bytes(32, "little"))), self.keccak_r,
                             n_bytes=32).expr()
            aux = (PrecompileAuxData(msg_hash=msg_hash, sig_v=v, sig_r=r, sig_s=s_,
                                     recovered_addr=addr, input_rlc=input_rlc,
                                     output_rlc=output_rlc), self.keccak_r)
            if pub is not None:
                self.w.sig_rows.append(SigRow.assign((v - 27, r, s_), pub, inp[0:32]))
            return (addr.to_bytes(32, "big") if addr else b""), EcrecoverGas, \
                ExecutionState.ECRECOVER, aux
        if target == 4:  # DATACOPY (identity)
            assert rd_offset == 0 and rd_length == cd_length, (
                "tracer: identity calls need rd_offset == 0 and "
                "rd_length == cd_length (dataCopy.py length-expression quirk)")
            assert cd_offset == 0 or cd_offset >= cd_length, (
                "tracer: identity calldata region must equal or be disjoint "
                "from the return region — the dataCopy gadget's copy events "
                "(dataCopy.py:38-62) re-read the input AFTER the callop "
                "return-region write, so a partial overlap cannot form a "
                "read-consistent integrated witness")
            gas = IdentityBaseGas + IdentityPerWordGas * ((cd_length + 31) // 32)
            return inp, gas, ExecutionState.DATACOPY, None
        if target == 6:  # BN254 ADD
            assert cd_length == 128
            px, py, qx, qy = words(inp, 4)
            out = bn254.g1_add(None if px == py == 0 else (px, py),
                               None if qx == qy == 0 else (qx, qy))
            ox, oy = (0, 0) if out is None else out
            self._ecc_circuit().append_add(EcAdd(p=(px, py), q=(qx, qy), out=(ox, oy)))
            return (ox.to_bytes(32, "big") + oy.to_bytes(32, "big"), Bn254AddGas,
                    ExecutionState.BN254_ADD, (px, py, qx, qy, ox, oy))
        if target == 7:  # BN254 SCALAR MUL
            assert cd_length == 96
            px, py, k = words(inp, 3)
            out = bn254.g1_mul(None if px == py == 0 else (px, py), k)
            ox, oy = (0, 0) if out is None else out
            self._ecc_circuit().append_mul(EcMul(p=(px, py), s=k, out=(ox, oy)))
            return (ox.to_bytes(32, "big") + oy.to_bytes(32, "big"), Bn254ScalarMulGas,
                    ExecutionState.BN254_SCALAR_MUL, (px, py, k, ox, oy))
        if target == 8:  # BN254 PAIRING
            assert cd_length % 192 == 0
            n_pairs = cd_length // 192
            pts = [tuple(words(inp[k * 192:(k + 1) * 192], 6)) for k in range(n_pairs)]
            g1s = [pt[:2] for pt in pts]
            g2s = [pt[2:] for pt in pts]        # (x2, x1, y2, y1), the EVM's order
            ok = self._curve_result(("pairing", inp), lambda: bn254.pairing_check(list(zip(
                [None if x == y == 0 else (x, y) for x, y in g1s],
                [None if all(v == 0 for v in g2) else
                 (bn254.FQ2([g2[1], g2[0]]), bn254.FQ2([g2[3], g2[2]])) for g2 in g2s]))))
            ib = b"".join(vv.to_bytes(32, "little")
                          for (p_x, p_y, q_x2, q_x1, q_y2, q_y1) in pts
                          for vv in (p_x, p_y, q_x1, q_x2, q_y1, q_y2))
            input_rlc = RLC(bytes(reversed(ib)), self.keccak_r, n_bytes=n_pairs * 192).expr()
            self._ecc_circuit().append_pairing(EcPairing(g1_pts=g1s, g2_pts=g2s, out=int(ok)))
            gas = Bn254PairingBaseGas + n_pairs * Bn254PairingPerPointGas
            return (int(ok).to_bytes(32, "big"), gas, ExecutionState.BN254_PAIRING,
                    (input_rlc, n_pairs, 1, int(ok)))
        raise NotImplementedError(f"tracer: precompile 0x{target:02x}")

    def _curve_result(self, key, compute):
        if key not in self.curve_results:
            self.curve_results[key] = compute()
        return self.curve_results[key]

    def _precompile_callee_rows(self, target: int, callee_call_id: int, success: int,
                                cd_offset: int, cd_length: int, rd_offset: int, rd_length: int,
                                resume_gas: int, next_mws: int, ret_len: int):
        """The callop gadget's precompile branch (callop.py:157-184): the
        callee's 7 context writes, the caller's 8 saved fields."""
        CC = CallContextFieldTag
        for tag, v in ((CC.IsSuccess, success), (CC.CalleeAddress, target),
                       (CC.CallerId, self.call_id), (CC.CallDataOffset, cd_offset),
                       (CC.CallDataLength, cd_length), (CC.ReturnDataOffset, rd_offset),
                       (CC.ReturnDataLength, rd_length)):
            self.rw.call_context_write(callee_call_id, tag, v)
        for tag, v in ((CC.ProgramCounter, self.pc + 1),
                       (CC.StackPointer, 1024 - len(self.stack)),
                       (CC.GasLeft, resume_gas), (CC.MemorySize, next_mws),
                       (CC.ReversibleWriteCounter, self.rev), (CC.LastCalleeId, callee_call_id),
                       (CC.LastCalleeReturnDataOffset, 0), (CC.LastCalleeReturnDataLength, ret_len)):
            self.rw.call_context_write(self.call_id, tag, v)

    def _saved_caller(self, resume_gas: int, next_mws: int) -> dict:
        return {"call_id": self.call_id, "is_root": self.is_root, "code_hash": self.code_hash,
                "resume_pc": self.pc + 1, "stack": self.stack, "resume_gas": resume_gas,
                "resume_mws": next_mws, "resume_rev": self.rev}

    def _enter_precompile(self, target, callee_call_id, cd_offset, cd_length, rd_offset,
                          rd_length, value, gas_cost, callee_gas, next_mws):
        """A call to 0x01 / 0x04 / 0x06 / 0x07 / 0x08: the callop gadget's
        precompile branch (callop.py:143-249), then the precompile's own
        step in the callee's frame, which restores the caller's context.
        The JAX tracer's limits hold: no value, and a persistent calling
        frame."""
        assert value == 0, "tracer: precompile calls must carry no value"
        assert self.persistent, (
            "tracer: precompile calls inside reverting frames unsupported "
            "(the transfer mirrors would need reference-incoherent offsets)")
        rw = self.rw
        CC = CallContextFieldTag
        inp = self._mem_bytes(cd_offset, cd_length)
        output, prec_gas, state, aux = self._run_precompile(target, inp, cd_offset, cd_length,
                                                            rd_offset, rd_length)
        ret_len = len(output)

        # the CALL_OP step's aux: (input length, return length), the
        # callop gadget's hints (callop.py:144-152)
        self.w.steps[-1].aux_data = (cd_length, ret_len)
        min_rd = min(ret_len, rd_length)
        resume_gas = self.gas_left - gas_cost - callee_gas
        self._precompile_callee_rows(target, callee_call_id, 1, cd_offset, cd_length, rd_offset,
                                     rd_length, resume_gas, next_mws, ret_len)

        # the copy events (callop.py:187-226): input -> RlcAcc, output ->
        # RlcAcc, output -> the caller's return region.  The callee's output
        # bytes are written by the block's prologue (memory_setups), so that
        # their first access is a write (the state circuit's rule)
        callee_mem = {i: output[i] for i in range(ret_len)}
        self.w.memory_setups += [(callee_call_id, i, output[i]) for i in range(ret_len)]
        cc = self.w.copy_circuit
        if cd_length:
            cc.copy(self.copy_r, rw, self.call_id, CopyDataTypeTag.Memory, callee_call_id,
                    CopyDataTypeTag.RlcAcc, cd_offset, cd_offset + cd_length, 0, cd_length,
                    {cd_offset + i: inp[i] for i in range(cd_length)})
        if ret_len:
            cc.copy(self.copy_r, rw, callee_call_id, CopyDataTypeTag.Memory, callee_call_id,
                    CopyDataTypeTag.RlcAcc, 0, ret_len, 0, ret_len, dict(callee_mem))
            cc.copy(self.copy_r, rw, callee_call_id, CopyDataTypeTag.Memory, self.call_id,
                    CopyDataTypeTag.Memory, 0, min_rd, rd_offset, min_rd, dict(callee_mem))
            for i in range(min_rd):
                self.memory[rd_offset + i] = output[i]

        # the precompile's step: the pc advances by 1 and the stack pointer
        # carries over (callop.py:242-243's Transition delta(1) / same), as
        # the reference's precompile steps do
        call_step = self.w.steps[-1]
        self.w.steps.append(StepState(
            state, rw.rw_counter, call_id=callee_call_id, is_root=False, code_hash=EMPTY_HASH,
            program_counter=call_step.program_counter + 1,
            stack_pointer=call_step.stack_pointer, gas_left=callee_gas,
            memory_word_size=(min_rd + 31) // 32, reversible_write_counter=2,
            log_id=self.log_count, aux_data=aux))

        # the precompile gadget's own rows, then the caller's restore
        saved = self._saved_caller(resume_gas, next_mws)
        prev_call_id, self.call_id = self.call_id, callee_call_id
        if target == 4:
            for tag, v in ((CC.CalleeAddress, target), (CC.CallerId, prev_call_id),
                           (CC.CallDataOffset, cd_offset), (CC.CallDataLength, cd_length),
                           (CC.ReturnDataOffset, rd_offset), (CC.ReturnDataLength, rd_length)):
                self.cc_read(tag, v)
            # dataCopy's two copy events (dataCopy.py:38-62)
            src_data = {cd_offset + i: inp[i] for i in range(cd_length)}
            cc.copy(self.copy_r, rw, prev_call_id, CopyDataTypeTag.Memory, prev_call_id,
                    CopyDataTypeTag.Memory, cd_offset, cd_offset + cd_length, rd_offset,
                    cd_length, src_data)
            cc.copy(self.copy_r, rw, prev_call_id, CopyDataTypeTag.Memory, callee_call_id,
                    CopyDataTypeTag.Memory, cd_offset, cd_offset + cd_length, 0, cd_length,
                    dict(src_data))
        else:
            self.cc_read(CC.IsSuccess, 1)
            if target == 8:  # ecPairing also reads CallDataLength
                self.cc_read(CC.CallDataLength, cd_length)
            self.cc_read(CC.CalleeAddress, target)
        self._restore_context_rows(saved, (callee_call_id, 0, ret_len),
                                   read_caller_id=target != 4)
        self.call_id = prev_call_id
        self.gas_left = resume_gas + (callee_gas - prec_gas)
        self.mws = next_mws
        self.last_callee = (callee_call_id, 0, ret_len)
        self.pc += 1

    def _enter_precompile_oog(self, target, callee_call_id, callee_anchor, callee_pending,
                              cd_offset, cd_length, rd_offset, rd_length, gas_cost, callee_gas,
                              next_mws):
        """A call to a precompile given too little gas: the callop gadget's
        precompile branch (IsSuccess 0, the input's copy alone), then an
        ErrorOutOfGasPrecompile step in the callee's frame, which restores
        the caller's context and burns the callee's gas (the reference's
        error_oog_precompile.py, which its callop leaves unreachable)."""
        assert self.persistent, "tracer: OOG precompile calls inside reverting frames unsupported"
        if target == 4:
            # PrecompileGadget pins identity's return length to its calldata
            # length, which a failed call (0 bytes returned) meets only with
            # empty calldata (the reference's precompile_gadget.py:24)
            assert cd_length == 0, "tracer: OOG identity calls need empty calldata"
        rw = self.rw
        CC = CallContextFieldTag
        self.w.steps[-1].aux_data = (cd_length, 0)
        resume_gas = self.gas_left - gas_cost - callee_gas
        self._precompile_callee_rows(target, callee_call_id, 0, cd_offset, cd_length, rd_offset,
                                     rd_length, resume_gas, next_mws, 0)
        # the input's copy event (callop.py:187-199); no output or return copy
        if cd_length:
            inp = self._mem_bytes(cd_offset, cd_length)
            self.w.copy_circuit.copy(
                self.copy_r, rw, self.call_id, CopyDataTypeTag.Memory, callee_call_id,
                CopyDataTypeTag.RlcAcc, cd_offset, cd_offset + cd_length, 0, cd_length,
                {cd_offset + i: inp[i] for i in range(cd_length)})

        call_step = self.w.steps[-1]
        self.w.steps.append(StepState(
            ExecutionState.ErrorOutOfGasPrecompile, rw.rw_counter, call_id=callee_call_id,
            is_root=False, code_hash=EMPTY_HASH, program_counter=call_step.program_counter + 1,
            stack_pointer=call_step.stack_pointer, gas_left=callee_gas, memory_word_size=0,
            reversible_write_counter=2, log_id=self.log_count))

        saved = self._saved_caller(resume_gas, next_mws)
        prev_call_id, self.call_id = self.call_id, callee_call_id
        # the gadget's CalleeAddress and CallDataLength reads, then
        # constrain_error_state's IsSuccess read and the caller's restore
        self.cc_read(CC.CalleeAddress, target)
        self.cc_read(CC.CallDataLength, cd_length)
        self.cc_read(CC.IsSuccess, 0)
        self._restore_context_rows(saved, (callee_call_id, 0, 0))
        # the callee's frame failed: its two reversible-write slots revert in
        # the counters the error gadget skipped
        caller_pending, caller_anchor = self.pending, self.anchor
        self.pending, self.anchor = list(callee_pending), callee_anchor
        self._materialize_reversion()
        self.pending, self.anchor = caller_pending, caller_anchor

        self.call_id = prev_call_id
        self.gas_left = resume_gas  # the callee's gas is consumed
        self.mws = next_mws
        self.last_callee = (callee_call_id, 0, 0)
        self.pc += 1

    def _ecc_circuit(self):
        if self.w.ecc_circuit is None:
            from ..circuits.ecc import EccCircuit

            self.w.ecc_circuit = EccCircuit(8, 8, 4)
        return self.w.ecc_circuit

    def op_create(self, op):
        """CREATE / CREATE2 (evm/execution/create.py's row order): the
        prechecks, the address (a CREATE2 collision stays in the caller),
        the transfer and the new account's nonce bound to the callee's
        frame, then the initcode copied from memory to the bytecode table
        and its frame entered; an empty initcode deploys in place.  As in
        the JAX tracer, the deployer is the frame's CallerAddress, the
        CREATE address takes the incremented nonce and CREATE2 packs the
        salt and the code hash little-endian."""
        is_create2 = op == Opcode.CREATE2
        rw = self.rw
        CC = CallContextFieldTag
        callee_call_id = self.w.steps[-1].rw_counter
        # the gadget charges GAS_COST_CREATE in its dynamic cost: undo
        # step_op's constant cost
        self.gas_left += constant_gas_cost(op)

        value = self.spop()
        offset = self.spop()
        size = self.spop()
        salt = self.spop() if is_create2 else 0

        initcode_bytes = bytearray(self._mem_bytes(offset, size))
        initcode = Bytecode(initcode_bytes)
        init_hash = initcode.hash() if size else EMPTY_HASH
        if size:
            # the gadget's code-hash hint rides the step's aux
            self.w.steps[-1].aux_data = init_hash

        deployer = self.caller_address
        nonce_prev = self.nonces.get(deployer, 0)
        nonce = nonce_prev + 1
        if is_create2:
            contract = int.from_bytes(
                keccak256(b"\xff" + deployer.to_bytes(20, "big") + salt.to_bytes(32, "little")
                          + init_hash.to_bytes(32, "little"))[-20:], "big")
        else:
            contract = int.from_bytes(
                keccak256(rlp_encode([deployer.to_bytes(20, "big"), nonce]))[-20:], "big")

        # the prechecks (create.py:80-88) and a collision
        precheck_ok = (self.depth < 1025 and self.balances.get(deployer, 0) >= value
                       and nonce_prev < (1 << 64) - 1)
        collision = precheck_ok and (
            self.nonces.get(contract, 0) != 0
            or self._account_code_hash(contract) not in (0, EMPTY_HASH))
        enters = precheck_ok and not collision and size > 0
        if enters:
            cidx, csucc = self._frame_outcome()
        else:
            cidx, csucc = None, bool(precheck_ok and not collision)
        self.spush(contract if csucc else 0)

        self.cc_read(CC.Depth, self.depth)
        self.cc_read(CC.TxId, self.tx_id)
        self.cc_read(CC.CallerAddress, deployer)
        rw.account_write(deployer, AccountFieldTag.Nonce, nonce, nonce_prev)
        self.nonces[deployer] = nonce
        rw.account_read(deployer, AccountFieldTag.Balance, self.balances.get(deployer, 0))
        # the outcome, from the callee's context (the gadget's deviation)
        rw.call_context_read(callee_call_id, CC.IsSuccess, int(csucc))
        self.cc_read(CC.IsStatic, self.is_static)
        self.reversion_reads()

        # memory expansion and the initcode's word gas (create.py:60-78)
        next_mws = max(self.mws, (offset + size + 31) // 32) if size else self.mws
        mem_gas = self._expansion_gas(offset, size)
        word_len = (size + 31) // 32
        gas_cost = GAS_COST_CREATE + mem_gas + word_len * GAS_COST_INITCODE_WORD
        if is_create2:
            gas_cost += GAS_COST_COPY_SHA3 * word_len
        gas_available = self.gas_left - gas_cost
        callee_gas = gas_available - gas_available // 64

        callee_persistent = self.persistent and csucc
        callee_anchor = {"own": None, "parent": self.anchor, "poffset": self.rev + 1,
                         "persistent": callee_persistent, "failed": enters and not csucc}
        callee_pending: List[dict] = []
        setup = [(callee_call_id, CC.IsSuccess, int(csucc))]
        snapshot = None

        if precheck_ok:
            warm = contract in self.warm_addr
            rw.tx_access_list_account_write(self.tx_id, contract, True, warm)
            self._mirror_last()
            self.rev += 1
            self.warm_addr.add(contract)
            rw.account_read(contract, AccountFieldTag.CodeHash, self._account_code_hash(contract))
            rw.account_read(contract, AccountFieldTag.Nonce, self.nonces.get(contract, 0))
            if not collision:
                rw.call_context_read(callee_call_id, CC.RwCounterEndOfReversion, 0)
                self._fix_rwceor(callee_anchor)
                rw.call_context_read(callee_call_id, CC.IsPersistent, int(callee_persistent))
                setup.append((callee_call_id, CC.RwCounterEndOfReversion, callee_anchor))
                setup.append((callee_call_id, CC.IsPersistent, int(callee_persistent)))
                # the transfer and the new account's nonce, bound to the
                # callee's frame
                snapshot = self._snapshot()
                src_prev = self.balances.get(deployer, 0)
                rw.account_write(deployer, AccountFieldTag.Balance, src_prev - value, src_prev)
                self._mirror_last(callee_pending)
                self.balances[deployer] = src_prev - value
                dst_prev = self.balances.get(contract, 0)
                rw.account_write(contract, AccountFieldTag.Balance, dst_prev + value, dst_prev)
                self._mirror_last(callee_pending)
                self.balances[contract] = dst_prev + value
                rw.account_write(contract, AccountFieldTag.Nonce, 1, 0)
                self._mirror_last(callee_pending)
                self.nonces[contract] = 1
        self.w.subcall_setups.append(setup)

        if not enters:
            # the create stays in the caller's frame (create.py:196-222)
            for tag in (CC.LastCalleeId, CC.LastCalleeReturnDataOffset,
                        CC.LastCalleeReturnDataLength):
                rw.call_context_write(self.call_id, tag, 0)
            # an empty initcode deploys in place: its mirrors join the caller's
            self.pending += callee_pending
            self.rev += len(callee_pending)
            if csucc and size == 0:
                self.codes[contract] = Bytecode(bytearray())
                self._register_code(Bytecode(bytearray()))
            self.gas_left -= gas_cost
            self.mws = next_mws
            self.pc += 1
            return

        # the initcode, copied from the caller's memory to the bytecode table
        self._register_code(initcode)
        is_code = init_is_code(initcode_bytes)
        self.w.copy_circuit.copy(
            self.copy_r, rw, self.call_id, CopyDataTypeTag.Memory, init_hash,
            CopyDataTypeTag.Bytecode, offset, offset + size, 0, size,
            {offset + i: (initcode_bytes[i], int(is_code[i])) for i in range(size)})

        # the caller's context, saved (5 writes)
        resume_gas = self.gas_left - gas_cost - callee_gas
        for tag, v in ((CC.ProgramCounter, self.pc + 1),
                       (CC.StackPointer, 1024 - len(self.stack)),
                       (CC.GasLeft, resume_gas),
                       (CC.MemorySize, next_mws),
                       (CC.ReversibleWriteCounter, self.rev)):
            rw.call_context_write(self.call_id, tag, v)

        # the callee's context (create.py:163-183)
        for tag, v in ((CC.CallerId, self.call_id), (CC.TxId, self.tx_id),
                       (CC.Depth, self.depth + 1), (CC.CallerAddress, deployer),
                       (CC.CalleeAddress, contract), (CC.IsSuccess, int(csucc)),
                       (CC.IsStatic, 0), (CC.IsRoot, 0), (CC.IsCreate, 1),
                       (CC.CodeHash, init_hash)):
            rw.call_context_read(callee_call_id, tag, v)
            if tag != CC.IsSuccess:
                setup.append((callee_call_id, tag, v))

        # enter the initcode's frame
        saved = self._push_frame()
        saved["resume_pc"] = self.pc + 1
        saved["resume_gas"] = resume_gas
        saved["resume_mws"] = next_mws
        saved["resume_rev"] = self.rev
        self.call_id = callee_call_id
        self.code = initcode
        self.code_hash = init_hash
        self.stack = []
        self.memory = {}
        self.mws = 0
        self.pc = 0
        self.gas_left = callee_gas
        self.rev = 3
        self.is_root = False
        self.callee_address = contract
        self.caller_address = deployer
        self.value = value
        self.is_static = 0
        self.depth = self.depth + 1
        self.calldata = b""
        self.cd_offset_abs = 0
        self.caller_frame_id = saved["call_id"]
        self.rd_offset_abs = 0
        self.rd_length = 0
        self.last_callee = (0, 0, 0)
        self.frame_idx = cidx
        self.persistent = callee_persistent
        self.pending = callee_pending
        self.anchor = callee_anchor
        self.snapshot = snapshot
        self.is_create_frame = True

    def op_return_revert(self, op):
        """RETURN / REVERT (evm/execution/return_revert.py's row order): at
        the root the tx ends; in a sub-call the returned chunk is copied
        into the caller's return region and the caller's context restored.
        A create frame deploys the returned chunk as its contract's code
        instead (the gadget's rows come for a REVERT too).  A REVERT places
        its frame's mirror section and rolls the world state back to the
        frame's entry."""
        is_return = op == Opcode.RETURN
        if not is_return:
            self._mark_failed()
        # the gadget reads IsSuccess before its pops
        self.cc_read(CallContextFieldTag.IsSuccess, int(is_return))
        offset = self.spop()
        length = self.spop()
        if self.is_create_frame:
            contract = self.callee_address
            self.cc_read(CallContextFieldTag.CalleeAddress, contract)
            self.rw.account_write(contract, AccountFieldTag.CodeHash, self.code_hash, EMPTY_HASH)
            deployed_bytes = bytearray(self._mem_bytes(offset, length))
            deployed = Bytecode(deployed_bytes)
            # the deployment sticks on RETURN only (the JAX tracer's model of
            # the gadget's unmirrored account write)
            if is_return:
                assert deployed.hash() == self.code_hash, (
                    "tracer: an initcode must return its own bytes (the gadget pins the "
                    "deployed CodeHash to the frame's, return_revert.py:40)")
                self.codes[contract] = deployed
            else:
                assert length == 0, (
                    "tracer: a REVERT with data in an initcode frame is not supported (the "
                    "gadget would register the data as bytecode under the initcode's hash)")
            self.gas_left -= length * GAS_COST_CODE_DEPOSIT
            if length:
                is_code = init_is_code(deployed_bytes)
                self.w.copy_circuit.copy(
                    self.copy_r, self.rw, self.call_id, CopyDataTypeTag.Memory, self.code_hash,
                    CopyDataTypeTag.Bytecode, offset, offset + length, 0, length,
                    {offset + i: (deployed_bytes[i], int(is_code[i])) for i in range(length)})

        if self.is_root:
            self.cc_read(CallContextFieldTag.IsPersistent, int(is_return))
            self._expand_dyn(offset if length else 0, length)
            if not is_return:
                self._materialize_reversion()
                self._rollback(self.snapshot)
            self.stopped = True
            return

        saved = self.frames[-1]
        if not self.is_create_frame:
            # the returned chunk, copied into the caller's return region
            self.cc_read(CallContextFieldTag.ReturnDataOffset, self.rd_offset_abs)
            self.cc_read(CallContextFieldTag.ReturnDataLength, self.rd_length)
            copy_length = min(length, self.rd_length)
            if copy_length:
                src_data = {offset + i: self.memory.get(offset + i, 0)
                            for i in range(copy_length)}
                self.w.copy_circuit.copy(
                    self.copy_r, self.rw, self.call_id, CopyDataTypeTag.Memory,
                    saved["call_id"], CopyDataTypeTag.Memory, offset, offset + length,
                    self.rd_offset_abs, copy_length, src_data)
                for i in range(copy_length):
                    saved["memory"][self.rd_offset_abs + i] = self.memory.get(offset + i, 0)
        self._expand_dyn(offset if length else 0, length)
        last_callee = (self.call_id, offset, length)
        self._restore_context_rows(saved, last_callee)
        if is_return:
            self._pop_frame(last_callee)
        else:
            self._materialize_reversion()
            self._rollback(self.snapshot)
            self._pop_frame(last_callee, success=False)

    # -- handlers -----------------------------------------------------------

    def op_stop(self, op):
        self.cc_read(CallContextFieldTag.IsSuccess, 1)
        if self.is_root:
            self.stopped = True
            return
        saved = self.frames[-1]
        last_callee = (self.call_id, 0, 0)
        self._restore_context_rows(saved, last_callee)
        self._pop_frame(last_callee)

    def op_push(self, op):
        n = get_push_size(op)
        v = int.from_bytes(self.code.code[self.pc + 1: self.pc + 1 + n], "big")
        self.spush(v)
        self.pc += 1 + n

    def op_dup(self, op):
        x = int(op) - int(Opcode.DUP1) + 1
        sp = 1024 - len(self.stack)
        v = self.stack[-x]
        self.rw.stack_read(self.call_id, sp + x - 1, v)
        self.spush(v)
        self.pc += 1

    def op_swap(self, op):
        n = int(op) - int(Opcode.SWAP1) + 1
        sp = 1024 - len(self.stack)
        top, deep = self.stack[-1], self.stack[-1 - n]
        self.rw.stack_read(self.call_id, sp, top)
        self.rw.stack_read(self.call_id, sp + n, deep)
        self.rw.stack_write(self.call_id, sp, deep)
        self.rw.stack_write(self.call_id, sp + n, top)
        self.stack[-1], self.stack[-1 - n] = deep, top
        self.pc += 1

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

    def op_signextend(self, op):
        i, x = self.spop(), self.spop()
        self.spush(signextend(i, x))
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

    def op_memory(self, op):
        rw, call_id = self.rw, self.call_id
        offset = self.spop()
        if op == Opcode.MLOAD:
            self.spush(int.from_bytes(self._mem_bytes(offset, 32), "big"))
            for i in range(32):
                rw.memory_read(call_id, offset + i, self.memory.get(offset + i, 0))
            address = offset + 32
        else:
            value = self.spop()
            if op == Opcode.MSTORE8:
                self.memory[offset] = value & 0xFF
                rw.memory_write(call_id, offset, value & 0xFF)
                address = offset + 1
            else:
                for i in range(32):
                    b = (value >> (8 * (31 - i))) & 0xFF
                    self.memory[offset + i] = b
                    rw.memory_write(call_id, offset + i, b)
                address = offset + 32
        # the MEMORY gadget passes curr.memory_word_size as the "offset" of
        # memory_expansion (reference memory.py:22-24, instruction.py:
        # 1138-1145), so the expansion target includes the current size
        next_size = max(self.mws, (address + self.mws + 31) // 32)
        self.gas_left -= (3 * (next_size - self.mws)
                          + next_size * next_size // 512 - self.mws * self.mws // 512)
        self.mws = next_size
        self.pc += 1

    def op_msize(self, op):
        self.spush(self.mws * 32)
        self.pc += 1

    def op_gas(self, op):
        self.spush(self.gas_left)  # gas after the constant cost
        self.pc += 1

    def op_pc(self, op):
        self.spush(self.pc)
        self.pc += 1

    def op_jumpdest(self, op):
        self.pc += 1

    def op_jump(self, op):
        self.pc = self.spop()

    def op_jumpi(self, op):
        dest = self.spop()
        cond = self.spop()
        self.pc = dest if cond != 0 else self.pc + 1

    def op_address(self, op):
        self.cc_read(CallContextFieldTag.CalleeAddress, self.callee_address)
        self.spush(self.callee_address)
        self.pc += 1

    def op_caller(self, op):
        self.cc_read(CallContextFieldTag.CallerAddress, self.caller_address)
        self.spush(self.caller_address)
        self.pc += 1

    def op_callvalue(self, op):
        self.cc_read(CallContextFieldTag.Value, self.value)
        self.spush(self.value)
        self.pc += 1

    def op_calldatasize(self, op):
        self.cc_read(CallContextFieldTag.CallDataLength, len(self.calldata))
        self.spush(len(self.calldata))
        self.pc += 1

    def op_returndatasize(self, op):
        self.cc_read(CallContextFieldTag.LastCalleeReturnDataLength, self.last_callee[2])
        self.spush(self.last_callee[2])
        self.pc += 1

    def op_codesize(self, op):
        self.spush(len(self.code.code))
        self.pc += 1

    def op_gasprice(self, op):
        self.cc_read(CallContextFieldTag.TxId, self.tx_id)
        self.spush(self.tx.gas_price)
        self.pc += 1

    def op_origin(self, op):
        self.cc_read(CallContextFieldTag.TxId, self.tx_id)
        self.spush(self.tx.caller_address)
        self.pc += 1

    def op_selfbalance(self, op):
        addr = self.callee_address
        self.cc_read(CallContextFieldTag.CalleeAddress, addr)
        bal = self.balances.get(addr, 0)
        self.rw.account_read(addr, AccountFieldTag.Balance, bal)
        self.spush(bal)
        self.pc += 1

    def op_blockctx(self, op):
        b = self.block
        self.spush({Opcode.COINBASE: b.coinbase, Opcode.TIMESTAMP: b.timestamp,
                    Opcode.NUMBER: b.number, Opcode.GASLIMIT: b.gas_limit,
                    Opcode.PREVRANDAO: b.prev_randao, Opcode.BASEFEE: b.base_fee,
                    Opcode.CHAINID: b.chainid}[op])
        self.pc += 1

    def op_blockhash(self, op):
        number = self.spop()
        cur = self.block.number
        if number < cur and cur <= 256 + number:
            idx = cur - number - 1  # history_hashes is most-recent-last
            assert idx < len(self.block.history_hashes), (
                f"tracer: BLOCKHASH of block {number} is inside the 256-block window but the "
                f"Block witness records only {len(self.block.history_hashes)} history hashes; "
                "the gadget's block-table lookup needs the hash: extend "
                "Block(history_hashes=...)")
            value = self.block.history_hashes[-1 - idx]
        else:
            value = 0
        self.spush(value)
        self.pc += 1

    def op_balance(self, op):
        addr = self.spop()
        self._access_account(addr)
        code_hash = self._account_code_hash(addr)
        self.rw.account_read(addr, AccountFieldTag.CodeHash, code_hash)
        if code_hash != 0:
            bal = self.balances.get(addr, 0)
            self.rw.account_read(addr, AccountFieldTag.Balance, bal)
        else:
            bal = 0
        self.spush(bal)
        self.pc += 1

    def op_extcodesize(self, op):
        addr = self.spop()
        self._access_account(addr)
        code_hash = self._account_code_hash(addr)
        self.rw.account_read(addr, AccountFieldTag.CodeHash, code_hash)
        size = len(self.codes[addr].code) if code_hash != 0 and addr in self.codes else 0
        if code_hash != 0 and addr not in self.codes:
            # an existing account without code: bytecode_length of the empty hash
            self._register_code(Bytecode(bytearray()))
        self.spush(size)
        self.pc += 1

    def op_extcodehash(self, op):
        addr = self.spop()
        self._access_account(addr)
        code_hash = self._account_code_hash(addr)
        self.rw.account_read(addr, AccountFieldTag.CodeHash, code_hash)
        self.spush(code_hash)
        self.pc += 1

    def _calldata_reads(self):
        """The calldata's context reads: the tx's in a root frame, the
        caller's memory region in a sub-call."""
        if self.is_root:
            self.cc_read(CallContextFieldTag.TxId, self.tx_id)
            self.cc_read(CallContextFieldTag.CallDataLength, len(self.calldata))
        else:
            self.cc_read(CallContextFieldTag.CallerId, self.caller_frame_id)
            self.cc_read(CallContextFieldTag.CallDataLength, len(self.calldata))
            self.cc_read(CallContextFieldTag.CallDataOffset, self.cd_offset_abs)

    def op_calldataload(self, op):
        offset = self.spop()
        data = self.calldata
        self._calldata_reads()
        if not self.is_root:
            # a callee's in-bounds bytes are read from its caller's memory
            src_addr = self.cd_offset_abs + offset
            src_end = self.cd_offset_abs + len(data)
            caller_mem = self.frames[-1]["memory"]
            for i in range(32):
                if src_addr + i < src_end:
                    self.rw.memory_read(self.caller_frame_id, src_addr + i,
                                        caller_mem.get(src_addr + i, 0))
        word = bytes(data[offset + i] if offset + i < len(data) else 0 for i in range(32))
        # the gadget packs the read-order bytes little-endian into the word,
        # as the reference does (calldataload.py:49-52)
        self.spush(int.from_bytes(word, "little"))
        self.pc += 1

    def op_calldatacopy(self, op):
        memory_offset = self.spop()
        data_offset = self.spop()
        length = self.spop()
        data = self.calldata
        self._calldata_reads()
        self._expand_dyn(memory_offset if length else 0, length)
        self._copier_gas(length)
        if length:
            if self.is_root:
                src_data = {data_offset + i: data[data_offset + i]
                            for i in range(length) if data_offset + i < len(data)}
                self.w.copy_circuit.copy(
                    self.copy_r, self.rw, self.tx_id, CopyDataTypeTag.TxCalldata,
                    self.call_id, CopyDataTypeTag.Memory, data_offset, len(data),
                    memory_offset, length, src_data)
            else:
                caller_mem = self.frames[-1]["memory"]
                src_base = self.cd_offset_abs + data_offset
                src_end = self.cd_offset_abs + len(data)
                src_data = {src_base + i: caller_mem.get(src_base + i, 0)
                            for i in range(length) if src_base + i < src_end}
                self.w.copy_circuit.copy(
                    self.copy_r, self.rw, self.caller_frame_id, CopyDataTypeTag.Memory,
                    self.call_id, CopyDataTypeTag.Memory, src_base, src_end,
                    memory_offset, length, src_data)
            for i in range(length):
                self.memory[memory_offset + i] = (data[data_offset + i]
                                                  if data_offset + i < len(data) else 0)
        self.pc += 1

    def _copy_code(self, code_hash: int, code: Optional[Bytecode], memory_offset: int,
                   code_offset: int, size: int):
        """A Bytecode -> Memory copy event of ``size`` bytes, zero-padded
        past the code's end (CODECOPY, EXTCODECOPY)."""
        raw = code.code if code is not None else b""
        is_code = code.is_code if code is not None else []
        src_data = {code_offset + i: (raw[code_offset + i], int(is_code[code_offset + i]))
                    for i in range(size) if code_offset + i < len(raw)}
        self.w.copy_circuit.copy(
            self.copy_r, self.rw, code_hash, CopyDataTypeTag.Bytecode,
            self.call_id, CopyDataTypeTag.Memory, code_offset, len(raw),
            memory_offset, size, src_data)
        for i in range(size):
            self.memory[memory_offset + i] = (raw[code_offset + i]
                                              if code_offset + i < len(raw) else 0)

    def op_codecopy(self, op):
        memory_offset = self.spop()
        code_offset = self.spop()
        size = self.spop()
        self._expand_dyn(memory_offset if size else 0, size)
        self._copier_gas(size)
        if size:
            self._copy_code(self.code_hash, self.code, memory_offset, code_offset, size)
        self.pc += 1

    def op_extcodecopy(self, op):
        addr = self.spop()
        memory_offset = self.spop()
        code_offset = self.spop()
        size = self.spop()
        self._access_account(addr)
        code_hash = self._account_code_hash(addr)
        self.rw.account_read(addr, AccountFieldTag.CodeHash, code_hash)
        self._expand_dyn(memory_offset if size else 0, size)
        self._copier_gas(size)
        ext = self.codes.get(addr)
        if code_hash != 0 and ext is None:
            self._register_code(Bytecode(bytearray()))
        if size:
            self._copy_code(code_hash, ext, memory_offset, code_offset, size)
        self.pc += 1

    def op_returndatacopy(self, op):
        memory_offset = self.spop()
        data_offset = self.spop()
        size = self.spop()
        last_id, rdo, rdl = self.last_callee
        self.cc_read(CallContextFieldTag.LastCalleeId, last_id)
        self.cc_read(CallContextFieldTag.LastCalleeReturnDataLength, rdl)
        self.cc_read(CallContextFieldTag.LastCalleeReturnDataOffset, rdo)
        self._expand_dyn(memory_offset if size else 0, size)
        self._copier_gas(size)
        if size:
            # the last callee's memory, from its return region
            src_mem = self.memories[last_id]
            src_base = rdo + data_offset
            src_data = {src_base + i: src_mem.get(src_base + i, 0) for i in range(size)}
            self.w.copy_circuit.copy(
                self.copy_r, self.rw, last_id, CopyDataTypeTag.Memory, self.call_id,
                CopyDataTypeTag.Memory, src_base, rdo + size, memory_offset, size, src_data)
            for i in range(size):
                self.memory[memory_offset + i] = src_mem.get(src_base + i, 0)
        self.pc += 1

    def op_log(self, op):
        mstart = self.spop()
        msize = self.spop()
        self.cc_read(CallContextFieldTag.TxId, self.tx_id)
        self.cc_read(CallContextFieldTag.IsStatic, self.is_static)
        self.cc_read(CallContextFieldTag.CalleeAddress, self.callee_address)
        persistent = self.persistent
        self.cc_read(CallContextFieldTag.IsPersistent, int(persistent))
        log_id = self.log_count + 1
        # logs of non-persistent frames are discarded: the gadget skips the
        # TxLog lookups and the data copy, and log_id does not advance
        if persistent:
            self.rw.tx_log_write(self.tx_id, log_id, TxLogFieldTag.Address, 0,
                                 self.callee_address)
        n_topics = int(op) - int(Opcode.LOG0)
        for i in range(n_topics):
            topic = self.spop()
            if persistent:
                self.rw.tx_log_write(self.tx_id, log_id, TxLogFieldTag.Topic, i, topic)
        if msize and persistent:
            data = self._mem_bytes(mstart, msize)
            self.w.copy_circuit.copy(
                self.copy_r, self.rw, self.call_id, CopyDataTypeTag.Memory,
                self.tx_id, CopyDataTypeTag.TxLog, mstart, mstart + msize,
                0, msize, {mstart + i: data[i] for i in range(msize)}, log_id=log_id)
        self._expand_dyn(mstart if msize else 0, msize)
        # the dynamic gas carries the base 375 too (the opcode's constant gas is 0)
        self.gas_left -= GAS_COST_LOG * (1 + n_topics) + GAS_COST_LOGDATA * msize
        if persistent:
            self.log_count = log_id
        self.pc += 1

    def op_sload(self, op):
        addr = self.callee_address
        self.cc_read(CallContextFieldTag.TxId, self.tx_id)
        self.reversion_reads()
        self.cc_read(CallContextFieldTag.CalleeAddress, addr)
        key = self.spop()
        skey = (addr, key)
        value = self.storage.get(skey, 0)
        committed = self.committed.setdefault(skey, value)
        self.rw.account_storage_read(addr, key, value, self.tx_id, committed)
        self.spush(value)
        warm = skey in self.warm_slot
        self.rw.tx_access_list_account_storage_write(self.tx_id, addr, key, True, warm)
        self._mirror_last()
        self.warm_slot.add(skey)
        self.rev += 1
        self.gas_left -= WARM_STORAGE_READ_COST if warm else COLD_SLOAD_COST
        self.pc += 1

    def op_sstore(self, op):
        addr = self.callee_address
        self.cc_read(CallContextFieldTag.TxId, self.tx_id)
        self.cc_read(CallContextFieldTag.IsStatic, self.is_static)
        self.reversion_reads()
        self.cc_read(CallContextFieldTag.CalleeAddress, addr)
        key = self.spop()
        value = self.spop()
        skey = (addr, key)
        value_prev = self.storage.get(skey, 0)
        original = self.committed.setdefault(skey, value_prev)
        self.rw.account_storage_write(addr, key, value, value_prev, self.tx_id, original)
        self._mirror_last()
        self.storage[skey] = value
        warm = skey in self.warm_slot
        self.rw.tx_access_list_account_storage_write(self.tx_id, addr, key, True, warm)
        self._mirror_last()
        self.warm_slot.add(skey)

        # EIP-3529 refund schedule (reference storage.py:88-131)
        refund_prev = self.refund
        refund = refund_prev
        if value != value_prev:
            if original == value_prev:
                if original != 0 and value == 0:
                    refund += SSTORE_CLEARS_SCHEDULE
            else:
                if original != 0:
                    if value_prev == 0:
                        refund -= SSTORE_CLEARS_SCHEDULE
                    if value == 0:
                        refund += SSTORE_CLEARS_SCHEDULE
                if original == value:
                    refund += (SSTORE_SET_GAS if original == 0 else SSTORE_RESET_GAS) - SLOAD_GAS
        self.rw.tx_refund_write(self.tx_id, refund, refund_prev)
        self._mirror_last()
        self.refund = refund
        self.rev += 3
        self.gas_left -= _sstore_gas(value, value_prev, original, warm)
        self.pc += 1

    def op_sha3(self, op):
        offset = self.spop()
        length = self.spop()
        data = self._mem_bytes(offset, length)
        self.spush(int.from_bytes(keccak256(data), "big"))
        if length:
            self.w.copy_circuit.copy(
                self.copy_r, self.rw, self.call_id, CopyDataTypeTag.Memory,
                self.call_id, CopyDataTypeTag.RlcAcc, offset, offset + length,
                0, length, {offset + i: data[i] for i in range(length)})
        self.w.sha3_preimages.append(data)
        self._expand_dyn(offset if length else 0, length)
        self._copier_gas(length, GAS_COST_COPY_SHA3)
        self.pc += 1

    def op_exp(self, op):
        base, exponent = self.spop(), self.spop()
        self.spush(pow(base, exponent, 1 << 256))
        if exponent > 1:
            identifier = self.w.steps[-1].rw_counter + 3
            self.w.exp_circuit.add_event(base, exponent, identifier)
        self.gas_left -= GAS_COST_EXP_PER_BYTE * _byte_size(exponent)
        self.pc += 1


def _sstore_gas(value: int, value_prev: int, original: int, warm: bool) -> int:
    """SSTORE's dynamic gas (EIP-2200 with EIP-2929's cold surcharge)."""
    if value == value_prev or value_prev != original:
        gas = SLOAD_GAS
    elif original == 0:
        gas = SSTORE_SET_GAS
    else:
        gas = SSTORE_RESET_GAS
    return gas if warm else gas + COLD_SLOAD_COST


def signextend(i: int, x: int) -> int:
    """SIGNEXTEND: x with the sign bit of its byte i extended (i < 31)."""
    if i >= 31:
        return x
    mask = (1 << (8 * i + 8)) - 1
    return x | (U256M - mask) if (x >> (8 * i + 7)) & 1 else x & mask


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
    Opcode.SAR: _ES.SAR, Opcode.SIGNEXTEND: _ES.SIGNEXTEND,
    Opcode.MLOAD: _ES.MEMORY, Opcode.MSTORE: _ES.MEMORY, Opcode.MSTORE8: _ES.MEMORY,
    Opcode.SLOAD: _ES.SLOAD, Opcode.SSTORE: _ES.SSTORE, Opcode.SHA3: _ES.SHA3,
    Opcode.ADDRESS: _ES.ADDRESS, Opcode.BALANCE: _ES.BALANCE, Opcode.ORIGIN: _ES.ORIGIN,
    Opcode.CALLER: _ES.CALLER, Opcode.CALLVALUE: _ES.CALLVALUE,
    Opcode.CALLDATALOAD: _ES.CALLDATALOAD, Opcode.CALLDATASIZE: _ES.CALLDATASIZE,
    Opcode.CALLDATACOPY: _ES.CALLDATACOPY, Opcode.CODESIZE: _ES.CODESIZE,
    Opcode.CODECOPY: _ES.CODECOPY, Opcode.GASPRICE: _ES.GASPRICE,
    Opcode.EXTCODESIZE: _ES.EXTCODESIZE, Opcode.EXTCODECOPY: _ES.EXTCODECOPY,
    Opcode.EXTCODEHASH: _ES.EXTCODEHASH, Opcode.RETURNDATASIZE: _ES.RETURNDATASIZE,
    Opcode.RETURNDATACOPY: _ES.RETURNDATACOPY, Opcode.BLOCKHASH: _ES.BLOCKHASH,
    Opcode.COINBASE: _ES.BlockCtx, Opcode.TIMESTAMP: _ES.BlockCtx, Opcode.NUMBER: _ES.BlockCtx,
    Opcode.GASLIMIT: _ES.BlockCtx, Opcode.PREVRANDAO: _ES.BlockCtx,
    Opcode.BASEFEE: _ES.BlockCtx, Opcode.CHAINID: _ES.BlockCtx,
    Opcode.SELFBALANCE: _ES.SELFBALANCE,
    Opcode.JUMP: _ES.JUMP, Opcode.JUMPI: _ES.JUMPI, Opcode.PC: _ES.PC,
    Opcode.MSIZE: _ES.MSIZE, Opcode.GAS: _ES.GAS, Opcode.JUMPDEST: _ES.JUMPDEST,
    Opcode.LOG0: _ES.LOG, Opcode.LOG1: _ES.LOG, Opcode.LOG2: _ES.LOG, Opcode.LOG3: _ES.LOG,
    Opcode.LOG4: _ES.LOG,
    Opcode.RETURN: _ES.RETURN, Opcode.REVERT: _ES.RETURN,
    Opcode.CALL: _ES.CALL_OP, Opcode.CALLCODE: _ES.CALL_OP, Opcode.DELEGATECALL: _ES.CALL_OP,
    Opcode.STATICCALL: _ES.CALL_OP,
    Opcode.CREATE: _ES.CREATE, Opcode.CREATE2: _ES.CREATE2,
}
for _i in range(1, 17):
    _STATE_BY_OPCODE[Opcode[f"DUP{_i}"]] = _ES.DUP
    _STATE_BY_OPCODE[Opcode[f"SWAP{_i}"]] = _ES.SWAP

_LOG_OPS = (Opcode.LOG0, Opcode.LOG1, Opcode.LOG2, Opcode.LOG3, Opcode.LOG4)
_CALL_OPS = (Opcode.CALL, Opcode.CALLCODE, Opcode.DELEGATECALL, Opcode.STATICCALL)
_HANDLERS = {
    Opcode.STOP: _Tracer.op_stop, Opcode.POP: _Tracer.op_pop,
    Opcode.ADDMOD: _Tracer.op_mod3, Opcode.MULMOD: _Tracer.op_mod3,
    Opcode.EXP: _Tracer.op_exp, Opcode.SIGNEXTEND: _Tracer.op_signextend,
    Opcode.MLOAD: _Tracer.op_memory, Opcode.MSTORE: _Tracer.op_memory,
    Opcode.MSTORE8: _Tracer.op_memory, Opcode.MSIZE: _Tracer.op_msize,
    Opcode.SLOAD: _Tracer.op_sload, Opcode.SSTORE: _Tracer.op_sstore,
    Opcode.SHA3: _Tracer.op_sha3,
    Opcode.GAS: _Tracer.op_gas, Opcode.PC: _Tracer.op_pc, Opcode.JUMPDEST: _Tracer.op_jumpdest,
    Opcode.JUMP: _Tracer.op_jump, Opcode.JUMPI: _Tracer.op_jumpi,
    Opcode.ADDRESS: _Tracer.op_address, Opcode.CALLER: _Tracer.op_caller,
    Opcode.CALLVALUE: _Tracer.op_callvalue, Opcode.CALLDATASIZE: _Tracer.op_calldatasize,
    Opcode.CALLDATALOAD: _Tracer.op_calldataload, Opcode.CALLDATACOPY: _Tracer.op_calldatacopy,
    Opcode.RETURNDATASIZE: _Tracer.op_returndatasize,
    Opcode.RETURNDATACOPY: _Tracer.op_returndatacopy,
    Opcode.CODESIZE: _Tracer.op_codesize, Opcode.CODECOPY: _Tracer.op_codecopy,
    Opcode.GASPRICE: _Tracer.op_gasprice, Opcode.ORIGIN: _Tracer.op_origin,
    Opcode.SELFBALANCE: _Tracer.op_selfbalance, Opcode.BLOCKHASH: _Tracer.op_blockhash,
    Opcode.BALANCE: _Tracer.op_balance, Opcode.EXTCODESIZE: _Tracer.op_extcodesize,
    Opcode.EXTCODECOPY: _Tracer.op_extcodecopy, Opcode.EXTCODEHASH: _Tracer.op_extcodehash,
    **{_o: _Tracer.op_log for _o in _LOG_OPS},
    Opcode.RETURN: _Tracer.op_return_revert, Opcode.REVERT: _Tracer.op_return_revert,
    **{_o: _Tracer.op_callop for _o in _CALL_OPS},
    Opcode.CREATE: _Tracer.op_create, Opcode.CREATE2: _Tracer.op_create,
}

# -- hot-path dispatch tables: 256-entry arrays indexed by the raw byte ------
_OP_BY_RAW: List[Optional[Opcode]] = [None] * 256
_MIN_SP = [0] * 256
_MAX_SP = [1024] * 256
_CONST_GAS = [0] * 256
_STATE: List[Optional[ExecutionState]] = [None] * 256
_HANDLER: List[Optional[object]] = [None] * 256
# raw bytes with a per-opcode dynamic check in _detect_error
_HAS_DYNAMIC_CHECK = [False] * 256
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
        if _o in _HANDLERS:
            _HANDLER[_raw] = _HANDLERS[_o]
        elif Opcode.DUP1 <= _o <= Opcode.DUP16:
            _HANDLER[_raw] = _Tracer.op_dup
        elif Opcode.SWAP1 <= _o <= Opcode.SWAP16:
            _HANDLER[_raw] = _Tracer.op_swap
        elif _STATE[_raw] is _ES.BlockCtx:
            _HANDLER[_raw] = _Tracer.op_blockctx
        else:
            _HANDLER[_raw] = _Tracer.op_alu
for _o in (Opcode.JUMP, Opcode.JUMPI, Opcode.BALANCE, Opcode.EXTCODESIZE, Opcode.EXTCODEHASH,
           Opcode.MLOAD, Opcode.MSTORE, Opcode.MSTORE8, Opcode.CALLDATACOPY, Opcode.CODECOPY,
           Opcode.EXTCODECOPY, Opcode.RETURNDATACOPY, Opcode.SLOAD, Opcode.SSTORE, *_LOG_OPS,
           Opcode.EXP, Opcode.SHA3, Opcode.RETURN, Opcode.REVERT, Opcode.CREATE, Opcode.CREATE2,
           *_CALL_OPS):
    _HAS_DYNAMIC_CHECK[int(_o)] = True


def _derive_tx_key(tx_id: int) -> int:
    """The deterministic secp256k1 secret key of tx ``tx_id`` (the traced
    block's senders are real key pairs, as in the reference's tests that
    sign with eth_keys, tests/test_tx_circuit.py)."""
    from ..ops.ecc import secp256k1

    sk = int.from_bytes(keccak256(b"zkevm-specs-tpu tx key #%d" % tx_id), "big") % secp256k1.N
    return sk or 1


def tx_sender_address(tx_id: int) -> int:
    """The address of tx ``tx_id``'s key, keccak(pk)[-20:] (reference
    tx_circuit.py:341-349)."""
    from ..ops.ecc import secp256k1

    pk = secp256k1.priv_to_pub(_derive_tx_key(tx_id))
    return int.from_bytes(keccak256(secp256k1.pubkey_bytes(pk))[-20:], "big")


def sign_block_txs(w: BlockWitness) -> None:
    """Sign every tx of a traced witness with its deterministic key and
    attach ``signed_txs``, so that the tx and sig circuits run on the block
    (reference tx_circuit.py:253-291 verifies real ECDSA for every tx).
    The tracer has already set each caller to its key's address, so the tx
    circuit's recovered-address constraint binds the signatures to the
    EVM-side tx table."""
    from ..circuits.tx import Transaction as SignedTx, sign_tx

    signed = []
    for tx in w.txs:
        stx = SignedTx(nonce=tx.nonce, gas_price=tx.gas_price, gas=tx.gas,
                       to=tx.callee_address, value=tx.value, data=bytes(tx.call_data),
                       sig_v=0, sig_r=0, sig_s=0)
        signed.append(sign_tx(_derive_tx_key(tx.id), stx, w.chain_id))
        assert tx_sender_address(tx.id) == tx.caller_address, (
            "signed-tx sender does not match the traced caller address")
    w.signed_txs = signed


def trace_block(
    block: Block,
    txs: List[Tuple[Transaction, Bytecode]],
    caller_balance: int = 10**21,
    withdrawals: Optional[List] = None,
    accounts: Optional[Dict[int, Account]] = None,
    sign: bool = True,
) -> BlockWitness:
    """Execute txs (each a call to a contract with the given bytecode) and
    emit the full witness, as the JAX ``trace_block`` does: two passes (the
    frame-outcome oracle, then the replay with the prologue budget
    reserved), EndBlock, the rw table's Start padding row and the
    call-context setup prologue at rw counters 1..11*n_txs (verified
    in-circuit by ``circuits/super_circuit.py``).

    With ``sign`` (the default) each tx's caller becomes the address of its
    deterministic key before tracing (``tx_sender_address``; the txs are
    changed in place, as in the JAX package), an ``accounts`` entry pinned
    to the old sender follows it, and the traced txs are signed into
    ``signed_txs`` for the tx and sig circuits."""
    if sign:
        for tx, _bc in txs:
            old = tx.caller_address
            tx.caller_address = tx_sender_address(tx.id)
            if accounts and old in accounts and tx.caller_address not in accounts:
                acct = accounts.pop(old)
                acct.address = tx.caller_address
                accounts[tx.caller_address] = acct
    if withdrawals:
        # chain the mock MPT withdrawal roots up front so the block table's
        # WithdrawalRoot matches the withdrawal circuit's final root
        block.withdrawal_root = 7 * sum(1 for wd in withdrawals if wd.amount)

    curve_results: dict = {}

    def run(start: int, outcomes=None) -> _Tracer:
        tracer = _Tracer(block, start, accounts, outcomes, curve_results)
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
    for setup in w.subcall_setups:
        for i, (callee_id, tag, value) in enumerate(setup):
            if isinstance(value, dict):
                setup[i] = (callee_id, tag, _resolve_anchor(value))

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
    # frames, then one write a sub-call context key, then one memory write
    # a byte of the precompiles' outputs ---
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
    for setup in w.subcall_setups:
        for callee_id, tag, value in setup:
            prologue.call_context_write(callee_id, tag, value)
    for callee_id, addr, byte in w.memory_setups:
        prologue.memory_write(callee_id, addr, byte)
    assert prologue.rw_counter == start + n_setup_rows
    w.rw.rws = start_rows + prologue.rws + w.rw.rws

    w.withdrawals = list(withdrawals or [])
    if not w.copy_circuit.rows:
        w.copy_circuit = None
    if not w.exp_circuit.rows:
        w.exp_circuit = None
    if sign:
        sign_block_txs(w)
    return w
