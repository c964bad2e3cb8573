"""Host-side witness rows (the part the ported paths need).

``Block``, ``Transaction``, ``Withdrawal``, ``Bytecode``, ``Account``,
``RWDictionary``, ``KeccakCircuit``, ``ExpCircuit`` and ``CopyCircuit`` emit plain row dicts (Python ints,
words as ints < 2^256) that feed the columnar ``Tables``; they are copies
of the JAX package's classes of the same names (reference:
src/zkevm_specs/evm_circuit/typing.py:64-845).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from ..ops.fr import P
from ..ops.keccak import EMPTY_HASH, keccak256
from ..tables.schemas import (
    RW,
    AccountFieldTag,
    BlockContextFieldTag,
    BytecodeFieldTag,
    CallContextFieldTag,
    CopyDataTypeTag,
    Target,
    TxContextFieldTag,
    TxLogFieldTag,
    TxReceiptFieldTag,
)
from ..utils.param import (
    GAS_COST_ACCESS_LIST_ADDRESS,
    GAS_COST_ACCESS_LIST_STORAGE,
    GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE,
    GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE,
)
from .rlc import RLC, linear_combine_bytes

POW2 = 2**256


def _opcode_mod():
    # deferred to avoid a circular import through the evm package __init__
    from ..evm import opcode as m

    return m


_U256_LIMIT = 1 << 256


def _to_int(v) -> int:
    """Witness values are raw ints (words up to 2^256); field reduction only
    happens on circuit-side tensors, never on stored witness rows."""
    if type(v) is int:
        if 0 <= v < _U256_LIMIT:
            return v
        assert v == -1
        return P - 1
    if isinstance(v, RLC):
        return v.int_value
    v = int(v)
    assert -1 <= v < _U256_LIMIT
    return v % P if v < 0 else v


class Block:
    def __init__(
        self,
        coinbase: int = 0x10,
        gas_limit: int = int(15e6),
        number: int = 0,
        timestamp: int = 0,
        prev_randao: int = 0,
        base_fee: int = int(1e9),
        chainid: int = 0x01,
        withdrawal_root: int = 0,
        history_hashes: Sequence[int] = (),
    ):
        assert len(history_hashes) <= min(256, number)
        self.coinbase = coinbase
        self.gas_limit = gas_limit
        self.number = number
        self.timestamp = timestamp
        self.prev_randao = prev_randao
        self.base_fee = base_fee
        self.chainid = chainid
        self.withdrawal_root = withdrawal_root
        self.history_hashes = list(history_hashes)

    def table_assignments(self) -> List[dict]:
        T = BlockContextFieldTag
        rows = [
            {"field_tag": T.Coinbase, "block_number_or_zero": 0, "value": self.coinbase},
            {"field_tag": T.GasLimit, "block_number_or_zero": 0, "value": self.gas_limit},
            {"field_tag": T.Number, "block_number_or_zero": 0, "value": self.number},
            {"field_tag": T.Timestamp, "block_number_or_zero": 0, "value": self.timestamp},
            {"field_tag": T.PrevRandao, "block_number_or_zero": 0, "value": self.prev_randao},
            {"field_tag": T.BaseFee, "block_number_or_zero": 0, "value": self.base_fee},
            {"field_tag": T.ChainId, "block_number_or_zero": 0, "value": self.chainid},
            {"field_tag": T.WithdrawalRoot, "block_number_or_zero": 0, "value": self.withdrawal_root},
        ]
        for idx, history_hash in enumerate(reversed(self.history_hashes)):
            rows.append(
                {
                    "field_tag": T.HistoryHash,
                    "block_number_or_zero": self.number - idx - 1,
                    "value": history_hash,
                }
            )
        return rows


class AccessTuple:
    def __init__(self, address: int, storage_keys: List[int]):
        self.address = address
        self.storage_keys = storage_keys


class Transaction:
    def __init__(
        self,
        id: int = 1,
        nonce: int = 0,
        gas: int = 21000,
        gas_price: int = int(2e9),
        caller_address: int = 0xCAFE,
        callee_address: Optional[int] = None,
        value: int = 0,
        call_data: bytes = bytes(),
        invalid_tx: int = 0,
        access_list: Optional[List[AccessTuple]] = None,
    ):
        self.id = id
        self.nonce = nonce
        self.gas = gas
        self.gas_price = gas_price
        self.caller_address = caller_address
        self.callee_address = callee_address
        self.value = value
        self.call_data = call_data
        self.invalid_tx = invalid_tx
        self.access_list = access_list or []

    def call_data_gas_cost(self) -> int:
        return sum(
            GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE if b == 0
            else GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE
            for b in self.call_data
        )

    def access_list_gas_cost(self) -> int:
        return sum(
            GAS_COST_ACCESS_LIST_ADDRESS + len(a.storage_keys) * GAS_COST_ACCESS_LIST_STORAGE
            for a in self.access_list
        )

    def table_assignments(self) -> List[dict]:
        T = TxContextFieldTag

        def row(tag, value, index=0):
            return {"tx_id": self.id, "field_tag": tag,
                    "call_data_index_or_zero": index, "value": _to_int(value)}

        return [
            row(T.Nonce, self.nonce),
            row(T.Gas, self.gas),
            row(T.GasPrice, self.gas_price),
            row(T.CallerAddress, self.caller_address),
            row(T.CalleeAddress, 0 if self.callee_address is None else self.callee_address),
            row(T.IsCreate, int(self.callee_address is None)),
            row(T.Value, self.value),
            row(T.CallDataLength, len(self.call_data)),
            row(T.CallDataGasCost, self.call_data_gas_cost()),
            row(T.TxInvalid, self.invalid_tx),
            row(T.AccessListGasCost, self.access_list_gas_cost()),
            row(T.TxSignHash, 1234),  # mock, as in reference typing.py:265
        ] + [row(T.CallData, byte, idx) for idx, byte in enumerate(self.call_data)]


class Withdrawal:
    def __init__(self, id: int = 0, validator_id: int = 0, address: int = 0xCAFE,
                 amount: int = int(1e9)):
        self.id = id
        self.validator_id = validator_id
        self.address = address
        self.amount = amount


def init_is_code(code: bytearray) -> List[bool]:
    is_codes = []
    push_data_left = 0
    for b in code:
        is_code = push_data_left == 0
        push_data_left = _opcode_mod().get_push_size(b) if is_code else push_data_left - 1
        is_codes.append(is_code)
    return is_codes


class Bytecode:
    """Opcode-DSL bytecode builder: Bytecode().add(a, b).stop() etc.
    (reference typing.py:327-427)."""

    def __init__(self, code: Optional[bytearray] = None, is_code: Optional[List[bool]] = None):
        self.code = bytearray() if code is None else code
        self.is_code = init_is_code(self.code) if is_code is None else is_code

    def __getattr__(self, name: str):
        def method(*args) -> "Bytecode":
            Opcode = _opcode_mod().Opcode
            try:
                opcode = Opcode[name.rstrip("_").upper()]
            except KeyError:
                raise ValueError(f"Invalid opcode {name}")
            if Opcode.PUSH1 <= opcode <= Opcode.PUSH32:
                assert len(args) == 1
                self.push(args[0], int(opcode) - int(Opcode.PUSH0))
            elif Opcode.DUP1 <= opcode <= Opcode.DUP16 or Opcode.SWAP1 <= opcode <= Opcode.SWAP16:
                assert len(args) == 0
                self.code.append(opcode)
                self.is_code.append(True)
            else:
                assert len(args) <= 1024 - _opcode_mod().max_stack_pointer(opcode)
                for arg in reversed(args):
                    self.push(arg)
                self.code.append(opcode)
                self.is_code.append(True)
            return self

        return method

    def push(self, value, n_bytes: int = 32) -> "Bytecode":
        if isinstance(value, int):
            value = value.to_bytes(n_bytes, "big")
        elif isinstance(value, str):
            value = bytes.fromhex(value.lower().removeprefix("0x"))
        elif isinstance(value, RLC):
            value = bytes(reversed(value.le_bytes))
        elif isinstance(value, (bytes, bytearray)):
            pass
        else:
            raise NotImplementedError(f"Value of type {type(value)} is not yet supported")
        assert 0 <= len(value) <= n_bytes
        self.code.append(int(_opcode_mod().Opcode.PUSH0) + n_bytes)
        self.is_code.append(True)
        self.code.extend(bytes(value).rjust(n_bytes, b"\x00"))
        self.is_code.extend([False] * n_bytes)
        return self

    def hash(self) -> int:
        return int.from_bytes(keccak256(bytes(self.code)), "big")

    def table_assignments(self) -> List[dict]:
        h = self.hash()
        rows = [
            {
                "bytecode_hash": h,
                "field_tag": BytecodeFieldTag.Header,
                "index": 0,
                "is_code": 0,
                "value": len(self.code),
            }
        ]
        for idx, (byte, is_code) in enumerate(zip(self.code, self.is_code)):
            rows.append(
                {
                    "bytecode_hash": h,
                    "field_tag": BytecodeFieldTag.Byte,
                    "index": idx,
                    "is_code": int(is_code),
                    "value": byte,
                }
            )
        return rows


class Account:
    def __init__(self, address: int = 0, nonce: int = 0, balance: int = 0,
                 code: Optional["Bytecode"] = None, storage: Optional[Dict[int, int]] = None):
        self.address = address
        self.nonce = nonce
        self.balance = balance
        self.code = Bytecode() if code is None else code
        self.storage = storage or {}

    def code_hash(self) -> int:
        return self.code.hash()

    def is_empty(self) -> bool:
        return self.nonce == 0 and self.balance == 0 and self.code_hash() == EMPTY_HASH


class RWDictionary:
    """Fluent builder of rw-table rows with auto rw_counter
    (reference typing.py:464-845)."""

    def __init__(self, rw_counter: int):
        self.rw_counter = rw_counter
        self.rws: List[dict] = []

    def _append(self, rw: RW, tag: Target, id=0, address=0, field_tag=0,
                storage_key=0, value=0, value_prev=0, aux0=0,
                rw_counter: Optional[int] = None) -> "RWDictionary":
        if rw_counter is None:
            rw_counter = self.rw_counter
            self.rw_counter += 1
        self.rws.append(
            {
                "rw_counter": rw_counter,
                "rw": int(rw),
                "key0": int(tag),
                "id": _to_int(id),
                "address": _to_int(address),
                "field_tag": _to_int(field_tag),
                "storage_key": _to_int(storage_key),
                "value": _to_int(value),
                "value_prev": _to_int(value_prev),
                "aux0": _to_int(aux0),
            }
        )
        return self

    def _state_write(self, tag: Target, id=0, address=0, field_tag=0, storage_key=0,
                     value=0, value_prev=0, aux0=0,
                     rw_counter_of_reversion: Optional[int] = None) -> "RWDictionary":
        self._append(RW.Write, tag, id, address, field_tag, storage_key, value, value_prev, aux0)
        if rw_counter_of_reversion is None:
            return self
        return self._append(RW.Write, tag, id, address, field_tag, storage_key,
                            value_prev, value, aux0, rw_counter=rw_counter_of_reversion)

    def stack_read(self, call_id, stack_pointer, value) -> "RWDictionary":
        return self._append(RW.Read, Target.Stack, id=call_id, address=stack_pointer, value=value)

    def stack_write(self, call_id, stack_pointer, value) -> "RWDictionary":
        return self._append(RW.Write, Target.Stack, id=call_id, address=stack_pointer, value=value)

    def memory_read(self, call_id, memory_address, byte) -> "RWDictionary":
        return self._append(RW.Read, Target.Memory, id=call_id, address=memory_address,
                            value=byte)

    def memory_write(self, call_id, memory_address, byte) -> "RWDictionary":
        return self._append(RW.Write, Target.Memory, id=call_id, address=memory_address,
                            value=byte)

    def call_context_read(self, call_id, field_tag: CallContextFieldTag, value) -> "RWDictionary":
        return self._append(RW.Read, Target.CallContext, id=call_id, address=int(field_tag),
                            value=value)

    def call_context_write(self, call_id, field_tag: CallContextFieldTag, value) -> "RWDictionary":
        return self._append(RW.Write, Target.CallContext, id=call_id, address=int(field_tag),
                            value=value)

    def tx_log_write(self, tx_id, log_id: int, field_tag: TxLogFieldTag, index,
                     value) -> "RWDictionary":
        return self._append(RW.Write, Target.TxLog, id=tx_id,
                            address=int(index) + (int(field_tag) << 32) + (int(log_id) << 48),
                            value=value)

    def tx_receipt_read(self, tx_id, field_tag: TxReceiptFieldTag, value) -> "RWDictionary":
        return self._append(RW.Read, Target.TxReceipt, id=tx_id, field_tag=int(field_tag),
                            value=value)

    def tx_receipt_write(self, tx_id, field_tag: TxReceiptFieldTag, value) -> "RWDictionary":
        return self._append(RW.Write, Target.TxReceipt, id=tx_id, field_tag=int(field_tag),
                            value=value)

    def tx_refund_read(self, tx_id, refund) -> "RWDictionary":
        return self._append(RW.Read, Target.TxRefund, id=tx_id, value=refund, value_prev=refund)

    def tx_refund_write(self, tx_id, refund, refund_prev,
                        rw_counter_of_reversion: Optional[int] = None) -> "RWDictionary":
        return self._state_write(Target.TxRefund, id=tx_id, value=refund, value_prev=refund_prev,
                                 rw_counter_of_reversion=rw_counter_of_reversion)

    def tx_access_list_account_write(self, tx_id, account_address, value: bool, value_prev: bool,
                                     rw_counter_of_reversion: Optional[int] = None) -> "RWDictionary":
        return self._state_write(Target.TxAccessListAccount, id=tx_id, address=account_address,
                                 value=int(value), value_prev=int(value_prev),
                                 rw_counter_of_reversion=rw_counter_of_reversion)

    def tx_access_list_account_read(self, tx_id, account_address, value: bool) -> "RWDictionary":
        return self._append(RW.Read, Target.TxAccessListAccount, id=tx_id,
                            address=account_address, value=int(value), value_prev=int(value))

    def tx_access_list_account_storage_read(self, tx_id, account_address, storage_key,
                                            value: bool) -> "RWDictionary":
        return self._append(RW.Read, Target.TxAccessListAccountStorage, id=tx_id,
                            address=account_address, storage_key=storage_key, value=int(value),
                            value_prev=int(value))

    def tx_access_list_account_storage_write(self, tx_id, account_address, storage_key,
                                             value: bool, value_prev: bool,
                                             rw_counter_of_reversion: Optional[int] = None
                                             ) -> "RWDictionary":
        return self._state_write(Target.TxAccessListAccountStorage, id=tx_id,
                                 address=account_address, storage_key=storage_key,
                                 value=int(value), value_prev=int(value_prev),
                                 rw_counter_of_reversion=rw_counter_of_reversion)

    def account_read(self, account_address, field_tag: AccountFieldTag, value) -> "RWDictionary":
        return self._append(RW.Read, Target.Account, address=account_address,
                            field_tag=int(field_tag), value=value, value_prev=value)

    def account_write(self, account_address, field_tag: AccountFieldTag, value, value_prev,
                      rw_counter_of_reversion: Optional[int] = None) -> "RWDictionary":
        return self._state_write(Target.Account, address=account_address,
                                 field_tag=int(field_tag), value=value, value_prev=value_prev,
                                 rw_counter_of_reversion=rw_counter_of_reversion)


    def account_storage_read(self, account_address, storage_key, value, tx_id,
                             value_committed) -> "RWDictionary":
        return self._append(RW.Read, Target.AccountStorage, id=tx_id, address=account_address,
                            storage_key=storage_key, value=value, value_prev=value,
                            aux0=value_committed)

    def account_storage_write(self, account_address, storage_key, value, value_prev, tx_id,
                              value_committed, rw_counter_of_reversion: Optional[int] = None
                              ) -> "RWDictionary":
        return self._state_write(Target.AccountStorage, id=tx_id, address=account_address,
                                 storage_key=storage_key, value=value, value_prev=value_prev,
                                 aux0=value_committed,
                                 rw_counter_of_reversion=rw_counter_of_reversion)


class KeccakCircuit:
    """Rows of the keccak table: one finalised hash per input (the JAX
    package's ``witness/typing.py:485-498``)."""

    def __init__(self) -> None:
        self.rows: List[dict] = []

    def add(self, data: bytes, r: int) -> "KeccakCircuit":
        self.rows.append(
            {
                "state_tag": 2,  # Finalize
                "input_rlc": linear_combine_bytes(bytes(reversed(data)), r, range_check=False),
                "input_len": len(data),
                "output": int.from_bytes(keccak256(data), "big"),
            }
        )
        return self


class ExpCircuit:
    """Exponentiation-by-squaring witness trace (the JAX package's
    ``witness/typing.py:501-574``; reference typing.py:868-994): one row per
    squaring or multiplying step of each EXP event, the event's last step
    (exponent 2) marked ``is_last``."""

    OFFSET_INCREMENT = 7

    def __init__(self, max_exp_steps: int = 100) -> None:
        self.rows: List[dict] = []
        self.max_exp_steps = max_exp_steps

    def table(self) -> List[dict]:
        return self.rows

    def add_event(self, base: int, exponent: int, identifier: int) -> "ExpCircuit":
        steps: List[Tuple[int, int, int]] = []
        self._exp_by_squaring(base, exponent, steps)
        steps.reverse()
        self._append_steps(base, exponent, steps, identifier)
        return self

    def _exp_by_squaring(self, base: int, exponent: int, steps):
        if exponent == 0:
            return 1
        if exponent == 1:
            return base
        exp1 = self._exp_by_squaring(base, exponent // 2, steps)
        exp2 = (exp1 * exp1) % POW2
        steps.append((exp1, exp1, exp2))
        if exponent % 2 == 0:
            return exp2
        exp = (base * exp2) % POW2
        steps.append((exp2, base, exp))
        return exp

    def _append_steps(self, base: int, exponent: int, steps, identifier: int):
        for i, (a, b, d) in enumerate(steps):
            quotient, is_odd = divmod(exponent, 2)
            self.rows.append({
                "q_usable": 1, "is_step": 1, "identifier": _to_int(identifier),
                "is_last": 1 if i == len(steps) - 1 else 0,
                "base": base, "exponent": exponent, "exponentiation": d,
                "a": a, "b": b, "c": 0, "d": d, "q": quotient, "r": is_odd,
            })
            exponent = exponent // 2 if is_odd == 0 else exponent - 1

    def fill_dummy_events(self) -> "ExpCircuit":
        """Pad to ``max_exp_steps * OFFSET_INCREMENT`` rows with disabled
        (``is_step`` 0) rows."""
        for _ in range(self.max_exp_steps * self.OFFSET_INCREMENT - len(self.rows)):
            self.rows.append({
                "q_usable": 1, "is_step": 0, "identifier": 0, "is_last": 0,
                "base": 1, "exponent": 1, "exponentiation": 1,
                "a": 1, "b": 1, "c": 0, "d": 1, "q": 0, "r": 1,
            })
        return self


class CopyCircuit:
    """Paired read/write copy-event rows (reference typing.py:997-1151; the
    JAX package's ``witness/typing.py:572-664``)."""

    def __init__(self, pad_rows: Optional[List[dict]] = None) -> None:
        self.rows: List[dict] = []
        self.pad_rows: List[dict] = pad_rows or []

    def table(self) -> List[dict]:
        return self.rows + self.pad_rows

    def copy(self, r: int, rw_dict: RWDictionary, src_id, src_tag: CopyDataTypeTag,
             dst_id, dst_tag: CopyDataTypeTag, src_addr: int, src_addr_end: int,
             dst_addr: int, copy_length: int,
             src_data: Mapping[int, Union[int, Tuple[int, int]]],
             log_id: int = 0) -> "CopyCircuit":
        """One copy event: a read row and a write row a byte, the source's
        memory and log rows emitted into ``rw_dict`` as they are read and
        written; an RlcAcc destination accumulates the bytes' RLC by r."""
        new_rows: List[dict] = []
        rlc_acc = 0
        for i in range(int(copy_length)):
            if int(src_addr + i) < int(src_addr_end):
                is_pad = False
                assert src_addr + i in src_data, f"Cannot find data at the offset {src_addr + i}"
                value = src_data[src_addr + i]
                if src_tag == CopyDataTypeTag.Bytecode or dst_tag == CopyDataTypeTag.Bytecode:
                    value, is_code = value
                else:
                    is_code = 0
            else:
                is_pad = True
                value = 0
                is_code = 0
            self._append_row(new_rows, rw_dict, False, i == 0, False, src_id, src_tag,
                             src_addr + i, value, 0, is_code, is_pad,
                             src_addr_end=src_addr_end, bytes_left=copy_length - i)
            if dst_tag == CopyDataTypeTag.RlcAcc:
                rlc_acc = (rlc_acc * r + _to_int(value)) % P
            self._append_row(new_rows, rw_dict, True, False, i == copy_length - 1, dst_id,
                             dst_tag, dst_addr + i,
                             rlc_acc if dst_tag == CopyDataTypeTag.RlcAcc else value,
                             0, is_code, False, log_id=log_id)
        rw_counter = rw_dict.rw_counter
        for row in new_rows:
            row["rwc_inc_left"] = rw_counter - row["rw_counter"]
            if dst_tag == CopyDataTypeTag.RlcAcc:
                row["rlc_acc"] = rlc_acc
        self.rows.extend(new_rows)
        return self

    def _append_row(self, rows, rw_dict: RWDictionary, is_write: bool, is_first: bool,
                    is_last: bool, id, tag: CopyDataTypeTag, addr, value, rlc_acc,
                    is_code, is_pad: bool, src_addr_end=0, bytes_left=0, log_id: int = 0):
        is_memory = tag == CopyDataTypeTag.Memory
        is_tx_log = tag == CopyDataTypeTag.TxLog
        rw_counter = rw_dict.rw_counter
        if is_memory:
            if is_write:
                rw_dict.memory_write(_to_int(id), addr, value)
            elif not is_pad:
                rw_dict.memory_read(_to_int(id), addr, value)
        elif is_tx_log:
            assert is_write
            rw_dict.tx_log_write(_to_int(id), log_id, TxLogFieldTag.Data, addr, value)
            addr = int(addr) + (int(TxLogFieldTag.Data) << 32) + (log_id << 48)
        rows.append({
            "q_step": int(not is_write),
            "is_first": int(is_first),
            "is_last": int(is_last),
            "id": _to_int(id),
            "tag": int(tag),
            "addr": _to_int(addr),
            "src_addr_end": _to_int(src_addr_end),
            "bytes_left": _to_int(bytes_left),
            "value": _to_int(value),
            "rlc_acc": _to_int(rlc_acc),
            "is_code": _to_int(is_code),
            "is_pad": int(is_pad),
            "rw_counter": rw_counter,
            "rwc_inc_left": 0,  # back-patched by copy()
            "is_memory": int(is_memory),
            "is_bytecode": int(tag == CopyDataTypeTag.Bytecode),
            "is_tx_calldata": int(tag == CopyDataTypeTag.TxCalldata),
            "is_tx_log": int(is_tx_log),
            "is_rlc_acc": int(tag == CopyDataTypeTag.RlcAcc),
        })


def copy_circuit_to_table(copy_circuit: CopyCircuit) -> List[dict]:
    """Copy-table rows from the circuit's first read row of each event and
    the write row after it (reference table.py:627-652)."""
    rows = copy_circuit.table()
    out = []
    for i, row in enumerate(rows):
        if row["is_first"] == 1:
            assert i + 1 < len(rows), "Not enough rows in copy circuit"
            nxt = rows[i + 1]
            assert nxt["q_step"] == 0, "Invalid copy circuit"
            out.append({
                "is_first": row["is_first"],
                "src_id": row["id"],
                "src_tag": row["tag"],
                "dst_id": nxt["id"],
                "dst_tag": nxt["tag"],
                "src_addr": row["addr"],
                "src_addr_end": row["src_addr_end"],
                "dst_addr": nxt["addr"],
                "length": row["bytes_left"],
                "rlc_acc": row["rlc_acc"],
                "rw_counter": row["rw_counter"],
                "rwc_inc": row["rwc_inc_left"],
            })
    return out


def exp_circuit_to_table(exp_circuit: ExpCircuit) -> List[dict]:
    """The exp-table rows of an exp circuit (the JAX package's
    ``witness/typing.py:694-712``; reference table.py:654-671)."""
    out = []
    for row in exp_circuit.table():
        base = row["base"]
        out.append({
            "is_step": 1, "identifier": row["identifier"], "is_last": row["is_last"],
            "base_limb0": base & ((1 << 64) - 1),
            "base_limb1": (base >> 64) & ((1 << 64) - 1),
            "base_limb2": (base >> 128) & ((1 << 64) - 1),
            "base_limb3": (base >> 192) & ((1 << 64) - 1),
            "exponent": row["exponent"], "exponentiation": row["exponentiation"],
        })
    return out
