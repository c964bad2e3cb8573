"""Public-inputs circuit: every public value of a block in one byte column
with a running keccak RLC, per-value linear combinations and the calldata
gas-cost accumulators (reference: src/zkevm_specs/pi_circuit.py:1-1077).

Counterpart of ``zkevm_specs_tpu/circuits/pi.py``.  The witness generator
(``public_data2witness``) mirrors it byte for byte, the test randomness
pinned to 255 included (reference :834-836), and the digest is the host
keccak of the byte column.  The row gates are one batched pass over all
rows (``check_pi``); on the card (``pi_kernel``, a ``CircuitKernel``) the
field products and sums run on K1 and K3, and the keccak and calldata-gas
lookups are fingerprint searches (K6).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F, Word
from ..ops import limbs as L
from ..ops.fr import P
from ..ops.keccak import keccak256
from ..tables.engine import Col, Schema, Table
from ..tables.schemas import KECCAK_SCHEMA
from ..tables.schemas import TxContextFieldTag as TxTag
from ..utils.param import (
    GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE,
    GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE,
    N_BYTES_WORD,
    PUBLIC_INPUTS_BLOCK_LEN as BLOCK_LEN,
    PUBLIC_INPUTS_TX_LEN as TX_LEN,
)
from ..utils.typing import is_circuit_code
from ..witness.rlc import RLC

N_BYTES_ONE = 1
N_BYTES_U64 = 8
N_BYTES_TX = 176
N_BYTES_WITHDRAWAL = 56
N_BYTES_BLOCK = 20 + 8 + 8 + 8 + 32 + 32 + 8 + 32 + 32 * 256
N_BYTES_EXTRA_VALUE = N_BYTES_WORD * 3

# test randomness pinned like the reference (pi_circuit.py:834-836); a
# constant, not the block's keccak randomness
byte_pow_base = 255
evm_rand = 255
keccak_rand = 255


@functools.lru_cache(maxsize=1 << 16)
def _inv(x: int) -> int:
    """x's inverse mod p (0 for 0), cached: the witness inverts the same
    small values (tx ids, calldata bytes) row after row."""
    return pow(x % P, P - 2, P) if x % P else 0


def _lo_hi(v: int) -> Tuple[int, int]:
    return v & ((1 << 128) - 1), v >> 128


@dataclass
class Block:
    hash: int
    parent_hash: int
    uncle_hash: int
    coinbase: int
    state_root: int
    tx_hash: int
    receipt_hash: int
    bloom: bytes
    prev_randao: int
    number: int
    gas_limit: int
    gas_used: int
    time: int
    extra: bytes
    mix_digest: int
    nonce: int
    base_fee: int
    withdrawals_root: int


@dataclass
class Transaction:
    nonce: int
    gas_price: int
    gas: int
    from_addr: int
    to_addr: Optional[int]
    value: int
    data: bytes
    tx_sign_hash: int

    @classmethod
    def default(cls):
        return cls(0, 0, 0, 0, 0, 0, bytes(), 0)

    def call_data_gas_cost(self) -> int:
        return sum(GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE if b == 0
                   else GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE for b in self.data)

    def tx_table_value_column(self) -> List[Tuple[int, bool]]:
        """(value, is_word) of each of this tx's tx-table rows."""
        return [
            (self.nonce, False),
            (self.gas, False),
            (self.gas_price, True),
            (self.from_addr, False),
            (self.to_addr or 0, False),
            (1 if self.to_addr is None else 0, False),
            (self.value, True),
            (len(self.data), False),
            (self.call_data_gas_cost(), False),
            (self.tx_sign_hash, True),
        ]

    def tx_raw_bytes(self, tx_id: int) -> List[bytes]:
        out: List[bytes] = []

        def emit(value_lo: bytes, value_hi: bytes = b""):
            out.append(tx_id.to_bytes(8, "big"))
            out.append((0).to_bytes(8, "big"))
            out.append(value_lo)
            if value_hi != b"":
                out.append(value_hi)

        emit(self.nonce.to_bytes(8, "big"))
        emit(self.gas.to_bytes(8, "big"))
        lo, hi = _lo_hi(self.gas_price)
        emit(lo.to_bytes(16, "big"), hi.to_bytes(16, "big"))
        emit(self.from_addr.to_bytes(20, "big"))
        emit((self.to_addr or 0).to_bytes(20, "big"))
        emit((1 if self.to_addr is None else 0).to_bytes(8, "big"))
        lo, hi = _lo_hi(self.value)
        emit(lo.to_bytes(16, "big"), hi.to_bytes(16, "big"))
        emit(len(self.data).to_bytes(8, "big"))
        emit(self.call_data_gas_cost().to_bytes(8, "big"))
        lo, hi = _lo_hi(self.tx_sign_hash)
        emit(lo.to_bytes(16, "big"), hi.to_bytes(16, "big"))
        return out


@dataclass
class Withdrawal:
    id: int
    validator_id: int
    address: int
    amount: int

    @classmethod
    def default(cls):
        return cls(0, 0, 0, 0)

    def withdrawal_raw_bytes(self, id: int) -> List[bytes]:
        lo, hi = _lo_hi(self.address)
        return [id.to_bytes(8, "big"), self.validator_id.to_bytes(8, "big"),
                lo.to_bytes(16, "big"), hi.to_bytes(16, "big"), self.amount.to_bytes(8, "big")]


@dataclass
class PublicData:
    chain_id: int
    block: Block
    state_root_prev: int
    block_hashes: List[int]
    txs: List[Transaction]
    withdrawals: List[Withdrawal]

    def block_table_value_column(self) -> List[Tuple[int, bool]]:
        col = [
            (0, False),
            (self.block.coinbase, False),
            (self.block.gas_limit, False),
            (self.block.number, False),
            (self.block.time, False),
            (self.block.prev_randao, True),
            (self.block.base_fee, True),
            (self.chain_id, False),
            (self.block.withdrawals_root, True),
        ]
        assert len(self.block_hashes) == 256
        return col + [(h, True) for h in self.block_hashes]

    def block_table_raw_byte_values(self) -> List[bytes]:
        out = [(0).to_bytes(1, "big"), self.block.coinbase.to_bytes(20, "big"),
               self.block.gas_limit.to_bytes(8, "big"), self.block.number.to_bytes(8, "big"),
               self.block.time.to_bytes(8, "big")]
        for v in (self.block.prev_randao, self.block.base_fee):
            lo, hi = _lo_hi(v)
            out += [lo.to_bytes(16, "big"), hi.to_bytes(16, "big")]
        out.append(self.chain_id.to_bytes(8, "big"))
        lo, hi = _lo_hi(self.block.withdrawals_root)
        out += [lo.to_bytes(16, "big"), hi.to_bytes(16, "big")]
        assert len(self.block_hashes) == 256
        for h in self.block_hashes:
            lo, hi = _lo_hi(h)
            out += [lo.to_bytes(16, "big"), hi.to_bytes(16, "big")]
        return out

    def tx_table_raw_bytes(self, MAX_TXS: int) -> List[bytes]:
        out = [(0).to_bytes(8, "big"), (0).to_bytes(8, "big"), (0).to_bytes(1, "big")]
        assert 0 < len(self.txs) <= MAX_TXS
        for i in range(MAX_TXS):
            tx = self.txs[i] if i < len(self.txs) else Transaction.default()
            out.extend(tx.tx_raw_bytes(i + 1))
        return out

    def tx_table_calldata_raw_bytes(self, MAX_CALLDATA_BYTES: int) -> List[bytes]:
        out = [b.to_bytes(1, "big") for tx in self.txs for b in tx.data]
        assert len(out) <= MAX_CALLDATA_BYTES
        return out + [(0).to_bytes(1, "big")] * (MAX_CALLDATA_BYTES - len(out))

    def withdrawal_table_raw_bytes(self, MAX_WITHDRAWALS: int) -> List[bytes]:
        # the raw-byte stream commits the withdrawal's own id (the reference
        # substitutes the slot index, pi_circuit.py:625/221, which silently
        # requires ids == 0..n-1; real ids are monotonic but arbitrary)
        out = []
        assert 0 < len(self.withdrawals) <= MAX_WITHDRAWALS
        for i in range(MAX_WITHDRAWALS):
            wd = self.withdrawals[i] if i < len(self.withdrawals) else Withdrawal.default()
            out.extend(wd.withdrawal_raw_bytes(wd.id))
        return out

    def tx_table_tx_cols(self, MAX_TXS: int):
        tx_id_col, index_col, value_col = [], [], []
        for i in range(MAX_TXS):
            tx = self.txs[i] if i < len(self.txs) else Transaction.default()
            tx_id_col += [i + 1] * TX_LEN
            index_col += [0] * TX_LEN
            value_col += tx.tx_table_value_column()
        return tx_id_col, index_col, value_col

    def tx_table_tx_calldata_cols(self, MAX_CALLDATA_BYTES: int):
        tx_id_col, index_col, value_col, gas_cost_col, is_final_col = [], [], [], [], []
        for i, tx in enumerate(self.txs):
            gas_cost_acc = 0
            for byte_index, b in enumerate(tx.data):
                tx_id_col.append(i + 1)
                index_col.append(byte_index)
                value_col.append((b, False))
                gas_cost_acc += (GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE if b == 0
                                 else GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE)
                gas_cost_col.append(gas_cost_acc)
                is_final_col.append(1 if byte_index == len(tx.data) - 1 else 0)
        assert len(value_col) <= MAX_CALLDATA_BYTES
        pad = MAX_CALLDATA_BYTES - len(value_col)
        tx_id_col += [0] * pad
        index_col += [0] * pad
        value_col += [(0, False)] * pad
        gas_cost_col += [0] * pad
        is_final_col += [0] * pad
        return tx_id_col, index_col, value_col, gas_cost_col, is_final_col

    def tx_table_cols(self, MAX_TXS: int, MAX_CALLDATA_BYTES: int):
        f = self.tx_table_tx_cols(MAX_TXS)
        d = self.tx_table_tx_calldata_cols(MAX_CALLDATA_BYTES)
        return [0] + f[0] + d[0], [0] + f[1] + d[1], [(0, False)] + f[2] + d[2]

    def withdrawal_table_cols(self, MAX_WITHDRAWALS: int):
        ids, vids, addrs, amounts = [], [], [], []
        for i in range(MAX_WITHDRAWALS):
            wd = self.withdrawals[i] if i < len(self.withdrawals) else Withdrawal.default()
            ids.append(wd.id)
            vids.append(wd.validator_id)
            addrs.append(wd.address)
            amounts.append(wd.amount)
        return ids, vids, addrs, amounts


@dataclass
class PublicInputs:
    pi_keccak: int
    block_hash: int
    state_root: int
    state_root_prev: int


@dataclass
class Witness:
    rows: List[dict]
    public_inputs: PublicInputs
    calldata_gas_cost_table: Set[Tuple[int, int, int]]
    keccak_table: set
    block_table: List[Tuple[int, bool]]
    tx_table: List[Tuple[int, int, int, Tuple[int, bool]]]
    withdrawal_table: List[Tuple[int, int, int, int]]
    circuit_len: int
    copy_constrains: List[bytes]


def _flatten_len(vals: List[bytes]) -> int:
    return sum(len(v) for v in vals)


def public_data2witness(public_data: PublicData, MAX_TXS: int, MAX_CALLDATA_BYTES: int,
                        MAX_WITHDRAWALS: int) -> Witness:
    """The reference's byte layout and row assignment (pi_circuit.py:
    839-1073): the raw values are walked last to first with the row index
    ``i`` counting down, so row 0 holds the stream's first byte and the
    keccak lookup."""
    rpi_byte_values: List[bytes] = []
    block_table_value_col = public_data.block_table_value_column()
    rpi_byte_values.extend(public_data.block_table_raw_byte_values())
    for v in (public_data.block.hash, public_data.block.state_root, public_data.state_root_prev):
        lo, hi = _lo_hi(v)
        rpi_byte_values.append(lo.to_bytes(16, "big"))
        rpi_byte_values.append(hi.to_bytes(16, "big"))
    assert _flatten_len(rpi_byte_values) == N_BYTES_ONE + N_BYTES_BLOCK + N_BYTES_EXTRA_VALUE

    tx_table_cols = public_data.tx_table_cols(MAX_TXS, MAX_CALLDATA_BYTES)
    tx_table_tx_calldata = public_data.tx_table_tx_calldata_cols(MAX_CALLDATA_BYTES)
    rpi_byte_values.extend(public_data.tx_table_raw_bytes(MAX_TXS))

    circuit_len = (N_BYTES_ONE + N_BYTES_BLOCK + N_BYTES_EXTRA_VALUE
                   + N_BYTES_U64 * TX_LEN * MAX_TXS + N_BYTES_U64
                   + N_BYTES_U64 * TX_LEN * MAX_TXS + N_BYTES_U64
                   + N_BYTES_TX * MAX_TXS + N_BYTES_ONE)
    assert _flatten_len(rpi_byte_values) == circuit_len

    rpi_byte_values.extend(public_data.tx_table_calldata_raw_bytes(MAX_CALLDATA_BYTES))
    circuit_len += MAX_CALLDATA_BYTES
    rpi_byte_values.extend(public_data.withdrawal_table_raw_bytes(MAX_WITHDRAWALS))
    circuit_len += N_BYTES_WITHDRAWAL * MAX_WITHDRAWALS
    assert _flatten_len(rpi_byte_values) == circuit_len

    wd_cols = public_data.withdrawal_table_cols(MAX_WITHDRAWALS)

    keccak_table = {(0, 0, 0, 0)}
    block_table: List[Tuple[int, bool]] = []
    tx_table: List[tuple] = []
    withdrawal_table: List[tuple] = []
    rows: List[dict] = []
    calldata_gas_cost_table = {(0, 0, 0)}

    i = circuit_len - 1
    keccakrlc_prev = 0
    value_lc_prev = 0
    rpi_bytes: List[int] = []
    tx_table_len = TX_LEN * MAX_TXS + 1
    tx_and_calldata_len = tx_table_len + MAX_CALLDATA_BYTES

    for value in reversed(rpi_byte_values):
        for byte_index, byte in enumerate(value):
            rpi_bytes.append(byte)
            q_bytes_last = 1 if len(rpi_bytes) == 1 else 0
            q_rpi_keccak_lookup = 1 if i == 0 else 0
            q_rpi_value_start = 1 if byte_index == 0 else 0

            keccakrlc = byte if len(rpi_bytes) == 1 else (keccakrlc_prev * keccak_rand + byte) % P
            keccakrlc_prev = keccakrlc
            value_lc = byte if byte_index == 0 else (value_lc_prev * byte_pow_base + byte) % P
            value_lc_prev = value_lc

            if i < BLOCK_LEN // 2 + 1:
                block_table.append(block_table_value_col[i])
            if i == BLOCK_LEN // 2 + 1:
                block_table.append((public_data.block.hash, True))
            if i == BLOCK_LEN // 2 + 2:
                block_table.append((public_data.block.state_root, True))
            if i == BLOCK_LEN // 2 + 3:
                block_table.append((public_data.state_root_prev, True))

            q_tx_table = q_tx_calldata = q_tx_calldata_start = q_withdrawal_table = 0
            tx_id_inv = tx_value_lo_inv = tx_id_diff_inv = 0
            calldata_gas_cost = is_final = 0
            tx_row = (0, 0, 0, (0, False))
            if i < tx_and_calldata_len:
                tx_id = tx_table_cols[0][i]
                index = tx_table_cols[1][i]
                val, is_word = tx_table_cols[2][i]
                tag = int(TxTag.CallData)
                if i == 0:
                    tag = 0
                elif i < tx_table_len:
                    tag = i % TX_LEN
                    if i % TX_LEN == 0:
                        tag = TX_LEN
                val_lo = val & ((1 << 128) - 1) if is_word else val
                if i < tx_table_len:
                    q_tx_table = 1
                    tx_id_inv = _inv(tag - int(TxTag.CallDataLength))
                    tx_value_lo_inv = _inv(val_lo)
                if i >= tx_table_len:
                    q_tx_calldata = 1
                    tx_id_inv = _inv(tx_id)
                    tx_value_lo_inv = _inv(val_lo)
                    tx_id_next = 0
                    if i < tx_and_calldata_len - 1:
                        tx_id_next = tx_table_cols[0][i + 1]
                    tx_id_diff_inv = _inv(tx_id_next - tx_id)
                    calldata_gas_cost = tx_table_tx_calldata[3][i - tx_table_len]
                    is_final = tx_table_tx_calldata[4][i - tx_table_len]
                    calldata_gas_cost_table.add((tx_id, is_final, calldata_gas_cost))
                if i == tx_table_len:
                    q_tx_calldata_start = 1
                tx_row = (tx_id, tag, index, (val, is_word))
                tx_table.append(tx_row)

            wd_row = (0, 0, 0, 0)
            if tx_and_calldata_len <= i < tx_and_calldata_len + MAX_WITHDRAWALS:
                j = i - tx_and_calldata_len
                wd_row = (wd_cols[0][j], wd_cols[1][j], wd_cols[2][j], wd_cols[3][j])
                q_withdrawal_table = 1
                withdrawal_table.append(wd_row)

            rows.append({
                "q_bytes_last": q_bytes_last,
                "q_tx_table": q_tx_table,
                "q_tx_calldata": q_tx_calldata,
                "q_tx_calldata_start": q_tx_calldata_start,
                "q_rpi_keccak_lookup": q_rpi_keccak_lookup,
                "q_rpi_value_start": q_rpi_value_start,
                "tx_id_inv": tx_id_inv,
                "tx_value_lo_inv": tx_value_lo_inv,
                "tx_id_diff_inv": tx_id_diff_inv,
                "calldata_gas_cost": calldata_gas_cost,
                "is_final": is_final,
                "q_withdrawal_table": q_withdrawal_table,
                "rpi_bytes": byte,
                "rpi_bytes_keccakrlc": keccakrlc,
                "rpi_value_lc": value_lc,
                "rpi_digest": 0,
                "q_rpi_byte_enable": 1,
                "tx_id": tx_row[0],
                "tx_tag": tx_row[1],
                "tx_index": tx_row[2],
                "tx_value_lo": tx_row[3][0] & ((1 << 128) - 1) if tx_row[3][1] else tx_row[3][0],
                "wd_id": wd_row[0],
                "wd_validator_id": wd_row[1],
                "wd_address": wd_row[2],
                "wd_amount": wd_row[3],
            })
            i -= 1
    rows.reverse()
    output_digest = int.from_bytes(keccak256(bytes(rpi_bytes)), "big")
    rows[0]["rpi_digest"] = output_digest
    keccak_table.add((1, RLC(bytes(reversed(bytes(rpi_bytes))), keccak_rand,
                             n_bytes=len(rpi_bytes)).expr(), len(rpi_bytes), output_digest))
    block_table.reverse()
    tx_table.reverse()
    withdrawal_table.reverse()
    return Witness(rows,
                   PublicInputs(output_digest, public_data.block.hash,
                                public_data.block.state_root, public_data.state_root_prev),
                   calldata_gas_cost_table, keccak_table, block_table, tx_table,
                   withdrawal_table, circuit_len, list(rpi_byte_values))


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------

CD_GAS_SCHEMA = Schema(
    "pi_cd_gas",
    {"tx_id": Col("f", 32), "is_final": Col("f", 1), "gas_cost": Col("f", 128)},
)


def _segment_layout(copy_constrains: List[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row positions of every raw-byte segment.

    The witness emits the byte stream segment by segment while the row
    index ``i`` counts down, so in final row order segment j occupies rows
    [off_j, off_j + len_j) with its bytes reversed (row off_j holds the
    least significant byte).  Returns (idx [n_segs, max_len] of the row of
    each little-endian byte position, mask of valid positions, lengths)."""
    lens = [len(s) for s in copy_constrains]
    n_segs, max_len = len(lens), max(lens)
    idx = np.zeros((n_segs, max_len), dtype=np.int32)
    mask = np.zeros((n_segs, max_len), dtype=bool)
    off = 0
    for j, n in enumerate(lens):
        idx[j, :n] = off + np.arange(n)
        mask[j, :n] = True
        off += n
    return idx, mask, np.asarray(lens, dtype=np.int32)


def _copy_lhs_values(witness: Witness, MAX_TXS: int, MAX_CALLDATA_BYTES: int,
                     MAX_WITHDRAWALS: int) -> List[int]:
    """The table-side value of every copy constraint, in stream-segment
    order (reference verify_circuit :338-452)."""
    pi = witness.public_inputs
    out: List[int] = []

    def emit(value, is_word):
        if is_word:
            out.extend(_lo_hi(value))
        else:
            out.append(value)

    for i in range(BLOCK_LEN // 2 + 1):
        emit(*witness.block_table[i])
    for v in (pi.block_hash, pi.state_root, pi.state_root_prev):
        emit(v, True)
    tx_len = TX_LEN * MAX_TXS + 1
    for i in range(tx_len):
        tx_id, _tag, index, (value, is_word) = witness.tx_table[i]
        out.append(tx_id)
        out.append(index)
        emit(value, is_word)
    for i in range(MAX_CALLDATA_BYTES):
        emit(*witness.tx_table[tx_len + i][3])
    for i in range(MAX_WITHDRAWALS):
        wd_id, validator_id, address, amount = witness.withdrawal_table[i]
        out.append(wd_id)
        out.append(validator_id)
        emit(address, True)
        out.append(amount)
    return out


_SMALL_COLS = [
    "q_bytes_last", "q_tx_table", "q_tx_calldata", "q_tx_calldata_start",
    "q_rpi_keccak_lookup", "q_rpi_value_start", "calldata_gas_cost",
    "is_final", "q_withdrawal_table", "rpi_bytes", "q_rpi_byte_enable",
    "tx_id", "tx_tag", "tx_index", "wd_id", "wd_validator_id", "wd_amount",
]
_WIDE_COLS = ["tx_id_inv", "tx_value_lo_inv", "tx_id_diff_inv",
              "rpi_bytes_keccakrlc", "rpi_value_lc", "tx_value_lo"]


def build_pi_inputs(witness: Witness, MAX_TXS: int, MAX_CALLDATA_BYTES: int,
                    MAX_WITHDRAWALS: int):
    """(ctx, cols, tables, static, extra) of the check, on host tensors:
    17 small columns at 64 bits, 6 wide ones at 254, the digest as a word;
    the copy constraints' row positions (``copy_idx``, ``copy_mask``) and
    their table-side values as 16-limb rows (``copy_lhs``)."""
    rows = witness.rows
    ctx = Ctx("cpu", len(rows), "eager")
    cols = {k: F.from_ints(ctx, [r[k] for r in rows], 64) for k in _SMALL_COLS}
    for k in _WIDE_COLS:
        cols[k] = F.from_ints(ctx, [r[k] for r in rows], 254)
    cols["rpi_digest"] = Word.from_ints(ctx, [r["rpi_digest"] for r in rows])

    idx, mask, _ = _segment_layout(witness.copy_constrains)
    lhs = _copy_lhs_values(witness, MAX_TXS, MAX_CALLDATA_BYTES, MAX_WITHDRAWALS)
    assert len(lhs) == idx.shape[0], "copy-constraint count mismatch"
    extra = {"copy_idx": idx, "copy_mask": mask.astype(np.uint8),
             "copy_lhs": L.ints_to_limbs([v % P for v in lhs], 16).numpy()}
    tables = {
        "keccak": Table.from_rows(
            ctx, KECCAK_SCHEMA,
            [{"state_tag": 2 if en else 0, "input_rlc": rlc, "input_len": ln, "output": out}
             for (en, rlc, ln, out) in witness.keccak_table]),
        "cd_gas": Table.from_rows(
            ctx, CD_GAS_SCHEMA,
            [{"tx_id": t, "is_final": f, "gas_cost": g}
             for (t, f, g) in witness.calldata_gas_cost_table]),
    }
    return ctx, cols, tables, {"circuit_len": witness.circuit_len}, extra


@is_circuit_code
def check_pi(ctx: Ctx, cs: ConstraintSystem, c, tables, static, extra):
    """The pi-circuit constraint body (reference check_row :150-322 and the
    copy constraints :338-452); ``extra`` holds tensors on the context's
    device.  The next row is cyclic: row n - 1 reads row 0."""
    n = ctx.batch
    idx1 = (torch.arange(n, device=ctx.device) + 1) % n
    nx = {k: v.gather(idx1) for k, v in c.items() if k != "rpi_digest"}

    def check(mask, ok, msg):
        cs.check(ok | ~mask, lambda: msg)

    en = ~c["q_rpi_byte_enable"].is_zero_mask()
    last = ~c["q_bytes_last"].is_zero_mask()
    # gates 1 and 2: the keccak RLC chain
    check(en & last, c["rpi_bytes_keccakrlc"].eq_mask(c["rpi_bytes"]), "keccakrlc last mismatch")
    check(en & ~last,
          c["rpi_bytes_keccakrlc"].eq_mask(nx["rpi_bytes_keccakrlc"] * keccak_rand + c["rpi_bytes"]),
          "keccakrlc chain mismatch")
    # gates 3 and 4: the value LC chain
    start = ~c["q_rpi_value_start"].is_zero_mask()
    check(en & ~start,
          c["rpi_value_lc"].eq_mask(nx["rpi_value_lc"] * byte_pow_base + c["rpi_bytes"]),
          "value lc chain mismatch")
    check(en & start, c["rpi_value_lc"].eq_mask(c["rpi_bytes"]), "value lc start mismatch")

    # gate 5: the keccak lookup binding the digest to the whole byte column
    # (reference :363 and :193-203)
    tables["keccak"].lookup(
        cs,
        {
            "state_tag": F.const(ctx, 2),
            "input_rlc": c["rpi_bytes_keccakrlc"],
            "input_len": F.const(ctx, static["circuit_len"]),
            "output": c["rpi_digest"],
        },
        enabled=~c["q_rpi_keccak_lookup"].is_zero_mask(),
    )

    # copy constraints: every table value equals the big-endian integer of
    # its raw-byte segment (reference :366-452), one verdict for all rows.
    # rhs is rebuilt from the byte column at static positions; the bytes are
    # little-endian along the gather axis, so limb k packs positions 2k and
    # 2k + 1
    byte_arr = c["rpi_bytes"].limbs[..., 0]
    gathered = byte_arr[extra["copy_idx"].long()] * extra["copy_mask"].to(L.DTYPE)
    max_len = gathered.shape[1]
    rhs = torch.stack([gathered[:, 2 * k] | ((gathered[:, 2 * k + 1] << 8)
                                             if 2 * k + 1 < max_len else 0)
                       for k in range((max_len + 1) // 2)], dim=-1)
    copies_ok = L.eq(rhs, extra["copy_lhs"]).all()
    cs.check(copies_ok.expand(n), lambda: "copy constraint violated (table value != raw bytes)")

    one = F.const(ctx, 1)
    # the calldata region (reference :207-293)
    m_cd = ~c["q_tx_calldata"].is_zero_mask()
    tx_id = c["tx_id"]
    tx_id_next = nx["tx_id"]
    check(m_cd, (tx_id * (one - c["tx_id_inv"] * tx_id)).is_zero_mask(), "tx_id_inv malformed")
    check(m_cd, (c["tx_value_lo"] * (one - c["tx_value_lo_inv"] * c["tx_value_lo"])).is_zero_mask(),
          "tx_value_lo_inv malformed")
    diff = tx_id_next - tx_id
    check(m_cd, (diff * (one - c["tx_id_diff_inv"] * diff)).is_zero_mask(),
          "tx_id_diff_inv malformed")
    is_tx_id_nonzero = tx_id * c["tx_id_inv"]
    is_tx_id_next_nonzero = tx_id_next * nx["tx_id_inv"]
    is_tx_id_zero = one - is_tx_id_nonzero
    is_tx_id_next_zero = one - is_tx_id_next_nonzero
    tx_id_not_equal_to_next = diff * c["tx_id_diff_inv"]
    tx_id_equal_to_next = one - tx_id_not_equal_to_next
    is_byte_nonzero = c["tx_value_lo"] * c["tx_value_lo_inv"]
    is_byte_next_nonzero = nx["tx_value_lo"] * nx["tx_value_lo_inv"]
    is_byte_zero = one - is_byte_nonzero
    is_byte_next_zero = one - is_byte_next_nonzero

    for expr, msg in (
        (is_tx_id_zero * tx_id, "default row tx_id"),
        (is_tx_id_zero * tx_id_next, "default row tx_id next"),
        (is_tx_id_zero * c["is_final"], "default row is_final"),
        (is_tx_id_zero * c["calldata_gas_cost"], "default row gas cost"),
    ):
        check(m_cd, expr.is_zero_mask(), msg)

    gas_cost = (is_byte_nonzero * GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE
                + is_byte_zero * GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE)
    gas_cost_next = (is_byte_next_nonzero * GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE
                     + is_byte_next_zero * GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE)

    # the fixed u16 lookup: value < 2^16, as a computed predicate
    u16_val = tx_id_not_equal_to_next * is_tx_id_next_nonzero * (diff - one)
    check(m_cd, u16_val.le_bits_mask(16), "tx id diff exceeds u16")

    constraints = [
        (tx_id_equal_to_next * (nx["tx_index"] - c["tx_index"] - one), "calldata index within tx"),
        (diff * nx["tx_index"], "calldata index of next tx"),
        (tx_id_equal_to_next * (nx["calldata_gas_cost"] - c["calldata_gas_cost"] - gas_cost_next),
         "gas acc within tx"),
        (is_tx_id_next_nonzero * diff * (nx["calldata_gas_cost"] - gas_cost_next),
         "gas acc of next tx"),
        (is_tx_id_next_zero * nx["calldata_gas_cost"], "gas acc of last tx"),
        (tx_id_equal_to_next * c["is_final"], "is_final within tx"),
        (diff * (c["is_final"] - one), "is_final at tx end"),
    ]
    for expr, msg in constraints:
        check(m_cd, (is_tx_id_nonzero * expr).is_zero_mask(), msg)

    m_cd_start = m_cd & ~c["q_tx_calldata_start"].is_zero_mask()
    check(m_cd_start, (is_tx_id_nonzero * c["tx_index"]).is_zero_mask(), "first calldata index")
    check(m_cd_start, (is_tx_id_nonzero * (c["calldata_gas_cost"] - gas_cost)).is_zero_mask(),
          "first calldata gas cost")

    # the tx-table region (reference :296-314)
    m_tx = ~c["q_tx_table"].is_zero_mask()
    row_is_cdl = c["tx_tag"] - int(TxTag.CallDataLength)
    check(m_tx, (row_is_cdl * (one - c["tx_id_inv"] * row_is_cdl)).is_zero_mask(),
          "cdl inv malformed")
    check(m_tx, (c["tx_value_lo"] * (one - c["tx_value_lo_inv"] * c["tx_value_lo"])).is_zero_mask(),
          "tx table value inv malformed")
    is_cdl_row = one - row_is_cdl * c["tx_id_inv"]
    is_cdl_nonzero = c["tx_value_lo"] * c["tx_value_lo_inv"]
    is_cdl_zero = one - is_cdl_nonzero
    calldata_cost = nx["tx_value_lo"]
    check(m_tx, (is_cdl_row * is_cdl_zero * calldata_cost).is_zero_mask(),
          "zero calldata length with nonzero cost")
    # the gas-cost accumulator lookup against the calldata region's totals
    # (reference :308-313)
    q_gas = m_tx & is_cdl_row.eq_mask(one) & is_cdl_nonzero.eq_mask(one)
    tables["cd_gas"].lookup(
        cs, {"tx_id": c["tx_id"], "is_final": F.const(ctx, 1), "gas_cost": calldata_cost},
        enabled=q_gas)

    # the withdrawal region (reference :316-320).  Deviation, as in the JAX
    # package: the reference asserts amount != 0 on every row
    # (pi_circuit.py:321), which forbids the zero-amount padding of its own
    # withdrawal circuit; here padding rows (amount 0) are allowed but must
    # form a suffix, and the id chain still increments through them
    m_wd = ~c["q_withdrawal_table"].is_zero_mask()
    m_wd_next = ~nx["q_withdrawal_table"].is_zero_mask()
    check(m_wd & m_wd_next, nx["wd_id"].eq_mask(c["wd_id"] + 1), "withdrawal id not incremented")
    is_pad = c["wd_amount"].is_zero_mask()
    nx_pad = nx["wd_amount"].is_zero_mask()
    check(m_wd & m_wd_next & is_pad, nx_pad, "withdrawal padding not a suffix")


# the key subset of each lookup, in the order the check queries it, so the
# prebuilt index is the one a device check searches
_PI_LOOKUP_SUBSETS = {
    "keccak": tuple(KECCAK_SCHEMA.columns),
    "cd_gas": tuple(CD_GAS_SCHEMA.columns),
}


def verify_circuit(witness: Witness, MAX_TXS: int, MAX_CALLDATA_BYTES: int,
                   MAX_WITHDRAWALS: int, success: bool = True) -> None:
    """Spec-mode (eager, host) check with the reference's verdict
    semantics."""
    from ..runtime.kernels import run_spec

    try:
        _, cols, tables, static, extra = build_pi_inputs(
            witness, MAX_TXS, MAX_CALLDATA_BYTES, MAX_WITHDRAWALS)
        run_spec("pi", check_pi, cols, tables, static, extra)
    except AssertionError:
        if success:
            raise
        return
    assert success, "expected pi circuit to fail, but it passed"


def pi_kernel(witness: Witness, MAX_TXS: int, MAX_CALLDATA_BYTES: int, MAX_WITHDRAWALS: int,
              device="cuda"):
    """Production path: the same constraint body as one ``CircuitKernel``
    on ``device`` (the card unless the caller asks for "cpu"), the lookup
    indexes built on the host."""
    from ..runtime.kernels import CircuitKernel

    _, cols, tables, static, extra = build_pi_inputs(
        witness, MAX_TXS, MAX_CALLDATA_BYTES, MAX_WITHDRAWALS)
    for name, t in tables.items():
        t.index_for(_PI_LOOKUP_SUBSETS[name])
    return CircuitKernel("pi", check_pi, cols, tables, static, extra, device=device)
