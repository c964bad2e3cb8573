"""State circuit: verifies the rw table itself.

Counterpart of ``zkevm_specs_tpu/circuits/state.py`` (reference:
src/zkevm_specs/state_circuit.py).  All rows are checked in one batched
pass: previous and next rows come from cyclic shifts, per-tag rules apply
under tag masks, and the MPT lookups of Storage and Account rows search
the MPT table.

The lexicographic ordering check is kernel K5 (``state_order_lt``,
``csrc/state_order_lt.cu``) for columns at their declared bounds.  A
widened (malformed) witness builds the 31-limb key with the F operations
instead, exactly as the JAX package does, because its F arithmetic then
crosses 253 bits and reduces mod p; the branch is decided on the host from
the columns' static bounds.
"""
from __future__ import annotations

from enum import IntEnum
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F, Word
from ..ops import limbs as L
from ..tables.engine import Table
from ..tables.schemas import (
    MPT_SCHEMA,
    AccountFieldTag,
    MPTProofType,
    RW,
    TxLogFieldTag,
    TxReceiptFieldTag,
)

MAX_RW_COUNTER = 2**32 - 1
MAX_MEMORY_ADDRESS = 2**32 - 1
MAX_STACK_PTR = 1023
MAX_TAG = 12
MAX_ID = 2**28 - 1
# the reference pins 24 but its own CallContextFieldTag enum reaches 25
# (ReversibleWriteCounter), as the JAX package notes
MAX_FIELD_TAG = 25
ID_BITS = 28
ADDRESS_BITS = 160
RW_COUNTER_BITS = 32


class Tag(IntEnum):
    Start = 1
    Memory = 2
    Stack = 3
    Storage = 4
    CallContext = 5
    Account = 6
    TxRefund = 7
    TxAccessListAccount = 8
    TxAccessListAccountStorage = 9
    TxLog = 10
    TxReceipt = 11


# ---------------------------------------------------------------------------
# Host-side operations / witness assignment (reference :617-933)
# ---------------------------------------------------------------------------

class Operation:
    def __init__(self, rw_counter, rw, tag, id, address, field_tag, storage_key,
                 value, initial_value, lexicographic_ordering_selector=1,
                 value_is_word=False, initial_is_word=False):
        self.rw_counter = rw_counter
        self.rw = rw
        self.tag = tag
        self.id = id
        self.address = address
        self.field_tag = field_tag
        self.storage_key = storage_key
        self.value = value
        self.initial_value = initial_value
        self.lexicographic_ordering_selector = lexicographic_ordering_selector


def StartOp(rw_counter, rw, lexicographic_ordering_selector=1):
    return Operation(rw_counter, rw, Tag.Start, 0, 0, 0, 0, 0, 0,
                     lexicographic_ordering_selector)


def MemoryOp(rw_counter, rw, call_id, mem_addr, value):
    return Operation(rw_counter, rw, Tag.Memory, call_id, mem_addr, 0, 0, value, 0)


def StackOp(rw_counter, rw, call_id, stack_ptr, value):
    return Operation(rw_counter, rw, Tag.Stack, call_id, stack_ptr, 0, 0, value, 0)


def StorageOp(rw_counter, rw, tx_id, addr, key, value, committed_value):
    return Operation(rw_counter, rw, Tag.Storage, tx_id, addr, 0, key, value, committed_value)


def CallContextOp(rw_counter, rw, call_id, field_tag, value):
    return Operation(rw_counter, rw, Tag.CallContext, call_id, 0, int(field_tag), 0, value, 0)


def AccountOp(rw_counter, rw, addr, field_tag, value, committed_value):
    return Operation(rw_counter, rw, Tag.Account, 0, addr, int(field_tag), 0, value, committed_value)


def TxRefundOp(rw_counter, rw, tx_id, value):
    return Operation(rw_counter, rw, Tag.TxRefund, tx_id, 0, 0, 0, value, 0)


def TxAccessListAccountOp(rw_counter, rw, tx_id, addr, value):
    return Operation(rw_counter, rw, Tag.TxAccessListAccount, tx_id, addr, 0, 0, value, 0)


def TxAccessListAccountStorageOp(rw_counter, rw, tx_id, addr, key, value):
    return Operation(rw_counter, rw, Tag.TxAccessListAccountStorage, tx_id, addr, 0, key, value, 0)


def TxLogOp(rw_counter, rw, tx_id, log_id, field_tag, index, value):
    return Operation(rw_counter, rw, Tag.TxLog, tx_id, log_id, int(field_tag), index, value, 0)


def TxReceiptOp(rw_counter, rw, tx_id, field_tag, value):
    return Operation(rw_counter, rw, Tag.TxReceipt, tx_id, 0, int(field_tag), 0, value, 0)


def _mpt_key(op: Operation) -> Optional[Tuple[int, int, int]]:
    if op.tag not in (Tag.Account, Tag.Storage):
        return None
    return (int(op.address), int(op.field_tag), int(op.storage_key))


def _mock_mpt_updates(ops: List[Operation]) -> Dict[Tuple[int, int, int], dict]:
    """Fake MPT root chain: root starts at 3, +=5 per distinct update
    (reference :903-933)."""
    mpt_map: Dict[Tuple[int, int, int], dict] = {}
    root = 3
    for op in ops:
        key = _mpt_key(op)
        if key is None:
            continue
        if key in mpt_map:
            # the MPT lookup fires on the LAST access of a key: keep its
            # value current and recompute the proof type the circuit will
            # derive from the final values
            entry = mpt_map[key]
            entry["value"] = int(op.value)
            now_non_exist = entry["value"] == 0 and entry["value_prev"] == 0
            if op.tag == Tag.Storage:
                entry["proof_type"] = int(
                    MPTProofType.NonExistingAccountProof if now_non_exist
                    else MPTProofType.StorageMod)
            elif (op.tag == Tag.Account
                  and int(op.field_tag) == int(AccountFieldTag.CodeHash)):
                entry["proof_type"] = int(
                    MPTProofType.NonExistingAccountProof if now_non_exist
                    else MPTProofType.from_account_field_tag(
                        AccountFieldTag(int(op.field_tag))))
            continue
        non_exist = int(op.value) == 0 and int(op.initial_value) == 0
        if op.tag == Tag.Account:
            if non_exist and int(op.field_tag) == int(AccountFieldTag.CodeHash):
                # matches the circuit's acc_non_exist rule (check_state_rows)
                proof_type = MPTProofType.NonExistingAccountProof
            else:
                proof_type = MPTProofType.from_account_field_tag(
                    AccountFieldTag(int(op.field_tag)))
        else:
            proof_type = (MPTProofType.NonExistingAccountProof if non_exist
                          else MPTProofType.StorageMod)
        new_root = root if op.tag == Tag.Start else root + 5
        mpt_map[key] = {
            "address": int(op.address),
            "proof_type": int(proof_type),
            "storage_key": int(op.storage_key),
            "root": new_root,
            "root_prev": root,
            "value": int(op.value),
            "value_prev": int(op.initial_value),
        }
        root = new_root
    return mpt_map


def mpt_table_from_ops(ops: List[Operation]) -> List[dict]:
    return list(_mock_mpt_updates(ops).values())


def assign_state_circuit(ops: List[Operation]) -> List[dict]:
    """Rows with back-filled roots (reference :861-889)."""
    mpt_updates = _mock_mpt_updates(ops)
    keys = [_mpt_key(op) for op in ops]
    updates = [None if k is None else mpt_updates.get(k) for k in keys]
    roots: List[Optional[int]] = [None if u is None else u["root_prev"] for u in updates]
    final_root = 3 + 5 * len(mpt_updates)
    roots.append(final_root)
    root = final_root
    for i in reversed(range(len(roots))):
        if roots[i] is None:
            roots[i] = root
        else:
            root = roots[i]
    rows = []
    for op, maybe_root in zip(ops, roots[1:]):
        rows.append(
            {
                "rw_counter": int(op.rw_counter),
                "is_write": 0 if op.rw == RW.Read else 1,
                "tag": int(op.tag),
                "id": int(op.id),
                "address": int(op.address),
                "field_tag": int(op.field_tag),
                "storage_key": int(op.storage_key),
                "value": int(op.value),
                "initial_value": int(op.initial_value),
                "root": int(maybe_root),
                "lexicographic_ordering_selector": int(op.lexicographic_ordering_selector),
            }
        )
    return rows


# ---------------------------------------------------------------------------
# Columnar batch
# ---------------------------------------------------------------------------

class StateRows:
    _BITS = {
        "rw_counter": 32, "is_write": 1, "tag": 8, "id": 32, "address": 160,
        "field_tag": 16, "lexicographic_ordering_selector": 1,
    }
    _WORDS = ("storage_key", "value", "initial_value", "root")

    def __init__(self, ctx: Ctx, rows: List[dict]):
        self.ctx = ctx
        self.n = len(rows)
        for name, bits in self._BITS.items():
            setattr(self, name, F.from_ints(ctx, [r[name] for r in rows], bits))
        for name in self._WORDS:
            setattr(self, name, Word.from_ints(ctx, [r[name] for r in rows]))

    def shifted(self, offset: int) -> "StateRows":
        idx = (torch.arange(self.n, device=self.ctx.device) + offset) % self.n
        out = object.__new__(StateRows)
        out.ctx = self.ctx
        out.n = self.n
        for name in self._BITS:
            setattr(out, name, getattr(self, name).gather(idx))
        for name in self._WORDS:
            setattr(out, name, getattr(self, name).gather(idx))
        return out


# ---------------------------------------------------------------------------
# K5: the ordering key and the compare with the previous row
# ---------------------------------------------------------------------------

# (column, declared bits, limb width) of the key's columns; K5 takes them
# at exactly these bounds and widths
_KEY_COLS = (("tag", 8, 1), ("id", 32, 2), ("address", ADDRESS_BITS, 16),
             ("field_tag", 16, 1), ("rw_counter", RW_COUNTER_BITS, 2))


def order_key_plain(tag, id_, address, field_tag, sk_lo, sk_hi, rw_counter) -> torch.Tensor:
    """The ordering key of each row at the declared bounds, ``[n, 19]``
    canonical limbs: (((tag*2^28 + id)*2^160 + address)*2^16 + field_tag)
    *2^32 + storage_key, then *2^32 + rw_counter."""
    n = tag.shape[0]
    a = (tag[:, 0] << ID_BITS) + id_[:, 0] + (id_[:, 1] << L.LIMB_BITS)
    w = torch.stack([field_tag[:, 0], *address[:, :10].unbind(1),
                     a & L.LIMB_MASK, (a >> 16) & L.LIMB_MASK, a >> 32], dim=1)
    v = torch.zeros((n, 17), dtype=L.DTYPE, device=tag.device)
    v[:, :8] += sk_lo
    v[:, 8:16] += sk_hi
    v[:, 2:16] += w
    return torch.cat([rw_counter[:, :2], L.carry_propagate_plain(v, 17)], dim=1)


def state_order_lt_plain(tag, id_, address, field_tag, sk_lo, sk_hi, rw_counter) -> torch.Tensor:
    """Plain version of K5 (see ``state_order_lt``)."""
    key = order_key_plain(tag, id_, address, field_tag, sk_lo, sk_hi, rw_counter)
    _, borrow = L.addsub_plain(torch.roll(key, 1, dims=0), key, L.SUB, 0)
    return borrow.bool() | (tag[:, 0] == int(Tag.Start))


def state_order_lt(tag, id_, address, field_tag, sk_lo, sk_hi, rw_counter) -> torch.Tensor:
    """K5 wrapper: ``key(i-1) < key(i) | tag(i) == Start`` for every row i
    (cyclic), as a bool ``[n]``, from the key columns at their declared
    widths (tag ``[n,1]``, id ``[n,2]``, address ``[n,16]``, field_tag
    ``[n,1]``, storage_key lo/hi ``[n,8]`` each, rw_counter ``[n,2]``).

    Replaces ``zkevm_specs_tpu/circuits/state.py:_order_limbs`` (:253-281)
    on the rows and on ``shifted(-1)``, with the ``L.lt`` of :304-311."""
    cols = (tag, id_, address, field_tag, sk_lo, sk_hi, rw_counter)
    widths = (1, 2, 16, 1, 8, 8, 2)
    n = tag.shape[0]
    for t, w in zip(cols, widths):
        L.check_limbs(t, "state_order_lt")
        if t.shape != (n, w):
            raise ValueError(f"state_order_lt: expected a [{n}, {w}] column, got {tuple(t.shape)}")
    if L.on_cpu(*cols):
        return state_order_lt_plain(*cols)
    from ..runtime import cuda_build

    out = torch.empty((n,), dtype=torch.bool, device=tag.device)
    args = []
    for t in cols:
        args += [t.data_ptr(), t.stride(0)]
    err = cuda_build.library("state_order_lt").state_order_lt_launch(
        *args, out.data_ptr(), n, L.cuda_stream())
    L.check_launch(err, "state_order_lt")
    return out


def _order_limbs(ctx: Ctx, rows: StateRows) -> torch.Tensor:
    """31x16-bit ordering key per row with the F operations (reference
    :552-565), the JAX package's ``_order_limbs`` step for step."""
    w = rows.tag * (1 << ID_BITS) + rows.id
    w = w * F.const(ctx, 1 << ADDRESS_BITS) + rows.address
    w = w * (1 << 16) + rows.field_tag
    w_limbs = L.pad_limbs(w.widen(16).limbs, 16)
    sk_limbs = torch.cat([rows.storage_key.lo.widen(8).limbs,
                          rows.storage_key.hi.widen(8).limbs], dim=-1)
    v = L.add(torch.nn.functional.pad(w_limbs, (2, 11)), L.pad_limbs(sk_limbs, 29), 29)
    rwc = L.pad_limbs(rows.rw_counter.widen(2).limbs, 2)
    return L.add(torch.nn.functional.pad(v, (2, 0)), L.pad_limbs(rwc, 31), 31)


def _at_declared_bounds(rows: StateRows) -> bool:
    ok = all(getattr(rows, name).bits <= bits and getattr(rows, name).width == width
             for name, bits, width in _KEY_COLS)
    sk = rows.storage_key
    return ok and all(h.bits <= 128 and h.width == 8 for h in (sk.lo, sk.hi))


def order_ok(ctx: Ctx, rows: StateRows) -> torch.Tensor:
    """``key(prev) < key(row) | row is Start`` per row: K5 at the declared
    bounds, the F-operation key otherwise (static branch on ``bits``)."""
    if _at_declared_bounds(rows):
        return state_order_lt(rows.tag.limbs, rows.id.limbs, rows.address.limbs,
                              rows.field_tag.limbs, rows.storage_key.lo.limbs,
                              rows.storage_key.hi.limbs, rows.rw_counter.limbs)
    cur = _order_limbs(ctx, rows)
    # _order_limbs works row by row, so the previous rows' keys are the
    # keys rolled by one
    return L.lt(torch.roll(cur, 1, dims=0), cur) | rows.tag.eq_mask(int(Tag.Start))


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------

def check_state_rows(ctx: Ctx, rows: StateRows, mpt: Table) -> ConstraintSystem:
    cs = ConstraintSystem(ctx)
    prev = rows.shifted(-1)
    nxt = rows.shifted(1)

    def rng(value: F, lo: int, hi: int, name: str):
        ok = ~value.lt_mask(lo) & ~F.const(ctx, hi).lt_mask(value)
        cs.check(ok, lambda: f"{name} out of range [{lo},{hi}]")

    # 0.0 ranges
    rng(rows.tag, 1, MAX_TAG, "tag")
    rng(rows.id, 0, MAX_ID, "id")
    rng(rows.field_tag, 0, MAX_FIELD_TAG, "field_tag")
    # 0.1 address fits 160 bits
    cs.check(rows.address.le_bits_mask(160), lambda: "address exceeds 160 bits")
    # 0.3 is_write boolean
    cs.constrain_bool(rows.is_write, "is_write")

    # 0.4 lexicographic ordering for non-Start rows
    not_start = ~rows.tag.eq_mask(int(Tag.Start))
    cs.check(order_ok(ctx, rows), lambda: "rows are not in lexicographic order")

    keys_eq_prev = (
        rows.tag.eq_mask(prev.tag)
        & rows.id.eq_mask(prev.id)
        & rows.address.eq_mask(prev.address)
        & rows.field_tag.eq_mask(prev.field_tag)
        & rows.storage_key.eq_mask(prev.storage_key)
    )
    keys_eq_next = (
        rows.tag.eq_mask(nxt.tag)
        & rows.id.eq_mask(nxt.id)
        & rows.address.eq_mask(nxt.address)
        & rows.field_tag.eq_mask(nxt.field_tag)
        & rows.storage_key.eq_mask(nxt.storage_key)
    )
    is_read = rows.is_write.is_zero_mask()

    # 0.5 read consistency + initial value propagation
    cs.check(
        rows.value.eq_mask(prev.value) | ~(is_read & keys_eq_prev),
        lambda: "read value differs from previous access",
    )
    cs.check(
        rows.initial_value.eq_mask(prev.initial_value) | ~keys_eq_prev,
        lambda: "initial value changed within key group",
    )
    # rwc != 0 for non-Start
    cs.check(
        ~rows.rw_counter.is_zero_mask() | ~not_start,
        lambda: "rw_counter is 0 on non-Start row",
    )

    root_same = rows.root.eq_mask(prev.root)
    value_lo_zero = rows.value.lo.is_zero_mask()
    value_is_byte = rows.value.lo.le_bits_mask(8) & rows.value.hi.is_zero_mask()

    def tag_mask(t: Tag):
        return rows.tag.eq_mask(int(t))

    def check(mask, ok, msg):
        cs.check(ok | ~mask, lambda: msg)

    # -- Start (reference :218-236)
    m = tag_mask(Tag.Start)
    check(m, rows.field_tag.is_zero_mask(), "Start: field_tag != 0")
    check(m, rows.address.is_zero_mask(), "Start: address != 0")
    check(m, rows.id.is_zero_mask(), "Start: id != 0")
    check(m, rows.storage_key.is_zero_mask(), "Start: storage_key != 0")
    check(m, rows.value.is_zero_mask(), "Start: value != 0")
    check(m, rows.initial_value.is_zero_mask(), "Start: initial value != 0")
    sel = ~rows.lexicographic_ordering_selector.is_zero_mask()
    check(
        m & sel,
        rows.rw_counter.eq_mask(prev.rw_counter + 1),
        "Start: rw_counter does not increase by 1",
    )
    check(m & sel, root_same, "Start: root changed")

    # -- Memory (reference :240-266)
    m = tag_mask(Tag.Memory)
    check(m, rows.field_tag.is_zero_mask(), "Memory: field_tag != 0")
    check(m, rows.storage_key.is_zero_mask(), "Memory: storage_key != 0")
    check(m & ~keys_eq_prev & is_read, value_lo_zero, "Memory: first read not 0")
    check(m, rows.address.le_bits_mask(32), "Memory: address out of range")
    check(m, value_is_byte, "Memory: value not a byte")
    check(m, rows.initial_value.is_zero_mask(), "Memory: initial value != 0")
    check(m, root_same, "Memory: root changed")

    # -- Stack (reference :270-301)
    m = tag_mask(Tag.Stack)
    check(m, rows.field_tag.is_zero_mask(), "Stack: field_tag != 0")
    check(m, rows.storage_key.is_zero_mask(), "Stack: storage_key != 0")
    check(m & ~keys_eq_prev, ~is_read, "Stack: first access is a read")
    check(m, rows.address.le_bits_mask(16) & ~F.const(ctx, MAX_STACK_PTR).lt_mask(rows.address),
          "Stack: stack pointer out of range")
    same_call = rows.tag.eq_mask(prev.tag) & rows.id.eq_mask(prev.id)
    diff = rows.address - prev.address
    diff_ok = diff.is_zero_mask() | diff.eq_mask(1)
    check(m & same_call, diff_ok, "Stack: pointer changes by more than 1")
    check(m, rows.initial_value.is_zero_mask(), "Stack: initial value != 0")
    check(m, root_same, "Stack: root changed")

    # -- Storage (reference :305-324)
    m = tag_mask(Tag.Storage)
    check(m, rows.field_tag.is_zero_mask(), "Storage: field_tag != 0")
    is_non_exist = rows.value.is_zero_mask() & rows.initial_value.is_zero_mask()
    proof_type = F.from_bool(ctx, is_non_exist) * int(MPTProofType.NonExistingAccountProof) + (
        1 - F.from_bool(ctx, is_non_exist)
    ) * int(MPTProofType.StorageMod)
    mpt.lookup(
        cs,
        {
            "address": rows.address,
            "proof_type": proof_type,
            "storage_key": rows.storage_key,
            "value": rows.value,
            "value_prev": rows.initial_value,
            "root": rows.root,
            "root_prev": prev.root,
        },
        enabled=m & ~keys_eq_next,
    )
    check(m & keys_eq_next, root_same, "Storage: root changed on non-last access")

    # -- CallContext (reference :328-345)
    m = tag_mask(Tag.CallContext)
    check(m, rows.address.is_zero_mask(), "CallContext: address != 0")
    check(m, rows.storage_key.is_zero_mask(), "CallContext: storage_key != 0")
    check(m & ~keys_eq_prev & is_read, value_lo_zero, "CallContext: first read not 0")
    check(m, rows.initial_value.is_zero_mask(), "CallContext: initial value != 0")
    check(m, root_same, "CallContext: root changed")

    # -- Account (reference :349-380)
    m = tag_mask(Tag.Account)
    check(m, rows.id.is_zero_mask(), "Account: id != 0")
    check(m, rows.storage_key.is_zero_mask(), "Account: storage_key != 0")
    m_nonce = m & rows.field_tag.eq_mask(int(AccountFieldTag.Nonce))
    check(m_nonce, rows.value.hi.is_zero_mask(), "Account: nonce hi != 0")
    check(m_nonce, rows.initial_value.hi.is_zero_mask(), "Account: nonce initial hi != 0")
    valid_ft = None
    for ft in AccountFieldTag:
        e = rows.field_tag.eq_mask(int(ft))
        valid_ft = e if valid_ft is None else (valid_ft | e)
    check(m, valid_ft, "Account: invalid field tag")
    acc_non_exist = (
        rows.value.is_zero_mask()
        & rows.initial_value.is_zero_mask()
        & rows.field_tag.eq_mask(int(AccountFieldTag.CodeHash))
    )
    # proof_type == field_tag numerically (AccountFieldTag and MPTProofType
    # share values 1..4 for Nonce/Balance/CodeHash/NonExisting)
    acc_proof_type = F.from_bool(ctx, acc_non_exist) * int(
        MPTProofType.NonExistingAccountProof
    ) + (1 - F.from_bool(ctx, acc_non_exist)) * rows.field_tag
    mpt.lookup(
        cs,
        {
            "address": rows.address,
            "proof_type": acc_proof_type,
            "storage_key": rows.storage_key,
            "value": rows.value,
            "value_prev": rows.initial_value,
            "root": rows.root,
            "root_prev": prev.root,
        },
        enabled=m & ~keys_eq_next,
    )
    check(m & keys_eq_next, root_same, "Account: root changed on non-last access")

    # -- TxRefund (reference :387-402)
    m = tag_mask(Tag.TxRefund)
    check(m, rows.address.is_zero_mask(), "TxRefund: address != 0")
    check(m, rows.field_tag.is_zero_mask(), "TxRefund: field_tag != 0")
    check(m, rows.storage_key.is_zero_mask(), "TxRefund: storage_key != 0")
    check(m, root_same, "TxRefund: root changed")
    check(m, rows.initial_value.is_zero_mask(), "TxRefund: initial value != 0")
    check(m & ~keys_eq_prev & is_read, rows.value.is_zero_mask(), "TxRefund: first read not 0")

    # -- TxAccessListAccount (reference :406-419)
    m = tag_mask(Tag.TxAccessListAccount)
    check(m, rows.field_tag.is_zero_mask(), "TxAccessListAccount: field_tag != 0")
    check(m, rows.storage_key.is_zero_mask(), "TxAccessListAccount: storage_key != 0")
    check(m, rows.value.hi.is_zero_mask(), "TxAccessListAccount: value hi != 0")
    check(m, rows.initial_value.hi.is_zero_mask(), "TxAccessListAccount: initial hi != 0")
    check(m, root_same, "TxAccessListAccount: root changed")
    check(m & ~keys_eq_prev & is_read, value_lo_zero, "TxAccessListAccount: first read not 0")

    # -- TxAccessListAccountStorage (reference :423-435)
    m = tag_mask(Tag.TxAccessListAccountStorage)
    check(m, rows.field_tag.is_zero_mask(), "TxAccessListAccountStorage: field_tag != 0")
    check(m, rows.value.hi.is_zero_mask(), "TxAccessListAccountStorage: value hi != 0")
    check(m, rows.initial_value.hi.is_zero_mask(), "TxAccessListAccountStorage: initial hi != 0")
    check(m, root_same, "TxAccessListAccountStorage: root changed")
    check(m & ~keys_eq_prev & is_read, value_lo_zero, "TxAccessListAccountStorage: first read not 0")

    # -- TxLog (reference :439-456)
    m = tag_mask(Tag.TxLog)
    not_topic = ~rows.field_tag.eq_mask(int(TxLogFieldTag.Topic))
    check(m & not_topic, rows.value.hi.is_zero_mask(), "TxLog: value hi != 0")
    check(m & not_topic, rows.initial_value.hi.is_zero_mask(), "TxLog: initial hi != 0")
    check(m, ~is_read, "TxLog: not a write")
    check(m, root_same, "TxLog: root changed")

    # -- TxReceipt (reference :460-488)
    m = tag_mask(Tag.TxReceipt)
    check(m, rows.address.is_zero_mask(), "TxReceipt: address != 0")
    check(m, rows.storage_key.is_zero_mask(), "TxReceipt: storage_key != 0")
    check(m, rows.value.hi.is_zero_mask(), "TxReceipt: value hi != 0")
    check(m, rows.initial_value.hi.is_zero_mask(), "TxReceipt: initial hi != 0")
    m_status = m & rows.field_tag.eq_mask(int(TxReceiptFieldTag.PostStateOrStatus))
    check(m_status, rows.value.lo.le_bits_mask(1), "TxReceipt: status not bool")
    id_change = ~rows.id.eq_mask(prev.id) & rows.tag.eq_mask(prev.tag)
    check(m & id_change, rows.id.eq_mask(prev.id + 1), "TxReceipt: tx id not incremented by 1")
    m_gas = m & id_change & rows.field_tag.eq_mask(int(TxReceiptFieldTag.CumulativeGasUsed))
    check(
        m_gas,
        prev.value.lo.lt_mask(rows.value.lo),
        "TxReceipt: cumulative gas not increasing",
    )
    tag_change = ~rows.tag.eq_mask(prev.tag)
    check(m & tag_change, rows.id.eq_mask(1), "TxReceipt: first tx id != 1")
    check(m, ~rows.id.is_zero_mask() & rows.id.le_bits_mask(12)
          & ~F.const(ctx, 2**11).lt_mask(rows.id), "TxReceipt: tx id out of range")

    return cs


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def pack_state_inputs(rows: List[dict], mpt_rows: List[dict]):
    """State rows and the mock-MPT table as flat limb trees, plus the static
    meta (bit bounds, sizes, the MPT index's span) that
    ``make_state_check_fn`` needs to rebuild them; the trees have the JAX
    package's layout (``state.py:519-557``): limbs as CPU int64 tensors,
    the MPT index as numpy ``uint64`` fingerprints and ``int64`` order."""
    ctx = Ctx("cpu", len(rows), "eager")
    state = StateRows(ctx, rows)
    mpt = Table.from_rows(ctx, MPT_SCHEMA, mpt_rows)
    subset = tuple(MPT_SCHEMA.columns)
    mpt.index_for(subset)

    cols = {name: getattr(state, name).limbs for name in StateRows._BITS}
    for name in StateRows._WORDS:
        w = getattr(state, name)
        cols[name + "_lo"] = w.lo.limbs
        cols[name + "_hi"] = w.hi.limbs

    mpt_tree = {
        "cols": {c: ({"lo": v.lo.limbs, "hi": v.hi.limbs} if isinstance(v, Word)
                     else {"f": v.limbs}) for c, v in mpt.data.items()},
        "fps": mpt._indexes[subset][0],
        "order": mpt._indexes[subset][1],
    }
    meta = {
        "n": len(rows),
        "bits": {name: getattr(state, name).bits for name in StateRows._BITS},
        "wbits": {name: (getattr(state, name).lo.bits, getattr(state, name).hi.bits)
                  for name in StateRows._WORDS},
        "mpt_bits": {c: ((v.lo.bits, v.hi.bits) if isinstance(v, Word) else v.bits)
                     for c, v in mpt.data.items()},
        "mpt_rows": mpt.n_rows,
        "subset": subset,
        "mpt_span": mpt._indexes[subset][2],
    }
    return cols, mpt_tree, meta


def make_state_check_fn(meta, device="cuda"):
    """The state check for inputs of the given meta (from
    ``pack_state_inputs``): a callable ``fn(cols, mpt_tree)`` over trees on
    ``device`` (``runtime.convert.to_device``) that runs ``check_state_rows``
    in a "device" context and returns the ``[n]`` bool fail bits there.
    ``device`` is the card unless the caller asks for "cpu"; there is no
    fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_state_check_fn: device 'cuda' requested but no CUDA device "
                           "is available; pass device='cpu' to check on the CPU")

    def fn(cols, mpt_tree):
        ctx = Ctx(device, meta["n"], "device")
        st = object.__new__(StateRows)
        st.ctx = ctx
        st.n = meta["n"]
        for name in StateRows._BITS:
            setattr(st, name, F(ctx, cols[name], meta["bits"][name]))
        for name in StateRows._WORDS:
            lo_b, hi_b = meta["wbits"][name]
            setattr(st, name, Word(F(ctx, cols[name + "_lo"], lo_b),
                                   F(ctx, cols[name + "_hi"], hi_b)))
        data = {}
        for c, arrs in mpt_tree["cols"].items():
            b = meta["mpt_bits"][c]
            if "lo" in arrs:
                data[c] = Word(F(ctx, arrs["lo"], b[0]), F(ctx, arrs["hi"], b[1]))
            else:
                data[c] = F(ctx, arrs["f"], b)
        mpt = Table(ctx, MPT_SCHEMA, data, meta["mpt_rows"])
        mpt._indexes[tuple(meta["subset"])] = (mpt_tree["fps"], mpt_tree["order"],
                                               meta.get("mpt_span", 8))
        return check_state_rows(ctx, st, mpt).fail

    return fn


def verify_state_rows(rows: List[dict], mpt_rows: List[dict], success: bool = True):
    """Reference-equivalent check (the JAX package's ``state.py:592-606``):
    cyclic prev/next over the whole row set, one eager batched evaluation on
    the host, the earliest failing row raising."""
    ctx = Ctx("cpu", len(rows), "eager")
    state = StateRows(ctx, rows)
    mpt = Table.from_rows(ctx, MPT_SCHEMA, mpt_rows)
    cs = check_state_rows(ctx, state, mpt)
    fail = cs.fail.numpy()
    if success:
        if fail.any():
            idx = int(np.argmax(fail))
            msgs = cs.first_failure_message()
            raise AssertionError(f"state row {idx}: {msgs[idx]}")
    else:
        assert fail.any(), "expected state circuit to fail, but all rows passed"
