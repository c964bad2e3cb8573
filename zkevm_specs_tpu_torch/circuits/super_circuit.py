"""The block's glue between circuits: the rw rows as state-circuit
operations, the pi circuit's view of a block, and the in-circuit prologue
check.

Counterpart of ``zkevm_specs_tpu/circuits/super_circuit.py``
(``rw_rows_to_state_ops`` :62-118, ``public_data_from_witness`` :121-155,
``build_prologue_inputs`` /
``_canon_u32`` / ``check_prologue`` / ``prologue_kernel`` :327-495).  The
tracer prepends a prologue of call-context setup writes at rw counters
1..K; the prologue check pins those rows in-circuit: their counters, keys
and ids, the constant values, IsPersistent == IsSuccess, the root-frame
values against the tx table and the code hash against the bytecode table.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..dsl.value import Ctx, F, Word
from ..tables.container import Tables
from ..tables.schemas import BytecodeFieldTag, Target, TxLogFieldTag
from ..tables.schemas import CallContextFieldTag as CC
from ..tables.schemas import TxContextFieldTag as TT
from ..utils.typing import is_circuit_code
from ..witness.tracer import _N_SETUP_ROWS, BlockWitness
from .state import (
    AccountOp,
    CallContextOp,
    MemoryOp,
    Operation,
    StackOp,
    StartOp,
    StorageOp,
    Tag,
    TxAccessListAccountOp,
    TxAccessListAccountStorageOp,
    TxLogOp,
    TxReceiptOp,
    TxRefundOp,
)

_TARGET_TO_TAG = {
    Target.Start: Tag.Start,
    Target.Memory: Tag.Memory,
    Target.Stack: Tag.Stack,
    Target.AccountStorage: Tag.Storage,
    Target.CallContext: Tag.CallContext,
    Target.Account: Tag.Account,
    Target.TxRefund: Tag.TxRefund,
    Target.TxAccessListAccount: Tag.TxAccessListAccount,
    Target.TxAccessListAccountStorage: Tag.TxAccessListAccountStorage,
    Target.TxLog: Tag.TxLog,
    Target.TxReceipt: Tag.TxReceipt,
}


def rw_rows_to_state_ops(rw_rows: List[dict]) -> List[Operation]:
    """The EVM circuit's rw rows as sorted state-circuit operations (the
    Target->Tag numbering differs; CallContext packs field_tag in
    `address`, TxLog packs log_id/field_tag/index)."""
    ops: List[Operation] = []
    initial_values: Dict[tuple, int] = {}
    for row in rw_rows:
        target = Target(row["key0"])
        tag = _TARGET_TO_TAG[target]
        rwc, rw = row["rw_counter"], row["rw"]
        if target == Target.Start:
            op = StartOp(rwc, rw)
        elif target == Target.Memory:
            op = MemoryOp(rwc, rw, row["id"], row["address"], row["value"])
        elif target == Target.Stack:
            op = StackOp(rwc, rw, row["id"], row["address"], row["value"])
        elif target == Target.CallContext:
            op = CallContextOp(rwc, rw, row["id"], row["address"], row["value"])
        elif target == Target.Account:
            key = (tag, row["address"], row["field_tag"])
            committed = initial_values.setdefault(key, row["value_prev"])
            op = AccountOp(rwc, rw, row["address"], row["field_tag"], row["value"], committed)
        elif target == Target.AccountStorage:
            key = (tag, row["address"], row["storage_key"])
            committed = initial_values.setdefault(key, row["value_prev"])
            op = StorageOp(rwc, rw, row["id"], row["address"], row["storage_key"],
                           row["value"], committed)
        elif target == Target.TxRefund:
            op = TxRefundOp(rwc, rw, row["id"], row["value"])
        elif target == Target.TxAccessListAccount:
            op = TxAccessListAccountOp(rwc, rw, row["id"], row["address"], row["value"])
        elif target == Target.TxAccessListAccountStorage:
            op = TxAccessListAccountStorageOp(rwc, rw, row["id"], row["address"],
                                              row["storage_key"], row["value"])
        elif target == Target.TxLog:
            addr = row["address"]
            op = TxLogOp(rwc, rw, row["id"], addr >> 48, TxLogFieldTag((addr >> 32) & 0xFFFF),
                         addr & 0xFFFFFFFF, row["value"])
        elif target == Target.TxReceipt:
            op = TxReceiptOp(rwc, rw, row["id"], row["field_tag"], row["value"])
        else:
            raise ValueError(target)
        ops.append(op)

    ops.sort(key=lambda op: (int(op.tag), int(op.id), int(op.address), int(op.field_tag),
                             int(op.storage_key), int(op.rw_counter)))
    # the first Start row must have the lexicographic selector disabled
    if ops and ops[0].tag == Tag.Start:
        ops[0].lexicographic_ordering_selector = 0
    return ops


def public_data_from_witness(witness: BlockWitness, MAX_WITHDRAWALS: int):
    """The pi circuit's ``PublicData`` of a block witness: the block and tx
    data the EVM tables carry, plus the header fields the EVM circuit never
    reads, mocked as in the reference (``tx_sign_hash`` 1234, reference
    typing.py:265); the withdrawals padded to ``MAX_WITHDRAWALS`` with zero
    amounts that continue the id chain, as the withdrawal circuit pads."""
    from .pi import Block as PiBlock, PublicData
    from .pi import Transaction as PiTransaction, Withdrawal as PiWithdrawal

    b = witness.block
    hashes = [0] * (256 - len(b.history_hashes)) + list(b.history_hashes)
    pi_block = PiBlock(
        hash=0, parent_hash=hashes[-1] if hashes else 0, uncle_hash=0,
        coinbase=b.coinbase, state_root=0, tx_hash=0, receipt_hash=0,
        bloom=bytes(256), prev_randao=b.prev_randao, number=b.number,
        gas_limit=b.gas_limit, gas_used=0, time=b.timestamp, extra=b"",
        mix_digest=0, nonce=0, base_fee=b.base_fee,
        withdrawals_root=b.withdrawal_root,
    )
    pi_txs = [PiTransaction(nonce=tx.nonce, gas_price=tx.gas_price, gas=tx.gas,
                            from_addr=tx.caller_address, to_addr=tx.callee_address,
                            value=tx.value, data=bytes(tx.call_data), tx_sign_hash=1234)
              for tx in witness.txs]
    pi_wds = [PiWithdrawal(wd.id, wd.validator_id, wd.address, wd.amount)
              for wd in witness.withdrawals]
    while len(pi_wds) < MAX_WITHDRAWALS:
        next_id = pi_wds[-1].id + 1 if pi_wds else 0
        pi_wds.append(PiWithdrawal(next_id, 0, 0, 0))
    return PublicData(chain_id=witness.block.chainid, block=pi_block, state_root_prev=0,
                      block_hashes=hashes, txs=pi_txs, withdrawals=pi_wds)


def build_prologue_inputs(witness: BlockWitness, tables: Tables):
    """Columns, lookup tables and expectation arrays of the prologue check:
    the first K rw counters must be exactly the canonical call-context
    (and memory) setup writes."""
    rws = sorted(witness.rw.rws, key=lambda r: r["rw_counter"])
    rws = [r for r in rws if r["key0"] != int(Target.Start)]
    n_setup = sum(len(s) for s in witness.subcall_setups) + len(witness.memory_setups)
    K = _N_SETUP_ROWS * len(witness.txs) + n_setup
    rows = rws[:K]
    assert len(rows) == K, "prologue: rw table shorter than the setup region"

    exp_key0 = np.full(K, int(Target.CallContext), dtype=np.int64)
    exp_addr = np.zeros(K, dtype=np.int64)
    exp_id = np.zeros(K, dtype=np.int64)
    const_mask = np.zeros(K, dtype=bool)
    const_val = np.zeros(K, dtype=np.int64)
    tx_mask = np.zeros(K, dtype=bool)
    tx_tag = np.zeros(K, dtype=np.int64)
    tx_id = np.zeros(K, dtype=np.int64)
    pair_mask = np.zeros(K, dtype=bool)
    pair_idx = np.zeros(K, dtype=np.int64)
    hash_mask = np.zeros(K, dtype=bool)

    tags = (CC.TxId, CC.RwCounterEndOfReversion, CC.IsPersistent, CC.IsSuccess,
            CC.Depth, CC.CallerAddress, CC.CalleeAddress, CC.CallDataLength,
            CC.Value, CC.IsRoot, CC.CodeHash)
    assert len(tags) == _N_SETUP_ROWS
    for i, tx in enumerate(witness.txs):
        b = i * _N_SETUP_ROWS
        for j, tag in enumerate(tags):
            exp_addr[b + j] = int(tag)
        # the call id is the row's own id column; all 11 rows are paired
        # with the first row's id (cross-checked by the state circuit
        # against BeginTx's reads at call_id == rw_counter)
        const_mask[b + 0] = True
        const_val[b + 0] = tx.id          # TxId value
        pair_mask[b + 2] = True           # IsPersistent == IsSuccess
        pair_idx[b + 2] = b + 3
        const_mask[b + 4] = True
        const_val[b + 4] = 1              # Depth
        for j, tt in ((5, TT.CallerAddress), (6, TT.CalleeAddress),
                      (7, TT.CallDataLength), (8, TT.Value)):
            tx_mask[b + j] = True
            tx_tag[b + j] = int(tt)
            tx_id[b + j] = tx.id
        const_mask[b + 9] = True
        const_val[b + 9] = 1              # IsRoot
        hash_mask[b + 10] = True          # CodeHash in bytecode table
    k = _N_SETUP_ROWS * len(witness.txs)
    for setup in witness.subcall_setups:
        for callee_id, tag, _value in setup:
            exp_addr[k] = int(tag)
            exp_id[k] = callee_id
            k += 1
    for callee_id, addr, _byte in witness.memory_setups:
        exp_key0[k] = int(Target.Memory)
        exp_addr[k] = addr
        exp_id[k] = callee_id
        k += 1
    # root-region ids: all 11 rows of tx i share the id of their own rows
    for i in range(len(witness.txs)):
        b = i * _N_SETUP_ROWS
        exp_id[b:b + _N_SETUP_ROWS] = rows[b]["id"]

    ctx = Ctx("cpu", K, "eager")
    cols = {
        "rw_counter": F.from_ints(ctx, [r["rw_counter"] for r in rows], 32),
        "key0": F.from_ints(ctx, [r["key0"] for r in rows], 8),
        "rw": F.from_ints(ctx, [r["rw"] for r in rows], 1),
        "id": F.from_ints(ctx, [r["id"] for r in rows], 32),
        "address": F.from_ints(ctx, [r["address"] for r in rows], 160),
        "value": Word.from_ints(ctx, [r["value"] for r in rows]),
    }
    extra = {
        "exp_key0": exp_key0, "exp_addr": exp_addr, "exp_id": exp_id,
        "const_mask": const_mask, "const_val": const_val,
        "tx_mask": tx_mask, "tx_tag": tx_tag, "tx_id": tx_id,
        "pair_mask": pair_mask, "pair_idx": pair_idx,
        "hash_mask": hash_mask,
    }
    # the tables re-bound to the prologue's batch context
    ktables = {"tx": tables.tx.to_backend(ctx), "bytecode": tables.bytecode.to_backend(ctx)}
    return cols, ktables, extra


def _canon_u32(ctx: Ctx, arr: torch.Tensor, bits: int) -> F:
    """Canonical 16-bit-limb F column of u32 values (call ids and rw
    counters pass 2^16 in large blocks)."""
    a = arr.to(torch.int64) & 0xFFFFFFFF
    return F(ctx, torch.stack([a & 0xFFFF, (a >> 16) & 0xFFFF], dim=-1), bits)


@is_circuit_code
def check_prologue(ctx: Ctx, cs, c, tables, static, extra):
    """Constraint body of the prologue region, eager and on the device
    alike; ``extra`` holds tensors on the context's device."""
    n = ctx.batch
    arange = _canon_u32(ctx, torch.arange(1, n + 1, dtype=torch.int64, device=ctx.device), 32)
    cs.constrain_equal(c["rw_counter"], arange, name="prologue rw_counter")
    cs.constrain_equal(c["rw"], F.const(ctx, 1), name="prologue not a write")

    key0 = F(ctx, (extra["exp_key0"] & 0xFFFFFFFF)[:, None], 8)
    cs.constrain_equal(c["key0"], key0, name="prologue target")
    cs.constrain_equal(c["address"], _canon_u32(ctx, extra["exp_addr"], 160),
                       name="prologue key")
    cs.constrain_equal(c["id"], _canon_u32(ctx, extra["exp_id"], 32), name="prologue call id")

    m_const = extra["const_mask"]
    cv = _canon_u32(ctx, extra["const_val"], 64)
    cs.check(~m_const | (c["value"].lo.eq_mask(cv) & c["value"].hi.is_zero_mask()),
             lambda: "prologue const value mismatch")

    m_pair = extra["pair_mask"]
    partner = c["value"].lo.gather(extra["pair_idx"])
    cs.check(~m_pair | c["value"].lo.eq_mask(partner),
             lambda: "prologue IsPersistent != IsSuccess")
    cs.check(~m_pair | (c["value"].lo.is_zero_mask() | c["value"].lo.eq_mask(F.const(ctx, 1))),
             lambda: "prologue IsPersistent not boolean")

    m_tx = extra["tx_mask"]
    row = tables["tx"].lookup(cs, {
        "tx_id": _canon_u32(ctx, extra["tx_id"], 32),
        "field_tag": F(ctx, (extra["tx_tag"] & 0xFFFFFFFF)[:, None], 8),
        "call_data_index_or_zero": F.const(ctx, 0),
    }, enabled=m_tx)
    cs.check(~m_tx | (c["value"].lo.eq_mask(row.value.lo) & c["value"].hi.eq_mask(row.value.hi)),
             lambda: "prologue value != tx table")

    tables["bytecode"].lookup(cs, {
        "bytecode_hash": c["value"],
        "field_tag": F.const(ctx, int(static["header_tag"])),
        "index": F.const(ctx, 0),
    }, enabled=extra["hash_mask"])


def prologue_kernel(witness: BlockWitness, tables: Tables, device="cuda"):
    """The prologue check as one ``CircuitKernel`` on ``device`` (the card
    unless the caller asks for "cpu")."""
    from ..runtime.kernels import CircuitKernel

    cols, ktables, extra = build_prologue_inputs(witness, tables)
    return CircuitKernel("prologue", check_prologue, cols, ktables,
                         {"header_tag": int(BytecodeFieldTag.Header)}, extra, device=device)


def sig_witness_from_txs(signed_txs, chain_id: int, keccak_randomness: int):
    """The sig-circuit rows of a block's signed txs (the JAX package's
    ``super_circuit.sig_witness_from_txs``, :157-176; reference
    sig_circuit.py)."""
    from ..ops.ecc import secp256k1
    from ..ops.keccak import keccak256
    from .sig import KeccakTable, SigRow, Witness

    kt = KeccakTable()
    rows = []
    for tx in signed_txs:
        h = keccak256(tx.sign_data(chain_id))
        parity = tx.sig_v - 35 - chain_id * 2
        pk = secp256k1.recover(int.from_bytes(h, "big"), parity, tx.sig_r, tx.sig_s)
        kt.add(secp256k1.pubkey_bytes(pk), keccak_randomness)
        rows.append(SigRow.assign((parity, tx.sig_r, tx.sig_s), pk, h))
    return Witness(rows, kt)
