"""Tx circuit: the tx table's layout and its signatures
(reference: src/zkevm_specs/tx_circuit.py:1-478).

Counterpart of ``zkevm_specs_tpu/circuits/tx.py``.  The witness RLP-encodes
each tx's sign data, recovers its key and links the address
keccak(pk)[-20:] through the keccak table; every tx slot is checked in one
batched constraint body (``circuits/sig.py:check_signverify`` plus the
tx-table copy constraints).  On the card (``tx_kernel``, a
``CircuitKernel``) the pk-bytes RLC runs on K8 and the keccak lookup on K6.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F, Word
from ..ops.ecc import secp256k1
from ..ops.keccak import keccak256
from ..tables.schemas import TxContextFieldTag as Tag
from ..utils.param import (
    GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE,
    GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE,
)
from ..utils.typing import is_circuit_code
from ..witness.rlp import rlp_encode
from .sig import KeccakTable, build_signverify_inputs, check_signverify, keccak_lookup_table


class Row(NamedTuple):
    tx_id: int
    tag: int
    index: int
    value: int  # word or value as an int


class SignVerifyChip:
    """Links an Ethereum address to a signed message hash
    (reference tx_circuit.py:161-243); address 0 disables the link (a
    padding tx)."""

    def __init__(self, pub_key_hash: bytes, address: int, msg_hash: int,
                 signature: Tuple[int, int], pub_key: Tuple[int, int], msg_hash_int: int):
        self.pub_key_hash = pub_key_hash
        self.address = address
        self.msg_hash = msg_hash
        self.signature = signature
        self.pub_key = pub_key
        self.msg_hash_int = msg_hash_int

    @classmethod
    def assign(cls, signature: Tuple[int, int], pub_key: Tuple[int, int], msg_hash: bytes):
        pub_key_hash = keccak256(secp256k1.pubkey_bytes(pub_key))
        address = int.from_bytes(pub_key_hash[-20:], "big")
        h = int.from_bytes(msg_hash, "big")
        return cls(pub_key_hash, address, h, signature, pub_key, h)


class Witness(NamedTuple):
    rows: List[Row]
    keccak_table: KeccakTable
    sign_verifications: List[SignVerifyChip]


def _tx_inputs(witness: Witness, MAX_TXS: int, ctx: Ctx,
               evm_callers: Optional[List[int]] = None):
    """Columns and host-crypto hints for ``check_tx``, one lane per tx slot
    (reference tx_circuit.py:253-291).  ``evm_callers``: the CallerAddress
    values of the block's EVM-side tx table; when given, ``check_tx`` binds
    them to the recovered addresses (the tx circuit produces the tx table
    the EVM circuit consumes, reference specs/tx-proof.md)."""
    rows = witness.rows
    chips = witness.sign_verifications
    cols, extra = build_signverify_inputs(
        ctx,
        [c.pub_key for c in chips],
        [c.pub_key_hash for c in chips],
        [c.address for c in chips],
        [0 if c.address == 0 else 1 for c in chips],
        [c.msg_hash_int for c in chips],
        [c.signature for c in chips],
        [1] * MAX_TXS,  # every chip (the dummy-signed padding too) verifies
    )
    caller_values, hash_values, chip_hashes = [], [], []
    for tx_index in range(MAX_TXS):
        tx_row_index = tx_index * int(Tag.TxSignHash)
        caller_values.append(rows[tx_row_index + int(Tag.CallerAddress) - 1].value)
        hash_values.append(rows[tx_row_index + int(Tag.TxSignHash) - 1].value)
        chip_hashes.append(chips[tx_index].msg_hash)
    cols["caller_addr_value"] = F.from_ints(ctx, caller_values, 160)
    cols["tx_sign_hash_value"] = Word.from_ints(ctx, hash_values)
    cols["msg_hash"] = Word.from_ints(ctx, chip_hashes)
    if evm_callers is not None:
        padded = list(evm_callers) + [0] * (MAX_TXS - len(evm_callers))
        cols["evm_caller_addr"] = F.from_ints(ctx, padded, 160)
    return cols, extra


@is_circuit_code
def check_tx(ctx: Ctx, cs: ConstraintSystem, cols, tables, static, extra):
    """The tx-circuit body: the shared sign-verify rules, then the copy
    constraints that bind the tx-table rows to the chips
    (reference tx_circuit.py:253-291)."""
    check_signverify(ctx, cs, cols, tables, static, extra)
    cs.constrain_equal(cols["caller_addr_value"], cols["recovered_addr"],
                       "tx caller address vs recovered address")
    cs.constrain_equal_word(cols["tx_sign_hash_value"], cols["msg_hash"],
                            "tx sign hash vs signed message hash")
    if "evm_caller_addr" in cols:
        # the block-level binding: the EVM circuit's tx-table sender is the
        # recovered signer (padding slots are 0 on both sides)
        cs.constrain_equal(cols["evm_caller_addr"], cols["recovered_addr"],
                           "EVM tx-table caller vs recovered signer")


def verify_circuit(witness: Witness, MAX_TXS: int, MAX_CALLDATA_BYTES: int,
                   keccak_randomness: int, success: bool = True,
                   evm_callers: Optional[List[int]] = None) -> None:
    """Spec-mode (eager, host) driver with reference verdict semantics."""
    from ..runtime.kernels import run_spec

    ctx = Ctx("cpu", MAX_TXS, "eager")
    cols, extra = _tx_inputs(witness, MAX_TXS, ctx, evm_callers)
    run_spec("tx", check_tx, cols, {"keccak": keccak_lookup_table(ctx, witness.keccak_table)},
             {"r": keccak_randomness}, extra, success=success, label="tx")


def tx_kernel(witness: Witness, MAX_TXS: int, keccak_randomness: int,
              evm_callers: Optional[List[int]] = None, device="cuda"):
    """Production path: the same constraint body as one ``CircuitKernel``
    on ``device`` (the card unless the caller asks for "cpu")."""
    from ..runtime.kernels import CircuitKernel

    ctx = Ctx("cpu", MAX_TXS, "eager")
    cols, extra = _tx_inputs(witness, MAX_TXS, ctx, evm_callers)
    return CircuitKernel("tx", check_tx, cols,
                         {"keccak": keccak_lookup_table(ctx, witness.keccak_table, True)},
                         {"r": keccak_randomness}, extra, device=device)


# -- witness generation ------------------------------------------------------------

class Transaction(NamedTuple):
    nonce: int
    gas_price: int
    gas: int
    to: Optional[int]
    value: int
    data: bytes
    sig_v: int
    sig_r: int
    sig_s: int

    def encode_to(self) -> bytes:
        if self.to is None:
            return bytes(0)
        return self.to.to_bytes(20, "big")

    def sign_data(self, chain_id: int) -> bytes:
        """The RLP of the EIP-155 sign data."""
        return rlp_encode([self.nonce, self.gas_price, self.gas, self.encode_to(), self.value,
                           self.data, chain_id, 0, 0])


def padding_tx(tx_id: int) -> List[Row]:
    tags = [Tag.Nonce, Tag.Gas, Tag.GasPrice, Tag.CallerAddress, Tag.CalleeAddress,
            Tag.IsCreate, Tag.Value, Tag.CallDataLength, Tag.CallDataGasCost,
            Tag.TxInvalid, Tag.AccessListGasCost, Tag.TxSignHash]
    return [Row(tx_id, int(t), 0, 0) for t in tags]


def tx2witness(index: int, tx: Transaction, chain_id: int, keccak_randomness: int,
               keccak_table: KeccakTable) -> Tuple[List[Row], SignVerifyChip]:
    """Reference tx_circuit.py:315-397."""
    tx_sign_hash = keccak256(tx.sign_data(chain_id))
    sig_parity = tx.sig_v - 35 - chain_id * 2
    pk = secp256k1.recover(int.from_bytes(tx_sign_hash, "big"), sig_parity, tx.sig_r, tx.sig_s)
    assert pk is not None, "cannot recover public key from signature"
    pk_bytes = secp256k1.pubkey_bytes(pk)
    keccak_table.add(pk_bytes, keccak_randomness)
    addr = keccak256(pk_bytes)[-20:]

    sign_verification = SignVerifyChip.assign((tx.sig_r, tx.sig_s), pk, tx_sign_hash)
    call_data_gas_cost = sum(GAS_COST_TX_CALL_DATA_PER_ZERO_BYTE if b == 0
                             else GAS_COST_TX_CALL_DATA_PER_NON_ZERO_BYTE for b in tx.data)
    tx_id = index + 1
    rows: List[Row] = [
        Row(tx_id, int(Tag.Nonce), 0, tx.nonce),
        Row(tx_id, int(Tag.Gas), 0, tx.gas),
        Row(tx_id, int(Tag.GasPrice), 0, tx.gas_price),
        Row(tx_id, int(Tag.CallerAddress), 0, int.from_bytes(addr, "big")),
        Row(tx_id, int(Tag.CalleeAddress), 0, tx.to or 0),
        Row(tx_id, int(Tag.IsCreate), 0, 1 if tx.to is None else 0),
        Row(tx_id, int(Tag.Value), 0, tx.value),
        Row(tx_id, int(Tag.CallDataLength), 0, len(tx.data)),
        Row(tx_id, int(Tag.CallDataGasCost), 0, call_data_gas_cost),
        Row(tx_id, int(Tag.TxInvalid), 0, 0),
        Row(tx_id, int(Tag.AccessListGasCost), 0, 0),
        Row(tx_id, int(Tag.TxSignHash), 0, int.from_bytes(tx_sign_hash, "big")),
    ]
    rows += [Row(tx_id, int(Tag.CallData), i, byte) for i, byte in enumerate(tx.data)]
    return rows, sign_verification


# the dummy signature of the padding slots (reference tx_circuit.py:405-413):
# secret key 1, message 1
DUMMY_SIGNATURE = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81799,
)
DUMMY_PUBLIC_KEY = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)
DUMMY_MSG_HASH = 1


def txs2witness(txs: List[Transaction], chain_id: int, MAX_TXS: int,
                MAX_CALLDATA_BYTES: int, keccak_randomness: int) -> Witness:
    """Reference tx_circuit.py:416-478."""
    assert len(txs) <= MAX_TXS
    keccak_table = KeccakTable()
    sign_verifications: List[SignVerifyChip] = []
    tx_fixed_rows: List[Row] = []
    tx_dyn_rows: List[Row] = []
    for index, tx in enumerate(txs):
        tx_rows, sv = tx2witness(index, tx, chain_id, keccak_randomness, keccak_table)
        sign_verifications.append(sv)
        for row in tx_rows:
            (tx_dyn_rows if row.tag == int(Tag.CallData) else tx_fixed_rows).append(row)
    assert len(tx_dyn_rows) <= MAX_CALLDATA_BYTES

    tx_padding_rows: List[Row] = []
    for i in range(len(txs), MAX_TXS):
        tx_padding_rows += padding_tx(i + 1)
    rows = (tx_fixed_rows + tx_padding_rows + tx_dyn_rows
            + [Row(0, int(Tag.CallData), 0, 0)] * (MAX_CALLDATA_BYTES - len(tx_dyn_rows)))
    padding = SignVerifyChip(bytes(32), 0, 0, DUMMY_SIGNATURE, DUMMY_PUBLIC_KEY, DUMMY_MSG_HASH)
    sign_verifications += [padding] * (MAX_TXS - len(txs))
    return Witness(rows, keccak_table, sign_verifications)


def sign_tx(sk: int, tx: Transaction, chain_id: int, k: Optional[int] = None) -> Transaction:
    """``tx`` signed with the secret key ``sk`` (the reference's tests sign
    with eth_keys); the nonce k defaults to (hash ^ sk) mod N, or 1."""
    h = int.from_bytes(keccak256(tx.sign_data(chain_id)), "big")
    if k is None:
        k = (h ^ sk) % secp256k1.N or 1
    v, r, s = secp256k1.sign(h, sk, k)
    return tx._replace(sig_v=(v & 1) + 35 + chain_id * 2, sig_r=r, sig_s=s)
