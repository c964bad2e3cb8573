"""Sig circuit: signature rows checked against the keccak table and ECDSA
(reference: src/zkevm_specs/sig_circuit.py:1-122).

Counterpart of ``zkevm_specs_tpu/circuits/sig.py``.  Every signature row
is checked in one batched constraint body (``check_signverify``, shared
with the tx circuit): the keccak(pk) link is a keccak-table lookup, the
address binding a split of the key hash, and the pk-bytes RLC a Horner
scan over 64 byte rows (kernel K8, ``circuits/keccak.py:horner_rlc``).
The ECDSA verdict is computed on the host (``ops/ecc/secp256k1.py:
verify_batch``) and shipped as a hint bit that the body constrains
against ``is_valid``.  On the card (``sig_kernel``, a ``CircuitKernel``)
the keccak lookup searches the prebuilt index (K6).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Set, Tuple

import numpy as np
import torch

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F, Word
from ..ops import limbs as L
from ..ops.ecc import secp256k1
from ..ops.keccak import keccak256
from ..tables.engine import Table
from ..tables.schemas import KECCAK_SCHEMA
from ..utils.typing import is_circuit_code
from ..witness.rlc import RLC
from .keccak import horner_rlc


class KeccakTable:
    """(is_enabled, input_rlc, input_len, output): the circuit's local
    keccak table (reference tx_circuit.py:38-61)."""

    def __init__(self):
        self.table: Set[Tuple[int, int, int, int]] = {(0, 0, 0, 0)}

    def add(self, data: bytes, keccak_randomness: int):
        output = int.from_bytes(keccak256(data), "big")
        self.table.add((1, RLC(bytes(reversed(data)), keccak_randomness, n_bytes=64).expr(),
                        len(data), output))

    def lookup(self, is_enabled: int, input_rlc: int, input_len: int, output: int,
               assert_msg: str):
        assert (is_enabled, input_rlc, input_len, output) in self.table, (
            f"{assert_msg}: keccak lookup failed")

    def rows(self) -> List[dict]:
        """Rows for the shared columnar keccak table schema."""
        return [{"state_tag": 2 if en else 0, "input_rlc": rlc, "input_len": ln, "output": out}
                for (en, rlc, ln, out) in self.table]


class SigRow:
    """One sig-circuit row (reference sig_circuit.py Row)."""

    def __init__(self, pub_key: Tuple[int, int], msg_hash: int,
                 sig_v: int, sig_r: int, sig_s: int, is_valid: bool):
        self.pub_key = pub_key
        self.msg_hash = msg_hash
        self.sig_v = sig_v
        self.sig_r = sig_r
        self.sig_s = sig_s
        self.pub_key_hash = keccak256(secp256k1.pubkey_bytes(pub_key))
        self.recovered_addr = int.from_bytes(self.pub_key_hash[-20:], "big")
        self.is_valid = is_valid

    @classmethod
    def assign(cls, signature: Tuple[int, int, int], pub_key: Tuple[int, int],
               msg_hash: bytes, is_valid: bool = True):
        v, r, s_ = signature
        return cls(pub_key, int.from_bytes(msg_hash, "big"), v, r, s_, is_valid)

    def table_row(self) -> dict:
        return {"msg_hash": self.msg_hash, "sig_v": self.sig_v, "sig_r": self.sig_r,
                "sig_s": self.sig_s, "recovered_addr": self.recovered_addr,
                "is_valid": int(self.is_valid)}


class Witness(NamedTuple):
    rows: List[SigRow]
    keccak_table: KeccakTable


# -- the sign-verify body, shared with the tx circuit -------------------------------

def build_signverify_inputs(
    ctx: Ctx,
    pub_keys: List[Tuple[int, int]],
    pub_key_hashes: List[bytes],
    recovered_addrs: List[int],
    enabled: List[int],
    msg_hashes: List[int],
    sigs: List[Tuple[int, int]],
    is_valid: List[int],
):
    """Columns and host-crypto hint arrays for ``check_signverify``: the
    keys' bytes as ``[64, n]`` byte rows and the ECDSA verdict bits."""
    n = len(pub_keys)
    cols: Dict[str, object] = {
        "pk_hash": Word.from_ints(ctx, [int.from_bytes(h, "big") for h in pub_key_hashes]),
        "recovered_addr": F.from_ints(ctx, recovered_addrs, 160),
        "enabled": F.from_ints(ctx, enabled, 1),
        "is_valid": F.from_ints(ctx, is_valid, 1),
    }
    pk_bytes = b"".join(secp256k1.pubkey_bytes(pk) for pk in pub_keys)
    pk_byte_cols = np.frombuffer(pk_bytes, dtype=np.uint8).reshape(n, 64).T.copy()
    ecdsa_ok = np.array(secp256k1.verify_batch(
        [(h, r, s, pk) for h, (r, s), pk in zip(msg_hashes, sigs, pub_keys)]), dtype=np.uint8)
    return cols, {"pk_byte_cols": pk_byte_cols, "ecdsa_ok": ecdsa_ok}


@is_circuit_code
def check_signverify(ctx: Ctx, cs: ConstraintSystem, cols, tables, static, extra):
    """keccak(pk) == pk_hash through the keccak table, address == the low
    20 bytes of pk_hash, and the host ECDSA verdict == is_valid, for all
    rows at once.  Rows with ``enabled == 0`` (padding) are held to the
    validity bit alone (padding carries the always-valid dummy signature,
    reference tx_circuit.py:405-413).  ``extra`` holds tensors on the
    context's device."""
    en = ~cols["enabled"].is_zero_mask()

    # 1. keccak(pk_bytes) == pk_hash through the keccak table
    pk_byte_cols = extra["pk_byte_cols"]
    active = torch.ones(pk_byte_cols.shape, dtype=torch.bool, device=pk_byte_cols.device)
    rlc = F(ctx, horner_rlc(pk_byte_cols, active, static["r"]), 254)
    tables["keccak"].lookup(
        cs,
        {"state_tag": F.const(ctx, 2), "input_rlc": rlc, "input_len": F.const(ctx, 64),
         "output": cols["pk_hash"]},
        enabled=en,
    )

    # 2. recovered_addr == low 20 bytes of pk_hash
    addr_hi, addr_lo = cols["recovered_addr"].split_pow2(128, 32)
    hash_hi_low32 = cols["pk_hash"].hi.split_pow2(32, 96)[1]
    cs.check(addr_lo.eq_mask(cols["pk_hash"].lo) | ~en, lambda: "address lo != pk_hash lo")
    cs.check(addr_hi.eq_mask(hash_hi_low32) | ~en,
             lambda: "address hi != pk_hash bytes 12..16")

    # 3. the host ECDSA verdict matches is_valid (all lanes: padding rows
    # carry the dummy valid signature)
    ok = F(ctx, extra["ecdsa_ok"].to(L.DTYPE)[:, None], 1)
    cs.check(ok.eq_mask(cols["is_valid"]), lambda: "ecdsa validity mismatch")


def _sig_inputs(witness: Witness, ctx: Ctx):
    rows = witness.rows
    cols, extra = build_signverify_inputs(
        ctx,
        [row.pub_key for row in rows],
        [row.pub_key_hash for row in rows],
        [row.recovered_addr for row in rows],
        [1] * len(rows),
        [row.msg_hash for row in rows],
        [(row.sig_r, row.sig_s) for row in rows],
        [int(row.is_valid) for row in rows],
    )
    cols["sig_v"] = F.from_ints(ctx, [row.sig_v for row in rows], 8)
    return cols, extra


@is_circuit_code
def check_sig(ctx: Ctx, cs: ConstraintSystem, cols, tables, static, extra):
    """The sig-circuit body: v boolean, then the shared sign-verify rules
    (reference sig_circuit.py Row.verify :63-105)."""
    cs.constrain_bool(cols["sig_v"], "sig_v")
    check_signverify(ctx, cs, cols, tables, static, extra)


def keccak_lookup_table(ctx: Ctx, keccak_table: KeccakTable, build_index: bool = False) -> Table:
    """The local keccak table as a columnar ``Table``; with
    ``build_index``, its index on the query's columns, which come in
    ``KECCAK_SCHEMA``'s order, built on the host so that a device check
    searches it and builds none."""
    t = Table.from_rows(ctx, KECCAK_SCHEMA, keccak_table.rows())
    if build_index:
        t.index_for(tuple(KECCAK_SCHEMA.columns))
    return t


def verify_circuit(witness: Witness, keccak_randomness: int, success: bool = True) -> None:
    """Spec-mode (eager, host) driver with reference verdict semantics."""
    from ..runtime.kernels import run_spec

    if not witness.rows:
        return
    ctx = Ctx("cpu", len(witness.rows), "eager")
    cols, extra = _sig_inputs(witness, ctx)
    run_spec("sig", check_sig, cols, {"keccak": keccak_lookup_table(ctx, witness.keccak_table)},
             {"r": keccak_randomness}, extra, success=success)


def sig_kernel(witness: Witness, keccak_randomness: int, device="cuda"):
    """Production path: the same constraint body as one ``CircuitKernel``
    on ``device`` (the card unless the caller asks for "cpu"); None when
    the witness has no row."""
    from ..runtime.kernels import CircuitKernel, require_device

    require_device(device, "sig")
    if not witness.rows:
        return None
    ctx = Ctx("cpu", len(witness.rows), "eager")
    cols, extra = _sig_inputs(witness, ctx)
    return CircuitKernel("sig", check_sig, cols,
                         {"keccak": keccak_lookup_table(ctx, witness.keccak_table, True)},
                         {"r": keccak_randomness}, extra, device=device)
