"""Bytecode circuit: verifies unrolled bytecode rows against the keccak
table (reference: src/zkevm_specs/bytecode_circuit.py:37-186), batched over
all rows with cyclic next-row shifts.

Counterpart of ``zkevm_specs_tpu/circuits/bytecode.py``.  On the card the
body runs through ``CircuitKernel``: the RLC step ``value_rlc * r`` is a
field multiply (K1), the index and push-counter steps are add/sub chains
(K3), and the keccak lookup is a fingerprint search (K6).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F, Word
from ..evm.opcode import get_push_size
from ..ops.fr import P
from ..ops.keccak import EMPTY_HASH
from ..tables.engine import Table
from ..tables.schemas import KECCAK_SCHEMA, BytecodeFieldTag
from ..utils.typing import is_circuit_code
from ..witness.typing import Bytecode, KeccakCircuit


class UnrolledBytecode:
    def __init__(self, bytes_: bytes, rows: Sequence[dict]):
        self.bytes = bytes_
        self.rows = rows


def unroll(code: bytes) -> UnrolledBytecode:
    return UnrolledBytecode(code, Bytecode(bytearray(code)).table_assignments())


def assign_bytecode_circuit(k: int, bytecodes: Sequence[UnrolledBytecode],
                            keccak_randomness: int) -> List[dict]:
    """Reference :104-171."""
    last_row_offset = 2**k - 1
    rows: List[dict] = []
    offset = 0
    for bytecode in bytecodes:
        next_push_data_left = 0
        value_rlc = 0
        for idx, row in enumerate(bytecode.rows):
            push_data_left = next_push_data_left
            is_code = push_data_left == 0
            push_data_size = 0
            if idx > 0:
                push_data_size = get_push_size(row["value"])
                next_push_data_left = push_data_size if is_code else push_data_left - 1
                value_rlc = (value_rlc * keccak_randomness + row["value"]) % P
            rows.append(
                {
                    "q_first": int(offset == 0),
                    "q_last": int(offset == last_row_offset),
                    "hash": row["bytecode_hash"],
                    "tag": int(row["field_tag"]),
                    "index": row["index"],
                    "value": row["value"],
                    "is_code": row["is_code"],
                    "push_data_left": push_data_left,
                    "value_rlc": value_rlc,
                    "length": len(bytecode.bytes),
                    "push_data_size": push_data_size,
                }
            )
            offset += 1
            if offset == 2**k:
                return rows
    for idx in range(offset, 2**k):
        rows.append(
            {
                "q_first": int(idx == 0),
                "q_last": int(idx == last_row_offset),
                "hash": EMPTY_HASH,
                "tag": int(BytecodeFieldTag.Header),
                "index": 0,
                "value": 0,
                "is_code": 0,
                "push_data_left": 0,
                "value_rlc": 0,
                "length": 0,
                "push_data_size": 0,
            }
        )
    return rows


def assign_keccak_table(bytecodes: Sequence[bytes], keccak_randomness: int) -> List[dict]:
    kc = KeccakCircuit()
    for code in bytecodes:
        kc.add(bytes(code), keccak_randomness)
    return kc.rows


_PUSH_SIZES = torch.tensor([get_push_size(i) for i in range(256)], dtype=torch.int64)
_PUSH_SIZES_ON: Dict[str, torch.Tensor] = {}

_BITS = {
    "q_first": 1, "q_last": 1, "tag": 8, "index": 32, "value": 16,
    "is_code": 1, "push_data_left": 16, "value_rlc": 254, "length": 32,
    "push_data_size": 8,
}


def _push_sizes(device) -> torch.Tensor:
    key = str(device)
    t = _PUSH_SIZES_ON.get(key)
    if t is None:
        t = _PUSH_SIZES_ON[key] = _PUSH_SIZES.to(device)
    return t


def build_bytecode_cols(ctx: Ctx, rows: List[dict]):
    col = {name: F.from_ints(ctx, [r[name] for r in rows], bits)
           for name, bits in _BITS.items()}
    col["hash"] = Word.from_ints(ctx, [r["hash"] for r in rows])
    return col


@is_circuit_code
def check_bytecode(ctx: Ctx, cs: ConstraintSystem, cols, tables, static, extra):
    """The bytecode-circuit constraint body (reference bytecode_circuit.py:37-101);
    runs eagerly (spec mode) and on the device unchanged."""
    col = cols
    hash_col = col["hash"]
    n = ctx.batch
    idx = (torch.arange(n, device=ctx.device) + 1) % n
    nxt = {name: v.gather(idx) for name, v in col.items() if name != "hash"}
    nxt_hash = hash_col.gather(idx)
    keccak = tables["keccak"]
    r = F.const(ctx, static["r"])

    is_header = col["tag"].eq_mask(int(BytecodeFieldTag.Header))
    is_byte = col["tag"].eq_mask(int(BytecodeFieldTag.Byte))
    next_is_header = nxt["tag"].eq_mask(int(BytecodeFieldTag.Header))
    next_is_byte = nxt["tag"].eq_mask(int(BytecodeFieldTag.Byte))
    q_first = ~col["q_first"].is_zero_mask()
    q_last = ~col["q_last"].is_zero_mask()
    not_last = ~q_last

    def check(mask, ok, msg):
        cs.check(ok | ~mask, lambda: msg)

    # q_first row must be a Header (reference :44-45)
    check(q_first, is_header, "first row is not a Header")

    # Header rows (reference :47-54)
    m = not_last & is_header
    check(m, col["value"].eq_mask(col["length"]), "Header: value != length")
    check(m, col["index"].is_zero_mask(), "Header: index != 0")
    # header -> byte (reference :67-73)
    mhb = m & next_is_byte
    check(mhb, nxt["length"].eq_mask(col["length"]), "Header->Byte: length mismatch")
    check(mhb, nxt["index"].is_zero_mask(), "Header->Byte: index != 0")
    check(mhb, nxt["is_code"].eq_mask(1), "Header->Byte: first byte must be code")
    check(mhb, nxt_hash.eq_mask(hash_col), "Header->Byte: hash mismatch")
    check(mhb, nxt["value_rlc"].eq_mask(nxt["value"]), "Header->Byte: rlc mismatch")
    # header -> header (reference :76-79)
    mhh = m & next_is_header
    check(mhh, col["length"].is_zero_mask(), "Header->Header: length != 0")
    check(mhh, hash_col.eq_mask(Word.const(ctx, EMPTY_HASH)), "Header->Header: not empty hash")

    # Byte rows (reference :56-62)
    m = not_last & is_byte
    # push table: push_data_size == get_push_size(value), value < 256
    push_sizes = _push_sizes(ctx.device)[torch.clamp(col["value"].limbs[..., 0], max=255)]
    check(
        m,
        col["value"].le_bits_mask(8)
        & (col["push_data_size"].limbs[..., 0] == push_sizes)
        & col["push_data_size"].le_bits_mask(8),
        "Byte: (value, push_data_size) not in push table",
    )
    check(
        m,
        col["is_code"].eq_mask(F.from_bool(ctx, col["push_data_left"].is_zero_mask())),
        "Byte: is_code mismatch",
    )
    # byte -> byte (reference :82-91)
    mbb = m & next_is_byte
    check(mbb, nxt["length"].eq_mask(col["length"]), "Byte->Byte: length mismatch")
    check(mbb, nxt["index"].eq_mask(col["index"] + 1), "Byte->Byte: index mismatch")
    check(mbb, nxt_hash.eq_mask(hash_col), "Byte->Byte: hash mismatch")
    check(
        mbb,
        nxt["value_rlc"].eq_mask(col["value_rlc"] * r + nxt["value"]),
        "Byte->Byte: rlc accumulation mismatch",
    )
    code_mask = ~col["is_code"].is_zero_mask()
    check(
        mbb & code_mask,
        nxt["push_data_left"].eq_mask(col["push_data_size"]),
        "Byte->Byte: push_data_left mismatch after opcode",
    )
    check(
        mbb & ~code_mask,
        nxt["push_data_left"].eq_mask(col["push_data_left"] - 1),
        "Byte->Byte: push_data_left not decremented",
    )
    # byte -> header (reference :94-97)
    mbh = m & next_is_header
    check(mbh, (col["index"] + 1).eq_mask(col["length"]), "Byte->Header: index+1 != length")
    keccak.lookup(
        cs,
        {
            "state_tag": F.const(ctx, 2),
            "input_rlc": col["value_rlc"],
            "input_len": col["length"],
            "output": hash_col,
        },
        enabled=mbh,
    )

    # q_last row (reference :64-66)
    check(q_last, is_header, "last row is not a Header")
    check(q_last, col["length"].is_zero_mask(), "last Header: length != 0")
    check(q_last, hash_col.eq_mask(Word.const(ctx, EMPTY_HASH)), "last Header: not empty hash")


def _host_inputs(rows: List[dict], keccak_rows: List[dict]):
    ctx = Ctx("cpu", len(rows), "eager")
    return build_bytecode_cols(ctx, rows), Table.from_rows(ctx, KECCAK_SCHEMA, keccak_rows)


def verify_bytecode_circuit(rows: List[dict], keccak_rows: List[dict],
                            keccak_randomness: int, success: bool = True):
    """Spec-mode (eager, host) check with reference verdict semantics."""
    from ..runtime.kernels import run_spec

    cols, keccak = _host_inputs(rows, keccak_rows)
    run_spec("bytecode", check_bytecode, cols, {"keccak": keccak},
             {"r": keccak_randomness}, success=success)


def bytecode_kernel(rows: List[dict], keccak_rows: List[dict],
                    keccak_randomness: int, device="cuda"):
    """Production path: the same constraint body as one ``CircuitKernel``
    on ``device`` (the card unless the caller asks for "cpu")."""
    from ..runtime.kernels import CircuitKernel

    cols, keccak = _host_inputs(rows, keccak_rows)
    keccak.index_for(tuple(KECCAK_SCHEMA.columns))
    return CircuitKernel("bytecode", check_bytecode, cols, {"keccak": keccak},
                         {"r": keccak_randomness}, device=device)
