"""Copy circuit: copy events as interleaved read/write row pairs
(reference: src/zkevm_specs/copy_circuit.py:23-130).

Counterpart of ``zkevm_specs_tpu/circuits/copy.py``: every row is checked
in one batched constraint body, with cyclic +1/+2 row shifts for the
transitions and masked lookups into the rw, bytecode and tx tables.  On the
card (``copy_kernel``, a ``CircuitKernel``) the field products and sums run
on K1 and K3, the shifts and masks on plain tensor ops, and the lookups are
fingerprint searches (K6) on indexes built on the host.
"""
from __future__ import annotations

from typing import List

import torch

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F, Word
from ..tables.container import Tables, TablesView
from ..tables.schemas import RW, BytecodeFieldTag, CopyDataTypeTag, Target, TxContextFieldTag
from ..utils.param import N_BYTES_MEMORY_ADDRESS
from ..utils.typing import is_circuit_code
from ..witness.typing import CopyCircuit

_BITS = {
    "q_step": 1, "is_first": 1, "is_last": 1, "tag": 8, "addr": 64,
    "src_addr_end": 64, "bytes_left": 64, "value": 254, "rlc_acc": 254,
    "is_code": 1, "is_pad": 1, "rw_counter": 32, "rwc_inc_left": 32,
    "is_memory": 1, "is_bytecode": 1, "is_tx_calldata": 1, "is_tx_log": 1,
    "is_rlc_acc": 1,
}


def build_copy_cols(ctx: Ctx, rows: List[dict]):
    c = {name: F.from_ints(ctx, [row[name] for row in rows], bits)
         for name, bits in _BITS.items()}
    c["id"] = Word.from_ints(ctx, [row["id"] for row in rows])
    return c


@is_circuit_code
def check_copy(ctx: Ctx, cs: ConstraintSystem, cols, tables, static, extra):
    """The copy-circuit constraint body (reference copy_circuit.py:23-130),
    eager and on the device alike."""
    tables = TablesView(ctx, tables)
    c = {k: v for k, v in cols.items() if k != "id"}
    id_col = cols["id"]
    n = ctx.batch
    rows = torch.arange(n, device=ctx.device)
    i1 = (rows + 1) % n
    i2 = (rows + 2) % n
    n1 = {name: v.gather(i1) for name, v in c.items()}
    n2 = {name: v.gather(i2) for name, v in c.items()}
    id2 = id_col.gather(i2)
    rf = F.const(ctx, static["r"])

    def tag_flag(name, t):
        cs.constrain_equal(c[name], F.from_bool(ctx, c["tag"].eq_mask(int(t))), name=name)

    # verify_row (reference :23-59)
    cs.constrain_bool(c["is_first"], "is_first")
    cs.constrain_bool(c["is_last"], "is_last")
    cs.constrain_zero((1 - c["q_step"]) * c["is_first"], "is_first on write row")
    cs.constrain_zero(c["q_step"] * c["is_last"], "is_last on read row")
    tag_flag("is_memory", CopyDataTypeTag.Memory)
    tag_flag("is_bytecode", CopyDataTypeTag.Bytecode)
    tag_flag("is_tx_calldata", CopyDataTypeTag.TxCalldata)
    tag_flag("is_tx_log", CopyDataTypeTag.TxLog)
    tag_flag("is_rlc_acc", CopyDataTypeTag.RlcAcc)

    def check(mask, ok, msg):
        cs.check(ok | ~mask, lambda: msg)

    not_last_two = (c["is_last"] + n1["is_last"]).is_zero_mask()
    check(not_last_two, id_col.eq_mask(id2), "copy step id mismatch")
    check(not_last_two, c["tag"].eq_mask(n2["tag"]), "copy step tag mismatch")
    check(not_last_two, (c["addr"] + 1).eq_mask(n2["addr"]), "copy step addr mismatch")
    check(not_last_two, c["src_addr_end"].eq_mask(n2["src_addr_end"]),
          "copy step src_addr_end mismatch")

    rw_diff = (1 - c["is_pad"]) * (c["is_memory"] + c["is_tx_log"])
    not_last = c["is_last"].is_zero_mask()
    check(not_last, (c["rw_counter"] + rw_diff).eq_mask(n1["rw_counter"]),
          "rw_counter transition")
    check(not_last, (c["rwc_inc_left"] - rw_diff).eq_mask(n1["rwc_inc_left"]),
          "rwc_inc_left transition")
    check(not_last, c["rlc_acc"].eq_mask(n1["rlc_acc"]), "rlc_acc not constant")
    is_last = ~not_last
    check(is_last, c["rwc_inc_left"].eq_mask(rw_diff), "rwc_inc_left at last row")
    check(is_last & ~c["is_rlc_acc"].is_zero_mask(), c["rlc_acc"].eq_mask(c["value"]),
          "rlc_acc != value at last RlcAcc row")

    # verify_step (reference :62-89)
    q = ~c["q_step"].is_zero_mask()
    check(q & ~n1["is_last"].is_zero_mask(), c["bytes_left"].eq_mask(1),
          "bytes_left != 1 at last step")
    check(q & n1["is_last"].is_zero_mask(), c["bytes_left"].eq_mask(n2["bytes_left"] + 1),
          "bytes_left not decremented")
    check(q & ~c["is_pad"].is_zero_mask(), c["value"].is_zero_mask(), "pad value != 0")
    not_log = c["is_tx_log"].is_zero_mask()
    in_range = (c["addr"].le_bits_mask(8 * N_BYTES_MEMORY_ADDRESS)
                & c["src_addr_end"].le_bits_mask(8 * N_BYTES_MEMORY_ADDRESS))
    check(q & not_log, in_range, "copy addr out of range")
    lt = c["addr"].lt_mask(c["src_addr_end"])
    check(q & not_log, F.from_bool(ctx, ~lt).eq_mask(c["is_pad"]),
          "is_pad != !(addr < src_addr_end)")
    check(q, n1["is_pad"].is_zero_mask(), "write row is padded")
    check(q & n1["is_rlc_acc"].is_zero_mask(), c["value"].eq_mask(n1["value"]),
          "write value != read value")
    check(q & ~c["is_first"].is_zero_mask(), c["value"].eq_mask(n1["value"]),
          "first step value mismatch")
    check(~q & not_last & ~c["is_rlc_acc"].is_zero_mask(),
          n2["value"].eq_mask(c["value"] * rf + n1["value"]), "rlc accumulation mismatch")

    # cross-table lookups (reference :105-130)
    m = ~c["is_memory"].is_zero_mask() & c["is_pad"].is_zero_mask()
    row = tables.rw_lookup(cs, c["rw_counter"], 1 - c["q_step"], F.const(ctx, int(Target.Memory)),
                           id=id_col.lo, address=c["addr"], enabled=m)
    check(m, row.value.lo.eq_mask(c["value"]), "memory copy value mismatch")

    m = ~c["is_bytecode"].is_zero_mask() & c["is_pad"].is_zero_mask()
    row = tables.bytecode_lookup(cs, id_col, F.const(ctx, int(BytecodeFieldTag.Byte)),
                                 c["addr"], c["is_code"], enabled=m)
    check(m, row.value.eq_mask(c["value"]), "bytecode copy value mismatch")

    m = ~c["is_tx_calldata"].is_zero_mask() & c["is_pad"].is_zero_mask()
    row = tables.tx_lookup(cs, id_col.lo, F.const(ctx, int(TxContextFieldTag.CallData)),
                           c["addr"], enabled=m)
    check(m, row.value.lo.eq_mask(c["value"]), "tx calldata copy value mismatch")

    m = ~c["is_tx_log"].is_zero_mask()
    row = tables.rw_lookup(cs, c["rw_counter"], F.const(ctx, int(RW.Write)),
                           F.const(ctx, int(Target.TxLog)), id=id_col.lo, address=c["addr"],
                           enabled=m)
    check(m, row.value.lo.eq_mask(c["value"]), "tx log copy value mismatch")


_LOOKUP_TABLES = ("rw", "bytecode", "tx")
_LOOKUP_SUBSETS = {
    "rw": [("rw_counter", "rw", "key0", "id", "address")],
    "bytecode": [("bytecode_hash", "field_tag", "index", "is_code")],
    "tx": [("tx_id", "field_tag", "call_data_index_or_zero")],
}


def _copy_tables(tables: Tables, ctx: Ctx, build_indexes: bool = False):
    tv = {}
    for name in _LOOKUP_TABLES:
        t = getattr(tables.with_ctx(ctx), name)
        if build_indexes:
            for s in _LOOKUP_SUBSETS[name]:
                t.index_for(s)
        tv[name] = t
    return tv


def verify_copy_table(copy_circuit: CopyCircuit, tables: Tables, r: int,
                      success: bool = True) -> None:
    """Spec-mode (eager, host) driver with reference verdict semantics."""
    from ..runtime.kernels import run_spec

    rows = copy_circuit.table()
    if not rows:
        return
    ctx = Ctx("cpu", len(rows), "eager")
    run_spec("copy", check_copy, build_copy_cols(ctx, rows), _copy_tables(tables, ctx),
             {"r": r}, success=success)


def copy_kernel(copy_circuit: CopyCircuit, tables: Tables, r: int, device="cuda"):
    """Production path: the same constraint body as one ``CircuitKernel``
    on ``device`` (the card unless the caller asks for "cpu"); None when
    the circuit has no row.  The lookups' indexes are built on the host
    (their query columns come in the schemas' order), so the device check
    builds none."""
    from ..runtime.kernels import CircuitKernel, require_device

    require_device(device, "copy")
    rows = copy_circuit.table()
    if not rows:
        return None
    ctx = Ctx("cpu", len(rows), "eager")
    return CircuitKernel("copy", check_copy, build_copy_cols(ctx, rows),
                         _copy_tables(tables, ctx, build_indexes=True), {"r": r}, None,
                         device=device)
