"""The shared Tables container consumed by the EVM circuit.

Counterpart of ``zkevm_specs_tpu/tables/container.py`` (reference:
src/zkevm_specs/evm_circuit/table.py:578-858): tables are built once from
host-side witness rows (dicts of ints) on the CPU; the fixed tables are
computed predicates (see fixed.py).  Only the typed lookups of the ported
gadgets and circuits are here (fixed, block, tx, bytecode, rw, copy,
keccak, exp).
"""
from __future__ import annotations

import copy as _copy
from typing import Mapping, Optional, Sequence, Union

from ..dsl.value import Ctx, F, Word, WordOrValue
from . import schemas as S
from .engine import Row, Table
from .fixed import FixedTables

TABLE_NAMES = (
    "block", "tx", "withdrawal", "bytecode", "rw", "copy",
    "keccak", "exp", "sig", "ecc", "mpt",
)


def _shared_fixed() -> FixedTables:
    # imported here: the evm package imports this module, so a top-level
    # import would make importing this module first a cycle
    from ..evm.execution_state import responsible_opcode_codes
    from ..evm.opcode import constant_gas_cost_pairs
    from ..evm.precompile import precompile_info_pairs

    ft = FixedTables()
    ft.register_set(S.FixedTableTag.ResponsibleOpcode, responsible_opcode_codes())
    ft.register_set(
        S.FixedTableTag.OpcodeConstantGas,
        sorted(op * 65536 + gas for op, gas in constant_gas_cost_pairs()),
    )
    ft.register_set(
        S.FixedTableTag.PrecompileInfo,
        sorted(st * 65536 * 256 + addr * 65536 + gas for st, addr, gas in precompile_info_pairs()),
    )
    return ft


_FIXED = None


def fixed_tables() -> FixedTables:
    global _FIXED
    if _FIXED is None:
        _FIXED = _shared_fixed()
    return _FIXED


class Tables:
    def __init__(
        self,
        ctx: Ctx = None,
        block_table: Sequence[Mapping[str, int]] = (),
        tx_table: Sequence[Mapping[str, int]] = (),
        withdrawal_table: Sequence[Mapping[str, int]] = (),
        bytecode_table: Sequence[Mapping[str, int]] = (),
        rw_table: Sequence[Mapping[str, int]] = (),
        copy_table: Sequence[Mapping[str, int]] = (),
        keccak_table: Sequence[Mapping[str, int]] = (),
        exp_table: Sequence[Mapping[str, int]] = (),
        sig_table: Sequence[Mapping[str, int]] = (),
        ecc_table: Sequence[Mapping[str, int]] = (),
        mpt_table: Sequence[Mapping[str, int]] = (),
    ):
        if ctx is None:
            ctx = Ctx("cpu", 1, "eager")
        self.ctx = ctx
        self.fixed = fixed_tables()
        self.block = Table.from_rows(ctx, S.BLOCK_SCHEMA, block_table)
        self.tx = Table.from_rows(ctx, S.TX_SCHEMA, tx_table)
        self.withdrawal = Table.from_rows(ctx, S.WITHDRAWAL_SCHEMA, withdrawal_table)
        self.bytecode = Table.from_rows(ctx, S.BYTECODE_SCHEMA, bytecode_table)
        self.rw = Table.from_rows(ctx, S.RW_SCHEMA, rw_table)
        self.copy = Table.from_rows(ctx, S.COPY_SCHEMA, copy_table)
        self.keccak = Table.from_rows(ctx, S.KECCAK_SCHEMA, keccak_table)
        self.exp = Table.from_rows(ctx, S.EXP_SCHEMA, exp_table)
        self.sig = Table.from_rows(ctx, S.SIG_SCHEMA, sig_table)
        self.ecc = Table.from_rows(ctx, S.ECC_SCHEMA, ecc_table)
        self.mpt = Table.from_rows(ctx, S.MPT_SCHEMA, mpt_table)

    def with_ctx(self, ctx: Ctx) -> "Tables":
        """Re-bind the same table data to a different batch context (tables
        are batch-agnostic; only queries carry the batch)."""
        out = _copy.copy(self)
        out.ctx = ctx
        for name in TABLE_NAMES:
            t: Table = getattr(self, name)
            nt = Table(ctx, t.schema, t.data, t.n_rows)
            nt._indexes = t._indexes
            setattr(out, name, nt)
        return out

    # -- typed lookups (reference table.py:673-858) ------------------------

    def fixed_lookup(self, cs, tag, value0: F, value1: F = None, value2: F = None, enabled=None):
        ctx = value0.ctx
        value1 = value1 if value1 is not None else F.const(ctx, 0)
        value2 = value2 if value2 is not None else F.const(ctx, 0)
        self.fixed.lookup(cs, tag, value0, value1, value2, enabled=enabled)

    def block_lookup(self, cs, field_tag: F, block_number: F, enabled=None) -> Row:
        return self.block.lookup(
            cs, {"field_tag": field_tag, "block_number_or_zero": block_number}, enabled=enabled)

    def tx_lookup(self, cs, tx_id: F, field_tag: F, call_data_index: F, enabled=None) -> Row:
        return self.tx.lookup(
            cs, {"tx_id": tx_id, "field_tag": field_tag,
                 "call_data_index_or_zero": call_data_index}, enabled=enabled)

    def bytecode_lookup(self, cs, bytecode_hash: Word, field_tag: F, index: F,
                        is_code: Optional[F] = None, enabled=None) -> Row:
        return self.bytecode.lookup(
            cs,
            {"bytecode_hash": bytecode_hash, "field_tag": field_tag, "index": index,
             "is_code": is_code},
            enabled=enabled,
        )

    def rw_lookup(
        self,
        cs,
        rw_counter: F,
        rw: F,
        tag: F,
        id: Optional[F] = None,
        address: Optional[F] = None,
        field_tag: Optional[F] = None,
        storage_key: Optional[Word] = None,
        value: Optional[Union[Word, F]] = None,
        value_prev: Optional[Union[Word, F]] = None,
        aux0: Optional[Word] = None,
        enabled=None,
    ) -> Row:
        def wv(x):
            if x is None:
                return None
            return x if isinstance(x, Word) else WordOrValue(x)

        return self.rw.lookup(
            cs,
            {
                "rw_counter": rw_counter,
                "rw": rw,
                "key0": tag,
                "id": id,
                "address": address,
                "field_tag": field_tag,
                "storage_key": storage_key,
                "value": wv(value),
                "value_prev": wv(value_prev),
                "aux0": aux0,
            },
            enabled=enabled,
        )

    def copy_lookup(self, cs, src_id, src_tag: F, dst_id, dst_tag: F, src_addr: F,
                    src_addr_end: F, dst_addr: F, length: F, rw_counter: F,
                    enabled=None) -> Row:
        def wv(x):
            return x if isinstance(x, Word) else WordOrValue(x)

        return self.copy.lookup(
            cs,
            {"src_id": wv(src_id), "src_tag": src_tag, "dst_id": wv(dst_id), "dst_tag": dst_tag,
             "src_addr": src_addr, "src_addr_end": src_addr_end, "dst_addr": dst_addr,
             "length": length, "rw_counter": rw_counter},
            enabled=enabled,
        )

    def keccak_lookup(self, cs, length: F, value_rlc: F, enabled=None) -> Row:
        return self.keccak.lookup(
            cs,
            {"state_tag": F.const(length.ctx, 2),  # Finalize
             "input_len": length, "input_rlc": value_rlc},
            enabled=enabled,
        )

    def exp_lookup(self, cs, identifier: F, is_last: F, base_limbs, exponent: Word,
                   enabled=None) -> Row:
        ctx = identifier.ctx
        return self.exp.lookup(
            cs,
            {"is_step": F.const(ctx, 1), "identifier": identifier, "is_last": is_last,
             "base_limb0": base_limbs[0], "base_limb1": base_limbs[1],
             "base_limb2": base_limbs[2], "base_limb3": base_limbs[3],
             "exponent": exponent},
            enabled=enabled,
        )

    def sig_lookup(self, cs, msg_hash: Word, sig_v: F, sig_r: Word, sig_s: Word,
                   recovered_addr: F, is_valid: F, enabled=None) -> Row:
        return self.sig.lookup(
            cs,
            {"msg_hash": msg_hash, "sig_v": sig_v, "sig_r": sig_r, "sig_s": sig_s,
             "recovered_addr": recovered_addr, "is_valid": is_valid},
            enabled=enabled,
        )

    def ecc_lookup(self, cs, op_type: F, px: Word, py: Word, qx: Word, qy: Word,
                   input_rlc: F, out_x: F, out_y: F, is_valid: F, enabled=None) -> Row:
        return self.ecc.lookup(
            cs,
            {"op_type": op_type, "px": px, "py": py, "qx": qx, "qy": qy,
             "input_rlc": input_rlc, "out_x": out_x, "out_y": out_y, "is_valid": is_valid},
            enabled=enabled,
        )


class TablesView(Tables):
    """Some of the tables under their usual attribute names, so that a
    circuit check that is given only the tables it reads can use the typed
    lookups above (the JAX package's ``TablesView``)."""

    def __init__(self, ctx: Ctx, tables: Mapping[str, Table]):
        self.ctx = ctx
        for k, v in tables.items():
            setattr(self, k, v)
