"""Fixed-table lookups as computed predicates.

Counterpart of ``zkevm_specs_tpu/tables/fixed.py``.  The reference
materializes ~221k fixed rows (reference:
src/zkevm_specs/evm_circuit/table.py:14-103,583); here the same membership
relations are computed elementwise, and the small irregular sets
(ResponsibleOpcode, OpcodeConstantGas, PrecompileInfo) are sorted-constant
membership checks.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..dsl.cs import ConstraintSystem
from ..dsl.value import F
from .schemas import FixedTableTag

_RANGES = {
    FixedTableTag.Range5: 5,
    FixedTableTag.Range16: 16,
    FixedTableTag.Range32: 32,
    FixedTableTag.Range64: 64,
    FixedTableTag.Range256: 256,
    FixedTableTag.Range512: 512,
    FixedTableTag.Range1024: 1024,
    FixedTableTag.Range24_576: 24576,
}


def _u32_value(v: F) -> torch.Tensor:
    """Low-32-bit integer view of an F (valid only where le_bits holds)."""
    out = v.limbs[..., 0]
    if v.width > 1:
        out = out | (v.limbs[..., 1] << 16)
    return out


class FixedTables:
    """Stateless fixed-table predicate engine (shared across circuits)."""

    def __init__(self):
        self._sets: Dict[FixedTableTag, np.ndarray] = {}
        self._device_sets: Dict[tuple, torch.Tensor] = {}

    def register_set(self, tag: FixedTableTag, codes) -> None:
        """Install the sorted code set for an irregular fixed sub-table."""
        self._sets[tag] = np.sort(np.asarray(codes, dtype=np.int64))

    def _isin(self, tag: FixedTableTag, values: torch.Tensor) -> torch.Tensor:
        key = (tag, str(values.device))
        table = self._device_sets.get(key)
        if table is None:
            table = torch.from_numpy(self._sets[tag]).to(values.device)
            self._device_sets[key] = table
        pos = torch.searchsorted(table, values.contiguous()).clamp(max=table.shape[0] - 1)
        return table[pos] == values

    def lookup(self, cs: ConstraintSystem, tag: FixedTableTag, value0: F, value1: F,
               value2: F, enabled=None) -> None:
        ok = self._predicate(tag, value0, value1, value2)
        if enabled is not None:
            ok = ok | ~enabled
        cs.check(
            ok,
            lambda: f"Lookup FixedTableRow is unsatisfied on inputs "
            f"{{'tag': {tag!r}, 'value0': {value0!r}, 'value1': {value1!r}, 'value2': {value2!r}}}",
        )

    def _predicate(self, tag: FixedTableTag, v0: F, v1: F, v2: F) -> torch.Tensor:
        rng = _RANGES.get(tag)
        if rng is not None:
            return v0.lt_mask(rng) & v1.is_zero_mask() & v2.is_zero_mask()

        if tag == FixedTableTag.SignByte:
            ok = v0.le_bits_mask(8) & v2.is_zero_mask()
            sign = (v0.limbs[..., 0] >> 7) * 0xFF
            return ok & v1.le_bits_mask(8) & (v1.limbs[..., 0] == sign)

        if tag in (FixedTableTag.BitwiseAnd, FixedTableTag.BitwiseOr, FixedTableTag.BitwiseXor):
            ok = v0.le_bits_mask(8) & v1.le_bits_mask(8) & v2.le_bits_mask(8)
            a, b, c = v0.limbs[..., 0], v1.limbs[..., 0], v2.limbs[..., 0]
            if tag == FixedTableTag.BitwiseAnd:
                return ok & ((a & b) == c)
            if tag == FixedTableTag.BitwiseOr:
                return ok & ((a | b) == c)
            return ok & ((a ^ b) == c)

        if tag == FixedTableTag.Pow2:
            # (value, 2^value if value<128 else 0, 0 if value<128 else 2^(value-128))
            ok = v0.le_bits_mask(8)
            n = _u32_value(v0) & 0xFF
            is_lo = n < 128
            ok = ok & _eq_pow2(v1, torch.where(is_lo, n, 0), is_lo)
            ok = ok & _eq_pow2(v2, torch.where(is_lo, 0, n - 128), ~is_lo)
            return ok

        if tag == FixedTableTag.ResponsibleOpcode:
            # code = state*2048*256 + opcode*2048 + aux (aux <= 1024)
            ok = v0.le_bits_mask(8) & v1.le_bits_mask(8) & v2.le_bits_mask(11)
            code = _u32_value(v0) * (2048 * 256) + _u32_value(v1) * 2048 + _u32_value(v2)
            return ok & self._isin(tag, code)

        if tag == FixedTableTag.OpcodeConstantGas:
            ok = v0.le_bits_mask(8) & v1.le_bits_mask(16) & v2.is_zero_mask()
            code = _u32_value(v0) * 65536 + _u32_value(v1)
            return ok & self._isin(tag, code)

        if tag == FixedTableTag.PrecompileInfo:
            ok = v0.le_bits_mask(8) & v1.le_bits_mask(8) & v2.le_bits_mask(16)
            code = _u32_value(v0) * (65536 * 256) + _u32_value(v1) * 65536 + _u32_value(v2)
            return ok & self._isin(tag, code)

        raise ValueError(f"unknown fixed table tag {tag}")


def _eq_pow2(v: F, exponent: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """v == 2^exponent where active, v == 0 elsewhere (exponent < 128)."""
    ok = torch.ones(exponent.shape, dtype=torch.bool, device=exponent.device)
    limb_idx = exponent >> 4
    bit = exponent & 15
    for i in range(max(v.width, 8)):
        want = torch.where(active & (limb_idx == i), torch.ones_like(bit) << bit, 0)
        have = v.limbs[..., i] if i < v.width else torch.zeros_like(want)
        ok = ok & (have == want)
    return ok
