"""Step state: host-side witness records and their columnar batch form.

Counterpart of ``zkevm_specs_tpu/evm/step.py`` (reference:
src/zkevm_specs/evm_circuit/step.py:6-75).  ``StepState`` is the host
witness record (Python ints); ``StepStateBatch`` is a group of steps of the
*same* execution state as columnar limb tensors.
"""
from __future__ import annotations

from typing import Any, List, Optional

from ..dsl.value import Ctx, F, Word
from .execution_state import ExecutionState


class StepState:
    """Host witness record for one step (all plain Python values)."""

    __slots__ = (
        "execution_state", "rw_counter", "call_id", "is_root", "is_create",
        "code_hash", "program_counter", "stack_pointer", "gas_left",
        "memory_word_size", "reversible_write_counter", "log_id", "aux_data",
    )

    def __init__(
        self,
        execution_state: ExecutionState,
        rw_counter: int,
        call_id: int = 0,
        is_root: bool = False,
        is_create: bool = False,
        code_hash: int = 0,
        program_counter: int = 0,
        stack_pointer: int = 1024,
        gas_left: int = 0,
        memory_word_size: int = 0,
        reversible_write_counter: int = 0,
        log_id: int = 0,
        aux_data: Optional[Any] = None,
    ) -> None:
        self.execution_state = execution_state
        self.rw_counter = rw_counter
        self.call_id = call_id
        self.is_root = is_root
        self.is_create = is_create
        self.code_hash = code_hash
        self.program_counter = program_counter
        self.stack_pointer = stack_pointer
        self.gas_left = gas_left
        self.memory_word_size = memory_word_size
        self.reversible_write_counter = reversible_write_counter
        self.log_id = log_id
        self.aux_data = aux_data


# declared bit-bounds per column (auto-widened by malformed witnesses)
_BITS = {
    "execution_state": 8,
    "rw_counter": 32,
    "call_id": 32,
    "is_root": 1,
    "is_create": 1,
    "program_counter": 64,
    "stack_pointer": 16,
    "gas_left": 64,
    "memory_word_size": 32,
    "reversible_write_counter": 32,
    "log_id": 32,
}


class StepStateBatch:
    """Columnar view over a group of host StepStates.

    ``execution_state_static`` is set for `curr` batches (group key); `next`
    batches carry only the tensor form since successors vary within a group.
    """

    COLUMNS = (
        "execution_state", "rw_counter", "call_id", "is_root", "is_create",
        "program_counter", "stack_pointer", "gas_left", "memory_word_size",
        "reversible_write_counter", "log_id",
    )

    def __init__(self, ctx: Ctx, steps: List[StepState],
                 static_state: Optional[ExecutionState] = None):
        self.ctx = ctx
        self.execution_state_static = static_state
        self.execution_state = F.from_ints(
            ctx, [int(s.execution_state) for s in steps], _BITS["execution_state"])
        for name in (
            "rw_counter", "call_id", "program_counter", "stack_pointer",
            "gas_left", "memory_word_size", "reversible_write_counter", "log_id",
        ):
            setattr(self, name, F.from_ints(ctx, [getattr(s, name) for s in steps], _BITS[name]))
        self.is_root = F.from_ints(ctx, [int(s.is_root) for s in steps], 1)
        self.is_create = F.from_ints(ctx, [int(s.is_create) for s in steps], 1)
        self.code_hash = Word.from_ints(ctx, [s.code_hash for s in steps])
        self.aux_data = [s.aux_data for s in steps]

    def to_columns(self):
        """Raw limb tensors for the replay's inputs."""
        cols = {name: getattr(self, name).limbs for name in self.COLUMNS}
        cols["code_hash_lo"] = self.code_hash.lo.limbs
        cols["code_hash_hi"] = self.code_hash.hi.limbs
        return cols

    @classmethod
    def from_columns(cls, ctx: Ctx, cols, static_state=None, bits=None):
        """Rebuild from raw limb tensors; ``bits`` carries the per-column
        static bounds captured at trace time."""
        out = object.__new__(cls)
        out.ctx = ctx
        out.execution_state_static = static_state
        for name in cls.COLUMNS:
            setattr(out, name, F(ctx, cols[name], bits[name]))
        out.code_hash = Word(
            F(ctx, cols["code_hash_lo"], bits["code_hash_lo"]),
            F(ctx, cols["code_hash_hi"], bits["code_hash_hi"]),
        )
        out.aux_data = None
        return out

    def column_bits(self):
        bits = {name: getattr(self, name).bits for name in self.COLUMNS}
        bits["code_hash_lo"] = self.code_hash.lo.bits
        bits["code_hash_hi"] = self.code_hash.hi.bits
        return bits
